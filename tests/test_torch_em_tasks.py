"""EM's job-wide task builder (align/batch.alignment_tasks) against the
JAX package's em.tasks_from_cigars, which builds the same tasks record by
record: get_sub_sequence, then alignment_to_anchor_pairs on forward
coordinates, then filter_anchors_to_matches, then the large-gap split.
Every Task must be equal field by field and anchor row by row, with the
host library's one call and without the library (CPECAN_TPU_NATIVE=0,
where the port goes record by record). Also: the table reverse
complement against utils/symbols.reverse_complement, chunk_tasks'
no-split path against the JAX package's split and its ``unsplit_jobs``
counter, and an EM iteration's model file."""

import dataclasses
import importlib.util
import io
import itertools
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from cpecan_tpu import config as jax_config
from cpecan_tpu.align import split as jax_split
from cpecan_tpu.cli import realign as jax_realign
from cpecan_tpu.em import em as jax_em
from cpecan_tpu.io import cigar as jax_cigar
from cpecan_tpu_torch.align import batch, native
from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.em import em
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils import symbols

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CELL_AREA = 3000 * 3000  # em-reads' splitMatrixBiggerThanThis


# ------------------------------------------------------------ the reference

def _jax_params(p):
    return jax_config.PairwiseAlignmentParameters(**dataclasses.asdict(p))


def reference_tasks(cigars, sequences, p):
    """jax_em.tasks_from_cigars as port Tasks: each task's job and (x1, y1)
    read off the chunks it iterates, one _iterate_chunks call a record."""
    where, jobs = [], itertools.count()
    inner = jax_em._iterate_chunks

    def iterate(*args):
        job = next(jobs)
        for chunk in inner(*args):
            x1, y1, x2, y2 = chunk[0]
            if x2 - x1 or y2 - y1:
                where.append((job, x1, y1))
            yield chunk

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_em, "_iterate_chunks", iterate)
        tasks = jax_em.tasks_from_cigars(cigars, sequences, _jax_params(p))
    assert len(where) == len(tasks)
    return [batch.Task(job, x1, y1, t.sub_x, t.sub_y,
                       np.asarray(t.anchors, np.int64), t.ragged_left,
                       t.ragged_right)
            for (job, x1, y1), t in zip(where, tasks)]


def reference_split(jobs, p):
    """The JAX package's split of whole jobs into Tasks."""
    tasks = []
    for ji, (sx, sy, anchors, rl0, rr0) in enumerate(jobs):
        for (x1, y1, x2, y2), local, rl, rr in jax_em._iterate_chunks(
                sx, sy, anchors, _jax_params(p), rl0, rr0):
            if x2 - x1 or y2 - y1:
                tasks.append(batch.Task(ji, x1, y1, sx[x1:x2], sy[y1:y2],
                                        local, rl, rr))
    return tasks


def record_jobs(cigars, sequences, p):
    """Whole jobs (sub_x, sub_y, matched anchors, True, True) from the JAX
    package's functions, before any split."""
    jobs = []
    for pa in cigars:
        sx = jax_realign.get_sub_sequence(sequences[pa.contig1], pa.start1,
                                          pa.end1, pa.strand1)
        sy = jax_realign.get_sub_sequence(sequences[pa.contig2], pa.start2,
                                          pa.end2, pa.strand2)
        fwd = jax_cigar.PairwiseAlignment(
            pa.contig1, 0, len(sx), True, pa.contig2, 0, len(sy), True,
            pa.score, pa.operations)
        anchors = jax_cigar.alignment_to_anchor_pairs(
            fwd, p.constraintDiagonalTrim, p.diagonalExpansion)
        jobs.append((sx, sy,
                     jax_realign.filter_anchors_to_matches(anchors, sx, sy),
                     True, True))
    return jobs


def whole_jobs(jobs, p):
    """How many anchored jobs the split leaves whole: the jobs that
    ``unsplit_jobs`` should count."""
    return sum(jax_split.get_split_points(a, len(sx), len(sy),
                                          p.splitMatrixBiggerThanThis, rl, rr)
               == [(0, 0, len(sx), len(sy))]
               for sx, sy, a, rl, rr in jobs if a is not None)


def unsplit_count():
    return metrics.snapshot()["counters"].get("unsplit_jobs", 0)


def assert_tasks_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.job, g.x1, g.y1, g.ragged_left, g.ragged_right) == (
            w.job, w.x1, w.y1, w.ragged_left, w.ragged_right), i
        assert g.sub_x == w.sub_x and g.sub_y == w.sub_y, i
        assert g.anchors.dtype == w.anchors.dtype == np.int64, i
        assert g.anchors.shape == w.anchors.shape, i
        np.testing.assert_array_equal(g.anchors, w.anchors, err_msg=str(i))


# --------------------------------------------------------------- corpora

def _planted():
    spec = importlib.util.spec_from_file_location(
        "planted", REPO / "benchmark" / "traffic" / "planted.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reads_slice(seed=3000000037):
    """The reads-4mb mix cut to 40 reads (about 96 kb) of a 400 kb
    reference: the em-reads cell's rates, lengths and strands."""
    planted = _planted()
    traffic = json.loads(
        (REPO / "benchmark" / "traffic" / "reads-4mb.json").read_text())
    traffic.update(reference_bases=400_000, corpus_bases=96_000)
    seqs, records = planted.generate(traffic, seed)
    text = "".join(planted.cigar_line(r) + "\n" for r in records)
    cigars = list(cigar_io.cigar_read(io.StringIO(text)))
    assert len(cigars) == 40 and any(not pa.strand2 for pa in cigars)
    return seqs, cigars


def _random_ops(rng, lx, ly, short_runs):
    """Ops consuming exactly lx and ly: match runs of 1-12 bases (or up
    to 40) between one- to three-base indels."""
    ops, x, y = [], 0, 0
    while x < lx or y < ly:
        if x < lx and y < ly:
            n = min(rng.randint(1, 12 if short_runs else 40), lx - x, ly - y)
            ops.append((cigar_io.MATCH, n))
            x, y = x + n, y + n
        if x < lx and rng.random() < 0.5:
            n = min(rng.randint(1, 3), lx - x)
            ops.append((cigar_io.INDEL_X, n))
            x += n
        if y < ly and rng.random() < 0.5:
            n = min(rng.randint(1, 3), ly - y)
            ops.append((cigar_io.INDEL_Y, n))
            y += n
    return ops


def mixed_corpus(seed=11, short_runs=False):
    """Both strands on both sides, over a reference of mixed case, N, n
    and IUPAC letters; plus records with no ops (a zero-length job),
    with only D or only I ops, and of one base."""
    rng = random.Random(seed)
    letters = "ACGTacgt" * 6 + "NnRYKMSWBDHVrykmswbdhv-."
    ref = "".join(rng.choice(letters) for _ in range(4000))
    seqs = {"ref": ref}
    cigars = []
    for i in range(24):
        n = rng.randint(30, 300)
        s = rng.randint(0, len(ref) - n)
        read = "".join(rng.choice(letters) if rng.random() < 0.1 else c
                       for c in ref[s:s + n])[: rng.randint(n - 20, n)]
        seqs[f"r{i}"] = read
        ops = _random_ops(rng, n, len(read), short_runs)
        s1, e1 = (s, s + n) if i % 2 else (s + n, s)
        s2, e2 = (0, len(read)) if i % 3 else (len(read), 0)
        cigars.append(cigar_io.PairwiseAlignment(
            "ref", s1, e1, bool(i % 2), f"r{i}", s2, e2, bool(i % 3), 1.0,
            ops))
    cigars += [
        cigar_io.PairwiseAlignment("ref", 7, 7, True, "r0", 3, 3, False,
                                   0.0, []),
        cigar_io.PairwiseAlignment("ref", 10, 22, True, "r1", 5, 5, True,
                                   0.0, [(cigar_io.INDEL_X, 12)]),
        cigar_io.PairwiseAlignment("ref", 40, 40, True, "r2", 9, 2, False,
                                   0.0, [(cigar_io.INDEL_Y, 7)]),
        cigar_io.PairwiseAlignment("ref", 100, 101, True, "r3", 0, 1, True,
                                   0.0, [(cigar_io.MATCH, 1)]),
    ]
    return seqs, cigars


def _params(trim=0, area=CELL_AREA, expansion=10):
    return PairwiseAlignmentParameters(
        constraintDiagonalTrim=trim, diagonalExpansion=expansion,
        splitMatrixBiggerThanThis=area)


@pytest.fixture(params=["native", "record"])
def builder(request, monkeypatch):
    """Whether the host library builds the anchors in one call or, under
    CPECAN_TPU_NATIVE=0, the port goes record by record; yields the calls
    of each."""
    calls = {"native": 0, "record": 0}
    native_fn, record_fn = native.alignment_anchors, batch._record_anchors

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(native, "alignment_anchors",
                        count("native", native_fn))
    monkeypatch.setattr(batch, "_record_anchors", count("record", record_fn))
    if request.param == "record":
        monkeypatch.setenv("CPECAN_TPU_NATIVE", "0")
    else:
        assert native.available()
    yield request.param, calls


CASES = {
    "reads_slice": (reads_slice, _params()),
    "mixed_trim0": (mixed_corpus, _params(trim=0, expansion=4)),
    "mixed_trim3_short_runs": (lambda: mixed_corpus(12, short_runs=True),
                               _params(trim=3, expansion=6)),
    "mixed_split": (mixed_corpus, _params(area=6 * 6)),
    "reads_trim3": (reads_slice, _params(trim=3)),
    "reads_split": (reads_slice, _params(area=3 * 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_alignment_tasks_equal_the_record_path(case, builder):
    make, p = CASES[case]
    seqs, cigars = make()
    metrics.reset()
    got = em.tasks_from_cigars(cigars, seqs, p)
    assert_tasks_equal(got, reference_tasks(cigars, seqs, p))
    assert unsplit_count() == whole_jobs(record_jobs(cigars, seqs, p), p)
    name, calls = builder
    assert calls == ({"native": 1, "record": 0} if name == "native" else
                     {"native": 0, "record": len(cigars)})
    if case.endswith("split"):
        assert any(t.x1 or t.y1 for t in got)


def test_non_ascii_sequences_go_record_by_record(builder):
    seqs, cigars = mixed_corpus()
    seqs["ref"] = "é" + seqs["ref"][1:]
    cigars.append(cigar_io.PairwiseAlignment(
        "ref", 0, 3, True, "r0", 0, 3, True, 0.0, [(cigar_io.MATCH, 3)]))
    p = _params()
    assert_tasks_equal(em.tasks_from_cigars(cigars, seqs, p),
                       reference_tasks(cigars, seqs, p))
    assert builder[1] == {"native": 0, "record": len(cigars)}


@pytest.mark.parametrize("ops", [
    [(cigar_io.MATCH, 5)],  # short of the end
    [(cigar_io.MATCH, 12), (cigar_io.INDEL_Y, 1)],  # past y's end
    [(cigar_io.MATCH, 12), (cigar_io.INDEL_X, 3)],  # past x's end
], ids=["short", "past_y", "past_x"])
def test_ops_that_miss_the_end_raise(ops, builder):
    seqs, cigars = mixed_corpus()
    seqs["q"] = "ACGTACGTACGT"
    cigars.insert(5, cigar_io.PairwiseAlignment(
        "ref", 0, 12, True, "q", 0, 12, True, 0.0, ops))
    p = _params()
    with pytest.raises(AssertionError):
        reference_tasks(cigars, seqs, p)
    with pytest.raises(AssertionError):
        em.tasks_from_cigars(cigars, seqs, p)
    assert builder[1]["native"] == (builder[0] == "native")


# ------------------------------------------------------- reverse complement

def test_reverse_complement_table_equals_the_copy(monkeypatch):
    every = "".join(map(chr, range(256)))
    assert batch.fast_reverse_complement(every) == \
        symbols.reverse_complement(every)
    rng = random.Random(5)
    for n in (0, 1, 2, 17, 1000):
        s = "".join(rng.choice("ACGTacgtNnRYrxX-") for _ in range(n))
        assert batch.fast_reverse_complement(s) == \
            symbols.reverse_complement(s)
    called = []
    monkeypatch.setattr(batch, "reverse_complement",
                        lambda s: called.append(s) or "copy")
    assert batch.fast_reverse_complement("ACGTĀ") == "copy"
    assert called == ["ACGTĀ"]
    assert batch.fast_reverse_complement("ACGTÿ") != "copy"


# ------------------------------------------------------ no-split and counter

@pytest.mark.parametrize("area", [0, 3 * 3, 40 * 40, CELL_AREA])
def test_chunk_tasks_equal_the_split_with_ragged_ends(area):
    """chunk_tasks' no-split path against the JAX package's split, under
    every pair of ragged flags; anchors out of order or outside the
    matrix raise, as the split does."""
    seqs, cigars = mixed_corpus()
    p = _params(area=area)
    jobs = [(sx, sy, a, i % 2 == 0, i % 4 < 2)
            for i, (sx, sy, a, _, _) in enumerate(
                record_jobs(cigars, seqs, p))]
    jobs.append(("ACGT", "AC", [(0, 0, 4), (1, 1, 4)], False, True))
    jobs.append(("ACGT", "AC", np.zeros((0, 3), np.int64), True, False))
    metrics.reset()
    assert_tasks_equal(batch.chunk_tasks(jobs, p), reference_split(jobs, p))
    assert unsplit_count() == whole_jobs(jobs, p)
    for bad in ([(2, 0, 4), (1, 1, 4)], [(0, 0, 4), (4, 1, 4)]):
        with pytest.raises(AssertionError):
            batch.chunk_tasks([("ACGT", "AC", bad, True, True)], p)


def test_unsplit_jobs_counts_the_jobs_that_skip_the_split(builder):
    """The native call's gap areas, or get_split_points without the
    library, decide the same jobs."""
    seqs, cigars = reads_slice()
    metrics.reset()
    em.tasks_from_cigars(cigars, seqs, _params())
    assert unsplit_count() == len(cigars)
    metrics.reset()
    tasks = em.tasks_from_cigars(cigars, seqs, _params(area=0))
    assert unsplit_count() == 0
    assert len(tasks) > len(cigars)
    metrics.reset()


def test_em_iteration_model_file_unchanged(tmp_path, monkeypatch):
    """One EM iteration on the CPU writes the same model file, byte for
    byte, from the job-wide tasks as from the JAX package's."""
    seqs, cigars = mixed_corpus(13)
    options = em.EmOptions(iterations=1, trials=1, diagonalExpansion=4,
                           splitMatrixBiggerThanThis=20 * 20)
    em.expectation_maximisation(seqs, cigars, str(tmp_path / "new.hmm"),
                                options, device="cpu")
    monkeypatch.setattr(em, "tasks_from_cigars", reference_tasks)
    em.expectation_maximisation(seqs, cigars, str(tmp_path / "old.hmm"),
                                options, device="cpu")
    assert (tmp_path / "new.hmm").read_bytes() == \
        (tmp_path / "old.hmm").read_bytes()
