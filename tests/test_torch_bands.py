"""The port's batched band builder (ops.band.construct_bands, one native
call over many pairs, csrc/host/band.cpp) against construct_band and
BandTensors.frame_width, bit for bit; and EM's bucketing and realign's
batch_posteriors on the CPU, equal with the native builder and with the
numpy fallback (CPECAN_TPU_NATIVE=0), with the ``native_bands`` counter
saying which one ran; and the batch layer's launch packer
(batch.launch_arrays) against a loop of pad_band calls, on EM's and
realign's tasks."""

import random

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.align import batch as batch_mod
from cpecan_tpu_torch.align import native
from cpecan_tpu_torch.align import pairwise
from cpecan_tpu_torch.align.batch import (
    filter_anchors_to_matches, get_sub_sequence)
from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.em import em as em_mod
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.models.hmm import Hmm, StateMachineType
from cpecan_tpu_torch.models.state_machine import state_machine5
from cpecan_tpu_torch.ops import band as band_mod
from cpecan_tpu_torch.parallel.mesh import pad_to_multiple
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils.symbols import encode, reverse_complement

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library unavailable")


def _monotone(rng, lx, ly, n, first_last=False):
    """n strictly monotone anchors (x, y, expansion) in an lx x ly matrix;
    with first_last, on its first and last rows and columns."""
    n = min(n, lx, ly)
    if n == 0:
        return np.zeros((0, 3), np.int64)
    xs = np.sort(rng.choice(lx, n, replace=False))
    ys = np.sort(rng.choice(ly, n, replace=False))
    if first_last:
        xs[0], ys[0], xs[-1], ys[-1] = 0, 0, lx - 1, ly - 1
        if n == 1:
            xs[0], ys[0] = (0, 0) if rng.random() < 0.5 else (lx - 1, ly - 1)
    exps = 2 * rng.integers(0, 7, n)
    return np.stack([xs, ys, exps], 1).astype(np.int64)


def _random_set(rng):
    lx, ly = (int(v) for v in rng.integers(1, 90, 2))
    return _monotone(rng, lx, ly, int(rng.integers(1, 40))), lx, ly


def _no_anchors(rng):
    lx, ly = (int(v) for v in rng.integers(0, 60, 2))
    return np.zeros((0, 3), np.int64), lx, ly


def _edges(rng):
    lx, ly = (int(v) for v in rng.integers(1, 50, 2))
    return _monotone(rng, lx, ly, int(rng.integers(1, 12)), True), lx, ly


def _one_side_empty(rng):
    n = int(rng.integers(0, 40))
    return (np.zeros((0, 3), np.int64), *((0, n) if rng.random() < 0.5
                                         else (n, 0)))


KINDS = {"random": _random_set, "no_anchors": _no_anchors,
         "first_and_last_rows_and_columns": _edges,
         "lx_or_ly_zero": _one_side_empty}


def _sets(kind, seed, n=40):
    rng = np.random.default_rng(seed)
    if kind == "mixed_batch":
        makers = list(KINDS.values())
        return [makers[i % len(makers)](rng) for i in range(n)]
    return [KINDS[kind](rng) for _ in range(n)]


def _oracle(sets, expansion):
    bands = [band_mod.construct_band(a if expansion is None else a[:, :2],
                                     lx, ly, expansion) for a, lx, ly in sets]
    return bands, [b.frame_width() for b in bands]


@needs_native
@pytest.mark.parametrize("expansion", [None, 0, 6], ids=["per_anchor",
                                                         "static_0",
                                                         "static_6"])
@pytest.mark.parametrize("kind", [*KINDS, "mixed_batch"])
def test_native_bands_equal_construct_band(kind, expansion):
    sets = _sets(kind, seed=len(kind) * 7 + (expansion or 1))
    metrics.reset()
    bands, frames = band_mod.construct_bands(
        [a for a, _, _ in sets], [lx for _, lx, _ in sets],
        [ly for _, _, ly in sets], expansion)
    assert metrics.snapshot()["counters"]["native_bands"] == len(sets)
    want, want_frames = _oracle(sets, expansion)
    assert frames.dtype == np.int64 and frames.tolist() == want_frames
    for got, ref in zip(bands, want):
        assert (got.lx, got.ly) == (ref.lx, ref.ly)
        assert got.offsets.dtype == got.widths.dtype == np.int32
        np.testing.assert_array_equal(got.offsets, ref.offsets)
        np.testing.assert_array_equal(got.widths, ref.widths)


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
def test_rejected_anchors_raise_as_construct_band(native_on, monkeypatch):
    """Anchors construct_band rejects (an odd expansion, an anchor outside
    the matrix) raise its error from either path."""
    if not native_on:
        monkeypatch.setenv("CPECAN_TPU_NATIVE", "0")
    good = np.array([[1, 1, 2], [4, 5, 2]], np.int64)
    for anchors, expansion in ((good, 3),
                               (np.array([[1, 1, 3]], np.int64), None),
                               (np.array([[9, 1, 2]], np.int64), 4)):
        with pytest.raises(AssertionError):
            band_mod.construct_band(
                anchors if expansion is None else anchors[:, :2], 8, 8,
                expansion)
        with pytest.raises(AssertionError):
            band_mod.construct_bands([good, anchors], [8, 8], [8, 8],
                                     expansion)


# ------------------------------------------------- the callers, both ways

def _walk(rng, x):
    """An evolved copy y of x and the cigar ops aligning them: 1-base
    indels and substitutions at read rates, and one two-sided unanchored
    gap in the middle (a large-gap split)."""
    ops, y, i = [], [], 0
    gap_at = len(x) // 2

    def op(kind, n):
        if ops and ops[-1][0] == kind:
            ops[-1] = (kind, ops[-1][1] + n)
        else:
            ops.append((kind, n))

    while i < len(x):
        if i == gap_at:
            y.extend(rng.choice("ACGT") for _ in range(25))
            op(cigar_io.INDEL_X, 30)
            op(cigar_io.INDEL_Y, 25)
            i += 30
            continue
        r = rng.random()
        if r < 0.05:
            op(cigar_io.INDEL_X, 1)
            i += 1
        elif r < 0.10:
            y.append(rng.choice("ACGT"))
            op(cigar_io.INDEL_Y, 1)
        else:
            y.append(x[i] if rng.random() > 0.07 else rng.choice("ACGT"))
            op(cigar_io.MATCH, 1)
            i += 1
    return "".join(y), ops


def _corpus(n=6, seed=11):
    """n reads against one reference, every other one on the minus strand."""
    rng = random.Random(seed)
    ref = "".join(rng.choice("ACGT") for _ in range(2000))
    sequences, cigars = {"ref": ref}, []
    for i in range(n):
        s = rng.randrange(0, 1500)
        e = s + rng.randrange(150, 450)
        y, ops = _walk(rng, ref[s:e])
        name = f"read{i}"
        if i % 2:
            sequences[name] = reverse_complement(y)
            cigars.append(cigar_io.PairwiseAlignment(
                "ref", s, e, True, name, len(y), 0, False, 0.0, ops))
        else:
            sequences[name] = y
            cigars.append(cigar_io.PairwiseAlignment(
                "ref", s, e, True, name, 0, len(y), True, 0.0, ops))
    return sequences, cigars


_P = PairwiseAlignmentParameters(constraintDiagonalTrim=0, diagonalExpansion=4,
                                 splitMatrixBiggerThanThis=20 * 20)


def _both_ways(monkeypatch, run):
    """run() with the native builder and with the numpy fallback: both
    results and both native_bands counts."""
    out = []
    for flag in ("1", "0"):
        monkeypatch.setenv("CPECAN_TPU_NATIVE", flag)
        metrics.reset()
        got = run()
        out.append((got, metrics.snapshot()["counters"].get("native_bands", 0)))
    return out


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for u, v in zip(a, b):
            _assert_equal(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (band_mod.BandTensors, batch_mod.Task)):
        _assert_equal(vars(a), vars(b))
    else:
        assert a == b


def _bucket_arrays_by_pad_band(items, P, n_dev):
    """launch_arrays as a loop of pad_band and encode calls, item by
    item (realign's packing before the batch layer had one packer): the
    oracle of its direct row copies."""
    B = pad_to_multiple(1 << max(len(items) - 1, 0).bit_length(), n_dev)
    sx, sy = np.zeros((B, P), np.int32), np.zeros((B, P), np.int32)
    offsets = np.zeros((B, P + 1), np.int32)
    offsets[:, 1::2] = 1
    widths = np.ones((B, P + 1), np.int32)
    lx, ly = np.zeros(B, np.int32), np.zeros(B, np.int32)
    rl, rr = np.zeros(B, bool), np.zeros(B, bool)
    for i, (t, band) in enumerate(items):
        offsets[i], widths[i], _ = band_mod.pad_band(band, P)
        sx[i, : len(t.sub_x)] = encode(t.sub_x)
        sy[i, : len(t.sub_y)] = encode(t.sub_y)
        lx[i], ly[i] = len(t.sub_x), len(t.sub_y)
        rl[i], rr[i] = t.ragged_left, t.ragged_right
    return sx, sy, offsets, widths, lx, ly, rl, rr


def _realign_job(sequences, pa, anchors=True):
    """The batch job realign builds from a cigar record: its
    subsequences (reverse-complemented on the minus strand), anchors from
    its match runs filtered to exact base matches, ragged ends; without
    anchors, a full-band job."""
    sx = get_sub_sequence(sequences[pa.contig1], pa.start1, pa.end1,
                          pa.strand1)
    sy = get_sub_sequence(sequences[pa.contig2], pa.start2, pa.end2,
                          pa.strand2)
    if not anchors:
        return sx, sy, None, True, True
    fwd = cigar_io.PairwiseAlignment(
        pa.contig1, 0, len(sx), True, pa.contig2, 0, len(sy), True,
        pa.score, pa.operations)
    return (sx, sy, filter_anchors_to_matches(
        cigar_io.alignment_to_anchor_pairs(fwd, 0, 4), sx, sy), True, True)


def _packer_buckets(tasks):
    """EM's tasks, or realign-style jobs chunked as realign chunks them,
    grouped by launch shape."""
    sequences, cigars = _corpus()
    if tasks == "em":
        return batch_mod.plan(
            em_mod.tasks_from_cigars(cigars, sequences, _P), _P)[0]
    p = _P if tasks == "split" else _P.replace(
        splitMatrixBiggerThanThis=10 ** 8)
    pa = {"minus_strand": cigars[1], "split": cigars[0],
          "full_band": cigars[2]}[tasks]
    assert pa.strand2 == (tasks != "minus_strand")
    jobs = [_realign_job(sequences, pa, anchors=tasks != "full_band")]
    chunks = batch_mod.chunk_tasks(jobs, p)
    assert (len(chunks) > 1) == (tasks == "split")
    return batch_mod.plan(chunks, p)[0]


@pytest.mark.parametrize("n_dev,tasks", [
    pytest.param(1, "em", id="1"), pytest.param(3, "em", id="3"),
    pytest.param(1, "minus_strand", id="minus_strand"),
    pytest.param(3, "split", id="split"),
    pytest.param(1, "full_band", id="full_band")])
def test_bucket_arrays_equal_pad_band(n_dev, tasks):
    buckets = _packer_buckets(tasks)
    assert len(buckets) > 1 or tasks != "em"
    for (P, _W), items in buckets.items():
        _assert_equal(batch_mod.launch_arrays(items, P, n_dev),
                      _bucket_arrays_by_pad_band(items, P, n_dev))


@needs_native
def test_em_buckets_and_counts_equal_native_and_numpy(monkeypatch):
    sequences, cigars = _corpus()
    tasks = em_mod.tasks_from_cigars(cigars, sequences, _P)
    assert len(tasks) > len(cigars)  # the gaps split every read

    def run():
        buckets, streamed = batch_mod.plan(tasks, _P)
        arrays = {k: batch_mod.launch_arrays(items, k[0])
                  for k, items in buckets.items()}
        hmm = Hmm(StateMachineType.fiveState)
        em_mod.expectation_step(state_machine5(), tasks, _P, hmm,
                                device="cpu")
        return (sorted(buckets), buckets, streamed, arrays, hmm.transitions,
                hmm.emissions, hmm.likelihood)

    (got, n_native), (want, n_numpy) = _both_ways(monkeypatch, run)
    _assert_equal(got, want)
    # plan twice: once above, once in expectation_step
    assert (n_native, n_numpy) == (2 * len(tasks), 0)


@needs_native
@pytest.mark.parametrize("dynamic", [False, True],
                         ids=["static", "per_anchor"])
def test_batch_posteriors_equal_native_and_numpy(dynamic, monkeypatch):
    p = PairwiseAlignmentParameters(
        diagonalExpansion=4, splitMatrixBiggerThanThis=20 * 20,
        dynamicAnchorExpansion=dynamic)
    sequences, cigars = _corpus(n=4, seed=13)
    jobs = []
    for pa in cigars:
        sx = get_sub_sequence(sequences[pa.contig1], pa.start1, pa.end1,
                              pa.strand1)
        sy = get_sub_sequence(sequences[pa.contig2], pa.start2, pa.end2,
                              pa.strand2)
        fwd = cigar_io.PairwiseAlignment(
            pa.contig1, 0, len(sx), True, pa.contig2, 0, len(sy), True,
            pa.score, pa.operations)
        anchors = cigar_io.alignment_to_anchor_pairs(fwd, 0, 4)
        anchors[:, 2] = 2 * (np.arange(len(anchors)) % 5)
        jobs.append((sx, sy, filter_anchors_to_matches(anchors, sx, sy),
                     False, False))
    jobs.append((jobs[0][0][:40], jobs[0][1][:37], None, False, False))
    tasks = batch_mod.chunk_tasks(jobs, p)
    n_anchored = sum(t.anchors is not None for t in tasks)
    assert n_anchored > len(jobs)  # the gaps split every anchored job

    def run():
        return (batch_mod.build_bands(tasks, p),
                batch_mod.batch_posteriors(state_machine5(), jobs, p,
                                           mode="posterior_all", device="cpu"))

    (got, n_native), (want, n_numpy) = _both_ways(monkeypatch, run)
    _assert_equal(got, want)
    assert (n_native, n_numpy) == (2 * n_anchored, 0)


@needs_native
def test_run_chunk_equal_native_and_numpy(monkeypatch):
    """The pairwise expectation and forward-probability APIs build their
    bands through the same builder."""
    sequences, cigars = _corpus(n=1, seed=17)
    tasks = em_mod.tasks_from_cigars(cigars, sequences, _P)
    t = max(tasks, key=lambda t: len(t.sub_x))

    def run():
        hmm = Hmm(StateMachineType.fiveState)
        pairwise.get_expectations_using_anchors(
            state_machine5(), hmm, t.sub_x, t.sub_y, t.anchors, _P,
            device="cpu")
        fwd = pairwise.compute_forward_probability(
            t.sub_x, t.sub_y, t.anchors, _P, state_machine5(), device="cpu")
        return hmm.transitions, hmm.emissions, hmm.likelihood, fwd

    (got, n_native), (want, n_numpy) = _both_ways(monkeypatch, run)
    _assert_equal(got, want)
    assert n_native >= 2 and n_numpy == 0
