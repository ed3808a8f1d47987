"""The port's batched posterior path and realign CLI against the JAX
package (both on the CPU), on the tests/test_cli.py fixture pattern.

Pair sets must agree except for entries within 1e-5 of the threshold
(fp32 noise can flip those), and fixed-point probabilities within 100 of
1e7; realigned cigars must have identical operations and coordinates and
posterior-based scores within 1e-5 relative."""

import io
import random

import numpy as np
import pytest
import torch

from cpecan_tpu.align import batch as jax_batch
from cpecan_tpu.cli import realign as jax_realign
from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.io import cigar as cigar_io
from cpecan_tpu.models.hmm import Hmm, StateMachineType
from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.utils.logmath import PAIR_ALIGNMENT_PROB_1
from cpecan_tpu.utils.symbols import (
    evolve_sequence, get_random_sequence, reverse_complement)
from cpecan_tpu_torch.align import batch as port_batch
from cpecan_tpu_torch.align import pairwise as port_pairwise
from cpecan_tpu_torch.cli import realign as port_realign
from cpecan_tpu_torch.ops import fb_batch
from test_cli import identity_cigar, write_fasta

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _jobs(n_pairs=3, length=90, seed=11):
    """Evolved pairs anchored by their identity cigar's matching bases
    (the realign job shape), plus one full-band job."""
    rng = random.Random(seed)
    jobs = []
    for i in range(n_pairs):
        x = get_random_sequence(length + 7 * i, rng).upper()
        y = evolve_sequence(x, rng).upper()
        pa = identity_cigar("x", "y", len(x), len(y))
        anchors = port_realign.filter_anchors_to_matches(
            cigar_io.alignment_to_anchor_pairs(pa, 0, 4), x, y)
        jobs.append((x, y, anchors, i % 2 == 0, i % 2 == 1))
    x = get_random_sequence(30, rng).upper()
    jobs.append((x, evolve_sequence(x, rng).upper(), None, False, False))
    return jobs


def _params(split=100 ** 2):
    """Realign's expansion; large-gap splitting only past 100 x 100 (few
    chunk shapes, so few JAX compiles; the CLI tests run realign's own
    10 x 10 default)."""
    return PairwiseAlignmentParameters(diagonalExpansion=4,
                                       splitMatrixBiggerThanThis=split)


def _assert_pairs_agree(a, b, thr):
    pa = {(int(x), int(y)): int(p) for p, x, y in zip(a["prob"], a["x"], a["y"])}
    pb = {(int(x), int(y)): int(p) for p, x, y in zip(b["prob"], b["x"], b["y"])}
    assert len(pa) == len(a) and len(pb) == len(b)
    near = lambda p: abs(p / PAIR_ALIGNMENT_PROB_1 - thr) < 1e-5
    for key in pa.keys() ^ pb.keys():
        assert near(pa.get(key, pb.get(key))), key
    for key in pa.keys() & pb.keys():
        assert abs(pa[key] - pb[key]) <= 100, (key, pa[key], pb[key])
    assert pa or not pb


@pytest.mark.parametrize("sm_factory,mode", [
    (state_machine5, "posterior_match"), (state_machine3, "posterior_all")])
def test_batch_posteriors_match_jax(sm_factory, mode):
    jobs, p, sm = _jobs(), _params(), sm_factory()
    ref = jax_batch.batch_posteriors(sm, jobs, p, mode=mode)
    new = port_batch.batch_posteriors(sm, jobs, p, mode=mode, device="cpu")
    assert fb_batch.LAST_ENGINE == "torch"
    assert len(new) == len(ref) == len(jobs)
    for r, n in zip(ref, new):
        for ra, na in (zip(r, n) if mode == "posterior_all" else [(r, n)]):
            _assert_pairs_agree(na, ra, p.threshold)


def test_pairwise_apis_match_jax():
    from cpecan_tpu.align import pairwise as jax_pairwise
    from cpecan_tpu.align.anchors import get_anchors

    rng = random.Random(31)
    x = get_random_sequence(70, rng).upper()
    y = evolve_sequence(x, rng).upper()
    p, sm = PairwiseAlignmentParameters(), state_machine5()
    _assert_pairs_agree(
        port_pairwise.get_aligned_pairs(sm, x, y, p, device="cpu"),
        jax_pairwise.get_aligned_pairs(sm, x, y, p), p.threshold)
    anchors = get_anchors(x, y, p)
    ref, ref_score = jax_pairwise.get_shifted_mea_alignment(
        sm, x, y, anchors, p)
    new, new_score = port_pairwise.get_shifted_mea_alignment(
        sm, x, y, anchors, p, device="cpu")
    np.testing.assert_array_equal(new["x"], ref["x"])
    np.testing.assert_array_equal(new["y"], ref["y"])
    assert np.abs(new["prob"] - ref["prob"]).max() <= 100
    assert new_score == pytest.approx(ref_score, rel=1e-5)


@pytest.mark.parametrize("cap", [64, 8])
def test_compaction_matches_jax(cap):
    from cpecan_tpu.ops import compact as jax_compact
    from cpecan_tpu_torch.ops import compact as port_compact

    win = np.random.default_rng(4).random((40, 32)).astype(np.float32)
    win[win < 0.97] = 0.0
    ref = jax_compact.compact_rows_exact(win, 0.5, cap)
    ref_rows = jax_compact.compact_rows(win, 0.5, cap)
    new = port_compact.compact_rows(torch.from_numpy(win), 0.5, cap)
    np.testing.assert_array_equal(new[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(new[1].numpy(), np.asarray(ref[1]))
    assert int(new[2]) == int(ref[2]) == int(ref_rows[2])
    assert int(new[3]) == int(ref_rows[3])


def test_width_buckets_do_not_change_pairs(monkeypatch):
    jobs, p, sm = _jobs(), _params(), state_machine5()
    a = port_batch.batch_posteriors(sm, jobs, p, device="cpu")
    monkeypatch.setattr(port_pairwise, "WIDTH_LADDER", (48, 96, 256))
    assert port_pairwise._width_bucket(20) == 48
    b = port_batch.batch_posteriors(sm, jobs, p, device="cpu")
    for x, y in zip(a, b):
        _assert_pairs_agree(x, y, p.threshold)


def test_streaming_chunks_are_not_ported_yet(monkeypatch):
    monkeypatch.setattr(port_batch, "_STREAM_BUDGET", 1)
    with pytest.raises(NotImplementedError, match="streaming"):
        port_batch.batch_posteriors(state_machine5(), _jobs(1), _params(),
                                    device="cpu")


@pytest.fixture
def seq_pair(tmp_path):
    rng = random.Random(17)
    x = get_random_sequence(80, rng).upper()
    y = evolve_sequence(x, rng).upper()
    fasta = tmp_path / "seqs.fa"
    write_fasta(fasta, {"seqX": x, "seqY": y})
    return str(fasta), [identity_cigar("seqX", "seqY", len(x), len(y))]


@pytest.fixture
def minus_strand(tmp_path):
    rng = random.Random(23)
    x = get_random_sequence(60, rng).upper()
    y_f = evolve_sequence(x, rng).upper() or "ACGT"
    y = reverse_complement(y_f)
    fasta = tmp_path / "minus.fa"
    write_fasta(fasta, {"seqX": x, "seqY": y})
    m = min(len(x), len(y_f))
    ops = [(cigar_io.MATCH, m)]
    if len(x) > m:
        ops.append((cigar_io.INDEL_X, len(x) - m))
    elif len(y_f) > m:
        ops.append((cigar_io.INDEL_Y, len(y_f) - m))
    pa = cigar_io.PairwiseAlignment(
        "seqX", 0, len(x), True, "seqY", len(y), 0, False, 0.0, ops)
    return str(fasta), [pa]


def _hmm_file(tmp_path, hmm_type):
    hmm = Hmm(hmm_type)
    hmm.randomise(np.random.default_rng(9))
    path = tmp_path / f"{hmm_type.name}.hmm"
    hmm.save(str(path))
    return str(path)


def _realign(cli, fasta, cigars, *args):
    stdin = io.StringIO("".join(cigar_io.cigar_format(c) + "\n"
                                for c in cigars))
    stdout = io.StringIO()
    assert cli.main([fasta, *args], stdin=stdin, stdout=stdout) == 0
    stdout.seek(0)
    return list(cigar_io.cigar_read(stdout))


_CLI_CASES = {
    "default": ("seq_pair", ()),
    "mea": ("seq_pair", ("--mea",)),
    "minus_strand": ("minus_strand", ()),
    "rescore_posterior": ("seq_pair", ("--rescoreByPosteriorProb",)),
    "rescore_identity": ("seq_pair", ("--rescoreByIdentity",)),
    "hmm_five_state": ("seq_pair", ("--loadHmm", StateMachineType.fiveState)),
    "hmm_three_state": ("seq_pair", ("--loadHmm", StateMachineType.threeState)),
}


@pytest.mark.parametrize("case", sorted(_CLI_CASES))
def test_realign_cli_matches_jax(case, request, tmp_path):
    fixture, args = _CLI_CASES[case]
    fasta, cigars = request.getfixturevalue(fixture)
    if args and args[0] == "--loadHmm":
        args = ("--loadHmm", _hmm_file(tmp_path, args[1]))
    ref = _realign(jax_realign, fasta, cigars, *args)
    new = _realign(port_realign, fasta, cigars, *args, "--device", "cpu")
    assert len(new) == len(ref) == len(cigars)
    for r, n in zip(ref, new):
        n.check()
        assert (n.contig1, n.start1, n.end1, n.strand1) == \
            (r.contig1, r.start1, r.end1, r.strand1)
        assert (n.contig2, n.start2, n.end2, n.strand2) == \
            (r.contig2, r.start2, r.end2, r.strand2)
        assert n.operations == r.operations
        assert n.score == pytest.approx(r.score, rel=1e-5, abs=1e-9)


def test_device_cuda_without_a_gpu_raises(seq_pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fasta, cigars = seq_pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _realign(port_realign, fasta, cigars, "--device", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_batch.batch_posteriors(state_machine5(), _jobs(1), _params(),
                                    device="cuda")
