"""The port's EM path against the JAX package, both on the CPU: the
expectation step, a 2-iteration EM run, the pairwise expectation and
forward-probability APIs, the em CLI and realign --outputExpectations, on
the tests/test_em.py and tests/test_cli.py fixtures.

Counts are fp32 sums taken in another order than XLA's: transitions and
emissions within rtol 1e-4, likelihoods within 1e-5 relative (the
tolerances of tests/test_em.py's data-parallel check). HMM files must
have the same line layout (fields per line) and agree within rtol 1e-4.
"""

import dataclasses
import io
import random

import numpy as np
import pytest
import torch

from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.em import em as jax_em
from cpecan_tpu.io import cigar as cigar_io
from cpecan_tpu.models.hmm import Hmm, StateMachineType
from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.utils.symbols import evolve_sequence, get_random_sequence
from cpecan_tpu_torch.em import em as port_em
from cpecan_tpu_torch.models.hmm import Hmm as PortHmm
from test_cli import identity_cigar, write_fasta
from test_em import make_corpus

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_P = PairwiseAlignmentParameters(constraintDiagonalTrim=0, diagonalExpansion=4,
                                 splitMatrixBiggerThanThis=100 * 100)


def _assert_hmms_close(new, ref):
    np.testing.assert_allclose(new.transitions, ref.transitions, rtol=1e-4)
    np.testing.assert_allclose(new.emissions, ref.emissions, rtol=1e-4)
    assert new.likelihood == pytest.approx(ref.likelihood, rel=1e-5)


def _assert_hmm_files_close(new_path, ref_path):
    with open(new_path) as a, open(ref_path) as b:
        la, lb = a.read().splitlines(), b.read().splitlines()
    assert [len(x.split("\t")) for x in la] == [len(x.split("\t")) for x in lb]
    new, ref = Hmm.load(new_path), Hmm.load(ref_path)
    assert new.type == ref.type
    _assert_hmms_close(new, ref)
    np.testing.assert_allclose(new.running_likelihoods,
                               ref.running_likelihoods, rtol=1e-5)


@pytest.mark.parametrize("sm_factory,hmm_type", [
    (state_machine5, StateMachineType.fiveState),
    (state_machine3, StateMachineType.threeState)])
def test_expectation_step_matches_jax(sm_factory, hmm_type):
    sequences, cigars = make_corpus(5, 30, seed=6)
    tasks = port_em.tasks_from_cigars(cigars, sequences, _P)
    ref_tasks = jax_em.tasks_from_cigars(cigars, sequences, _P)
    assert [(t.sub_x, t.sub_y, t.ragged_left, t.ragged_right) for t in tasks] \
        == [(t.sub_x, t.sub_y, t.ragged_left, t.ragged_right) for t in ref_tasks]
    for a, b in zip(tasks, ref_tasks):
        np.testing.assert_array_equal(np.asarray(a.anchors), np.asarray(b.anchors))
    ref = Hmm(hmm_type)
    jax_em.expectation_step(sm_factory(), ref_tasks, _P, ref)
    new = PortHmm(hmm_type)
    port_em.expectation_step(sm_factory(), tasks, _P, new, device="cpu")
    _assert_hmms_close(new, ref)


def test_wide_unanchored_gap_buckets_within_the_kernels():
    """A task with a 2.6 kb unanchored two-sided gap does not stream and
    has a band wider than the exp kernel keeps its emission columns in
    shared memory for; and no band that does not stream (a full band is
    the widest for its diagonals) is wider than the kernels' shared-memory
    variants take (MAX_KERNEL_WIDTH, where the wide variants start)."""
    from cpecan_tpu_torch.align.batch import should_stream
    from cpecan_tpu_torch.align.pairwise import _width_bucket
    from cpecan_tpu_torch.ops import fb_wavefront
    from cpecan_tpu_torch.ops.band import construct_band

    rng = random.Random(5)
    x = get_random_sequence(2600, rng).upper()
    y = evolve_sequence(x, rng).upper()
    p = port_em.EmOptions().pairwise_params()
    buckets, streamed = port_em.bucket_tasks(
        [port_em._Task(x, y, [], True, True)], p)
    assert not streamed
    (P, W), items = buckets.popitem()
    assert fb_wavefront.EXP_SHARED_WIDTH < W <= fb_wavefront.MAX_KERNEL_WIDTH
    assert len(items) == 1 and P >= len(x) + len(y)
    for n in range(2048, 4096, 64):
        band = construct_band([], n, n, p.diagonalExpansion)
        W = _width_bucket(band.frame_width())
        if not should_stream(band.diagonal_number, W):
            assert W <= fb_wavefront.MAX_KERNEL_WIDTH, n


def test_expectation_maximisation_matches_jax(tmp_path):
    sequences, cigars = make_corpus(5, 30, seed=6)
    options = jax_em.EmOptions(
        modelType="fiveState", iterations=2, trials=1, randomStart=True,
        trainEmissions=True, seed=7, diagonalExpansion=4,
        splitMatrixBiggerThanThis=100 * 100)
    ref = jax_em.expectation_maximisation(
        sequences, cigars, str(tmp_path / "ref.hmm"), options)
    new = port_em.expectation_maximisation(
        sequences, cigars, str(tmp_path / "new.hmm"),
        port_em.EmOptions(**dataclasses.asdict(options)), device="cpu")
    _assert_hmms_close(new, ref)
    np.testing.assert_allclose(new.running_likelihoods,
                               ref.running_likelihoods, rtol=1e-5)
    _assert_hmm_files_close(tmp_path / "new.hmm", tmp_path / "ref.hmm")


def test_pairwise_expectation_and_forward_apis_match_jax():
    from cpecan_tpu.align import pairwise as jax_pairwise
    from cpecan_tpu_torch.align import pairwise as port_pairwise

    rng = random.Random(31)
    x = get_random_sequence(70, rng).upper()
    y = evolve_sequence(x, rng).upper()
    p, sm = PairwiseAlignmentParameters(), state_machine5()
    ref = Hmm(StateMachineType.fiveState)
    jax_pairwise.get_expectations(sm, ref, x, y, p)
    new = PortHmm(StateMachineType.fiveState)
    port_pairwise.get_expectations(sm, new, x, y, p, device="cpu")
    _assert_hmms_close(new, ref)

    from cpecan_tpu.align.anchors import get_anchors

    anchors = get_anchors(x, y, p)
    want = jax_pairwise.compute_forward_probability(x, y, anchors, p, sm)
    got = port_pairwise.compute_forward_probability(x, y, anchors, p, sm,
                                                    device="cpu")
    assert got == pytest.approx(want, rel=1e-5)


def test_reports_match_jax():
    """XML summary and lastz scoring matrix of the same trial models."""
    import xml.etree.ElementTree as ET

    hmms = []
    for seed in (1, 2):
        h = Hmm(StateMachineType.fiveState)
        h.randomise(np.random.default_rng(seed))
        h.likelihood = -100.0 * seed
        h.running_likelihoods = [-300.0, -100.0 * seed]
        hmms.append(h)
    port_hmms = [PortHmm.loads(h.dumps()) for h in hmms]
    for ph, h in zip(port_hmms, hmms):
        ph.transitions, ph.emissions = h.transitions, h.emissions
        ph.likelihood, ph.running_likelihoods = h.likelihood, h.running_likelihoods
    assert (ET.tostring(port_em.hmms_xml(port_hmms), encoding="unicode")
            == ET.tostring(jax_em.hmms_xml(hmms), encoding="unicode"))
    seqs = ["ACGTTGCA", "GGCCAATT"]
    out = []
    for mod, h in ((port_em, port_hmms[0]), (jax_em, hmms[0])):
        buf = io.StringIO()
        mod.write_lastz_scoring_matrix(buf, *mod.make_blast_scoring_matrix(h, seqs))
        out.append(buf.getvalue())
    assert out[0] == out[1]


def _corpus_files(tmp_path, n=2, length=25, seed=8):
    sequences, cigars = make_corpus(n, length, seed=seed)
    fasta = tmp_path / "seqs.fa"
    write_fasta(fasta, sequences)
    cigar_file = tmp_path / "aln.cigar"
    with open(cigar_file, "w") as fh:
        for pa in cigars:
            cigar_io.cigar_write(fh, pa)
    return str(fasta), str(cigar_file)


def test_em_cli_matches_jax(tmp_path):
    from cpecan_tpu.cli import em as jax_cli
    from cpecan_tpu_torch.cli import em as port_cli

    fasta, cigar_file = _corpus_files(tmp_path)
    argv = ["--sequences", fasta, "--alignments", cigar_file,
            "--iterations", "2", "--trials", "1", "--randomStart",
            "--trainEmissions", "--diagonalExpansion", "4",
            "--splitMatrixBiggerThanThis", "100"]
    ref, new = str(tmp_path / "ref.hmm"), str(tmp_path / "new.hmm")
    assert jax_cli.main(argv + ["--outputModel", ref]) == 0
    assert port_cli.main(argv + ["--outputModel", new, "--device", "cpu"]) == 0
    _assert_hmm_files_close(new, ref)


def test_em_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    from cpecan_tpu_torch.cli import em as port_cli

    fasta, cigar_file = _corpus_files(tmp_path)
    argv = ["--sequences", fasta, "--alignments", cigar_file,
            "--outputModel", str(tmp_path / "m.hmm")]
    for extra in (["--dataParallel"], ["--numProcesses", "2"],
                  ["--coordinator", "localhost:1234"]):
        with pytest.raises(NotImplementedError, match="item 10"):
            port_cli.main(argv + extra + ["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 10"):
        port_em.expectation_step(state_machine5(), [], _P, PortHmm(
            StateMachineType.fiveState), mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(argv)


def test_realign_output_expectations_matches_jax(tmp_path):
    from cpecan_tpu.cli import realign as jax_realign
    from cpecan_tpu_torch.cli import realign as port_realign

    rng = random.Random(17)
    x = get_random_sequence(80, rng).upper()
    y = evolve_sequence(x, rng).upper()
    fasta = str(tmp_path / "seqs.fa")
    write_fasta(fasta, {"seqX": x, "seqY": y})
    cigars = [identity_cigar("seqX", "seqY", len(x), len(y))]
    text = "".join(cigar_io.cigar_format(c) + "\n" for c in cigars)
    ref, new = str(tmp_path / "ref.hmm"), str(tmp_path / "new.hmm")
    outs = []
    for cli, path, extra in ((jax_realign, ref, []),
                             (port_realign, new, ["--device", "cpu"])):
        stdout = io.StringIO()
        assert cli.main([fasta, "--outputExpectations", path, *extra],
                        stdin=io.StringIO(text), stdout=stdout) == 0
        outs.append(stdout.getvalue())
    assert outs == ["", ""]
    _assert_hmm_files_close(new, ref)
