"""The port's streaming overrides: CPECAN_TPU_STREAM_BUDGET and
CPECAN_TPU_STREAM_ENGINE change its routing as they change the JAX
package's (cpecan_tpu/ops/fb_streaming.py:61-68, 248-270).

The budget: a 1-byte budget streams every chunk of ``batch_posteriors``
and ``expectation_step`` and reproduces their two-pass results at
tests/test_streaming.py's tolerances, as that file's JAX tests do. The
engine: each value of the variable sets ``LAST_ENGINE`` of
``fb_pass_streaming`` (the JAX names map onto the port's two engines) or
raises. CPU only: the exact engine runs the kernels' plain versions.
"""

import random

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.align.anchors import get_anchors
from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
from cpecan_tpu_torch.ops import fb_parallel, fb_streaming
from cpecan_tpu_torch.ops.band import construct_band
from cpecan_tpu_torch.utils.symbols import (
    encode, evolve_sequence, get_random_sequence)

torch.set_num_threads(1)

BURNIN = fb_parallel.burnin_rows(PairwiseAlignmentParameters())


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    monkeypatch.delenv("CPECAN_TPU_STREAM_BUDGET", raising=False)
    monkeypatch.delenv("CPECAN_TPU_STREAM_ENGINE", raising=False)


def _assert_pair_arrays_close(a, b):
    a = np.sort(a, order=["x", "y"])
    b = np.sort(b, order=["x", "y"])
    np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(a["y"], b["y"])
    np.testing.assert_allclose(a["prob"], b["prob"], rtol=2e-3, atol=30)


def test_stream_budget_reads_the_variable_at_call_time(monkeypatch):
    """The default is the module's _STREAM_BUDGET, read when asked (so a
    patched value counts); the variable overrides it, as in the JAX
    package, whose should_stream then agrees."""
    from cpecan_tpu.ops import fb_streaming as jax_streaming

    assert fb_streaming.stream_budget_bytes() == fb_streaming._STREAM_BUDGET
    assert not fb_streaming.should_stream(2000, 64)
    monkeypatch.setattr(fb_streaming, "_STREAM_BUDGET", 7)
    assert fb_streaming.stream_budget_bytes() == 7
    assert fb_streaming.should_stream(2000, 64)
    monkeypatch.undo()
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", "1000")
    assert fb_streaming.stream_budget_bytes() == 1000
    assert jax_streaming.stream_budget_bytes() == 1000
    for rows, width in ((10, 4), (20, 4), (2000, 64)):
        assert fb_streaming.should_stream(rows, width) \
            == jax_streaming.should_stream(rows, width)


def test_stream_budget_variable_streams_batch_posteriors(monkeypatch):
    """tests/test_streaming.py:152's case: CPECAN_TPU_STREAM_BUDGET=1
    streams every chunk and reproduces the two-pass pairs."""
    from cpecan_tpu_torch.align import batch as batch_mod
    from cpecan_tpu_torch.utils import metrics

    rng = random.Random(21)
    p = PairwiseAlignmentParameters(
        diagonalExpansion=6, minDiagsBetweenTraceBack=64,
        traceBackDiagonals=16)
    sm = state_machine5()
    jobs = []
    for _ in range(3):
        x = get_random_sequence(rng.randint(80, 200), rng)
        y = evolve_sequence(x, rng) or "ACGT"
        jobs.append((x, y, get_anchors(x, y, p), False, False))
    ref = batch_mod.batch_posteriors(sm, jobs, p, mode="posterior_match",
                                     device="cpu")
    metrics.reset()
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", "1")
    got = batch_mod.batch_posteriors(sm, jobs, p, mode="posterior_match",
                                     device="cpu")
    assert metrics.snapshot()["counters"]["streamed_chunks"] >= len(jobs)
    assert fb_streaming.LAST_ENGINE == "exact"
    for a, b in zip(got, ref):
        _assert_pair_arrays_close(a, b)


def test_stream_budget_variable_streams_expectation_step(monkeypatch):
    """tests/test_streaming.py:164's case: CPECAN_TPU_STREAM_BUDGET=1
    leaves no chunk for the two-pass buckets, and the streamed counts
    match the two-pass ones."""
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.em import em as em_mod
    from cpecan_tpu_torch.io import cigar as cigar_io
    from cpecan_tpu_torch.models.hmm import Hmm, StateMachineType

    rng = random.Random(31)
    sequences, cigars = {}, []
    for i in range(3):
        x = get_random_sequence(100, rng)
        y = evolve_sequence(x, rng) or "ACGTACGT"
        sequences[f"x{i}"], sequences[f"y{i}"] = x, y
        n = min(len(x), len(y))
        cigars.append(cigar_io.PairwiseAlignment(
            f"x{i}", 0, n, True, f"y{i}", 0, n, True, 0.0,
            [(cigar_io.MATCH, n)]))
    p = PairwiseAlignmentParameters(
        constraintDiagonalTrim=0, diagonalExpansion=6,
        minDiagsBetweenTraceBack=64, traceBackDiagonals=16)
    sm = state_machine5()
    tasks = em_mod.tasks_from_cigars(cigars, sequences, p)
    assert tasks and batch.plan(tasks, p)[0]
    serial = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, serial, device="cpu")
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", "1")
    assert not batch.plan(tasks, p)[0]
    streamed = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, streamed, device="cpu")
    assert fb_streaming.LAST_ENGINE == "exact"
    np.testing.assert_allclose(streamed.transitions, serial.transitions,
                               rtol=1e-4)
    np.testing.assert_allclose(streamed.emissions, serial.emissions,
                               rtol=1e-4)
    assert streamed.likelihood == pytest.approx(serial.likelihood, rel=1e-5)


def _pair():
    rng = random.Random(17)
    x = get_random_sequence(120, rng)
    y = evolve_sequence(x, rng)
    p = PairwiseAlignmentParameters(diagonalExpansion=8)
    anchors = [(a, b) for (a, b, *_r) in get_anchors(x, y, p)]
    return x, y, construct_band(anchors, len(x), len(y), 8)


def _stream(mode, engine=None):
    x, y, band = _pair()
    W = max(8, band.frame_width())
    return fb_streaming.fb_pass_streaming(
        PairHMM.from_state_machine(state_machine5()), encode(x), encode(y),
        band.offsets, band.widths, len(x), len(y), False, False, mode, W, 64,
        BURNIN, engine=engine)


# (CPECAN_TPU_STREAM_ENGINE, mode, the engine it gives on CPU tensors)
ENGINE_CASES = [
    ("auto", "posterior_match", "exact"),
    ("auto", "expectation", "exact"),
    ("wavefront", "posterior_match", "exact"),
    ("wavefront", "expectation", "exact"),
    ("parallel", "posterior_match", "parallel"),
    ("parallel", "posterior_all", "parallel"),
    ("parallel", "expectation", "exact"),
    ("scan", "posterior_match", "exact"),
    ("scan", "forward", "exact"),
]


@pytest.mark.parametrize("name,mode,engine", ENGINE_CASES)
def test_stream_engine_variable_picks_the_engine(monkeypatch, name, mode,
                                                 engine):
    monkeypatch.setenv("CPECAN_TPU_STREAM_ENGINE", name)
    out = _stream(mode)
    assert fb_streaming.LAST_ENGINE == engine
    assert ("post_entries" in out) == (mode in ("posterior_match",
                                                "posterior_all"))
    assert ("mf" in out) == (engine == "exact")


@pytest.mark.parametrize("name,mode,engine", [
    ("auto", "posterior_match", "parallel"), ("auto", "expectation", "exact"),
    ("wavefront", "posterior_all", "exact"), ("scan", "posterior_match", "exact"),
    ("parallel", "forward", "exact")])
def test_stream_engine_variable_on_the_card(monkeypatch, name, mode, engine):
    """The same choice for a PairHMM on the card (the device rule of
    "auto"), read without a card: the choice alone."""
    monkeypatch.setenv("CPECAN_TPU_STREAM_ENGINE", name)
    assert fb_streaming._env_engine(mode, on_card=True) == engine


def test_stream_engine_variable_rejects_unknown_values(monkeypatch):
    monkeypatch.setenv("CPECAN_TPU_STREAM_ENGINE", "bogus")
    with pytest.raises(ValueError, match="CPECAN_TPU_STREAM_ENGINE"):
        _stream("posterior_match")


def test_engine_argument_takes_precedence(monkeypatch):
    """An explicit engine= wins over the variable, as in the JAX
    package."""
    monkeypatch.setenv("CPECAN_TPU_STREAM_ENGINE", "parallel")
    _stream("posterior_match", engine="exact")
    assert fb_streaming.LAST_ENGINE == "exact"
    monkeypatch.setenv("CPECAN_TPU_STREAM_ENGINE", "bogus")
    _stream("posterior_match", engine="parallel")
    assert fb_streaming.LAST_ENGINE == "parallel"
