"""The port's burn-in-parallel window engine against the JAX package.

``fb_parallel.fb_pass_parallel`` (on the CPU the kernels' plain versions)
is held against cpecan_tpu's exact two-pass engine ``fb.fb_pass`` on
tests/test_parallel.py's cases and at its tolerances: the thresholded
entries agree within the burn-in error budget (2e-3, entries within 2e-3
of the threshold excepted), a pair shorter than one window is exact, and
the default burn-in holds for a 3-state model, a 5x lower threshold and
the 5eebe95 grid (thresholds 1e-3 and 1e-2 x an asymmetric 5-state and a
3-state model x band expansions 20 and 64).
The port's window is K + 2*burnin rows rounded to 8 (the JAX package
rounds to its TPU chunk), so its backward starts sit elsewhere than the
JAX parallel engine's and the two agree at the burn-in error level; on a
single window both are exact and agree at fp32 noise.
"""

import functools
import random

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
from cpecan_tpu_torch.ops import fb_parallel, fb_streaming
from cpecan_tpu_torch.ops.band import pad_band
from cpecan_tpu_torch.utils.symbols import (
    encode, evolve_sequence, get_random_sequence)
from test_torch_streaming import _case, _dense

torch.set_num_threads(1)


def _model(name, package):
    """The state machine of a model type by name, from ``package``'s
    state_machine module (the port's or the JAX package's)."""
    t = package.StateMachineType[name]
    return (package.state_machine3(t) if name == "threeState"
            else package.state_machine5(t))


def _two_pass(name, x, y, band, mode, W):
    """cpecan_tpu's exact engine (tests/test_parallel.py's _two_pass)."""
    import jax.numpy as jnp
    from cpecan_tpu.models import state_machine as jax_sm
    from cpecan_tpu.ops import fb

    P = band.diagonal_number
    Pb = 1
    while Pb < P:
        Pb *= 2
    offsets, widths, L = pad_band(band, Pb)
    sx = np.zeros(Pb, np.int32)
    sy = np.zeros(Pb, np.int32)
    sx[:len(x)] = encode(x)
    sy[:len(y)] = encode(y)
    params = _model(name, jax_sm).device_params()
    out = fb.fb_pass(params, jnp.asarray(sx), jnp.asarray(sy),
                     jnp.asarray(offsets), jnp.asarray(widths),
                     jnp.int32(len(x)), jnp.int32(len(y)), False, False,
                     mode=mode, width=W)
    return {k: np.asarray(v) for k, v in out.items()}, L


def _parallel(name, x, y, band, mode, W, **kw):
    from cpecan_tpu_torch.models import state_machine as port_sm

    return fb_parallel.fb_pass_parallel(
        PairHMM.from_state_machine(_model(name, port_sm)), encode(x), encode(y),
        band.offsets, band.widths, len(x), len(y), False, False, mode, W,
        **kw)


def _assert_within_burnin_budget(got, ref, keys, L, thr):
    """tests/test_parallel.py:67-80: same entry set up to knife-edge
    threshold crossings, probabilities within 2e-3."""
    for key in keys:
        dense = _dense(got["post_entries"][key], *ref[key].shape)
        ref_thr = np.where(ref[key] >= thr, ref[key], 0.0)[:L + 1]
        got_thr = np.where(dense >= thr, dense, 0.0)[:L + 1]
        diff = np.abs(got_thr - ref_thr)
        near_thr = np.minimum(np.abs(ref_thr - thr),
                              np.abs(got_thr - thr)) < 2e-3
        assert np.all((diff < 2e-3) | near_thr), (key, float(diff.max()))


@pytest.mark.parametrize("mode", ["posterior_match", "posterior_all"])
def test_parallel_matches_exact_at_threshold(mode):
    x, y, band = _case(n=600)
    W = max(8, band.frame_width())
    thr = 0.01
    ref, L = _two_pass("fiveState", x, y, band, mode, W)
    got = _parallel("fiveState", x, y, band, mode, W, burnin=64,
                    threshold=thr, window=128)
    assert got["windows"] == -(-L // 128)
    keys = fb_parallel.POST_KEYS[:3 if mode == "posterior_all" else 1]
    assert set(got["post_entries"]) == set(keys)
    _assert_within_burnin_budget(got, ref, keys, L, thr)


def test_parallel_single_window_is_exact():
    """A pair shorter than one window runs exactly (true start, natural
    end), as the JAX parallel engine does on the same pair."""
    from cpecan_tpu.models.state_machine import state_machine5 as jax_sm5
    from cpecan_tpu.ops import fb_parallel as jax_parallel

    x, y, band = _case(n=120, seed=9)
    W = max(8, band.frame_width())
    ref, L = _two_pass("fiveState", x, y, band, "posterior_match", W)
    got = _parallel("fiveState", x, y, band, "posterior_match", W,
                    burnin=32, threshold=0.0, window=4 * (L + 2))
    assert got["windows"] == 1
    dense = _dense(got["post_entries"]["post_match"], *ref["post_match"].shape)
    np.testing.assert_allclose(dense[:L + 1], ref["post_match"][:L + 1],
                               rtol=1e-3, atol=2e-5)
    jax_got = jax_parallel.fb_pass_parallel(
        jax_sm5().device_params(), encode(x), encode(y), band.offsets,
        band.widths, len(x), len(y), False, False, "posterior_match", W,
        burnin=32, threshold=0.0, window=4 * (L + 2))
    np.testing.assert_allclose(
        dense, _dense(jax_got["post_entries"]["post_match"], *dense.shape),
        rtol=1e-3, atol=2e-5)


def _assert_default_burnin_parity(name, x, y, band, thr):
    W = max(8, band.frame_width())
    ref, L = _two_pass(name, x, y, band, "posterior_match", W)
    got = _parallel(name, x, y, band, "posterior_match", W,
                    burnin=fb_parallel.burnin_rows(PairwiseAlignmentParameters()),
                    threshold=thr, window=128)
    _assert_within_burnin_budget(got, ref, ("post_match",), L, thr)


@pytest.mark.parametrize("thr,name", [(0.002, "fiveState"),
                                      (0.01, "threeState")])
def test_parallel_burnin_robust_across_models(thr, name):
    """tests/test_parallel.py:141-153 at the default burn-in."""
    _assert_default_burnin_parity(name, *_case(n=500, seed=31), thr)


@pytest.mark.parametrize("thr", [0.001, 0.01])
@pytest.mark.parametrize("name", ["fiveStateAsymmetric", "threeState"])
@pytest.mark.parametrize("expansion", [20, 64])
def test_parallel_burnin_grid(thr, name, expansion):
    """tests/test_parallel.py:156-174's grid (5eebe95): low thresholds x
    an asymmetric and a 3-state model x wide band expansions, at the
    default burn-in, against the exact engine."""
    _assert_default_burnin_parity(
        name, *_case(n=500, seed=47, expansion=expansion), thr)


def test_parallel_batch_route(monkeypatch):
    """tests/test_parallel.py:102-138: the batch path with every chunk
    streamed through the parallel engine reproduces its two-pass pairs
    up to knife-edge threshold effects, probabilities within the burn-in
    wobble (fixed-point units of 1e7)."""
    from cpecan_tpu_torch.align import batch as batch_mod
    from cpecan_tpu_torch.align.anchors import get_anchors

    rng = random.Random(21)
    p = PairwiseAlignmentParameters(diagonalExpansion=6)
    sm = state_machine5()
    jobs = []
    for _ in range(2):
        x = get_random_sequence(rng.randint(300, 500), rng)
        y = evolve_sequence(x, rng) or "ACGT"
        jobs.append((x, y, get_anchors(x, y, p), False, False))
    ref = batch_mod.batch_posteriors(sm, jobs, p, device="cpu")
    monkeypatch.setattr(fb_streaming, "_STREAM_BUDGET", 1)
    monkeypatch.setattr(fb_streaming, "fb_pass_streaming", functools.partial(
        fb_streaming.fb_pass_streaming, engine="parallel"))
    got = batch_mod.batch_posteriors(sm, jobs, p, device="cpu")
    assert fb_streaming.LAST_ENGINE == "parallel"
    for a, b in zip(got, ref):
        ka = set(zip(a["x"].tolist(), a["y"].tolist()))
        kb = set(zip(b["x"].tolist(), b["y"].tolist()))
        assert len(ka ^ kb) <= max(2, len(kb) // 50), ka ^ kb
        pa = {(r["x"], r["y"]): r["prob"] for r in a}
        pb = {(r["x"], r["y"]): r["prob"] for r in b}
        for kxy in ka & kb:
            assert abs(pa[kxy] - pb[kxy]) < 2e-2 * 1e7 + 30


def test_burnin_is_required():
    x, y, band = _case(n=60, seed=3)
    with pytest.raises(TypeError):
        fb_parallel.fb_pass_parallel(
            PairHMM.from_state_machine(state_machine5()), encode(x),
            encode(y), band.offsets, band.widths, len(x), len(y), False,
            False, "posterior_match", 64, threshold=0.01)
