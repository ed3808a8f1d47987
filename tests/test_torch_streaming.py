"""The port's streaming engines for long single pairs against the JAX
package, and the window-started plain versions against one pass.

On the CPU ``fb_pass_streaming`` runs the exact engine (ops/
fb_segmented.py) on the kernels' plain versions; it is held against
cpecan_tpu's scan streaming engine on tests/test_streaming.py's inputs
(same seeds, expansion 8) with the tolerances of chip_smoke.py
(TOLERANCES below) for the scale streams and posteriors, and those of
tests/test_torch_expectation.py for the counts. The batch and EM routes
with the streaming budget patched to 1 byte are held against their own
two-pass results at tests/test_streaming.py's tolerances. The tests
marked ``cuda`` hold the kernels with carries against the plain versions
on the card and skip elsewhere.

jax and the JAX engines are imported inside the JAX comparisons only, so
that the ``cuda`` tests also run where jax is not installed.
"""

import random

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.align.anchors import get_anchors
from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.state_machine import (
    PairHMM, state_machine3, state_machine5)
from cpecan_tpu_torch.ops import fb_parallel, fb_streaming, fb_wavefront
from cpecan_tpu_torch.ops.band import construct_band, pad_band
from cpecan_tpu_torch.utils.symbols import (
    encode, evolve_sequence, get_random_sequence)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (rtol, atol): chip_smoke.py's (those of tests/test_wavefront.py)
TOLERANCES = {"mf": (1e-4, 2e-5), "mb": (1e-4, 2e-5),
              "total_raw": (1e-4, 2e-5), "post": (1e-3, 2e-5)}
COUNT_TOL = {"rtol": 1e-4, "atol": 1e-6}  # tests/test_torch_expectation.py
BURNIN = fb_parallel.burnin_rows(PairwiseAlignmentParameters())


def _case(n=220, seed=5, expansion=8):
    """tests/test_streaming.py's pair: an evolved copy, anchored."""
    rng = random.Random(seed)
    x = get_random_sequence(n, rng)
    y = evolve_sequence(x, rng)
    while len(y) < 4:
        y = evolve_sequence(x, rng)
    p = PairwiseAlignmentParameters(diagonalExpansion=expansion)
    anchors = [(a, b) for (a, b, *_r) in get_anchors(x, y, p)]
    band = construct_band(anchors, len(x), len(y), expansion)
    return x, y, band


def _stream(hmm, x, y, band, mode, window, engine=None, threshold=0.0,
            ragged=(False, False)):
    W = max(8, band.frame_width())
    return fb_streaming.fb_pass_streaming(
        hmm, encode(x), encode(y), band.offsets, band.widths, len(x), len(y),
        *ragged, mode, W, window, BURNIN, threshold=threshold, engine=engine)


def _dense(entries, rows, W):
    vals, ks, js = entries
    out = np.zeros((rows, W))
    out[ks, js] = vals
    return out


def _close(a, b, key):
    rtol, atol = TOLERANCES[key]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=key)


# --------------------------------------------------------------------------
# (a) the exact engine against the JAX scan streaming engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [64, 256])
@pytest.mark.parametrize("mode", ["posterior_all", "expectation", "forward"])
def test_exact_engine_matches_jax_scan_streaming(mode, window):
    from cpecan_tpu.models.state_machine import state_machine5 as jax_sm5
    from cpecan_tpu.ops import fb_streaming as jax_streaming

    x, y, band = _case()
    W = max(8, band.frame_width())
    L = len(x) + len(y)
    ref = jax_streaming.fb_pass_streaming(
        jax_sm5().device_params(), encode(x), encode(y), band.offsets,
        band.widths, len(x), len(y), False, False, mode, W, window,
        engine="scan")
    got = _stream(PairHMM.from_state_machine(state_machine5()), x, y, band,
                  mode, window)
    assert fb_streaming.LAST_ENGINE == "exact"
    assert got["windows"] == ref["windows"] == -(-L // window)
    _close(got["mf"], ref["mf"], "mf")
    lf = lambda o: o["log_fwd"] + np.sum(o["mf"], dtype=np.float64)
    assert lf(got) == pytest.approx(lf(ref), rel=1e-6, abs=1e-4)
    if mode == "forward":
        return
    _close(got["mb"][1:], ref["mb"][1:], "mb")
    _close(got["total_raw"][1:], ref["total_raw"][1:], "total_raw")
    if mode == "expectation":
        np.testing.assert_allclose(got["trans"], ref["trans"], **COUNT_TOL)
        np.testing.assert_allclose(got["emis"], ref["emis"], **COUNT_TOL)
        return
    np.testing.assert_array_equal(got["xoff"][:L + 1], ref["xoff"][:L + 1])
    for key in ("post_match", "post_gap_x", "post_gap_y"):
        _close(_dense(got["post_entries"][key], L + 1, W),
               _dense(ref["post_entries"][key], L + 1, W), "post")


# --------------------------------------------------------------------------
# (b) window-started plain versions against one pass
# --------------------------------------------------------------------------


def _batch_streams(sm, P=64, Wd=32, seed=3):
    """precompute's streams of three anchored evolved pairs in one batch."""
    rng = random.Random(seed)
    cols = {k: [] for k in ("sx", "sy", "offs", "wids", "lx", "ly")}
    for _ in range(3):
        x = get_random_sequence(30, rng)
        y = evolve_sequence(x, rng)[:P - 30] or "ACGT"
        band = construct_band([(i, i) for i in range(4, min(len(x), len(y)) - 4, 6)],
                              len(x), len(y), 6)
        o, w, _ = pad_band(band, P, Wd)
        sx, sy = np.zeros(P, np.int32), np.zeros(P, np.int32)
        sx[:len(x)], sy[:len(y)] = encode(x), encode(y)
        for k, v in zip(cols, (sx, sy, o, w, len(x), len(y))):
            cols[k].append(v)
    args = [torch.from_numpy(np.asarray(cols[k])) for k in cols]
    hmm = PairHMM.from_state_machine(sm)
    rl = torch.tensor([False, True, False])
    rr = torch.tensor([True, False, False])
    return hmm, fb_wavefront.precompute(hmm, *args, rl, rr, width=Wd)


@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_windowed_plain_versions_match_one_pass(sm_factory):
    """Windows k0 = 1 + w*K with the previous window's carries give the
    one-pass rows bit for bit (forward, backward) and the same counts
    (expectation, summed over windows)."""
    hmm, pre = _batch_streams(sm_factory())
    t, nz = hmm.t_prob_host, hmm.nz
    F, bv, mf = fb_wavefront.fwd_reference(
        t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"], pre["b0"],
        pre["F0"], nz)
    back = ("efx", "efy", "efm", "em")
    masks = ("abw", "c1", "c0", "bm1", "bm0")
    posts, mb, tot = fb_wavefront.bwd_reference(
        t, *[pre[k] for k in back], F, bv, *[pre[k] for k in masks],
        pre["pm"], pre["end_row"], nz, "posterior_all")
    mf[:, 0] += pre["m0log"]
    adj1, adj2 = fb_wavefront.scale_adjustments(mf)
    exp_in = lambda sl, F_, bv_: (
        t, *[pre[k][:, sl] for k in back], pre["ex"][:, sl],
        pre["ey"][:, sl], F_, bv_, *[pre[k][:, sl] for k in masks],
        pre["a"][:, sl], pre["b1"][:, sl], pre["b0"][:, sl], pre["pm"][:, sl],
        pre["end_row"], adj1[:, sl], adj2[:, sl], pre["wx"][:, sl],
        pre["wy"][:, sl], nz)
    trans, emis, _, _ = fb_wavefront.exp_reference(
        *exp_in(slice(None), F, bv))

    K, R = 16, F.shape[1]
    B, S, W = pre["F0"].shape
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0)
    carry = (pre["F0"], torch.zeros_like(pre["F0"]), torch.ones(B))
    windows = []
    for k0 in range(1, R, K):
        sl = slice(k0, k0 + K)
        windows.append((k0, sl, carry))
        Fw, bvw, mfw, carry = fb_wavefront.fwd_reference(
            t, pre["ex"][:, sl], pre["ey"][:, sl], pre["em"][:, sl],
            pre["a"][:, sl], pre["b1"][:, sl], pre["b0"][:, sl], None, nz,
            carry=carry, k0=k0)
        same(Fw, F[:, sl])
        same(bvw, bv[:, sl])
        same(mfw, mf[:, sl])
    zero = torch.zeros(B, W)
    cb = ce = (torch.zeros(B, S, W), torch.zeros(B, S, W), torch.ones(B),
               zero, zero)
    tw, ew = torch.zeros_like(trans), torch.zeros_like(emis)
    for k0, sl, fc in reversed(windows):
        Fw, bvw = F[:, sl], bv[:, sl]
        pw, mbw, totw, cb = fb_wavefront.bwd_reference(
            t, *[pre[k][:, sl] for k in back], Fw, bvw,
            *[pre[k][:, sl] for k in masks], pre["pm"][:, sl],
            pre["end_row"], nz, "posterior_all", carry=cb, k0=k0)
        for a, b in zip(pw, posts):
            same(a, b[:, sl])
        same(mbw, mb[:, sl])
        same(totw, tot[:, sl])
        halo = torch.stack([fc[1], fc[0]], 1)
        trw, emw, mbe, tote, ce = fb_wavefront.exp_reference(
            *exp_in(sl, Fw, bvw), halo=halo, carry=ce, k0=k0)
        same(mbe, mbw)
        same(tote, totw)
        tw, ew = tw + trw, ew + emw
    torch.testing.assert_close(tw, trans, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ew, emis, rtol=1e-5, atol=1e-6)


def test_precompute_window_from_zero_is_precompute():
    """A window that starts at diagonal 0 and covers the pair gives
    precompute's streams row for row."""
    x, y, band = _case(n=60, seed=11)
    hmm = PairHMM.from_state_machine(state_machine5())
    L = len(x) + len(y)
    W = 64
    o, w, _ = pad_band(band, L, W)
    args = [torch.from_numpy(np.asarray(a)) for a in (
        encode(x)[None], encode(y)[None], o[None], w[None], [len(x)],
        [len(y)], [False], [True])]
    want = fb_wavefront.precompute(hmm, *args, width=W)
    frame = fb_streaming._pad_frame(
        *fb_streaming._host_frame(band.offsets, band.widths), L)
    sx, sy, fr = fb_streaming._device_pair(encode(x), encode(y), frame,
                                           W + 1, "cpu")
    got = fb_wavefront.precompute_window(
        hmm, sx, sy, fr, len(y), L, torch.tensor([0]), L + 1, W, W + 1)
    for k, v in got.items():
        rows = slice(0, L) if k in ("bm1", "bm0") else slice(None)
        np.testing.assert_array_equal(v[:, rows].numpy(),
                                      want[k][:, rows].numpy(), err_msg=k)


# --------------------------------------------------------------------------
# (d) the batch and EM routes with every chunk streamed
# --------------------------------------------------------------------------


def _assert_pair_arrays_close(a, b):
    a = np.sort(a, order=["x", "y"])
    b = np.sort(b, order=["x", "y"])
    np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(a["y"], b["y"])
    np.testing.assert_allclose(a["prob"], b["prob"], rtol=2e-3, atol=30)


def test_batch_posteriors_stream_route_matches(monkeypatch):
    """tests/test_streaming.py's case: a 1-byte budget streams every
    chunk (the exact engine on the CPU) and reproduces the two-pass
    batch results."""
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
    for mode in ("posterior_match", "posterior_all"):
        ref = batch_mod.batch_posteriors(sm, jobs, p, mode=mode,
                                         device="cpu")
        metrics.reset()
        monkeypatch.setattr(fb_streaming, "_STREAM_BUDGET", 1)
        got = batch_mod.batch_posteriors(sm, jobs, p, mode=mode,
                                         device="cpu")
        monkeypatch.undo()
        assert metrics.snapshot()["counters"]["streamed_chunks"] >= len(jobs)
        assert fb_streaming.LAST_ENGINE == "exact"
        for a, b in zip(got, ref):
            for x_, y_ in (zip(a, b) if mode == "posterior_all" else [(a, b)]):
                _assert_pair_arrays_close(x_, y_)


def test_expectation_step_stream_route_matches(monkeypatch):
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
    assert tasks
    serial = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, serial, device="cpu")
    monkeypatch.setattr(fb_streaming, "_STREAM_BUDGET", 1)
    assert not em_mod.bucket_tasks(tasks, p)[0]
    streamed = Hmm(StateMachineType.fiveState)
    em_mod.expectation_step(sm, tasks, p, streamed, device="cpu")
    np.testing.assert_allclose(streamed.transitions, serial.transitions,
                               rtol=1e-4)
    np.testing.assert_allclose(streamed.emissions, serial.emissions,
                               rtol=1e-4)
    assert streamed.likelihood == pytest.approx(serial.likelihood, rel=1e-5)


# --------------------------------------------------------------------------
# (e) routing, (f) the window and burn-in sizes
# --------------------------------------------------------------------------


def test_wide_unanchored_gap_streams_to_the_wide_kernels():
    """An anchor-free 4300 x 4300 gap at realign's parameters (split only
    above 4400 x 4400, so the gap stays one chunk) has a band wider than
    the kernels' shared-memory variants take, equal to cpecan_tpu's band;
    the chunk streams, and on the card each kernel launch of that width
    takes its wide variant."""
    from cpecan_tpu.ops.band import construct_band as jax_construct_band
    from cpecan_tpu_torch.align.pairwise import _width_bucket
    from cpecan_tpu_torch.cli import realign

    p = realign.alignment_parameters(realign.make_parser().parse_args(
        ["in.fa", "--splitMatrixBiggerThanThis", "4400"]))
    assert 4300 * 4300 <= p.splitMatrixBiggerThanThis
    band = construct_band([], 4300, 4300, p.diagonalExpansion)
    ref = jax_construct_band([], 4300, 4300, p.diagonalExpansion)
    np.testing.assert_array_equal(band.offsets, ref.offsets)
    np.testing.assert_array_equal(band.widths, ref.widths)
    W = _width_bucket(band.frame_width())
    assert W > fb_wavefront.MAX_KERNEL_WIDTH
    assert fb_streaming.should_stream(band.diagonal_number, W)
    for kernel in ("fwd", "bwd", "exp"):
        assert fb_wavefront.kernel_route(
            kernel, torch.device("cuda"), W) == f"cpecan_wavefront_{kernel}_wide"


def test_engine_routing_on_cpu_tensors():
    x, y, band = _case(n=120, seed=17)
    hmm = PairHMM.from_state_machine(state_machine5())
    exact = _stream(hmm, x, y, band, "posterior_match", 64)
    assert fb_streaming.LAST_ENGINE == "exact" and "mf" in exact
    par = _stream(hmm, x, y, band, "posterior_match", 64, engine="parallel")
    assert fb_streaming.LAST_ENGINE == "parallel" and "mf" not in par
    assert set(par["post_entries"]) == {"post_match"}
    with pytest.raises(ValueError, match="parallel engine"):
        _stream(hmm, x, y, band, "expectation", 64, engine="parallel")
    with pytest.raises(ValueError, match="engine"):
        _stream(hmm, x, y, band, "posterior_match", 64, engine="scan")


@pytest.mark.parametrize("params", [
    {}, {"minDiagsBetweenTraceBack": 200, "traceBackDiagonals": 300},
    {"minDiagsBetweenTraceBack": 20, "traceBackDiagonals": 10},
    {"traceBackDiagonals": 90}])
def test_window_and_burnin_rows_match_jax(params, monkeypatch):
    from cpecan_tpu.config import PairwiseAlignmentParameters as JaxParams
    from cpecan_tpu.ops import fb_parallel as jax_parallel
    from cpecan_tpu.ops import fb_streaming as jax_streaming

    monkeypatch.delenv("CPECAN_TPU_BURNIN", raising=False)
    p, jp = PairwiseAlignmentParameters(**params), JaxParams(**params)
    assert fb_streaming.window_rows(p) == jax_streaming.window_rows(jp)
    assert fb_parallel.burnin_rows(p) == jax_parallel.burnin_rows(jp)
    assert fb_streaming.should_stream(150_000, 64) \
        == jax_streaming.should_stream(150_000, 64)


# --------------------------------------------------------------------------
# On the card: the kernels with carries against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_against_cpu(cuda_device, sm, mode, engine):
    x, y, band = _case(n=300, seed=41)
    L = len(x) + len(y)
    W = max(8, band.frame_width())
    hmm = PairHMM.from_state_machine(sm)
    fb_wavefront.reset_launch_counts()
    got = _stream(hmm.to(cuda_device), x, y, band, mode, 64, engine=engine,
                  ragged=(True, False))
    torch.cuda.synchronize()
    launches = dict(fb_wavefront.LAUNCHES)
    want = _stream(hmm.cpu(), x, y, band, mode, 64, engine=engine,
                   ragged=(True, False))
    for key in ("mf", "mb", "total_raw"):
        if key in want:
            _close(got[key][1:], want[key][1:], key)
    if "trans" in want:
        np.testing.assert_allclose(got["trans"], want["trans"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["emis"], want["emis"], rtol=1e-5,
                                   atol=1e-6)
    for key in want.get("post_entries", {}):
        _close(_dense(got["post_entries"][key], L + 1, W),
               _dense(want["post_entries"][key], L + 1, W), "post")
    return launches, got["windows"]


@pytest.mark.cuda
@pytest.mark.parametrize("sm_factory,mode", [
    (state_machine5, "posterior_all"), (state_machine3, "posterior_match"),
    (state_machine5, "expectation"), (state_machine3, "expectation"),
    (state_machine5, "forward")])
def test_segmented_kernels_match_plain_versions_on_card(cuda_device,
                                                        sm_factory, mode):
    launches, windows = _card_against_cpu(cuda_device, sm_factory(), mode,
                                          "exact")
    passes = 1 if mode == "forward" else 2
    assert launches["seg_fwd"] == passes * windows
    assert launches["seg_bwd"] == (windows if mode.startswith("post") else 0)
    assert launches["seg_exp"] == (windows if mode == "expectation" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sm_factory,mode", [
    (state_machine5, "posterior_all"), (state_machine3, "posterior_match")])
def test_parallel_kernels_match_plain_versions_on_card(cuda_device,
                                                       sm_factory, mode):
    launches, _ = _card_against_cpu(cuda_device, sm_factory(), mode,
                                    "parallel")
    assert launches["par_fwd"] == launches["par_bwd"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 1664])
@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_bwd_window_kernel_with_carries_on_card(cuda_device, W, sm_factory):
    """One window of wavefront_bwd at ring widths, with a random carry in
    and k0 = 5 (rescale phase 1 off the batch path's): posteriors, mb,
    total_raw and the carry out of row 0 against bwd_reference."""
    from test_torch_wavefront import assert_bwd_close, random_bwd_inputs

    hmm = PairHMM.from_state_machine(sm_factory())
    assert fb_wavefront.bwd_plan(hmm.state_number, W)["depth"] >= 2
    args, carry = random_bwd_inputs(np.random.default_rng(W + 1), hmm, 2, 45,
                                    W, carry=True)
    dev = lambda a: a.to(cuda_device) if torch.is_tensor(a) else a
    args = [args[0]] + [dev(a) for a in args[1:]]
    carry = tuple(dev(c) for c in carry)
    fb_wavefront.reset_launch_counts()
    got = fb_wavefront.bwd(*args, "posterior_all", carry=carry, k0=5,
                           site="seg_bwd")
    want = fb_wavefront.bwd_reference(*args, "posterior_all", carry=carry,
                                      k0=5)
    torch.cuda.synchronize()
    assert fb_wavefront.LAUNCHES["seg_bwd"] == 1
    assert_bwd_close(got, want, f"window S={hmm.state_number} W={W}")
