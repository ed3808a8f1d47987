"""The port's banded wavefront FB pass against the JAX package.

On the CPU the port runs its kernels' plain PyTorch versions; they are
held against cpecan_tpu's Pallas wavefront kernels (interpreter mode off
a TPU) and against its lax.scan engine, on the same numpy inputs and
tolerances as tests/test_wavefront.py. The tests marked ``cuda`` hold the
CUDA kernels against the plain versions on the card and skip elsewhere.

jax is imported inside the JAX comparisons only, so that the ``cuda``
tests of this file also run where jax is not installed.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.ops.band import construct_band, full_band, pad_band
from cpecan_tpu.utils.symbols import encode
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import _kernels, fb_batch, fb_wavefront

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W = 32
CASES = [(state_machine5, "posterior_all"),
         (state_machine3, "posterior_match"),
         (state_machine5, "forward")]
# (rtol, atol) per output, fp32 summed in another order than XLA's
TOLERANCES = {"log_fwd": (2e-5, 2e-5), "mf": (1e-4, 2e-5),
              "mb": (1e-4, 2e-5), "total_raw": (1e-4, 2e-5),
              "post_match": (1e-3, 2e-5), "post_gap_x": (1e-3, 2e-5),
              "post_gap_y": (1e-3, 2e-5)}


def _random_batch(rng, B=3, P=64, W=32, n=24, zero_pair=False):
    """tests/test_wavefront.py's batch (same generator, same shapes),
    optionally with a zero-length pair appended the way batch_posteriors
    pads its launches."""
    sxs, sys_, offs, wids, lxs, lys = [], [], [], [], [], []
    for i in range(B):
        nx = int(n + rng.integers(-4, 4))
        ny = int(n + rng.integers(-4, 4))
        sx = np.zeros(P, np.int32)
        sy = np.zeros(P, np.int32)
        qx = "".join("ACGTN"[j] for j in rng.integers(0, 5, nx))
        qy = "".join("ACGT"[j] for j in rng.integers(0, 4, ny))
        sx[:nx] = encode(qx)
        sy[:ny] = encode(qy)
        if i == 0:
            band = full_band(nx, ny)
        else:
            anchors = [(k, min(k, ny - 2))
                       for k in range(4, min(nx, ny) - 4, 6)]
            band = construct_band(anchors, nx, ny, 6)
        o, w, L = pad_band(band, P, W)
        sxs.append(sx)
        sys_.append(sy)
        offs.append(o)
        wids.append(w)
        lxs.append(nx)
        lys.append(ny)
    if zero_pair:
        o = np.zeros(P + 1, np.int32)
        o[1::2] = 1
        sxs.append(np.zeros(P, np.int32))
        sys_.append(np.zeros(P, np.int32))
        offs.append(o)
        wids.append(np.ones(P + 1, np.int32))
        lxs.append(0)
        lys.append(0)
    return (np.stack(sxs), np.stack(sys_), np.stack(offs), np.stack(wids),
            np.asarray(lxs, np.int32), np.asarray(lys, np.int32))


def _inputs(zero_pair=False, seed=42):
    args = _random_batch(np.random.default_rng(seed), W=W,
                         zero_pair=zero_pair)
    B = len(args[0])
    rl = np.arange(B) % 3 == 1
    rr = np.arange(B) % 3 == 2
    return args, rl, rr


def _tensors(args, rl, rr, device="cpu"):
    return [torch.from_numpy(np.asarray(a)).to(device)
            for a in (*args, rl, rr)]


def _assert_close(new, ref, L):
    assert set(new) == set(ref)
    for k, (rtol, atol) in TOLERANCES.items():
        if k not in ref:
            continue
        a = np.asarray(new[k].cpu() if torch.is_tensor(new[k]) else new[k])
        b = np.asarray(ref[k].cpu() if torch.is_tensor(ref[k]) else ref[k])
        assert a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        if k == "total_raw":
            for i, Li in enumerate(L):
                np.testing.assert_allclose(a[i, 1:Li + 1], b[i, 1:Li + 1],
                                           rtol=rtol, atol=atol, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)


def _run_port(sm_factory, mode, args, rl, rr, device="cpu"):
    hmm = PairHMM.from_state_machine(sm_factory()).to(device)
    return fb_batch.fb_pass_batch(hmm, *_tensors(args, rl, rr, device),
                                  mode=mode, width=W)


@pytest.mark.parametrize("sm_factory,mode", CASES)
def test_matches_jax_wavefront_kernels(sm_factory, mode):
    pytest.importorskip("jax")
    from cpecan_tpu.ops import fb_wavefront as jax_wf

    args, rl, rr = _inputs()
    params = sm_factory().device_params()
    ref = jax_wf.fb_pass_batch_wavefront(params, *args, rl, rr, mode=mode,
                                         width=W)
    new = _run_port(sm_factory, mode, args, rl, rr)
    assert fb_batch.LAST_ENGINE == "torch"
    _assert_close(new, ref, args[4] + args[5])


@pytest.mark.parametrize("sm_factory,mode", CASES)
def test_matches_jax_scan_engine(sm_factory, mode):
    jax = pytest.importorskip("jax")
    from cpecan_tpu.ops import fb_batch as jax_fb_batch

    args, rl, rr = _inputs()
    params = sm_factory().device_params()
    ref = jax_fb_batch.fb_pass_batch_scan(
        params, *[jax.numpy.asarray(a) for a in (*args, rl, rr)], mode=mode,
        width=W)
    new = _run_port(sm_factory, mode, args, rl, rr)
    _assert_close(new, {k: ref[k] for k in new}, args[4] + args[5])


def test_zero_length_pair_gives_zeros():
    """A zero-length pad pair (as batch_posteriors adds) yields finite
    outputs, zero posteriors, and leaves the other pairs unchanged."""
    args, rl, rr = _inputs(zero_pair=True)
    out = _run_port(state_machine5, "posterior_all", args, rl, rr)
    for k, v in out.items():
        assert torch.isfinite(v).all(), k
    for k in ("post_match", "post_gap_x", "post_gap_y"):
        assert not out[k][-1].any(), k
    assert not out["mf"][-1, 1:].any()
    head = _run_port(state_machine5, "posterior_all",
                     [a[:-1] for a in args], rl[:-1], rr[:-1])
    for k in head:
        torch.testing.assert_close(out[k][:-1], head[k], rtol=0, atol=0)


def test_slicing_under_f_budget_matches_unsliced(monkeypatch):
    args, rl, rr = _inputs()
    whole = _run_port(state_machine5, "posterior_match", args, rl, rr)
    monkeypatch.setattr(fb_wavefront, "_F_BUDGET",
                        (args[2].shape[1]) * 5 * W * 4)
    sliced = _run_port(state_machine5, "posterior_match", args, rl, rr)
    for k in whole:
        torch.testing.assert_close(sliced[k], whole[k], rtol=0, atol=0)


def test_cpu_wrappers_run_plain_versions_without_launching():
    args, rl, rr = _inputs()
    hmm = PairHMM.from_state_machine(state_machine5())
    pre = fb_wavefront.precompute(hmm, *_tensors(args, rl, rr), width=W)
    fb_wavefront.reset_launch_counts()
    fin = (hmm.t_prob_host, pre["ex"], pre["ey"], pre["em"], pre["a"],
           pre["b1"], pre["b0"], pre["F0"], hmm.nz)
    got = fb_wavefront.fwd(*fin)
    want = fb_wavefront.fwd_reference(*fin)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not any(fb_wavefront.LAUNCHES.values())


# widths around the start of the wide variants (MAX_KERNEL_WIDTH = 4096)
WIDE_WIDTHS = (4096, 4097, 4224, 8200)


@pytest.mark.parametrize("W", WIDE_WIDTHS)
def test_kernel_route_by_width(W):
    """CPU tensors take the plain versions; CUDA tensors take a kernel's
    entry point, the shared-memory variant up to MAX_KERNEL_WIDTH and the
    wide variant above, never a plain version."""
    for kernel in ("fwd", "bwd", "exp"):
        assert fb_wavefront.kernel_route(kernel, torch.device("cpu"), W) is None
        entry = fb_wavefront.kernel_route(kernel, torch.device("cuda"), W)
        wide = W > fb_wavefront.MAX_KERNEL_WIDTH
        assert entry == f"cpecan_wavefront_{kernel}" + ("_wide" if wide else "")
        assert entry in _kernels._SIGNATURES


class _StubLibrary:
    """Stands in for the kernel library: each entry point checks its
    argument count against the ctypes signature and records its name."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            assert len(args) == len(_kernels._SIGNATURES[name]), name
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("W", WIDE_WIDTHS)
def test_wrappers_launch_the_variant_of_their_width(monkeypatch, W, window):
    """The three wrappers on device tensors (meta tensors stand in for the
    card's) call the entry point of their width, batch and window alike,
    with the wide variants' scratch where they take one, and never a
    plain version."""
    lib = _StubLibrary()
    monkeypatch.setattr(_kernels, "load", lambda: lib)
    monkeypatch.setattr(fb_wavefront, "_on_card",
                        lambda x: x.device.type == "meta")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))

    def plain(*a, **k):
        raise AssertionError("a plain version ran for device tensors")

    for name in ("fwd_reference", "bwd_reference", "exp_reference"):
        monkeypatch.setattr(fb_wavefront, name, plain)
    hmm = PairHMM.from_state_machine(state_machine5())
    rng = np.random.default_rng(W)

    def meta(x):
        if isinstance(x, tuple) and x and torch.is_tensor(x[0]):
            return tuple(map(meta, x))
        return x.to("meta") if torch.is_tensor(x) else x

    fin, fkw = random_fwd_inputs(rng, hmm, 2, 3, W, window)
    ein, ekw = random_exp_inputs(rng, hmm, 2, 3, W, window)
    bin_ = [*ein[:5], *ein[7:14], *ein[17:19], ein[23]]
    bkw = {"carry": ekw["carry"]} if window else {}
    fb_wavefront.reset_launch_counts()
    fb_wavefront.fwd(fin[0], *map(meta, fin[1:]), **{k: meta(v) for k, v in fkw.items()})
    fb_wavefront.bwd(bin_[0], *map(meta, bin_[1:]), "posterior_all",
                     **{k: meta(v) for k, v in bkw.items()})
    fb_wavefront.exp(ein[0], *map(meta, ein[1:]), **{k: meta(v) for k, v in ekw.items()})
    wide = "_wide" if W > fb_wavefront.MAX_KERNEL_WIDTH else ""
    # (the wide bwd and exp also ask the stub for their plan, for the
    # cluster counts: it answers cluster 0)
    lib.calls = [(n, a) for n, a in lib.calls if not n.endswith("_plan")]
    assert [name for name, _ in lib.calls] == [
        f"cpecan_wavefront_{k}{wide}" for k in ("fwd", "bwd", "exp")]
    counts = {k: 1 for k in ("fwd", "bwd", "exp")}
    if wide:
        counts.update(wide_fwd=1, wide_bwd=1, wide_exp=1)
    assert fb_wavefront.LAUNCHES == {**{k: 0 for k in fb_wavefront.LAUNCHES},
                                     **counts}
    for name, args in lib.calls:
        # (..., B, R, W, k0, stream); fwd's window starts at k0 = 6
        k0 = 6 if window and name.startswith("cpecan_wavefront_fwd") else 0
        assert args[-5:-1] == (2, 3, W, k0), name


def _run_full_band(sm, x, y, rl=False, rr=False, device="cpu"):
    """One pair on its full band through the launcher (no padding)."""
    band = full_band(len(x), len(y))
    o, w, _ = pad_band(band, band.diagonal_number)
    args = [encode(x)[None], encode(y)[None], o[None], w[None],
            np.array([len(x)]), np.array([len(y)]), np.array([rl]),
            np.array([rr])]
    hmm = PairHMM.from_state_machine(sm).to(device)
    out = fb_wavefront.fb_pass_batch_wavefront(
        hmm, *[torch.from_numpy(np.asarray(a)).to(device) for a in args],
        mode="posterior_all", width=band.frame_width())
    return {k: v[0].cpu().numpy() for k, v in out.items()}, band


def _dense_posteriors(post, band, lx, ly):
    """(diagonal, x-frame slot) posteriors -> an (lx+1, ly+1) grid."""
    from cpecan_tpu.ops.pairs import frame_offsets

    dense = np.zeros((lx + 1, ly + 1))
    xoff = frame_offsets(band.offsets.astype(np.int64))
    for k in range(band.diagonal_number + 1):
        o, w = int(band.offsets[k]), int(band.widths[k])
        for j in range(w):
            x = (k + o + 2 * j) // 2
            dense[x, k - x] = post[k, x - xoff[k]]
    return dense


def _oracle_cases():
    import random

    from cpecan_tpu.utils.symbols import evolve_sequence, get_random_sequence

    cases = [("agcg_5", state_machine5, "AGCG", "AGTTCG", False, False),
             ("agcg_3", state_machine3, "AGCG", "AGTTCG", False, False)]
    for seed in range(3):
        rng = random.Random(seed)
        x = get_random_sequence(rng.randint(5, 40), rng)
        y = evolve_sequence(x, rng) or "A"
        cases.append((f"random{seed}_5", state_machine5, x, y, False, False))
        cases.append((f"random{seed}_3", state_machine3, x, y, False, False))
    for rl, rr in ((True, False), (False, True), (True, True)):
        cases.append((f"ragged_{int(rl)}{int(rr)}", state_machine5,
                      "ACGTACGTAC", "TTACGTACGTACTT", rl, rr))
    return {c[0]: c[1:] for c in cases}


_ORACLE = _oracle_cases()


def _check_against_oracle(case, device):
    """The tests/test_fb.py oracle checks (the naive float64 full-matrix
    forward-backward of tests/oracle.py): log-likelihood, match
    posteriors, and every per-diagonal total against the global one."""
    import oracle

    sm_factory, x, y, rl, rr = _ORACLE[case]
    sm = sm_factory()
    out, band = _run_full_band(sm, x, y, rl, rr, device)
    L = len(x) + len(y)
    post_o, total_o = oracle.posterior_match_probs(sm, x, y, rl, rr)
    cf = np.cumsum(out["mf"][:L + 1], dtype=np.float64)
    cb = np.cumsum(out["mb"][:L + 1][::-1], dtype=np.float64)[::-1]
    assert abs(float(out["log_fwd"]) + cf[-1] - total_o) < 1e-3
    for k in range(1, L + 1):
        assert abs(out["total_raw"][k] + cf[k] + cb[k] - total_o) < 0.01, k
    np.testing.assert_allclose(
        _dense_posteriors(out["post_match"], band, len(x), len(y)), post_o,
        atol=5e-3)


@pytest.mark.parametrize("case", sorted(_ORACLE))
def test_plain_versions_match_full_matrix_oracle(case):
    _check_against_oracle(case, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_ORACLE))
def test_kernels_match_full_matrix_oracle(cuda_device, case):
    _check_against_oracle(case, cuda_device)


# --------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sm_factory,mode", CASES)
def test_kernels_match_plain_versions_on_card(cuda_device, sm_factory, mode):
    args, rl, rr = _inputs(zero_pair=True)
    fb_wavefront.reset_launch_counts()
    got = _run_port(sm_factory, mode, args, rl, rr, cuda_device)
    torch.cuda.synchronize()
    assert fb_batch.LAST_ENGINE == "cuda"
    assert fb_wavefront.LAUNCHES["fwd"] == 1
    assert fb_wavefront.LAUNCHES["bwd"] == (0 if mode == "forward" else 1)
    want = _run_port(sm_factory, mode, args, rl, rr, "cpu")
    _assert_close(got, want, args[4] + args[5])


@pytest.mark.cuda
def test_kernels_wide_band_on_card(cuda_device):
    """W > 1024: several band slots per thread (identical sequences, so
    the per-diagonal totals stay inside fp32's range)."""
    rng = np.random.default_rng(5)
    n, P, Wd = 1100, 2240, 1152
    sx = np.zeros((2, P), np.int32)
    sx[:, :n] = rng.integers(0, 4, (2, n))
    o, w, _ = pad_band(full_band(n, n), P, Wd)
    args = [sx, sx.copy(), np.stack([o, o]), np.stack([w, w]),
            np.full(2, n, np.int32), np.full(2, n, np.int32),
            np.array([False, True]), np.array([True, False])]
    hmm = PairHMM.from_state_machine(state_machine5())
    got = fb_wavefront.fb_pass_batch_wavefront(
        hmm.to(cuda_device), *[torch.from_numpy(a).to(cuda_device)
                               for a in args],
        mode="posterior_all", width=Wd)
    want = fb_wavefront.fb_pass_batch_wavefront(
        hmm.cpu(), *[torch.from_numpy(a) for a in args],
        mode="posterior_all", width=Wd)
    _assert_close(got, want, args[4] + args[5])


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_cannot_run(cuda_device):
    args, rl, rr = _inputs()
    hmm = PairHMM.from_state_machine(state_machine5())
    pre = fb_wavefront.precompute(hmm, *_tensors(args, rl, rr), width=W)
    g = {k: v.to(cuda_device) for k, v in pre.items()}
    fin = [hmm.t_prob_host, g["ex"], g["ey"], g["em"], g["a"], g["b1"],
           g["b0"], g["F0"], hmm.nz]
    with pytest.raises(TypeError):
        fb_wavefront.fwd(*fin[:1], g["ex"].double(), *fin[2:])
    with pytest.raises(ValueError):
        fb_wavefront.fwd(*fin[:4], pre["a"], *fin[5:])
    with pytest.raises(ValueError):
        fb_wavefront.fwd(*fin[:-1], fin[-1] + ((0, 1, 2),))


# --------------------------------------------------------------------------
# On the card: wavefront_fwd in each of its launch plans
# --------------------------------------------------------------------------

# 1, 2 and 4 slots per thread on the ring, and 16 slots (W > 2048) with the
# direct loads
FWD_WIDTHS = (32, 128, 384, 544, 1024, 1664, 2048, 4096)
# wavefront_fwd's (slots, ring depth) per W, S = 5 and 3, for
# 16-byte-aligned streams
FWD_PLANS = {32: (1, 4), 128: (1, 4), 384: (1, 4), 544: (2, 4),
             1024: (2, 4), 1664: (4, 4), 2048: (4, 4), 4096: (16, 0)}


def _fwd_outputs(out, window):
    """fwd's outputs as named tensors: F, bv, mf and the carry out."""
    names = ["F", "bv", "mf"] + ([f"carry {i}" for i in range(3)]
                                 if window else [])
    flat = list(out[:3]) + (list(out[3]) if window else [])
    return dict(zip(names, flat))


def assert_fwd_equal(got, want, window, what):
    """wavefront_fwd rounds each product and sum as fwd_reference does, so
    F, bv, mf and the carry out are its values bit for bit."""
    for key, w in _fwd_outputs(want, window).items():
        g = _fwd_outputs(got, window)[key]
        assert torch.isfinite(g).all(), (what, key)
        assert torch.equal(g, w), (
            f"{what} {key}: max abs diff {float((g - w).abs().max()):.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("W", FWD_WIDTHS)
@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_fwd_kernel_launch_plans_on_card(cuda_device, sm_factory, W, window):
    """wavefront_fwd against fwd_reference on the same card tensors at
    widths that run each launch plan, as a batch and as a window with a
    carry in and k0 = 6 (67 diagonals: the ring wraps many times, and
    rows of every rescale phase)."""
    hmm = PairHMM.from_state_machine(sm_factory())
    S = hmm.state_number
    plan = fb_wavefront.fwd_plan(S, W)
    assert (plan["slots"], plan["depth"]) == FWD_PLANS[W]
    args, kw = random_fwd_inputs(np.random.default_rng(W + S), hmm, 3, 67, W,
                                 window)
    args, kw = _on(cuda_device, args, kw)
    fb_wavefront.reset_launch_counts()
    got = fb_wavefront.fwd(*args, **kw)
    want = fb_wavefront.fwd_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fb_wavefront.LAUNCHES["fwd"] == 1
    assert_fwd_equal(got, want, window, f"S={S} W={W} window={window}")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 544, 1664])
def test_fwd_kernel_off_grid_streams_on_card(cuda_device, W):
    """A stream off the 16-byte grid (here ex, one float in) cannot feed
    the ring's bulk copies: the launch runs the direct-load variant (1, 2
    and 4 slots here), and the outputs still equal fwd_reference's."""
    hmm = PairHMM.from_state_machine(state_machine5())
    assert fb_wavefront.fwd_plan(5, W)["depth"] >= 2
    assert fb_wavefront.fwd_plan(5, W, aligned=False)["depth"] == 0
    args, kw = random_fwd_inputs(np.random.default_rng(W + 9), hmm, 2, 37, W,
                                 window=True)
    args, kw = _on(cuda_device, args, kw)
    ex = args[1]
    buf = torch.empty(ex.numel() + 4, dtype=ex.dtype, device=cuda_device)
    args[1] = buf[1:1 + ex.numel()].view(ex.shape)
    args[1].copy_(ex)
    got = fb_wavefront.fwd(*args, **kw)
    want = fb_wavefront.fwd_reference(*args, **kw)
    torch.cuda.synchronize()
    assert_fwd_equal(got, want, True, f"off-grid ex W={W}")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 1664, 4096])
@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_fwd_kernel_window_chain_on_card(cuda_device, sm_factory, W):
    """Two windows of wavefront_fwd, the second started from the first's
    carry out at k0 + 29, give what one window over both gives, bit for
    bit: F, bv, mf and the carry out of the last row."""
    hmm = PairHMM.from_state_machine(sm_factory())
    args, kw = random_fwd_inputs(np.random.default_rng(W + 3), hmm, 2, 53, W,
                                 window=True)
    args, kw = _on(cuda_device, args, kw)
    whole = fb_wavefront.fwd(*args, **kw)
    cut = 29
    part = lambda lo, hi: [args[0]] + [x[:, lo:hi].contiguous()
                                       for x in args[1:7]] + args[7:]
    first = fb_wavefront.fwd(*part(0, cut), carry=kw["carry"], k0=kw["k0"])
    second = fb_wavefront.fwd(*part(cut, None), carry=first[3],
                              k0=kw["k0"] + cut)
    torch.cuda.synchronize()
    joined = (*(torch.cat([a, b], dim=1) for a, b in zip(first[:3],
                                                         second[:3])),
              second[3])
    assert_fwd_equal(joined, whole, True,
                     f"S={hmm.state_number} W={W} two windows")


# --------------------------------------------------------------------------
# On the card: wavefront_bwd in each of its launch variants
# --------------------------------------------------------------------------

# every ring depth (4, 3, 2), the direct loads (W % 16 != 0, too little
# shared memory for two stages, W > 1920) and 1, 2 and 4 slots per thread
BWD_WIDTHS = (32, 40, 128, 544, 1664, 2048, 4096)
# wavefront_bwd's ring depth per (S, W) for 16-byte-aligned streams
BWD_DEPTHS = {5: {32: 4, 40: 0, 128: 4, 544: 4, 1664: 2, 2048: 0, 4096: 0},
              3: {32: 4, 40: 0, 128: 4, 544: 4, 1664: 3, 2048: 0, 4096: 0}}


def random_bwd_inputs(rng, hmm, B, R, W, carry=False):
    """wavefront_bwd's inputs filled at random, so that every slot of every
    diagonal holds data (a padded pair's band leaves most of a wide W
    zero): streams in [0.1, 1), F, bv and end_row in [0, 1), random shift
    selects and posterior gates, the at-end and bridge bits of pm
    row-constant as precompute makes them (one at-end row per pair). With
    ``carry`` also a random carry in (B_{k1}, B_{k1+1}, 1/mb, em, bv).
    CPU tensors, in the argument order of ``fb_wavefront.bwd``."""
    S = hmm.state_number

    def unif(*shape, lo=0.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape).astype(np.float32))

    def bits(*shape):
        return torch.from_numpy((rng.random(shape) < 0.5).astype(np.int8))

    row = np.where(rng.random((B, R)) < 0.7, 16, 0)
    row[np.arange(B), rng.integers(R // 2, R, B)] |= 8
    pm = rng.integers(0, 8, (B, R, W)) | row[..., None]
    args = [hmm.t_prob_host, *(unif(B, R, W, lo=0.1) for _ in range(4)),
            unif(B, R, S, W), unif(B, R, W), *(bits(B, R) for _ in range(5)),
            torch.from_numpy(pm.astype(np.int8)), unif(B, S, W), hmm.nz]
    if not carry:
        return args
    return args, (unif(B, S, W), unif(B, S, W), 0.5 + 1.5 * unif(B),
                  unif(B, W), unif(B, W))


def random_fwd_inputs(rng, hmm, B, R, W, window=False):
    """wavefront_fwd's inputs filled at random: emission streams in
    [0.1, 1), random shift selects, a start row F0 in [0, 1); with
    ``window`` a random carry in (F_{k0-1}, F_{k0-2}, 1/m) in place of
    F0's role and k0 = 6. CPU tensors: (arguments in the order of
    ``fb_wavefront.fwd``, keyword arguments)."""
    S = hmm.state_number

    def unif(*shape, lo=0.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape).astype(np.float32))

    bits = [torch.from_numpy((rng.random((B, R)) < 0.5).astype(np.int8))
            for _ in range(3)]
    args = [hmm.t_prob_host, *(unif(B, R, W, lo=0.1) for _ in range(3)),
            *bits, unif(B, S, W), hmm.nz]
    kw = ({"carry": (unif(B, S, W), unif(B, S, W), 0.5 + unif(B)), "k0": 6}
          if window else {})
    return args, kw


def random_exp_inputs(rng, hmm, B, R, W, window=False):
    """wavefront_exp's inputs filled at random, as ``random_bwd_inputs``
    fills bwd's (whose draws come first): forward emission streams in
    [0.1, 1), random forward shift selects, adj1/adj2 in [0.5, 1.5) and
    symbol pairs in 0..5 (4 and 5, N and the sentinel, add no emission
    count). With ``window`` also the F halo (B, 2, S, W) and a random
    carry in. CPU tensors: (arguments in the order of
    ``fb_wavefront.exp``, keyword arguments)."""
    S = hmm.state_number
    got = random_bwd_inputs(rng, hmm, B, R, W, carry=window)
    bw, carry = got if window else (got, None)

    def unif(*shape, lo=0.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape).astype(np.float32))

    fwd_streams = [unif(B, R, W, lo=0.1) for _ in range(2)]
    sel = [torch.from_numpy((rng.random((B, R)) < 0.5).astype(np.int8))
           for _ in range(3)]
    adj = [0.5 + unif(B, R) for _ in range(2)]
    sym = [torch.from_numpy(rng.integers(0, 6, (B, R, W)).astype(np.int8))
           for _ in range(2)]
    args = [*bw[:5], *fwd_streams, *bw[5:12], *sel, *bw[12:14], *adj, *sym,
            bw[14]]
    kw = {} if not window else {"halo": unif(B, 2, S, W), "carry": carry}
    return args, kw


def assert_exp_close(got, want, what):
    """exp outputs (trans, emis, mb, total_raw[, carry out]): the counts
    within EXP_RTOL relative (fp32 sums over the slots and diagonals in
    another order), mb and total_raw within 1e-5 absolute, the carry out
    at rtol 1e-4."""
    pairs = [("trans", got[0], want[0], (1e-5, 1e-7)),
             ("emis", got[1], want[1], (1e-5, 1e-7)),
             ("mb", got[2], want[2], (0.0, 1e-5)),
             ("total_raw", got[3], want[3], (0.0, 1e-5))]
    if len(want) > 4:
        pairs += [(f"carry {i}", g, w, (1e-4, 1e-6))
                  for i, (g, w) in enumerate(zip(got[4], want[4]))]
    for key, g, w, (rtol, atol) in pairs:
        g = g.cpu()
        assert torch.isfinite(g).all(), (what, key)
        torch.testing.assert_close(g, w.cpu(), rtol=rtol, atol=atol,
                                   msg=f"{what} {key}")


def assert_bwd_close(got, want, what):
    """bwd outputs (posts, mb, total_raw[, carry out]) within TOLERANCES
    (the carry out, like F and bv in chip_smoke.py, at rtol 1e-4)."""
    keys = ("post_match", "post_gap_x", "post_gap_y")
    pairs = [(keys[i], g, w) for i, (g, w) in enumerate(zip(got[0], want[0]))]
    pairs += [("mb", got[1], want[1]), ("total_raw", got[2], want[2])]
    if len(want) > 3:
        pairs += [(f"carry {i}", g, w)
                  for i, (g, w) in enumerate(zip(got[3], want[3]))]
    for key, g, w in pairs:
        g = g.cpu()
        assert torch.isfinite(g).all(), (what, key)
        rtol, atol = TOLERANCES.get(key, (1e-4, 1e-6))
        torch.testing.assert_close(g, w.cpu(), rtol=rtol, atol=atol,
                                   msg=f"{what} {key}")


@pytest.mark.cuda
@pytest.mark.parametrize("W", BWD_WIDTHS)
@pytest.mark.parametrize("sm_factory,mode", [
    (state_machine5, "posterior_match"), (state_machine5, "posterior_all"),
    (state_machine3, "posterior_match"), (state_machine3, "posterior_all")])
def test_bwd_kernel_launch_variants_on_card(cuda_device, W, sm_factory, mode):
    """wavefront_bwd against bwd_reference on the same card tensors at
    widths that run each ring depth and the direct loads (67 diagonals:
    the ring wraps many times, and 67 % 4 != 0 leaves a partial round)."""
    hmm = PairHMM.from_state_machine(sm_factory())
    S = hmm.state_number
    assert fb_wavefront.bwd_plan(S, W)["depth"] == BWD_DEPTHS[S][W]
    args = random_bwd_inputs(np.random.default_rng(W), hmm, 3, 67, W)
    args = [args[0]] + [a.to(cuda_device) if torch.is_tensor(a) else a
                        for a in args[1:]]
    fb_wavefront.reset_launch_counts()
    got = fb_wavefront.bwd(*args, mode)
    want = fb_wavefront.bwd_reference(*args, mode)
    torch.cuda.synchronize()
    assert fb_wavefront.LAUNCHES["bwd"] == 1
    assert_bwd_close(got, want, f"S={S} W={W} {mode}")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 1664])
def test_bwd_kernel_off_grid_streams_on_card(cuda_device, W):
    """A stream that starts off the 16-byte grid (here pm, one byte in)
    cannot feed the ring's bulk copies: the launch runs the direct-load
    variant, and the outputs still match bwd_reference."""
    hmm = PairHMM.from_state_machine(state_machine5())
    assert fb_wavefront.bwd_plan(5, W)["depth"] >= 2
    args = random_bwd_inputs(np.random.default_rng(W + 2), hmm, 2, 37, W)
    args = [args[0]] + [a.to(cuda_device) if torch.is_tensor(a) else a
                        for a in args[1:]]
    pm = args[12]
    buf = torch.empty(pm.numel() + 16, dtype=pm.dtype, device=cuda_device)
    args[12] = buf[1:1 + pm.numel()].view(pm.shape)
    args[12].copy_(pm)
    got = fb_wavefront.bwd(*args, "posterior_all")
    want = fb_wavefront.bwd_reference(*args, "posterior_all")
    torch.cuda.synchronize()
    assert_bwd_close(got, want, f"off-grid pm W={W}")


# --------------------------------------------------------------------------
# On the card: wavefront_exp in each of its launch plans, and the wide
# variants of all three kernels
# --------------------------------------------------------------------------

# every ring depth (4, 3), the direct loads (W % 16 != 0, too little shared
# memory for three stages, 8 slots), 1, 2, 4 and 8 slots per thread, and
# the emission columns in device scratch (W > 2048)
EXP_WIDTHS = (32, 40, 128, 384, 544, 768, 1664, 2048, 4096)
# wavefront_exp's (slots, ring depth) per (S, W) for 16-byte-aligned streams
EXP_PLANS = {
    5: {32: (1, 4), 40: (1, 0), 128: (1, 4), 384: (2, 4), 544: (4, 4),
        768: (4, 3), 1664: (8, 0), 2048: (8, 0), 4096: (8, 0)},
    3: {32: (1, 4), 40: (1, 0), 128: (1, 4), 384: (2, 4), 544: (4, 4),
        768: (4, 4), 1664: (8, 0), 2048: (8, 0), 4096: (8, 0)}}


def _on(device, args, kw):
    dev = lambda a: a.to(device) if torch.is_tensor(a) else a
    return ([args[0]] + [dev(a) for a in args[1:]],
            {k: tuple(map(dev, v)) if isinstance(v, tuple) else dev(v)
             for k, v in kw.items()})


def _bwd_of_exp(args, kw):
    """wavefront_bwd's arguments from wavefront_exp's."""
    return ([*args[:5], *args[7:14], *args[17:19], args[23]],
            {k: v for k, v in kw.items() if k != "halo"})


def _compute_threads(plan):
    return plan["threads"] - (32 if plan["depth"] else 0), plan["slots"]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("W", EXP_WIDTHS)
@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_exp_kernel_launch_plans_on_card(cuda_device, sm_factory, W, window):
    """wavefront_exp against exp_reference on the same card tensors at
    widths that run each launch plan, as a batch and as a window with the
    F halo, a carry in and k0 = 7 (67 diagonals: the ring wraps many
    times). mb and total_raw against wavefront_bwd's on the same inputs:
    bit for bit where the two plans give the same threads and slots."""
    hmm = PairHMM.from_state_machine(sm_factory())
    S = hmm.state_number
    plan = fb_wavefront.exp_plan(S, W)
    assert (plan["slots"], plan["depth"]) == EXP_PLANS[S][W]
    args, kw = random_exp_inputs(np.random.default_rng(W + S), hmm, 3, 67, W,
                                 window)
    if window:
        kw["k0"] = 7
    args, kw = _on(cuda_device, args, kw)
    fb_wavefront.reset_launch_counts()
    got = fb_wavefront.exp(*args, **kw)
    want = fb_wavefront.exp_reference(*args, **kw)
    bargs, bkw = _bwd_of_exp(args, kw)
    _, mb_b, tot_b, *_ = fb_wavefront.bwd(*bargs, **bkw)
    torch.cuda.synchronize()
    assert fb_wavefront.LAUNCHES["exp"] == 1
    assert_exp_close(got, want, f"S={S} W={W} window={window}")
    assert torch.equal(got[2], mb_b)
    if _compute_threads(plan) == _compute_threads(fb_wavefront.bwd_plan(S, W)):
        assert torch.equal(got[3], tot_b)
    torch.testing.assert_close(got[3], tot_b, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 384, 544])
def test_exp_kernel_off_grid_streams_on_card(cuda_device, W):
    """A stream off the 16-byte grid (here wx, one byte in) cannot feed the
    ring's bulk copies: the launch runs the direct-load variant (1, 2 and
    4 slots here), and the outputs still match exp_reference."""
    hmm = PairHMM.from_state_machine(state_machine5())
    assert fb_wavefront.exp_plan(5, W)["depth"] >= 3
    assert fb_wavefront.exp_plan(5, W, aligned=False)["depth"] == 0
    args, kw = random_exp_inputs(np.random.default_rng(W + 9), hmm, 2, 37, W,
                                 window=True)
    args, kw = _on(cuda_device, args, kw)
    wx = args[21]
    buf = torch.empty(wx.numel() + 16, dtype=wx.dtype, device=cuda_device)
    args[21] = buf[1:1 + wx.numel()].view(wx.shape)
    args[21].copy_(wx)
    got = fb_wavefront.exp(*args, **kw)
    want = fb_wavefront.exp_reference(*args, **kw)
    torch.cuda.synchronize()
    assert_exp_close(got, want, f"off-grid wx W={W}")


def _wide_inputs(kernel, hmm, W, window, R=29):
    """Random inputs of a wide launch (B=2) of ``kernel`` on the CPU, as
    (arguments, keywords); windows start at k0 = 5 (bwd) or 3 (exp)."""
    rng = np.random.default_rng(W)
    if kernel == "fwd":
        return random_fwd_inputs(rng, hmm, 2, R, W, window)
    if kernel == "bwd":
        got_ = random_bwd_inputs(rng, hmm, 2, R, W, carry=window)
        args, carry = got_ if window else (got_, None)
        return ([*args, "posterior_all"],
                {"carry": carry, "k0": 5} if window else {})
    args, kw = random_exp_inputs(rng, hmm, 2, R, W, window)
    if window:
        kw["k0"] = 3
    return args, kw


@contextlib.contextmanager
def _cluster_limit(cluster):
    """wavefront_back_wide's cluster size for the block (0: the
    global-scratch kernel at every width)."""
    before = fb_wavefront.set_cluster_limit(cluster)
    try:
        yield
    finally:
        fb_wavefront.set_cluster_limit(before)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("W", [4224, 8200])
@pytest.mark.parametrize("kernel", ["fwd", "bwd", "exp"])
@pytest.mark.parametrize("sm_factory", [state_machine5, state_machine3])
def test_wide_variants_on_card(cuda_device, sm_factory, kernel, W, window):
    """Bands wider than MAX_KERNEL_WIDTH run the wide variants (a
    thread-block cluster of 8 CTAs per pair, which the plan query shows):
    against the plain versions on the same card tensors, as a batch and
    as a window (carries in and out; exp's F halo), at a width on the
    16-byte grid and one off it; fwd bit for bit."""
    hmm = PairHMM.from_state_machine(sm_factory())
    args, kw = _on(cuda_device, *_wide_inputs(kernel, hmm, W, window))
    assert fb_wavefront.kernel_route(kernel, cuda_device, W).endswith("_wide")
    S = hmm.state_number
    plan = (fb_wavefront.fwd_wide_plan(S, W) if kernel == "fwd"
            else fb_wavefront.back_wide_plan(S, W, kernel == "exp"))
    assert plan["cluster"] == 8, plan
    fb_wavefront.reset_launch_counts()
    got = getattr(fb_wavefront, kernel)(*args, **kw)
    want = getattr(fb_wavefront, f"{kernel}_reference")(*args, **kw)
    torch.cuda.synchronize()
    assert fb_wavefront.LAUNCHES[kernel] == 1
    assert fb_wavefront.LAUNCHES[f"wide_{kernel}"] == 1
    assert fb_wavefront.LAUNCHES[f"cluster_{kernel}"] == 1
    what = f"wide {kernel} S={hmm.state_number} W={W} window={window}"
    if kernel == "bwd":
        assert_bwd_close(got, want, what)
    elif kernel == "exp":
        assert_exp_close(got, want, what)
    else:
        assert_fwd_equal(got, want, window, what)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
def test_wide_fwd_global_route_above_cluster_capacity(cuda_device, window):
    """Above the fwd cluster's capacity (the backward cluster's: W >
    12288) the plan declares the global-scratch kernel; it runs and
    equals fwd_reference bit for bit (23 diagonals)."""
    W = 12320
    hmm = PairHMM.from_state_machine(state_machine5())
    assert fb_wavefront.fwd_wide_plan(5, W)["cluster"] == 0
    assert fb_wavefront.fwd_wide_plan(5, 12288)["cluster"] == 8
    args, kw = _on(cuda_device, *_wide_inputs("fwd", hmm, W, window, R=23))
    fb_wavefront.reset_launch_counts()
    got = fb_wavefront.fwd(*args, **kw)
    want = fb_wavefront.fwd_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fb_wavefront.LAUNCHES["wide_fwd"] == 1
    assert fb_wavefront.LAUNCHES["cluster_fwd"] == 0
    assert_fwd_equal(got, want, window, f"global wide fwd W={W} window={window}")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("kernel", ["bwd", "exp"])
def test_wide_back_global_route_above_cluster_capacity(cuda_device, kernel,
                                                       window):
    """Above the cluster's capacity (8 CTAs of 384 threads x 4 slots,
    W > 12288) the plan declares the global-scratch kernel; it still
    matches the plain versions (23 diagonals)."""
    W = 12320
    hmm = PairHMM.from_state_machine(state_machine5())
    assert fb_wavefront.back_wide_plan(5, W, kernel == "exp")["cluster"] == 0
    assert fb_wavefront.back_wide_plan(5, 12288, kernel == "exp")["cluster"] == 8
    args, kw = _on(cuda_device, *_wide_inputs(kernel, hmm, W, window, R=23))
    fb_wavefront.reset_launch_counts()
    got = getattr(fb_wavefront, kernel)(*args, **kw)
    want = getattr(fb_wavefront, f"{kernel}_reference")(*args, **kw)
    torch.cuda.synchronize()
    assert fb_wavefront.LAUNCHES[f"wide_{kernel}"] == 1
    what = f"global wide {kernel} W={W} window={window}"
    (assert_bwd_close if kernel == "bwd" else assert_exp_close)(got, want, what)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [3, 4, 8])
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("kernel", ["bwd", "exp"])
def test_cluster_matches_global_variant(cuda_device, kernel, window, cluster):
    """At W=4224 the cluster variant (3, 4 or 8 CTAs) against the
    global-scratch kernel on the same inputs: mb (a max of the same B)
    and the carry out bit for bit; total_raw within 1e-5 absolute and the
    posteriors or counts within the kernel tests' tolerances, because
    the dot and bridge are summed over another partition of the slots."""
    W = 4224
    hmm = PairHMM.from_state_machine(state_machine5())
    args, kw = _on(cuda_device, *_wide_inputs(kernel, hmm, W, window))
    run = getattr(fb_wavefront, kernel)
    with _cluster_limit(cluster):
        assert fb_wavefront.back_wide_plan(5, W, kernel == "exp")["cluster"] \
            == cluster
        got = run(*args, **kw)
    with _cluster_limit(0):
        assert fb_wavefront.back_wide_plan(5, W, kernel == "exp")["cluster"] == 0
        ref = run(*args, **kw)
    torch.cuda.synchronize()
    what = f"cluster {cluster} vs global {kernel} window={window}"
    mb, tot = (1, 2) if kernel == "bwd" else (2, 3)
    assert torch.equal(got[mb], ref[mb]), what
    torch.testing.assert_close(got[tot], ref[tot], rtol=0, atol=1e-5, msg=what)
    if window:
        for g, r in zip(got[-1], ref[-1]):
            assert torch.equal(g, r), what
    if kernel == "bwd":
        assert_bwd_close(got, ref, what)
    else:
        assert_exp_close(got, ref, what)


@pytest.mark.cuda
@pytest.mark.parametrize("W,cluster,slots", [
    (4224, 3, 4), (4224, 4, 4), (4224, 8, 2), (8200, 8, 4)])
@pytest.mark.parametrize("window", [False, True])
def test_fwd_cluster_matches_global_variant(cuda_device, W, window, cluster,
                                            slots):
    """wavefront_fwd_cluster (3, 4 or 8 CTAs, at the plan's 2 or 4 slots a
    thread) against the global-scratch kernel on the same inputs, bit for
    bit: F, bv, mf and the carry out (both round as fwd_reference). At
    W=8200 only a cluster of 8 holds the band."""
    hmm = PairHMM.from_state_machine(state_machine5())
    args, kw = _on(cuda_device, *_wide_inputs("fwd", hmm, W, window))
    with _cluster_limit(cluster):
        plan = fb_wavefront.fwd_wide_plan(5, W)
        assert plan["cluster"] == cluster, plan
        assert plan["slots"] == slots, plan
        got = fb_wavefront.fwd(*args, **kw)
    with _cluster_limit(0):
        assert fb_wavefront.fwd_wide_plan(5, W)["cluster"] == 0
        ref = fb_wavefront.fwd(*args, **kw)
    torch.cuda.synchronize()
    assert_fwd_equal(got, ref, window,
                     f"fwd cluster {cluster} at {plan['slots']} slots vs "
                     f"global, W={W} window={window}")
