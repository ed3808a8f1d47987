"""The port's banded wavefront FB pass against the JAX package.

On the CPU the port runs its kernels' plain PyTorch versions; they are
held against cpecan_tpu's Pallas wavefront kernels (interpreter mode off
a TPU) and against its lax.scan engine, on the same numpy inputs and
tolerances as tests/test_wavefront.py. The tests marked ``cuda`` hold the
CUDA kernels against the plain versions on the card and skip elsewhere.

jax is imported inside the JAX comparisons only, so that the ``cuda``
tests of this file also run where jax is not installed.
"""

import numpy as np
import pytest
import torch

from cpecan_tpu.models.state_machine import state_machine3, state_machine5
from cpecan_tpu.ops.band import construct_band, full_band, pad_band
from cpecan_tpu.utils.symbols import encode
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import fb_batch, fb_wavefront

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
