"""The stream prep's slot part, ``fb_wavefront.streams``: its plain route
against the one-pass torch prep it was split from and against the JAX
package's ``jax.vmap(_precompute_one)``; its card route (the kernel
``wavefront_prep``) against the plain route. The row part, the kernel
``wavefront_rows``, has tests/test_torch_rows.py.

``_one_pass_precompute`` and ``_one_pass_window`` below are the torch
prep as one function each (symbol windows, then every (B, R, W) stream
by tensor ops), kept here as the oracle of the split: ``precompute`` and
``precompute_window`` must return the same tensors bit for bit. The
batch shapes are tests/test_torch_wavefront.py's (``_inputs``), so the
JAX comparison compiles no new shapes.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.models import state_machine as torch_sm
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import _kernels, fb_streaming
from cpecan_tpu_torch.ops import fb as _fb
from cpecan_tpu_torch.ops import fb_wavefront as wf
from cpecan_tpu_torch.utils.symbols import encode
from test_torch_streaming import _case
from test_torch_wavefront import W, _inputs, _StubLibrary, _tensors

torch.set_num_threads(1)

STREAMS = ("ex", "ey", "em", "efx", "efy", "efm")
SLOT_KEYS = STREAMS + ("pm", "wx", "wy")


# --------------------------------------------------------------------------
# The one-pass torch prep (the oracle of the split)
# --------------------------------------------------------------------------


def _one_pass_streams(prob, wx, wy, slot_ok, xs, ys, valid_rows, at_end,
                      bridge, delta, dmid, d1, dsum2, dmid1):
    W_ = slot_ok.shape[-1]
    fm = slot_ok.to(torch.float32)
    e_x, e_y, e_m = _fb._emissions(prob, wx[..., :W_], wy[..., 1:])
    ef_x, ef_y, ef_m = _fb._emissions(prob, wx[..., 1:], wy[..., :W_])
    valid_k = valid_rows[..., None] & slot_ok
    row_bits = (torch.where(at_end, wf._PM_ATEND, 0)
                | torch.where(bridge, wf._PM_BRIDGE, 0))
    pm = (torch.where(valid_k & (xs > 0) & (ys > 0), wf._PM_MATCH, 0)
          | torch.where(valid_k & (xs > 0), wf._PM_GAPX, 0)
          | torch.where(valid_k & (ys > 0), wf._PM_GAPY, 0)
          | row_bits[..., None])
    i8 = lambda cond: cond.to(torch.int8)
    return {
        "ex": e_x * fm, "ey": e_y * fm, "em": e_m * fm,
        "efx": ef_x * fm, "efy": ef_y * fm, "efm": ef_m * fm,
        "a": i8(delta == 1), "b1": i8(dmid == 1), "b0": i8(dmid == 0),
        "abw": i8(d1 == 1), "c1": i8(dsum2 == 2), "c0": i8(dsum2 == 1),
        "bm1": i8(dmid1 == 1), "bm0": i8(dmid1 == 0),
        "pm": pm.to(torch.int8),
        "wx": wx[..., :W_].contiguous(), "wy": wy[..., 1:].contiguous(),
    }


def _one_pass_precompute(hmm, sx, sy, offsets, widths, lx, ly, ragged_left,
                         ragged_right, width):
    dev = offsets.device
    W_ = int(width)
    S = hmm.state_number
    B, P1 = offsets.shape
    P = P1 - 1
    prob = _fb._prob_params(hmm)
    lx, ly = lx.long(), ly.long()
    L = lx + ly
    xoff, delta, jlo, jhi = _fb._frame_from_band(offsets, widths)
    LX, LY = sx.shape[1], sy.shape[1]
    sent = torch.tensor(_fb._SENTINEL, dtype=torch.int8, device=dev)
    sx_s = torch.where(torch.arange(LX, device=dev) < lx[:, None],
                       sx.to(torch.int8), sent)
    sy_s = torch.where(torch.arange(LY, device=dev) < ly[:, None],
                       sy.to(torch.int8), sent)
    pad = torch.full((B, W_ + 1), _fb._SENTINEL, dtype=torch.int8, device=dev)
    sx_pad = torch.cat([pad, sx_s, pad], dim=1)
    sy_pad = torch.cat([pad, torch.flip(sy_s, dims=[1]), pad], dim=1)
    wx, wy = _fb._symbol_windows(sx_pad, sy_pad, xoff, LY, W_)
    js = torch.arange(W_, device=dev)
    ks = torch.arange(P1, device=dev)
    slot_ok = (js >= jlo[..., None]) & (js <= jhi[..., None])
    d_km1 = torch.cat([delta[:, :1], delta[:, :-1]], dim=1)
    dmid = delta + d_km1 - 1
    delta_pad = torch.cat([delta, delta.new_zeros(B, 2)], dim=1)
    d1 = delta_pad[:, 1:P + 2]
    dsum2 = d1 + delta_pad[:, 2:P + 3]
    dmid1 = torch.cat([dmid[:, 1:], dmid.new_zeros(B, 1)], dim=1)
    xs = xoff[..., None] + js
    out = _one_pass_streams(
        prob, wx, wy, slot_ok, xs, ks[:, None] - xs,
        (ks >= 1) & (ks <= L[:, None]), ks == L[:, None],
        (ks >= 1) & (ks < L[:, None]), delta, dmid, d1, dsum2, dmid1)
    out["F0"], out["m0log"] = wf.start_rows(prob, ragged_left, S, W_)
    slot_ok_L = slot_ok[torch.arange(B, device=dev), L.clamp(0, P)]
    out["end_row"] = wf.end_rows(prob, ragged_right, slot_ok_L.float())
    out.update(xoff=xoff, jlo=jlo, jhi=jhi, L=L)
    return out


def _one_pass_window(hmm, sx_pad, sy_pad, frame, LY, L, starts, rows, width,
                     pad_off, base=None, emit=None):
    dev = sx_pad.device
    W_ = int(width)
    prob = _fb._prob_params(hmm)
    ks = starts[:, None] + torch.arange(rows, device=dev)
    last = frame["xoff"].shape[0] - 1
    at = lambda key, off=0: frame[key][(ks + off).clamp(0, last)]
    base = (torch.zeros_like(starts) if base is None else base)[:, None]
    xoff = at("xoff") + base
    delta, d_km1, d1, d2 = (at("delta"), at("delta", -1), at("delta", 1),
                            at("delta", 2))
    jlo, jhi = at("jlo") - base, at("jhi") - base
    wx, wy = _fb._symbol_windows(sx_pad, sy_pad, xoff, LY, W_, ks=ks,
                                 pad_off=pad_off)
    js = torch.arange(W_, device=dev)
    slot_ok = (js >= jlo[..., None]) & (js <= jhi[..., None])
    xs = xoff[..., None] + js
    lo, hi = ((ks[:, :1], ks[:, -1:] + 1) if emit is None
              else (emit[:, :1], emit[:, 1:]))
    return _one_pass_streams(
        prob, wx, wy, slot_ok, xs, ks[..., None] - xs,
        (ks >= lo) & (ks < hi) & (ks >= 1) & (ks <= L), ks == L,
        (ks >= 1) & (ks < L), delta, delta + d_km1 - 1, d1, d1 + d2,
        d1 + delta - 1)


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------


def _hmm(kind):
    """The port's model by name; "nan" is the 5-state model with NaN and
    inf in each emission table (symbols A, C and G meet them)."""
    if kind != "nan":
        return PairHMM.from_state_machine(getattr(torch_sm, kind)())
    hmm = PairHMM.from_state_machine(torch_sm.state_machine5())
    p = {k: v.numpy().copy() for k, v in hmm.named_buffers()}
    p["em_gap_x"][0] = np.nan
    p["em_gap_y"][2] = np.inf
    p["em_match"][1, 3] = np.nan
    p["em_match"][2, 0] = np.inf
    return PairHMM(p)


def _batch(device="cpu"):
    args, rl, rr = _inputs(zero_pair=True)
    return _tensors(args, rl, rr, device)


WINDOW_W, WINDOW_PAD, WINDOW_ROWS = 36, 90, 24


def _window_pair(device="cpu"):
    """An anchored evolved pair of tests/test_torch_streaming.py on the
    device as the streaming engines hold it, with its length and LY."""
    x, y, band = _case(n=120, seed=11)
    L = len(x) + len(y)
    frame = fb_streaming._pad_frame(
        *fb_streaming._host_frame(band.offsets, band.widths), L + 64)
    sx, sy, fr = fb_streaming._device_pair(encode(x), encode(y), frame,
                                           WINDOW_PAD, device)
    return sx, sy, fr, len(y), L


def _window_args(L, device="cpu"):
    """Five windows from nonzero starts (one past L), with slot bases and
    emitted row ranges."""
    starts = torch.tensor([1, 17, 40, L - 10, L + 5], device=device)
    base = torch.tensor([0, 2, -3, 5, 0], device=device)
    return starts, base, torch.stack([starts + 3, starts + 20], 1)


def _assert_same(got, want, keys, what=""):
    """Equal bit for bit, NaN where the other has NaN."""
    for k in keys:
        g, w_ = got[k].cpu(), want[k].cpu()
        assert g.dtype == w_.dtype and g.shape == w_.shape, (what, k)
        if g.is_floating_point():
            assert torch.equal(g.isnan(), w_.isnan()), (what, k)
            g, w_ = g.nan_to_num(), w_.nan_to_num()
        assert torch.equal(g, w_), (what, k)


def _off_band(out):
    js = torch.arange(out["ex"].shape[-1])
    return ~((js >= out["jlo"][..., None]) & (js <= out["jhi"][..., None]))


# --------------------------------------------------------------------------
# On the CPU: the plain route
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["state_machine5", "state_machine3", "nan"])
def test_precompute_equals_one_pass_prep(kind):
    """precompute (row part, then the wrapper's plain route) returns the
    one-pass prep's tensors bit for bit: every key, ragged flags and a
    zero-length pair included."""
    hmm = _hmm(kind)
    args = _batch()
    got = wf.precompute(hmm, *args, width=W)
    want = _one_pass_precompute(hmm, *args, W)
    assert set(got) == set(want)
    _assert_same(got, want, want, kind)


@pytest.mark.parametrize("kind", ["state_machine5", "nan"])
@pytest.mark.parametrize("ranges", [False, True])
def test_precompute_window_equals_one_pass_prep(kind, ranges):
    """Windows of one long pair from nonzero starts (one past L), with
    and without slot bases and emitted row ranges, give the one-pass
    prep's window tensors bit for bit."""
    hmm = _hmm(kind)
    sx, sy, fr, LY, L = _window_pair()
    starts, base, emit = _window_args(L)
    kw = {"base": base, "emit": emit} if ranges else {}
    got = wf.precompute_window(hmm, sx, sy, fr, LY, L, starts, WINDOW_ROWS,
                               WINDOW_W, WINDOW_PAD, **kw)
    want = _one_pass_window(hmm, sx, sy, fr, LY, L, starts, WINDOW_ROWS,
                            WINDOW_W, WINDOW_PAD, **kw)
    assert set(got) == set(want)
    _assert_same(got, want, want, kind)


def _check_masked_lookups(out, off, prob):
    """ex, ey and em are the table entries of the cells' symbol pairs
    times 1 on the band and 0 off it: off the band NaN exactly where the
    entry is NaN or inf. Returns the count of those NaN."""
    gx = torch.cat([prob["em_gap_x"], torch.zeros(1)])
    gy = torch.cat([prob["em_gap_y"], torch.zeros(1)])
    gm = torch.nn.functional.pad(prob["em_match"], (0, 1, 0, 1))
    wx, wy = out["wx"].long(), out["wy"].long()
    for k, entry in (("ex", gx[wx]), ("ey", gy[wy]), ("em", gm[wx, wy])):
        want = torch.where(off, entry * 0.0, entry)
        assert torch.equal(out[k].isnan(), want.isnan()), k
        assert torch.equal(out[k].nan_to_num(), want.nan_to_num()), k
    return sum(int(out[k][off].isnan().sum()) for k in ("ex", "ey", "em"))


def test_nan_and_inf_tables_give_nan_off_the_band():
    """Masking is a multiply by 0 or 1: off the band a NaN or inf table
    entry gives NaN, in the batch prep and in the window prep alike."""
    hmm = _hmm("nan")
    prob = _fb._prob_params(hmm)
    pre = wf.precompute(hmm, *_batch(), width=W)
    off = _off_band(pre)
    _check_masked_lookups(pre, off, prob)
    for k in STREAMS:  # NaN off the band; on it NaN or inf as the table
        assert pre[k][off].isnan().any(), k
        assert not pre[k][~off].isfinite().all(), k
    sx, sy, fr, LY, L = _window_pair()
    starts, _, _ = _window_args(L)
    win = wf.precompute_window(hmm, sx, sy, fr, LY, L, starts, WINDOW_ROWS,
                               WINDOW_W, WINDOW_PAD)
    js = torch.arange(WINDOW_W)
    ks = starts[:, None] + torch.arange(WINDOW_ROWS)
    at = lambda key: fr[key][ks.clamp(0, fr["xoff"].shape[0] - 1)]
    assert _check_masked_lookups(
        win, ~((js >= at("jlo")[..., None]) & (js <= at("jhi")[..., None])),
        prob) > 0


@pytest.mark.parametrize("sm_name", ["state_machine5", "state_machine3"])
def test_streams_match_jax_precompute_one(sm_name):
    """The wrapper's plain route, called with the row part's tensors,
    returns what jax.vmap(_precompute_one) returns for the slot streams
    (tests/test_torch_precompute.py's tolerances; ragged flags and a
    zero-length pair)."""
    import jax
    import jax.numpy as jnp

    from cpecan_tpu.models import state_machine as jax_sm
    from cpecan_tpu.ops import fb_wavefront as jax_wf

    args, rl, rr = _inputs(zero_pair=True)
    P1 = args[2].shape[1]
    ref = jax.vmap(lambda *a: jax_wf._precompute_one(
        getattr(jax_sm, sm_name)().device_params(), *a, width=W, rows=P1))(
        *[jnp.asarray(a) for a in (*args, rl, rr)])
    ref = {k: np.asarray(v) for k, v in ref.items()}

    hmm = _hmm(sm_name)
    sx, sy, offsets, widths, lx, ly, _, _ = _tensors(args, rl, rr)
    B = sx.shape[0]
    L = (lx.long() + ly.long())[:, None]
    xoff, _, jlo, jhi = _fb._frame_from_band(offsets, widths)
    sent = _fb._SENTINEL
    sx_s = torch.where(torch.arange(sx.shape[1]) < lx[:, None],
                       sx.to(torch.int8), sent)
    sy_s = torch.where(torch.arange(sy.shape[1]) < ly[:, None],
                       sy.to(torch.int8), sent)
    pad = torch.full((B, W + 1), sent, dtype=torch.int8)
    ks = torch.arange(P1)
    got = wf.streams(
        wf.emission_tables(_fb._prob_params(hmm)),
        torch.cat([pad, sx_s, pad], 1),
        torch.cat([pad, torch.flip(sy_s, [1]), pad], 1),
        sy.shape[1], W + 1, wf.row_tensor(ks, xoff, jlo, jhi),
        wf.row_bits((ks >= 1) & (ks <= L), ks == L, (ks >= 1) & (ks < L)), W)
    for k in STREAMS:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(got["pm"].numpy(), ref["pm"])
    for k in ("wx", "wy"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    # the zero-length pair emits nothing and has no posterior slots
    for k in STREAMS:
        assert not got[k][-1].any(), k
    assert not (got["pm"][-1] & 7).any()


def test_cpu_route_launches_nothing():
    hmm = _hmm("state_machine5")
    wf.reset_launch_counts()
    wf.precompute(hmm, *_batch(), width=W)
    sx, sy, fr, LY, L = _window_pair()
    wf.precompute_window(hmm, sx, sy, fr, LY, L, _window_args(L)[0],
                         WINDOW_ROWS, WINDOW_W, WINDOW_PAD)
    assert wf.LAUNCHES["prep"] == 0
    assert not any(wf.LAUNCHES.values())


@pytest.mark.parametrize("width", [W, 4097, 8200])
def test_prep_route_has_one_entry_point(width):
    """The prep kernel has one entry point at every width (no wide
    variant), and none on the CPU."""
    assert wf.kernel_route("prep", torch.device("cpu"), width) is None
    entry = wf.kernel_route("prep", torch.device("cuda"), width)
    assert entry == "cpecan_wavefront_prep"
    assert entry in _kernels._SIGNATURES


@pytest.mark.parametrize("window", [False, True])
def test_device_tensors_launch_the_prep_kernel(monkeypatch, window):
    """On device tensors (meta tensors stand in for the card's) precompute
    and precompute_window call the row kernel's entry point and then the
    prep's, once each, with the ctypes signature's argument count, the
    pair strides (0 for a window's one long pair) and the shapes (the row
    kernel's batch form with band pointers, its window form with none),
    count one launch of each and never run a plain version."""
    lib = _StubLibrary()
    monkeypatch.setattr(_kernels, "load", lambda: lib)
    monkeypatch.setattr(wf, "_on_card", lambda x: x.device.type == "meta")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))

    def plain(*a, **k):
        raise AssertionError("the plain streams ran for device tensors")

    for name in ("streams_reference", "rows_reference",
                 "rows_window_reference"):
        monkeypatch.setattr(wf, name, plain)
    hmm = _hmm("state_machine5").to("meta")
    wf.reset_launch_counts()
    if window:
        sx, sy, fr, LY, L = _window_pair("meta")
        starts = torch.tensor([1, 17, 40, L - 10, L + 5], device="meta")
        out = wf.precompute_window(hmm, sx, sy, fr, LY, L, starts,
                                   WINDOW_ROWS, WINDOW_W, WINDOW_PAD)
        B, R, Wd = 5, WINDOW_ROWS, WINDOW_W
        strides, pad_off, LYs = (0, 0), WINDOW_PAD, LY
    else:
        args = _batch("meta")
        out = wf.precompute(hmm, *args, width=W)
        B, R, Wd = args[2].shape[0], args[2].shape[1], W
        strides = (args[0].shape[1] + 2 * (W + 1),) * 2
        pad_off, LYs = W + 1, args[1].shape[1]
    assert [name for name, _ in lib.calls] == ["cpecan_wavefront_rows",
                                               "cpecan_wavefront_prep"]
    (_, r), (_, a) = lib.calls
    assert a[2:4] == strides
    assert a[6:8] == (LYs, pad_off)
    assert a[-4:-1] == (B, R, Wd)
    # the row kernel: the batch form's element types (int32 band and
    # lengths, bool flags) or the window form's zeros, B and R
    assert r[16:24] == ((0,) * 8 if window else (4,) * 6 + (-1,) * 2)
    assert r[-4:-2] == (B, R)
    assert wf.LAUNCHES == {**{k: 0 for k in wf.LAUNCHES}, "prep": 1,
                           "rows": 1}
    for k in STREAMS:
        assert out[k].shape == (B, R, Wd) and out[k].dtype == torch.float32
    for k in ("pm", "wx", "wy"):
        assert out[k].shape == (B, R, Wd) and out[k].dtype == torch.int8


# --------------------------------------------------------------------------
# On the card: wavefront_prep against the plain route
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@contextlib.contextmanager
def _plain_streams():
    saved = wf.streams
    wf.streams = wf.streams_reference
    try:
        yield
    finally:
        wf.streams = saved


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["state_machine5", "state_machine3", "nan"])
def test_prep_kernel_equals_plain_streams_on_card(cuda_device, kind):
    """wavefront_prep writes the plain route's streams bit for bit (NaN
    where the plain route has NaN): the batch prep, the window prep with
    and without ranges, and rows whose window origins pass both ends of
    the sliding windows (the clamps), at W % 4 == 0 and not."""
    hmm = _hmm(kind).to(cuda_device)
    args = _batch(cuda_device)
    wf.reset_launch_counts()
    got = wf.precompute(hmm, *args, width=W)
    assert wf.LAUNCHES["prep"] == 1
    with _plain_streams():
        want = wf.precompute(hmm, *args, width=W)
    torch.cuda.synchronize()
    _assert_same(got, want, want, "batch")

    sx, sy, fr, LY, L = _window_pair(cuda_device)
    starts, base, emit = _window_args(L, cuda_device)
    for Wd in (WINDOW_W, 41):
        for kw in ({}, {"base": base, "emit": emit}):
            call = lambda: wf.precompute_window(
                hmm, sx, sy, fr, LY, L, starts, WINDOW_ROWS, Wd, WINDOW_PAD,
                **kw)
            got = call()
            with _plain_streams():
                want = call()
            _assert_same(got, want, want, f"window W={Wd} {sorted(kw)}")

    g = torch.Generator().manual_seed(0)
    tables = wf.emission_tables(_fb._prob_params(hmm))
    for Wd in (32, 41):
        B, R = 3, 40
        rnd = lambda lo, hi: torch.randint(lo, hi, (B, R), generator=g)
        sxp = torch.randint(0, 6, (B, 120), generator=g, dtype=torch.int8)
        syp = torch.randint(0, 6, (B, 100), generator=g, dtype=torch.int8)
        jlo = rnd(-5, Wd)
        rows = [rnd(-80, 200), rnd(-80, 200), jlo, jlo + rnd(-3, Wd)]
        bits = wf.row_bits(rnd(0, 2) == 1, rnd(0, 2) == 1, rnd(0, 2) == 1)
        on = lambda x: x.to(cuda_device)
        rows = on(wf.row_tensor(*rows))
        got = wf.streams(tables, on(sxp), on(syp), 70, Wd + 1, rows,
                         on(bits), Wd)
        want = wf.streams_reference(tables, on(sxp), on(syp), 70, Wd + 1,
                                    rows, on(bits), Wd)
        _assert_same(got, want, SLOT_KEYS, f"clamps W={Wd}")


@pytest.mark.cuda
def test_prep_wrapper_rejects_what_the_kernel_cannot_run(cuda_device):
    hmm = _hmm("state_machine5").to(cuda_device)
    sx, sy, offsets, widths, lx, ly, rl, rr = _batch(cuda_device)
    tables = wf.emission_tables(_fb._prob_params(hmm))
    xoff, _, jlo, jhi = _fb._frame_from_band(offsets, widths)
    ks = torch.arange(xoff.shape[1], device=cuda_device)
    bits = wf.row_bits(ks >= 1, ks == 5, ks < 5).expand(xoff.shape).contiguous()
    pad = lambda x: torch.nn.functional.pad(x.to(torch.int8), (W + 1, W + 1),
                                            value=5)
    rows = wf.row_tensor(ks, xoff, jlo, jhi)
    args = [tables, pad(sx), pad(sy), sy.shape[1], W + 1, rows, bits, W]
    wf.streams(*args)
    with pytest.raises(TypeError):  # symbols of another type
        wf.streams(tables, pad(sx).long(), *args[2:])
    with pytest.raises(TypeError):  # rows of another type
        wf.streams(*args[:5], rows.long(), *args[6:])
    with pytest.raises(ValueError):  # a CPU tensor among the card's
        wf.streams(*args[:6], bits.cpu(), W)
    with pytest.raises(ValueError):  # symbol rows neither 1 nor B
        wf.streams(tables, pad(sx)[:2], *args[2:])
