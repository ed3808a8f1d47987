"""The stream prep's row part: the plain versions ``rows_reference`` and
``rows_window_reference`` against the JAX package's ``_precompute_one``
(vmapped), ``_prep_window`` and ``_prep_one`` on the same numpy inputs;
``precompute`` after the split against the one-pass torch prep; the
wrappers' card route (the kernel ``wavefront_rows``) on meta tensors with
a stub library, and on the card against the plain versions. The tests
that need the JAX package import it inside, so the file runs on a card
without it.

The batch shapes are tests/test_torch_wavefront.py's (``_inputs``); the
window pair is tests/test_torch_prep.py's.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import _kernels, fb_streaming
from cpecan_tpu_torch.ops import fb_wavefront as wf
from cpecan_tpu_torch.utils.symbols import encode
from test_torch_prep import (
    _assert_same, _batch, _hmm, _one_pass_precompute, WINDOW_ROWS, WINDOW_W)
from test_torch_streaming import _case
from test_torch_wavefront import W, _inputs, _StubLibrary, _tensors

torch.set_num_threads(1)

BATCH_KEYS = wf.SELECTS + (
    "tables", "rows", "bits", "sx_pad", "sy_pad", "xoff", "jlo", "jhi", "L",
    "F0", "m0log", "end_row")
WINDOW_KEYS = wf.SELECTS + ("tables", "rows", "bits")
STREAMS = ("ex", "ey", "em", "efx", "efy", "efm")


def _jax_tables(params):
    return np.concatenate([np.exp(np.asarray(params[k], np.float32)).ravel()
                           for k in ("em_gap_x", "em_gap_y", "em_match")])


# --------------------------------------------------------------------------
# On the CPU: the plain versions against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sm_name", ["state_machine5", "state_machine3"])
def test_rows_reference_matches_jax_precompute_one(sm_name):
    """rows_reference returns what jax.vmap(_precompute_one) returns for
    the row part (ragged flags and a zero-length pair): the frame, the
    selects and pm's row bits exactly, F0/end_row/m0log within rtol 1e-6;
    the row tensor, the tables and the padded symbols as the JAX function
    builds them."""
    import jax
    import jax.numpy as jnp

    from cpecan_tpu.models import state_machine as jax_sm
    from cpecan_tpu.ops import fb_wavefront as jax_wf

    args, rl, rr = _inputs(zero_pair=True)
    P1 = args[2].shape[1]
    params = getattr(jax_sm, sm_name)().device_params()
    ref = jax.vmap(lambda *a: jax_wf._precompute_one(
        params, *a, width=W, rows=P1))(
        *[jnp.asarray(a) for a in (*args, rl, rr)])
    ref = {k: np.asarray(v) for k, v in ref.items()}

    got = {k: v.numpy() for k, v in wf.rows_reference(
        _hmm(sm_name), *_tensors(args, rl, rr), W).items()}
    for k in wf.SELECTS:
        assert got[k].dtype == np.int8
        np.testing.assert_array_equal(got[k], ref[k][..., 0], err_msg=k)
    for k in ("xoff", "jlo", "jhi", "L"):
        assert got[k].dtype == np.int64
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("F0", "end_row"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    np.testing.assert_allclose(got["m0log"], ref["m0log"][:, 0], rtol=1e-6,
                               atol=1e-7)
    ks = np.arange(P1)
    L = ref["L"][:, None]
    np.testing.assert_array_equal(got["bits"] & (wf._PM_ATEND | wf._PM_BRIDGE),
                                  ref["pm"][..., 0] & (wf._PM_ATEND
                                                       | wf._PM_BRIDGE))
    np.testing.assert_array_equal(got["bits"] & wf._ROW_VALID,
                                  ((ks >= 1) & (ks <= L)) * wf._ROW_VALID)
    assert got["rows"].dtype == np.int32
    np.testing.assert_array_equal(
        got["rows"], np.stack([np.broadcast_to(ks, ref["xoff"].shape),
                               ref["xoff"], ref["jlo"], ref["jhi"]], -1))
    np.testing.assert_allclose(got["tables"], _jax_tables(params), rtol=1e-6)
    sx, sy, _, _, lx, ly = args
    for k, seq, n, flip in (("sx_pad", sx, lx, False), ("sy_pad", sy, ly, True)):
        s = np.where(np.arange(seq.shape[1]) < n[:, None], seq, 5)
        s = s[:, ::-1] if flip else s
        pad = np.full((len(s), W + 1), 5)
        np.testing.assert_array_equal(got[k], np.concatenate([pad, s, pad], 1),
                                      err_msg=k)


def _window_case():
    """A small anchored pair (tests/test_torch_prep.py's) as the streaming
    engines hold it, at pad K + W + 1 (``_prep_window``'s)."""
    x, y, band = _case(n=120, seed=11)
    L = len(x) + len(y)
    frame = fb_streaming._pad_frame(
        *fb_streaming._host_frame(band.offsets, band.widths), L + 64)
    pad_off = WINDOW_ROWS + WINDOW_W + 1
    sx, sy, fr = fb_streaming._device_pair(encode(x), encode(y), frame,
                                           pad_off, "cpu")
    return sx, sy, fr, frame, len(y), L, pad_off


def _check_window(got, ref, sx, sy, LY, pad_off, what):
    """The window row part against a JAX window prep: the selects exactly,
    and the slot streams that ``streams_reference`` builds from the rows,
    bits and tables (pm exactly, the emissions within rtol 1e-6)."""
    for k in wf.SELECTS:
        np.testing.assert_array_equal(got[k][0].numpy(),
                                      np.asarray(ref[k])[:, 0],
                                      err_msg=f"{what} {k}")
    st = wf.streams_reference(got["tables"], sx, sy, LY, pad_off, got["rows"],
                              got["bits"], WINDOW_W)
    np.testing.assert_array_equal(st["pm"][0].numpy(), np.asarray(ref["pm"]),
                                  err_msg=f"{what} pm")
    for k in STREAMS:
        np.testing.assert_allclose(st[k][0].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("sm_name", ["state_machine5", "state_machine3"])
def test_rows_window_reference_matches_jax_prep_window(sm_name):
    """Windows from several starts (one past L) against _prep_window
    (the exact engine's window prep)."""
    import jax.numpy as jnp

    from cpecan_tpu.models import state_machine as jax_sm
    from cpecan_tpu.ops import fb_segmented as jax_seg

    sx, sy, fr, frame, LY, L, pad_off = _window_case()
    params = getattr(jax_sm, sm_name)().device_params()
    hmm = _hmm(sm_name)
    g = [jnp.asarray(a) for a in frame]
    for k0 in (1, 17, L - 10, L + 5):
        ref, _ = jax_seg._prep_window(
            params, jnp.asarray(sx[0].numpy()), jnp.asarray(sy[0].numpy()),
            *g, k0, LY, L, WINDOW_ROWS, WINDOW_W, True)
        got = wf.rows_window_reference(hmm, fr, L, torch.tensor([k0]),
                                       WINDOW_ROWS)
        _check_window(got, ref, sx, sy, LY, pad_off, k0)


def test_rows_window_reference_matches_jax_prep_one():
    """A burn-in window with a slot base and an emitted row range against
    _prep_one (the parallel engine's window prep)."""
    import jax.numpy as jnp

    from cpecan_tpu.models import state_machine as jax_sm
    from cpecan_tpu.ops import fb_parallel as jax_par

    sx, sy, fr, frame, LY, L, pad_off = _window_case()
    params = jax_sm.state_machine5().device_params()
    hmm = _hmm("state_machine5")
    g = [jnp.asarray(a) for a in frame]
    K = 8
    for s, k0, base in ((1, 1, 0), (9, 17, 2), (L - 12, L - 4, -3)):
        ref = jax_par._prep_one(
            params, jnp.asarray(sx[0].numpy()), jnp.asarray(sy[0].numpy()),
            *g, s, k0, base, K, LY, L, WINDOW_ROWS, WINDOW_W, pad_off)
        got = wf.rows_window_reference(
            hmm, fr, L, torch.tensor([s]), WINDOW_ROWS,
            base=torch.tensor([base]), emit=torch.tensor([[k0, k0 + K]]))
        _check_window(got, ref, sx, sy, LY, pad_off, (s, k0, base))


@pytest.mark.parametrize("kind", ["state_machine5", "state_machine3", "nan"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int16])
def test_precompute_after_the_split_is_the_one_pass_prep(kind, dtype):
    """precompute (rows, then streams) returns the one-pass torch prep's
    tensors bit for bit with the band, lengths and symbols in another
    integer dtype than int32, and equals its int32 run."""
    hmm = _hmm(kind)
    args = _batch()
    other = [a.to(dtype) if i < 6 else a for i, a in enumerate(args)]
    got = wf.precompute(hmm, *other, width=W)
    _assert_same(got, _one_pass_precompute(hmm, *args, W), got, kind)
    _assert_same(got, wf.precompute(hmm, *args, width=W), got, kind)


# --------------------------------------------------------------------------
# The card route without a card: meta tensors and a stub library
# --------------------------------------------------------------------------


@pytest.mark.parametrize("width", [W, 4097, 8200])
def test_rows_route_has_one_entry_point(width):
    assert wf.kernel_route("rows", torch.device("cpu"), width) is None
    entry = wf.kernel_route("rows", torch.device("cuda"), width)
    assert entry == "cpecan_wavefront_rows"
    assert entry in _kernels._SIGNATURES


@pytest.fixture
def meta_card(monkeypatch):
    """Meta tensors stand in for the card's; the kernel library is a stub
    that records its calls; a plain row version raises."""
    lib = _StubLibrary()
    monkeypatch.setattr(_kernels, "load", lambda: lib)
    monkeypatch.setattr(wf, "_on_card", lambda x: x.device.type == "meta")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))

    def plain(*a, **k):
        raise AssertionError("a plain row version ran for device tensors")

    for name in ("rows_reference", "rows_window_reference"):
        monkeypatch.setattr(wf, name, plain)
    wf.reset_launch_counts()
    return lib


def test_batch_rows_launch_the_row_kernel(meta_card):
    """prep_rows on device tensors: one call of the entry point with the
    signature's argument count, the inputs' element types (uint8
    symbols, int64 band, int32 lengths, bool flags), LX/LY, B/R/W, one
    launch counted, and every output at its contract's dtype and shape."""
    hmm = _hmm("state_machine5").to("meta")
    sx, sy, offsets, widths, lx, ly, rl, rr = _batch("meta")
    B, R = offsets.shape
    out = wf.prep_rows(hmm, sx.to(torch.uint8), sy, offsets.long(), widths,
                       lx, ly, rl, rr, W)
    (name, a), = meta_card.calls
    assert name == "cpecan_wavefront_rows"
    assert a[16:24] == (-1, 4, 8, 4, 4, 4, -1, -1)
    assert a[24:26] == (sx.shape[1], sy.shape[1])
    assert a[-4:-1] == (B, R, W)
    assert wf.LAUNCHES == {**{k: 0 for k in wf.LAUNCHES}, "rows": 1}
    shapes = {"tables": ((35,), torch.float32), "rows": ((B, R, 4), torch.int32),
              "bits": ((B, R), torch.int8),
              "sx_pad": ((B, sx.shape[1] + 2 * W + 2), torch.int8),
              "sy_pad": ((B, sy.shape[1] + 2 * W + 2), torch.int8),
              "L": ((B,), torch.int64), "m0log": ((B,), torch.float32),
              "F0": ((B, 5, W), torch.float32),
              "end_row": ((B, 5, W), torch.float32)}
    shapes.update({k: ((B, R), torch.int64) for k in ("xoff", "jlo", "jhi")})
    shapes.update({k: ((B, R), torch.int8) for k in wf.SELECTS})
    assert set(out) == set(shapes)
    for k, (shape, dtype) in shapes.items():
        assert out[k].shape == shape and out[k].dtype == dtype, k
        assert out[k].is_contiguous(), k


def test_window_rows_launch_the_row_kernel(meta_card):
    """prep_rows_window on device tensors: the window form (no batch
    inputs, zero element types), the frame's length, L and n/R."""
    hmm = _hmm("state_machine5").to("meta")
    fr = {k: torch.zeros(90, dtype=torch.int64, device="meta")
          for k in ("xoff", "delta", "jlo", "jhi")}
    starts = torch.zeros(4, dtype=torch.int64, device="meta")
    out = wf.prep_rows_window(hmm, fr, 70, starts, WINDOW_ROWS, base=starts,
                              emit=torch.zeros(4, 2, dtype=torch.int64,
                                               device="meta"))
    (name, a), = meta_card.calls
    assert name == "cpecan_wavefront_rows"
    assert a[16:26] == (0,) * 10
    assert a[30] == 90 and a[34] == 70
    assert a[-4:-1] == (4, WINDOW_ROWS, 1)
    assert wf.LAUNCHES["rows"] == 1
    assert set(out) == set(WINDOW_KEYS)
    assert out["rows"].shape == (4, WINDOW_ROWS, 4)


def test_rows_wrappers_reject_what_the_kernel_cannot_run(meta_card):
    hmm = _hmm("state_machine5").to("meta")
    args = _batch("meta")
    with pytest.raises(TypeError):  # a float band
        wf.prep_rows(hmm, *args[:2], args[2].float(), *args[3:], W)
    with pytest.raises(ValueError):  # lengths of another batch
        wf.prep_rows(hmm, *args[:4], args[4][:2], *args[5:], W)
    fr = {k: torch.zeros(90, dtype=torch.int64, device="meta")
          for k in ("xoff", "delta", "jlo", "jhi")}
    with pytest.raises(TypeError):  # int32 starts
        wf.prep_rows_window(hmm, fr, 70, torch.zeros(4, dtype=torch.int32,
                                                     device="meta"), 8)
    assert not meta_card.calls


# --------------------------------------------------------------------------
# On the card: wavefront_rows against the plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_band(rng, B, P, Wd, dtype, negative):
    """B random bands of P+1 diagonals (drifting offsets, negative k +
    offset on some rows when ``negative``, widths 0..Wd), random symbols,
    a zero-length pair first, random ragged flags."""
    n = max(P // 2, 1)
    lx, ly = rng.integers(0, n + 1, B), rng.integers(0, n + 1, B)
    lx[0] = ly[0] = 0
    offs = (np.cumsum(rng.integers(0, 2, (B, P + 1)), 1)
            + rng.integers(-3, 4, (B, P + 1))
            - (rng.integers(0, 40, (B, 1)) if negative else 0))
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    return [t(rng.integers(0, 5, (B, n))), t(rng.integers(0, 5, (B, n + 3))),
            t(offs), t(rng.integers(0, Wd + 1, (B, P + 1))), t(lx), t(ly),
            torch.from_numpy(rng.random(B) < 0.5),
            torch.from_numpy(rng.random(B) < 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["state_machine5", "state_machine3", "nan"])
def test_rows_kernel_equals_plain_version_on_card(cuda_device, kind):
    """wavefront_rows writes the plain versions' outputs bit for bit on the
    card: test_torch_wavefront.py's batch, random bands with R above the
    block's threads and R = 1, negative k + offset, int16/int64 inputs, a
    NaN start probability (the "nan" model), and windows with and without
    slot bases and emitted ranges."""
    hmm = _hmm(kind)
    if kind == "nan":
        p = {k: v.numpy().copy() for k, v in hmm.named_buffers()}
        p["start"][1] = np.nan
        p["ragged_end"][0] = np.inf
        hmm = PairHMM(p)
    hmm = hmm.to(cuda_device)
    rng = np.random.default_rng(3)
    on = lambda xs: [x.to(cuda_device) for x in xs]
    batches = [(_batch(cuda_device), W)] + [
        (on(_random_band(rng, B, P, Wd, dt, neg)), Wd)
        for B, P, Wd, dt, neg in ((3, 600, 36, torch.int32, False),
                                  (2, 0, 32, torch.int64, False),
                                  (4, 300, 41, torch.int16, True),
                                  (3, 40, 1, torch.int64, True))]
    for args, Wd in batches:
        wf.reset_launch_counts()
        got = wf.prep_rows(hmm, *args, Wd)
        assert wf.LAUNCHES["rows"] == 1
        want = wf.rows_reference(hmm, *args, Wd)
        torch.cuda.synchronize()
        _assert_same(got, want, BATCH_KEYS, (kind, Wd))
    if kind == "nan":
        assert got["F0"].isnan().any() and (got["m0log"] == 0).all()

    x, y, band = _case(n=120, seed=11)
    L = len(x) + len(y)
    frame = fb_streaming._pad_frame(
        *fb_streaming._host_frame(band.offsets, band.widths), L + 64)
    _, _, fr = fb_streaming._device_pair(encode(x), encode(y), frame, 90,
                                         cuda_device)
    starts = torch.tensor([0, 1, 17, 40, L - 10, L + 5], device=cuda_device)
    base = torch.tensor([1, 0, 2, -3, 5, 0], device=cuda_device)
    emit = torch.stack([starts + 3, starts + 20], 1)
    for R in (WINDOW_ROWS, 1, 300):
        for kw in ({}, {"base": base}, {"base": base, "emit": emit}):
            got = wf.prep_rows_window(hmm, fr, L, starts, R, **kw)
            want = wf.rows_window_reference(hmm, fr, L, starts, R, **kw)
            _assert_same(got, want, WINDOW_KEYS, (kind, R, sorted(kw)))


@pytest.mark.cuda
def test_precompute_is_two_launches_on_card(cuda_device):
    """precompute and precompute_window each make two CUDA launches (the
    row kernel, then the prep kernel), counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    hmm = _hmm("state_machine5").to(cuda_device)
    args = _batch(cuda_device)
    x, y, band = _case(n=120, seed=11)
    L = len(x) + len(y)
    frame = fb_streaming._pad_frame(
        *fb_streaming._host_frame(band.offsets, band.widths), L + 64)
    sx, sy, fr = fb_streaming._device_pair(encode(x), encode(y), frame, 90,
                                           cuda_device)
    starts = torch.tensor([1, 17, 40], device=cuda_device)
    calls = (lambda: wf.precompute(hmm, *args, width=W),
             lambda: wf.precompute_window(hmm, sx, sy, fr, len(y), L, starts,
                                          WINDOW_ROWS, WINDOW_W, 90))
    dev_us = lambda e: (getattr(e, "self_device_time_total", 0)
                        or getattr(e, "self_cuda_time_total", 0))
    for call in calls:
        call()
        # a session's first launches can go unrecorded: each session
        # first runs torch.cuda._sleep's spin kernel (not counted); the
        # profiler never invents an event, so the most of a few sessions
        # and every name seen
        most, names = 0, set()
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                call()
                torch.cuda.synchronize()
            kernels = {e.key: e.count for e in prof.key_averages()
                       if dev_us(e) > 0 and "spin_kernel" not in e.key}
            most = max(most, sum(kernels.values()))
            names |= set(kernels)
        assert most == 2, names
        assert any("wavefront_rows" in k for k in names), names
        assert any("wavefront_prep" in k for k in names), names
