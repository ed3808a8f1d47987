"""Banded-wavefront forward-backward: stream prep, plain versions, kernels.

Counterpart of cpecan_tpu/ops/fb_wavefront.py. Two hand-written CUDA
kernels (csrc/wavefront.cu) replace its Pallas kernels on this path:

 * ``fwd`` <- ``_fwd_kernel``: forward wavefront from the start row F0.
   Per diagonal it forms the gap-X, gap-Y and match terms through the
   statically nonzero transitions, rescales by the row max every
   NORM_EVERY-th diagonal (mf records exactly the applied scale) and
   emits the F rows, mf and the bridge vector.
 * ``bwd`` <- ``_bwd_kernel``: backward wavefront high to low. Per
   diagonal it forms the total (F.B dot plus the one-step match bridge,
   reference diagonalCalculationTotalProbability) and writes the
   posteriors gated by the pm bits; no B tensor reaches device memory.

Each wrapper runs its plain PyTorch version (``fwd_reference`` /
``bwd_reference``) for a CPU tensor, and launches its kernel or raises
for a CUDA tensor. The plain versions follow the Pallas bodies line for
line in arithmetic and serve as the kernels' oracle.

Layout is batch-major: streams (B, R, W) with R = P+1 diagonals and W
band slots; the forward intermediate F is (B, R, S, W); the row-constant
shift selects are (B, R) int8. The TPU-only machinery (lane packing,
tile picking, the VMEM envelope, group padding) has no counterpart.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as tF

from cpecan_tpu_torch.ops import _kernels
from cpecan_tpu_torch.ops import fb as _fb

# Apply the per-row max-rescale only on diagonals k with
# k % NORM_EVERY == NORM_EVERY - 1 (the schedule of the JAX engines, so
# the mf/mb streams compare element by element).
NORM_EVERY = 4

# Device-memory budget for the (B, R, S, W) forward intermediate; larger
# batches run in slices.
_F_BUDGET = 3 << 30

# pm bitfield (int8 per (row, slot))
_PM_MATCH = 1  # posterior-match valid: 1<=k<=L & slot & x>0 & y>0
_PM_GAPX = 2
_PM_GAPY = 4
_PM_ATEND = 8  # k == L (broadcast over slots)
_PM_BRIDGE = 16  # 1 <= k < L (broadcast over slots)

# Widest band the kernels take: 1024 threads x 4 slots per thread.
MAX_KERNEL_WIDTH = 4096

# Transition structures compiled into the kernels, {S: triples}, read
# from csrc/wavefront.cu's CPECAN_NZ5 / CPECAN_NZ3. A model whose active
# set is a subset runs on the same code: its absent transitions are 0
# and add exact zeros.
KERNEL_NZ = _kernels.kernel_structures()

# Kernel launches since the last reset, per kernel. Incremented only
# where a wrapper launches its kernel.
LAUNCHES = {"fwd": 0, "bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nonzero_transitions(t_log) -> tuple:
    """Static (class, from, to) triples of active transitions from the
    numpy/host copy of the (3, S, S) log transition tensor."""
    t = np.asarray(t_log)
    triples = []
    for c in range(3):
        for f in range(t.shape[1]):
            for to in range(t.shape[2]):
                if np.isfinite(t[c, f, to]):
                    triples.append((c, f, to))
    return tuple(triples)


def _shift_l(x):
    """out[..., j] = x[..., j+1], zero fill."""
    return tF.pad(x[..., 1:], (0, 1))


def _shift_r(x):
    """out[..., j] = x[..., j-1], zero fill."""
    return tF.pad(x[..., :-1], (1, 0))


# ---------------------------------------------------------------------------
# Stream preparation
# ---------------------------------------------------------------------------


def precompute(hmm, sx, sy, offsets, widths, lx, ly, ragged_left,
               ragged_right, width: int) -> dict:
    """Batched port of ``_precompute_one``: masked emission streams,
    row shift selects, the pm bitfield, F0 and end rows.

    sx, sy: (B, n) int symbols; offsets, widths: (B, P+1) band tensors;
    lx, ly: (B,) lengths; ragged_left/right: (B,) bool. Returns
    ex/ey/em/efx/efy/efm (B, P+1, W) f32 with slot validity folded in;
    a/b1/b0/abw/c1/c0/bm1/bm0 (B, P+1) int8; pm (B, P+1, W) int8;
    F0 and end_row (B, S, W) f32; m0log (B,); xoff/jlo/jhi (B, P+1)
    int64; L (B,) int64.
    """
    dev = offsets.device
    W = int(width)
    S = hmm.state_number
    B, P1 = offsets.shape
    P = P1 - 1
    prob = _fb._prob_params(hmm)
    lx = lx.long()
    ly = ly.long()
    L = lx + ly

    xoff, delta, jlo, jhi = _fb._frame_from_band(offsets, widths)

    LX = sx.shape[1]
    LY = sy.shape[1]
    sent = torch.tensor(_fb._SENTINEL, dtype=torch.int8, device=dev)
    sx_s = torch.where(torch.arange(LX, device=dev) < lx[:, None],
                       sx.to(torch.int8), sent)
    sy_s = torch.where(torch.arange(LY, device=dev) < ly[:, None],
                       sy.to(torch.int8), sent)
    pad = torch.full((B, W + 1), _fb._SENTINEL, dtype=torch.int8,
                     device=dev)
    sx_pad = torch.cat([pad, sx_s, pad], dim=1)
    sy_pad = torch.cat([pad, torch.flip(sy_s, dims=[1]), pad], dim=1)
    wx, wy = _fb._symbol_windows(sx_pad, sy_pad, xoff, LY, W)

    e_x, e_y, e_m = _fb._emissions(prob, wx[..., :W], wy[..., 1:])
    ef_x, ef_y, ef_m = _fb._emissions(prob, wx[..., 1:], wy[..., :W])

    js = torch.arange(W, device=dev)
    ks = torch.arange(P1, device=dev)
    slot_ok = (js >= jlo[..., None]) & (js <= jhi[..., None])
    fm = slot_ok.to(torch.float32)
    e_x, e_y, e_m = e_x * fm, e_y * fm, e_m * fm
    ef_x, ef_y, ef_m = ef_x * fm, ef_y * fm, ef_m * fm

    d_km1 = torch.cat([delta[:, :1], delta[:, :-1]], dim=1)
    dmid = delta + d_km1 - 1
    delta_pad = torch.cat([delta, delta.new_zeros(B, 2)], dim=1)
    d1 = delta_pad[:, 1:P + 2]
    dsum2 = d1 + delta_pad[:, 2:P + 3]
    dmid1 = torch.cat([dmid[:, 1:], dmid.new_zeros(B, 1)], dim=1)

    i8 = lambda cond: cond.to(torch.int8)
    xs = xoff[..., None] + js
    ys = ks[:, None] - xs
    valid_k = ((ks >= 1) & (ks <= L[:, None]))[..., None] & slot_ok
    row_bits = (torch.where(ks == L[:, None], _PM_ATEND, 0)
                | torch.where((ks >= 1) & (ks < L[:, None]), _PM_BRIDGE, 0))
    pm = (torch.where(valid_k & (xs > 0) & (ys > 0), _PM_MATCH, 0)
          | torch.where(valid_k & (xs > 0), _PM_GAPX, 0)
          | torch.where(valid_k & (ys > 0), _PM_GAPY, 0)
          | row_bits[..., None])

    start_vec = torch.where(ragged_left.bool()[:, None],
                            prob["ragged_start"], prob["start"])
    F0 = torch.zeros(B, S, W, dtype=torch.float32, device=dev)
    F0[:, :, 0] = start_vec
    m0 = F0.amax(dim=(1, 2))
    m0 = torch.where(m0 > 0, m0, torch.ones_like(m0))
    F0 = F0 / m0[:, None, None]

    end_vec = torch.where(ragged_right.bool()[:, None],
                          prob["ragged_end"], prob["end"])
    slot_ok_L = fm[torch.arange(B, device=dev), L.clamp(0, P)]
    end_row = end_vec[:, :, None] * slot_ok_L[:, None, :]

    return {
        "ex": e_x, "ey": e_y, "em": e_m,
        "efx": ef_x, "efy": ef_y, "efm": ef_m,
        "a": i8(delta == 1), "b1": i8(dmid == 1), "b0": i8(dmid == 0),
        "abw": i8(d1 == 1), "c1": i8(dsum2 == 2), "c0": i8(dsum2 == 1),
        "bm1": i8(dmid1 == 1), "bm0": i8(dmid1 == 0),
        "pm": pm.to(torch.int8),
        "F0": F0, "m0log": torch.log(m0), "end_row": end_row,
        "xoff": xoff, "jlo": jlo, "jhi": jhi, "L": L,
    }


# ---------------------------------------------------------------------------
# Plain versions (the kernels' oracle; the engine for CPU tensors)
# ---------------------------------------------------------------------------


def fwd_reference(t, ex, ey, em, a, b1, b0, F0, nz):
    """Forward wavefront, vectorised over (B, S, W) with a loop over
    diagonals; follows ``_fwd_kernel`` (fresh, phase 0) in arithmetic.

    t: (3S, S) transition probabilities; ex/ey/em (B, R, W) f32;
    a/b1/b0 (B, R) int8; F0 (B, S, W). Returns F (B, R, S, W),
    bv (B, R, W) and mf (B, R)."""
    B, R, W = ex.shape
    S = F0.shape[1]
    tv = t.detach().cpu().reshape(3 * S, S).tolist()
    F = ex.new_empty(B, R, S, W)
    bv = ex.new_zeros(B, R, W)
    mf = ex.new_zeros(B, R)
    F[:, 0] = F0
    zero = ex.new_zeros(B, W)
    F1 = list(F0.unbind(1))
    F2 = [zero] * S
    invm = ex.new_ones(B, 1)

    xs_rows = sorted({f for cl, f, _ in nz if cl == 0})
    ys_rows = sorted({f for cl, f, _ in nz if cl == 2})
    mid_rows = sorted({f for cl, f, _ in nz if cl == 1})
    match_tm = [(f, to) for cl, f, to in nz if cl == 1 and to == 0]

    for i in range(1, R):
        ai = (a[:, i] != 0)[:, None]
        b1i = (b1[:, i] != 0)[:, None]
        b0i = (b0[:, i] != 0)[:, None]
        exi, eyi = ex[:, i], ey[:, i]
        # lower neighbour (consumes X): shift d-1 in {-1,0}
        lx = {f: torch.where(ai, F1[f], _shift_r(F1[f])) * exi
              for f in xs_rows}
        # upper neighbour (consumes Y): shift d in {0,1}
        ly = {f: torch.where(ai, _shift_l(F1[f]), F1[f]) * eyi
              for f in ys_rows}
        # middle neighbour (consumes XY): F_{k-2} at dmid in {-1,0,1}
        emi = em[:, i] * invm
        lm = {f: torch.where(b1i, _shift_l(F2[f]),
                             torch.where(b0i, F2[f], _shift_r(F2[f]))) * emi
              for f in mid_rows}

        cur = [None] * S
        for cl, f, to in nz:
            term = (lx[f] if cl == 0 else lm[f] if cl == 1 else ly[f])
            term = term * tv[cl * S + f][to]
            cur[to] = term if cur[to] is None else cur[to] + term
        cur = [zero if c is None else c for c in cur]

        # bridgevec[r] = (sum_f F_{r-2}[f] * t_m[f, match]) / m_{r-1}
        bvr = zero
        for f, to in match_tm:
            bvr = bvr + F2[f] * tv[S + f][to]
        bv[:, i] = bvr * invm

        if i % NORM_EVERY == NORM_EVERY - 1:
            m = torch.stack(cur, dim=1).amax(dim=(1, 2))[:, None]
            m = torch.where(m > 0, m, torch.ones_like(m))
            mf[:, i] = torch.log(m[:, 0])
            r = 1.0 / m
            F_new = [c * r for c in cur]
            invm = r
        else:
            F_new = cur
            invm = torch.ones_like(invm)
        F[:, i] = torch.stack(F_new, dim=1)
        F1, F2 = F_new, F1
    return F, bv, mf


def bwd_reference(t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm,
                  end_row, nz, mode: str = "posterior_match"):
    """Backward+posterior wavefront (high to low), vectorised over
    (B, S, W); follows ``_bwd_kernel`` (batch path, phase 0).

    Returns (posts, mb, total_raw): posts is [post_match] or
    [post_match, post_gap_x, post_gap_y], each (B, R, W); mb and
    total_raw are (B, R)."""
    B, R, W = efx.shape
    S = F.shape[2]
    tv = t.detach().cpu().reshape(3 * S, S).tolist()
    n_out = 3 if mode == "posterior_all" else 1
    posts = [efx.new_empty(B, R, W) for _ in range(n_out)]
    mb = efx.new_empty(B, R)
    tot = efx.new_empty(B, R)

    zero = efx.new_zeros(B, W)
    B1 = [zero] * S
    B2 = [zero] * S
    invb = efx.new_ones(B, 1)
    em_next = zero
    bvn = zero

    x_targets = sorted({to for cl, _, to in nz if cl == 0})
    y_targets = sorted({to for cl, _, to in nz if cl == 2})
    m_targets = sorted({to for cl, _, to in nz if cl == 1})

    for ii in range(R - 1, -1, -1):
        abwi = (abw[:, ii] != 0)[:, None]
        c1i = (c1[:, ii] != 0)[:, None]
        c0i = (c0[:, ii] != 0)[:, None]
        bm1i = (bm1[:, ii] != 0)[:, None]
        bm0i = (bm0[:, ii] != 0)[:, None]
        pmi = pm[:, ii].to(torch.int32)

        # receive from k+1: x-class at shift 1-d1 in {0,1}; y at -d1 in
        # {-1,0}; from k+2: m-class at shift 1-dsum2 in {-1,0,1}
        bxe = {to: torch.where(abwi, B1[to], _shift_l(B1[to])) * efx[:, ii]
               for to in x_targets}
        bye = {to: torch.where(abwi, _shift_r(B1[to]), B1[to]) * efy[:, ii]
               for to in y_targets}
        efmi = efm[:, ii] * invb
        bme = {to: torch.where(c1i, _shift_r(B2[to]),
                               torch.where(c0i, B2[to], _shift_l(B2[to])))
               * efmi for to in m_targets}

        raw = [None] * S
        for cl, f, to in nz:
            term = (bxe[to] if cl == 0 else bme[to] if cl == 1 else bye[to])
            term = term * tv[cl * S + f][to]
            raw[f] = term if raw[f] is None else raw[f] + term
        raw = [zero if r_ is None else r_ for r_ in raw]

        at_end = (pmi & _PM_ATEND) != 0  # (B, W), row-constant
        ae_f = at_end.to(torch.float32)
        ae_col = ae_f[:, :1]
        for f in range(S):
            raw[f] = torch.where(at_end, end_row[:, f], raw[f])

        if ii % NORM_EVERY == NORM_EVERY - 1:
            m = torch.stack(raw, dim=1).amax(dim=(1, 2))[:, None]
            # m := m where (m > 0 and not at_end) else 1
            good = (m > 0).to(torch.float32) * (1.0 - ae_col)
            m = m * good + (1.0 - good)
            r = 1.0 / m
            B_new = [x * r for x in raw]
            mb[:, ii] = torch.log(m[:, 0])
        else:
            r = torch.ones_like(ae_col)
            B_new = raw
            mb[:, ii] = 0.0

        # per-diagonal total: dot + bridge (reference :636-653)
        F_row = F[:, ii].unbind(1)
        br_sh = torch.where(bm1i, _shift_l(bvn),
                            torch.where(bm0i, bvn, _shift_r(bvn)))
        dot = torch.sum(F_row[0] * B_new[0], dim=-1, keepdim=True)
        for s in range(1, S):
            dot = dot + torch.sum(F_row[s] * B_new[s], dim=-1, keepdim=True)
        bridge = torch.sum(br_sh * em_next * B1[0], dim=-1, keepdim=True)
        bvalid = ((pmi[:, :1] & _PM_BRIDGE) != 0).to(torch.float32)
        total = dot + bridge * r * bvalid
        tot_ok = (total > 0).to(torch.float32)
        invt = tot_ok / (total + (1.0 - tot_ok))
        tot[:, ii] = (torch.log(total + (1.0 - tot_ok)) * tot_ok)[:, 0]

        gates = (_PM_MATCH, _PM_GAPX, _PM_GAPY)
        for s in range(n_out):
            posts[s][:, ii] = torch.where(
                (pmi & gates[s]) != 0, F_row[s] * B_new[s] * invt, 0.0)

        B2 = [x * (1.0 - ae_f) for x in B1]
        B1 = B_new
        invb = r * (1.0 - ae_col) + ae_col
        em_next = em[:, ii]
        bvn = bv[:, ii]
    return posts, mb, tot


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _check_launch(name: str, S: int, W: int, nz, tensors: dict) -> None:
    """Structure, width, device, dtype, shape and contiguity checks before
    a launch; ``tensors`` maps a name to (tensor, dtype, shape)."""
    if S not in KERNEL_NZ:
        raise ValueError(f"{name}: kernels support S in (3, 5), got {S}")
    extra = set(nz) - set(KERNEL_NZ[S])
    if extra:
        raise ValueError(
            f"{name}: transitions {sorted(extra)} are outside the kernels' "
            f"{S}-state structure")
    if not 1 <= W <= MAX_KERNEL_WIDTH:
        raise ValueError(
            f"{name}: band width {W} outside the kernels' 1..{MAX_KERNEL_WIDTH}")
    dev = None
    for key, (x, dtype, shape) in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {x.device}, not cuda")
        if dev is not None and x.device != dev:
            raise ValueError(f"{name}: {key} is on {x.device}, not {dev}")
        dev = x.device
        if x.dtype != dtype:
            raise TypeError(f"{name}: {key} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: {key} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def _launch(name: str, fn_name: str, device, *args) -> None:
    lib = _kernels.load()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_kernels.error_string(err)} (cuda error {err})")


def _host_transitions(t, S: int):
    """(3S, S) float32 transitions on the host: the launch copies them
    into the kernel's arguments."""
    return t.detach().to("cpu", torch.float32).reshape(3 * S, S).contiguous()


def fwd(t, ex, ey, em, a, b1, b0, F0, nz):
    """Forward wavefront: ``fwd_reference`` for CPU tensors, the CUDA
    kernel ``wavefront_fwd`` for CUDA tensors. Same contract as
    ``fwd_reference``; ``t`` may live on the host (no device sync)."""
    if ex.device.type == "cpu":
        return fwd_reference(t, ex, ey, em, a, b1, b0, F0, nz)
    B, R, W = ex.shape
    S = F0.shape[1]
    f32, i8 = torch.float32, torch.int8
    row, rows = (B, R, W), (B, R)
    _check_launch("fwd", S, W, nz, {
        "ex": (ex, f32, row), "ey": (ey, f32, row), "em": (em, f32, row),
        "a": (a, i8, rows), "b1": (b1, i8, rows), "b0": (b0, i8, rows),
        "F0": (F0, f32, (B, S, W))})
    th = _host_transitions(t, S)
    F = torch.empty(B, R, S, W, dtype=f32, device=ex.device)
    bv = torch.empty(B, R, W, dtype=f32, device=ex.device)
    mf = torch.empty(B, R, dtype=f32, device=ex.device)
    _launch("fwd", "cpecan_wavefront_fwd", ex.device, S, _ptr(th),
            _ptr(ex), _ptr(ey), _ptr(em), _ptr(a), _ptr(b1), _ptr(b0),
            _ptr(F0), _ptr(F), _ptr(bv), _ptr(mf), B, R, W)
    LAUNCHES["fwd"] += 1
    return F, bv, mf


def bwd(t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm, end_row, nz,
        mode: str = "posterior_match"):
    """Backward+posterior wavefront: ``bwd_reference`` for CPU tensors,
    the CUDA kernel ``wavefront_bwd`` for CUDA tensors."""
    if efx.device.type == "cpu":
        return bwd_reference(t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1,
                             bm0, pm, end_row, nz, mode)
    B, R, W = efx.shape
    S = F.shape[2]
    f32, i8 = torch.float32, torch.int8
    row, rows = (B, R, W), (B, R)
    _check_launch("bwd", S, W, nz, {
        "efx": (efx, f32, row), "efy": (efy, f32, row),
        "efm": (efm, f32, row), "em": (em, f32, row),
        "F": (F, f32, (B, R, S, W)), "bv": (bv, f32, row),
        "abw": (abw, i8, rows), "c1": (c1, i8, rows), "c0": (c0, i8, rows),
        "bm1": (bm1, i8, rows), "bm0": (bm0, i8, rows), "pm": (pm, i8, row),
        "end_row": (end_row, f32, (B, S, W))})
    th = _host_transitions(t, S)
    n_out = 3 if mode == "posterior_all" else 1
    posts = [torch.empty(B, R, W, dtype=f32, device=efx.device)
             for _ in range(n_out)]
    mb = torch.empty(B, R, dtype=f32, device=efx.device)
    tot = torch.empty(B, R, dtype=f32, device=efx.device)
    px, py = ((_ptr(posts[1]), _ptr(posts[2])) if n_out == 3
              else (ctypes.c_void_p(None), ctypes.c_void_p(None)))
    _launch("bwd", "cpecan_wavefront_bwd", efx.device, S, _ptr(th),
            _ptr(efx), _ptr(efy), _ptr(efm), _ptr(em), _ptr(F), _ptr(bv),
            _ptr(abw), _ptr(c1), _ptr(c0), _ptr(bm1), _ptr(bm0), _ptr(pm),
            _ptr(end_row), _ptr(posts[0]), px, py, _ptr(mb), _ptr(tot),
            B, R, W)
    LAUNCHES["bwd"] += 1
    return posts, mb, tot


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

MODES = ("forward", "posterior_match", "posterior_all")


def fb_pass_batch_wavefront(hmm, sx, sy, offsets, widths, lx, ly,
                            ragged_left, ragged_right,
                            mode: str = "posterior_match", width: int = 0):
    """Batched banded FB pass through the wavefront kernels (plain
    versions on CPU tensors).

    Same keys as cpecan_tpu's ``fb_pass_batch_wavefront``: mf and log_fwd,
    plus mb, total_raw and post_match (and post_gap_x/post_gap_y in
    posterior_all mode), each sliced to P+1 rows. All tensors and the
    PairHMM must be on one device."""
    if mode == "expectation":
        raise NotImplementedError(
            "expectation mode needs the _exp_kernel port (the EM slice)")
    if mode not in MODES:
        raise ValueError(f"wavefront engine does not support mode={mode!r}")
    S = hmm.state_number
    B, P1 = offsets.shape
    W = int(width)

    per_pair = P1 * S * W * 4
    bmax = max(1, _F_BUDGET // per_pair)
    if B > bmax:
        outs = [fb_pass_batch_wavefront(
            hmm, sx[i:i + bmax], sy[i:i + bmax], offsets[i:i + bmax],
            widths[i:i + bmax], lx[i:i + bmax], ly[i:i + bmax],
            ragged_left[i:i + bmax], ragged_right[i:i + bmax], mode=mode,
            width=W) for i in range(0, B, bmax)]
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}

    pre = precompute(hmm, sx, sy, offsets, widths, lx, ly, ragged_left,
                     ragged_right, W)
    t = hmm.t_prob_host
    F, bv, mf = fwd(t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"],
                    pre["b0"], pre["F0"], hmm.nz)
    mf[:, 0] += pre["m0log"]

    # forward log prob at diagonal L (end-state dot), per pair; end_row is
    # the end vector masked to the slots of row L and F is zero off-band
    FL = F[torch.arange(B, device=F.device), pre["L"].clamp(0, P1 - 1)]
    log_fwd = torch.log(torch.sum(FL * pre["end_row"], dim=(1, 2)))

    out = {"mf": mf, "log_fwd": log_fwd}
    if mode == "forward":
        return out
    posts, mb, tot = bwd(t, pre["efx"], pre["efy"], pre["efm"], pre["em"], F,
                         bv, pre["abw"], pre["c1"], pre["c0"], pre["bm1"],
                         pre["bm0"], pre["pm"], pre["end_row"], hmm.nz, mode)
    out["mb"] = mb
    out["total_raw"] = tot
    out["post_match"] = posts[0]
    if mode == "posterior_all":
        out["post_gap_x"] = posts[1]
        out["post_gap_y"] = posts[2]
    return out
