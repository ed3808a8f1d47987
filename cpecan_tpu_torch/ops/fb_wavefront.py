"""Banded-wavefront forward-backward: stream prep, plain versions, kernels.

Counterpart of cpecan_tpu/ops/fb_wavefront.py. Three hand-written CUDA
kernels (csrc/wavefront.cu) replace its Pallas kernels:

 * ``fwd`` <- ``_fwd_kernel``: forward wavefront from the start row F0.
   Per diagonal it forms the gap-X, gap-Y and match terms through the
   statically nonzero transitions, rescales by the row max every
   NORM_EVERY-th diagonal (mf records exactly the applied scale) and
   emits the F rows, mf and the bridge vector.
 * ``bwd`` <- ``_bwd_kernel``: backward wavefront high to low. Per
   diagonal it forms the total (F.B dot plus the one-step match bridge,
   reference diagonalCalculationTotalProbability) and writes the
   posteriors gated by the pm bits; no B tensor reaches device memory.
 * ``exp`` <- ``_exp_kernel``: the same backward recursion plus the
   Baum-Welch expected counts (EM's E-step): per cell the posterior flow
   F_prev[f] * T_c * e_c * B_k[t] / total_k into trans[f, t] and, through
   the cell's symbol pair, into emis[t, a, b]; per-pair outputs.

Two more kernels take the stream prep, which the JAX package traces into
its jit and leaves to XLA (``_precompute_one``, no Pallas kernel):

 * ``prep_rows`` / ``prep_rows_window`` <- the row part of
   ``_precompute_one`` (and of its window forms): the kernel
   ``wavefront_rows`` writes per row the frame, the shift selects, pm's
   row bits and the row tensor, per pair the padded symbols, F0 and the
   end row, and the emission tables in probability space;
 * ``streams`` <- the slot part: the kernel ``wavefront_prep`` writes
   every (B, R, W) stream of the three kernels (masked emissions, pm, the
   cells' symbol pairs) in one pass from what the row part wrote.

So ``precompute`` and ``precompute_window`` are two launches on the card.
Each wrapper runs its plain PyTorch version (``fwd_reference`` /
``bwd_reference`` / ``exp_reference`` / ``rows_reference`` /
``rows_window_reference`` / ``streams_reference``) for a CPU
tensor, and launches its kernel or raises for a CUDA tensor
(``kernel_route`` picks the entry point: the shared-memory variants up
to ``MAX_KERNEL_WIDTH`` band slots, the wide variants above). The plain
versions follow the Pallas bodies (and ``_precompute_one``) line for
line in arithmetic and serve as the kernels' oracle.

Layout is batch-major: streams (B, R, W) with R = P+1 diagonals and W
band slots; the forward intermediate F is (B, R, S, W); the row-constant
shift selects are (B, R) int8. The TPU-only machinery (lane packing,
tile picking, the VMEM envelope, group padding) has no counterpart.

The streaming engines of long pairs (ops/fb_segmented.py,
ops/fb_parallel.py) run windows of a pair as the batch's "pairs": each
wrapper then takes the window's carries and its first row's global
diagonal k0 (the rescale schedule), and exp the two F rows below the
window; ``precompute_window`` builds the windows' streams.
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
# the row bit (row_bits, not in pm) of the rows whose posteriors pm lets
# through
_ROW_VALID = 32

# Widest band of the kernels' shared-memory variants (fwd/bwd 1024 threads
# x 4 slots per thread, exp 512 x 8); wider bands run the wide variants:
# a thread-block cluster per pair that keeps F (fwd) or B (bwd, exp) on
# chip up to W = 12288 (``fwd_wide_plan``, ``back_wide_plan``), and above
# it the global-scratch kernels (fwd's carries in its own F output, bwd's
# and exp's in a (B, 3, S, W) fp32 scratch the wrapper passes).
MAX_KERNEL_WIDTH = 4096
# Widest band whose per-thread emission accumulators fit exp's shared
# memory (256 threads x 8 slots); wider launches, and every launch of the
# wide variant, pass a device scratch buffer for them, (B, S*16,
# EXP_WIDE_THREADS) fp32.
EXP_SHARED_WIDTH = 2048
EXP_WIDE_THREADS = 512

# Transition structures compiled into the kernels, {S: triples}, read
# from csrc/wavefront.cu's CPECAN_NZ5 / CPECAN_NZ3. A model whose active
# set is a subset runs on the same code: its absent transitions are 0
# and add exact zeros.
KERNEL_NZ = _kernels.kernel_structures()

# Kernel launches since the last reset, per TPU kernel site: the batch
# path (fwd, bwd, exp), the exact segmented engine's windows (seg_*) and
# the burn-in-parallel engine's window batches (par_*). The CUDA kernels
# serve all sites; each wrapper adds one to the count its caller names
# where it launches a kernel, and nowhere else, and one more to wide_fwd,
# wide_bwd or wide_exp where that kernel is a wide variant, and of those
# one more to cluster_fwd, cluster_bwd or cluster_exp where the launch
# plan (``fwd_wide_plan``, ``back_wide_plan``) ran the cluster variant.
# prep counts the stream prep's slot kernel (``streams``) and rows its
# row kernel (``prep_rows``, ``prep_rows_window``) at every site.
LAUNCHES = {"fwd": 0, "bwd": 0, "exp": 0, "seg_fwd": 0, "seg_bwd": 0,
            "seg_exp": 0, "par_fwd": 0, "par_bwd": 0, "wide_fwd": 0,
            "wide_bwd": 0, "wide_exp": 0, "cluster_fwd": 0, "cluster_bwd": 0,
            "cluster_exp": 0, "prep": 0, "rows": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nonzero_transitions(t_log) -> tuple:
    """Static (class, from, to) triples of active transitions from the
    numpy/host copy of the (3, S, S) log transition tensor. Only -inf
    (probability 0) is inactive: a NaN stays in, as the kernels, whose
    structure is compiled in, carry it too."""
    t = np.asarray(t_log)
    triples = []
    for c in range(3):
        for f in range(t.shape[1]):
            for to in range(t.shape[2]):
                if not np.isneginf(t[c, f, to]):
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
    wx/wy (B, P+1, W) int8, the symbol pair of each cell (x at slot j,
    y at slot j; the sentinel off the sequences), which the expectation
    pass bins its emission counts by; F0 and end_row (B, S, W) f32;
    m0log (B,); xoff/jlo/jhi (B, P+1) int64; L (B,) int64.

    Two parts: the row part ``prep_rows`` (the kernel ``wavefront_rows``
    for CUDA tensors) and the slot part ``streams``, every (B, P+1, W)
    output (the kernel ``wavefront_prep``): two launches on the card.
    """
    W = int(width)
    r = prep_rows(hmm, sx, sy, offsets, widths, lx, ly, ragged_left,
                  ragged_right, W)
    out = streams(r.pop("tables"), r.pop("sx_pad"), r.pop("sy_pad"),
                  sy.shape[1], W + 1, r.pop("rows"), r.pop("bits"), W)
    out.update(r)
    return out


def precompute_window(hmm, sx_pad, sy_pad, frame: dict, LY: int, L: int,
                      starts, rows: int, width: int, pad_off: int,
                      base=None, emit=None) -> dict:
    """Stream prep for windows of ONE long pair, batched as pairs: window
    i covers global diagonals [starts[i], starts[i] + rows) of the pair's
    padded frame (counterpart of ``_prep_window`` in
    cpecan_tpu/ops/fb_segmented.py and ``_prep_one`` in fb_parallel.py).

    sx_pad, sy_pad: (1, pad_off + n + pad_off) int8 symbols of the pair
    (sy reversed), padded with pad_off sentinels; frame: the pair's
    x-frame ``xoff``/``delta``/``jlo``/``jhi``, 1-D int64 over all
    diagonals plus padding rows with an empty band, at least two rows
    past the last window. starts (n,) int64. base (n,): window i's slot j
    is global slot j + base[i] (default 0). emit (n, 2): the rows
    [lo, hi) whose posteriors the pm bits let through (default all of
    the window's). The row bits of pm (at_end at k == L, bridge for
    1 <= k < L) and the neighbour diagonals d_{k-1}, d_{k+1}, d_{k+2}
    come from the global frame.

    Returns ``precompute``'s stream keys (ex .. pm, wx, wy) at (n, rows,
    width) and (n, rows); a window that starts at 0 and covers a pair's
    P+1 diagonals gives precompute's rows (bm1/bm0 of the last row aside,
    which read a diagonal past the window). Two launches on the card, as
    ``precompute``: ``prep_rows_window`` and ``streams``."""
    W = int(width)
    r = prep_rows_window(hmm, frame, L, starts, rows, base, emit)
    out = streams(r.pop("tables"), sx_pad, sy_pad, LY, pad_off,
                  r.pop("rows"), r.pop("bits"), W)
    out.update(r)
    return out


SELECTS = ("a", "b1", "b0", "abw", "c1", "c0", "bm1", "bm0")


def rows_reference(hmm, sx, sy, offsets, widths, lx, ly, ragged_left,
                   ragged_right, width: int) -> dict:
    """The row part of ``precompute`` in plain PyTorch, the oracle of the
    kernel ``wavefront_rows`` (batch form): per pair and row what
    ``_precompute_one`` computes outside the (B, P+1, W) streams.

    Returns the shift selects (``SELECTS``), F0, m0log, end_row, xoff,
    jlo, jhi and L as ``precompute`` returns them, and what ``streams``
    reads: tables (35,) f32 (``emission_tables``), sx_pad and sy_pad
    (B, W+1 + n + W+1) int8 (sy reversed; the sentinel past each length),
    rows (B, P+1, 4) int32 (``row_tensor``) and bits (B, P+1) int8
    (``row_bits``)."""
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
    sx_s = torch.where(torch.arange(LX, device=dev) < lx[:, None],
                       sx.to(torch.int8), _fb._SENTINEL)
    sy_s = torch.where(torch.arange(LY, device=dev) < ly[:, None],
                       sy.to(torch.int8), _fb._SENTINEL)
    pad = torch.full((B, W + 1), _fb._SENTINEL, dtype=torch.int8,
                     device=dev)
    ks = torch.arange(P1, device=dev)
    Lc = L[:, None]

    d_km1 = torch.cat([delta[:, :1], delta[:, :-1]], dim=1)
    dmid = delta + d_km1 - 1
    delta_pad = torch.cat([delta, delta.new_zeros(B, 2)], dim=1)
    d1 = delta_pad[:, 1:P + 2]
    dsum2 = d1 + delta_pad[:, 2:P + 3]
    dmid1 = torch.cat([dmid[:, 1:], dmid.new_zeros(B, 1)], dim=1)
    out = row_selects(delta, dmid, d1, dsum2, dmid1)
    out["F0"], out["m0log"] = start_rows(prob, ragged_left, S, W)
    bi, rowL = torch.arange(B, device=dev), L.clamp(0, P)
    js = torch.arange(W, device=dev)
    slot_ok_L = ((js >= jlo[bi, rowL][:, None])
                 & (js <= jhi[bi, rowL][:, None]))
    out["end_row"] = end_rows(prob, ragged_right, slot_ok_L.float())
    out.update(
        xoff=xoff, jlo=jlo, jhi=jhi, L=L, tables=emission_tables(prob),
        sx_pad=torch.cat([pad, sx_s, pad], dim=1),
        sy_pad=torch.cat([pad, torch.flip(sy_s, dims=[1]), pad], dim=1),
        rows=row_tensor(ks, xoff, jlo, jhi),
        bits=row_bits((ks >= 1) & (ks <= Lc), ks == Lc, (ks >= 1) & (ks < Lc)))
    return out


def rows_window_reference(hmm, frame: dict, L: int, starts, rows: int,
                          base=None, emit=None) -> dict:
    """The row part of ``precompute_window`` in plain PyTorch, the oracle
    of the kernel ``wavefront_rows`` (window form; arguments as there).
    Returns the shift selects (``SELECTS``) and tables, rows and bits as
    ``rows_reference`` does, at (n, rows)."""
    dev = starts.device
    prob = _fb._prob_params(hmm)
    ks = starts[:, None] + torch.arange(rows, device=dev)
    last = frame["xoff"].shape[0] - 1
    at = lambda key, off=0: frame[key][(ks + off).clamp(0, last)]
    base = (torch.zeros_like(starts) if base is None else base)[:, None]
    xoff = at("xoff") + base
    delta, d_km1, d1, d2 = at("delta"), at("delta", -1), at("delta", 1), \
        at("delta", 2)
    jlo, jhi = at("jlo") - base, at("jhi") - base
    lo, hi = ((ks[:, :1], ks[:, -1:] + 1) if emit is None
              else (emit[:, :1], emit[:, 1:]))
    out = row_selects(delta, delta + d_km1 - 1, d1, d1 + d2, d1 + delta - 1)
    out.update(
        tables=emission_tables(prob), rows=row_tensor(ks, xoff, jlo, jhi),
        bits=row_bits((ks >= lo) & (ks < hi) & (ks >= 1) & (ks <= L),
                      ks == L, (ks >= 1) & (ks < L)))
    return out


def row_selects(delta, dmid, d1, dsum2, dmid1) -> dict:
    """The kernels' row-constant shift selects, (..., R) int8, from the
    x-frame steps: delta, dmid = d_k + d_{k-1} - 1, d1 = d_{k+1}, dsum2 =
    d_{k+1} + d_{k+2} and dmid1 (dmid of row k+1)."""
    conds = (delta == 1, dmid == 1, dmid == 0, d1 == 1, dsum2 == 2,
             dsum2 == 1, dmid1 == 1, dmid1 == 0)
    return {k: c.to(torch.int8) for k, c in zip(SELECTS, conds)}


def row_bits(valid_rows, at_end, bridge):
    """pm's row-constant bits, (..., R) int8: _PM_ATEND at k == L
    (``at_end``), _PM_BRIDGE for 1 <= k < L (``bridge``), and _ROW_VALID
    (not a pm bit) on the rows whose posteriors pm lets through
    (``valid_rows``)."""
    i8 = torch.int8
    return (valid_rows.to(i8) * _ROW_VALID | at_end.to(i8) * _PM_ATEND
            | bridge.to(i8) * _PM_BRIDGE)


def row_tensor(ks, xoff, jlo, jhi):
    """The (B, R, 4) int32 rows {k, xoff, jlo, jhi} that ``streams``
    reads; ks may broadcast."""
    return torch.stack([ks.expand_as(xoff), xoff, jlo, jhi],
                       dim=-1).to(torch.int32)


def emission_tables(prob):
    """(35,) f32: the gap x (5,), gap y (5,) and match (5 x 5) emission
    probabilities that ``streams`` reads, from ``_fb._prob_params``."""
    return torch.cat([prob["em_gap_x"], prob["em_gap_y"],
                      prob["em_match"].reshape(-1)])


def streams_reference(tables, sx_pad, sy_pad, LY: int, pad_off: int, rows,
                      bits, width: int) -> dict:
    """The slot part of the stream prep in plain PyTorch, the oracle of
    the kernel ``wavefront_prep``: per (row, slot) the emissions masked
    to the band's slots, the pm bitfield and the cells' symbol pairs.

    tables: (35,) f32 from ``emission_tables``. sx_pad, sy_pad: (B or 1,
    pad_off + n + pad_off) int8 symbols (sy reversed) padded with pad_off
    sentinels; one row serves every row of the batch (the windows of one
    long pair). LY: sy's unpadded length. rows: (B, R, 4) int32 {row
    diagonal k, window origin xoff, band slot bounds jlo, jhi} from
    ``row_tensor``; bits (B, R) int8 from ``row_bits``. Returns
    ex/ey/em/efx/efy/efm (B, R, W) f32 and pm/wx/wy (B, R, W) int8, as
    ``precompute`` returns them."""
    W = int(width)
    ks, xoff, jlo, jhi = rows.long().unbind(-1)
    prob = {"em_gap_x": tables[:5], "em_gap_y": tables[5:10],
            "em_match": tables[10:].reshape(5, 5)}
    wx, wy = _fb._symbol_windows(sx_pad, sy_pad, xoff, LY, W, ks=ks,
                                 pad_off=pad_off)
    js = torch.arange(W, device=xoff.device)
    slot_ok = (js >= jlo[..., None]) & (js <= jhi[..., None])
    xs = xoff[..., None] + js
    ys = ks[..., None] - xs
    fm = slot_ok.to(torch.float32)
    e_x, e_y, e_m = _fb._emissions(prob, wx[..., :W], wy[..., 1:])
    ef_x, ef_y, ef_m = _fb._emissions(prob, wx[..., 1:], wy[..., :W])
    valid_k = ((bits & _ROW_VALID) != 0)[..., None] & slot_ok
    pm = (torch.where(valid_k & (xs > 0) & (ys > 0), _PM_MATCH, 0)
          | torch.where(valid_k & (xs > 0), _PM_GAPX, 0)
          | torch.where(valid_k & (ys > 0), _PM_GAPY, 0)
          | (bits & (_PM_ATEND | _PM_BRIDGE))[..., None])
    return {
        "ex": e_x * fm, "ey": e_y * fm, "em": e_m * fm,
        "efx": ef_x * fm, "efy": ef_y * fm, "efm": ef_m * fm,
        "pm": pm.to(torch.int8),
        "wx": wx[..., :W].contiguous(), "wy": wy[..., 1:].contiguous(),
    }


def start_rows(prob, ragged_left, S: int, W: int):
    """Diagonal 0's start rows F0 (B, S, W), each scaled by its max, and
    the logs of those maxima (B,)."""
    start_vec = torch.where(ragged_left.bool()[:, None],
                            prob["ragged_start"], prob["start"])
    F0 = torch.zeros(ragged_left.shape[0], S, W, dtype=torch.float32,
                     device=start_vec.device)
    F0[:, :, 0] = start_vec
    m0 = F0.amax(dim=(1, 2))
    m0 = torch.where(m0 > 0, m0, torch.ones_like(m0))
    return F0 / m0[:, None, None], torch.log(m0)


def end_rows(prob, ragged_right, slot_ok_L):
    """The end vectors masked to the band slots of diagonal L: (B, S, W)
    from slot_ok_L (B, W) f32."""
    end_vec = torch.where(ragged_right.bool()[:, None],
                          prob["ragged_end"], prob["end"])
    return end_vec[:, :, None] * slot_ok_L[:, None, :]


# ---------------------------------------------------------------------------
# Plain versions (the kernels' oracle; the engine for CPU tensors)
# ---------------------------------------------------------------------------


def _is_norm_row(k: int) -> bool:
    """Whether global diagonal k applies the row-max rescale."""
    return k % NORM_EVERY == NORM_EVERY - 1


def fwd_reference(t, ex, ey, em, a, b1, b0, F0, nz, carry=None, k0=0):
    """Forward wavefront, vectorised over (B, S, W) with a loop over
    diagonals; follows ``_fwd_kernel`` in arithmetic.

    t: (3S, S) transition probabilities; ex/ey/em (B, R, W) f32;
    a/b1/b0 (B, R) int8. Returns F (B, R, S, W), bv (B, R, W) and
    mf (B, R).

    Batch path (fresh): F0 (B, S, W) is diagonal 0's start row, row 0 of
    the outputs, and the recursion starts at row 1. With ``carry`` =
    (F_{k0-1}, F_{k0-2}, 1/m_{k0-1}), (B, S, W), (B, S, W), (B,), F0 is
    unused, every row is a computed diagonal, and the return gains the
    carry out of the last row (same layout) for the next window. k0 is
    the first row's global diagonal, which sets the rescale schedule."""
    B, R, W = ex.shape
    zero = ex.new_zeros(B, W)
    if carry is None:
        S = F0.shape[1]
        F1, F2 = list(F0.unbind(1)), [zero] * S
        invm = ex.new_ones(B, 1)
    else:
        S = carry[0].shape[1]
        F1, F2 = list(carry[0].unbind(1)), list(carry[1].unbind(1))
        invm = carry[2][:, None]
    tv = t.detach().cpu().reshape(3 * S, S).tolist()
    F = ex.new_empty(B, R, S, W)
    bv = ex.new_zeros(B, R, W)
    mf = ex.new_zeros(B, R)
    if carry is None:
        F[:, 0] = F0

    xs_rows = sorted({f for cl, f, _ in nz if cl == 0})
    ys_rows = sorted({f for cl, f, _ in nz if cl == 2})
    mid_rows = sorted({f for cl, f, _ in nz if cl == 1})
    match_tm = [(f, to) for cl, f, to in nz if cl == 1 and to == 0]

    for i in range(0 if carry is not None else 1, R):
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

        if _is_norm_row(k0 + i):
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
    if carry is None:
        return F, bv, mf
    return F, bv, mf, (torch.stack(F1, 1), torch.stack(F2, 1), invm[:, 0])


def _bwd_sweep(t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm,
               end_row, nz, mb, tot, carry=None, k0=0, carry_out=None):
    """The backward recursion of ``_bwd_kernel`` / ``_exp_kernel``,
    vectorised over (B, S, W), high to low. Writes mb and total_raw into
    ``mb``/``tot`` (B, R) and yields, per diagonal ii, (ii, F row (S
    tensors), B_k (S tensors), 1/total_k (B, 1), pm row).

    The recursion starts from ``carry`` = (B_{k1}, B_{k1+1}, 1/mb_{k1},
    em_{k1}, bridgevec_{k1}) of the row just above the window, (B, S, W),
    (B, S, W), (B,), (B, W), (B, W), or from zeros past the last
    diagonal (batch path). k0 is row 0's global diagonal. When given the
    list ``carry_out``, the carry of row 0 (same layout) is appended to
    it once the sweep is done."""
    B, R, W = efx.shape
    S = F.shape[2]
    tv = t.detach().cpu().reshape(3 * S, S).tolist()

    zero = efx.new_zeros(B, W)
    if carry is None:
        B1, B2 = [zero] * S, [zero] * S
        invb, em_next, bvn = efx.new_ones(B, 1), zero, zero
    else:
        B1, B2 = list(carry[0].unbind(1)), list(carry[1].unbind(1))
        invb, em_next, bvn = carry[2][:, None], carry[3], carry[4]

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

        if _is_norm_row(k0 + ii):
            m = torch.stack(raw, dim=1).amax(dim=(1, 2))[:, None]
            # m := m where (m > 0 and not at_end) else 1, as the JAX
            # package selects it: a NaN row max (amax propagates NaN)
            # gives the scale 1 and mb 0
            m = torch.where((m > 0) & ~at_end[:, :1], m, torch.ones_like(m))
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

        yield ii, F_row, B_new, invt, pmi

        B2 = [x * (1.0 - ae_f) for x in B1]
        B1 = B_new
        invb = r * (1.0 - ae_col) + ae_col
        em_next = em[:, ii]
        bvn = bv[:, ii]
    if carry_out is not None:
        carry_out.append((torch.stack(B1, 1), torch.stack(B2, 1),
                          invb[:, 0], em_next, bvn))


def bwd_reference(t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm,
                  end_row, nz, mode: str = "posterior_match", carry=None,
                  k0=0):
    """Backward+posterior wavefront (high to low), vectorised over
    (B, S, W); follows ``_bwd_kernel``.

    Returns (posts, mb, total_raw): posts is [post_match] or
    [post_match, post_gap_x, post_gap_y], each (B, R, W); mb and
    total_raw are (B, R). With ``carry`` (see ``_bwd_sweep``) the
    recursion starts from it and the return gains row 0's carry out."""
    B, R, W = efx.shape
    n_out = 3 if mode == "posterior_all" else 1
    posts = [efx.new_empty(B, R, W) for _ in range(n_out)]
    mb = efx.new_empty(B, R)
    tot = efx.new_empty(B, R)
    gates = (_PM_MATCH, _PM_GAPX, _PM_GAPY)
    out = []
    for ii, F_row, B_new, invt, pmi in _bwd_sweep(
            t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm, end_row,
            nz, mb, tot, carry, k0, out):
        for s in range(n_out):
            posts[s][:, ii] = torch.where(
                (pmi & gates[s]) != 0, F_row[s] * B_new[s] * invt, 0.0)
    if carry is None:
        return posts, mb, tot
    return posts, mb, tot, out[0]


def exp_reference(t, efx, efy, efm, em, ex, ey, F, bv, abw, c1, c0, bm1,
                  bm0, a, b1, b0, pm, end_row, adj1, adj2, wx, wy, nz,
                  halo=None, carry=None, k0=0):
    """Backward recursion plus expected counts, vectorised over (B, S, W);
    follows ``_exp_kernel``.

    The recursion is ``bwd_reference``'s, so mb and total_raw are the
    same. Per cell the neighbour F rows of the forward intermediate
    (F_{k-1}, F_{k-2}), rescaled into diagonal k's frame by adj1 =
    exp(-mf_k)*[k>=1] and adj2 = exp(-(mf_k+mf_{k-1}))*[k>=2], times
    their emission give n_e per active transition; n_e*B_k[t]/total_k
    accumulates per transition (times T at the end), and sum over the
    transitions into t of n_e*T*B_k[t]/total_k into the cell's symbol
    pair (a, b) = (wx, wy) of state t (N and the sentinel add nothing).

    ex/ey/em (B, R, W) f32 are the forward emission streams; a/b1/b0 the
    forward shift selects; adj1/adj2 (B, R) f32; wx/wy (B, R, W) int8.
    Returns (trans (B, S, S), emis (B, S, 4, 4), mb, total_raw).

    A window of a long pair passes ``halo`` (B, 2, S, W), the F rows
    k0-2 and k0-1 below it (the neighbours of its first two rows; zero
    rows without it), and ``carry`` as ``bwd_reference`` does; the
    return then gains row 0's backward carry out."""
    B, R, W = efx.shape
    S = F.shape[2]
    tv = t.detach().cpu().reshape(3 * S, S).tolist()
    mb = efx.new_empty(B, R)
    tot = efx.new_empty(B, R)
    zero = efx.new_zeros(B, W)
    tacc = [zero] * len(nz)  # one (B, W) lane accumulator per transition
    eacc = efx.new_zeros(B, S, 17, W)  # (state, 4*symx+symy | discard, slot)

    xs_rows = sorted({f for cl, f, _ in nz if cl == 0})
    ys_rows = sorted({f for cl, f, _ in nz if cl == 2})
    mid_rows = sorted({f for cl, f, _ in nz if cl == 1})
    # rows k0-2, k0-1: the halo, or zero (the batch path's adj is 0 there)
    below = ([[zero] * S] * 2 if halo is None
             else [halo[:, 0].unbind(1), halo[:, 1].unbind(1)])

    out = []
    for ii, _, B_new, invt, _ in _bwd_sweep(
            t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm, end_row,
            nz, mb, tot, carry, k0, out):
        ai = (a[:, ii] != 0)[:, None]
        b1i = (b1[:, ii] != 0)[:, None]
        b0i = (b0[:, ii] != 0)[:, None]
        exa = ex[:, ii] * adj1[:, ii, None]
        eya = ey[:, ii] * adj1[:, ii, None]
        ema = em[:, ii] * adj2[:, ii, None]
        Fm1 = F[:, ii - 1].unbind(1) if ii >= 1 else below[1]
        Fm2 = F[:, ii - 2].unbind(1) if ii >= 2 else below[ii]

        nxe = {f: torch.where(ai, Fm1[f], _shift_r(Fm1[f])) * exa
               for f in xs_rows}
        nye = {f: torch.where(ai, _shift_l(Fm1[f]), Fm1[f]) * eya
               for f in ys_rows}
        nme = {f: torch.where(b1i, _shift_l(Fm2[f]),
                              torch.where(b0i, Fm2[f], _shift_r(Fm2[f])))
               * ema for f in mid_rows}

        Bw = [B_new[to] * invt for to in range(S)]
        q = [zero] * S
        for idx, (cl, f, to) in enumerate(nz):
            n_e = (nxe[f] if cl == 0 else nme[f] if cl == 1 else nye[f])
            tacc[idx] = tacc[idx] + n_e * Bw[to]
            q[to] = q[to] + n_e * tv[cl * S + f][to]

        wxi = wx[:, ii].long()
        wyi = wy[:, ii].long()
        sidx = torch.where((wxi < 4) & (wyi < 4), wxi * 4 + wyi, 16)
        for to in range(S):
            eacc[:, to].scatter_add_(1, sidx[:, None, :],
                                     (q[to] * Bw[to])[:, None, :])

    trans = efx.new_zeros(B, S, S)
    for idx, (cl, f, to) in enumerate(nz):
        trans[:, f, to] += tacc[idx].sum(dim=-1) * tv[cl * S + f][to]
    emis = eacc[:, :, :16].sum(dim=-1).reshape(B, S, 4, 4)
    if carry is None:
        return trans, emis, mb, tot
    return trans, emis, mb, tot, out[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _on_card(x) -> bool:
    return x.device.type == "cuda"


def _check_launch(name: str, S, W: int, nz, tensors: dict) -> None:
    """Structure (not for S None: a kernel without one), width, device,
    dtype, shape and contiguity checks before a launch; ``tensors`` maps
    a name to (tensor, dtype, shape)."""
    if S is not None and S not in KERNEL_NZ:
        raise ValueError(f"{name}: kernels support S in (3, 5), got {S}")
    extra = set(nz) - set(KERNEL_NZ[S]) if S is not None else ()
    if extra:
        raise ValueError(
            f"{name}: transitions {sorted(extra)} are outside the kernels' "
            f"{S}-state structure")
    if W < 1:
        raise ValueError(f"{name}: band width {W} < 1")
    dev = None
    for key, (x, dtype, shape) in tensors.items():
        if not _on_card(x):
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


def kernel_route(kernel: str, device, W: int):
    """The C entry point that a launch of ``kernel`` ("fwd", "bwd", "exp",
    "prep" or "rows") at band width W takes for tensors on ``device``:
    None for the CPU (the wrapper runs the plain version), else the
    shared-memory variant's entry point up to MAX_KERNEL_WIDTH and the
    wide variant's above (prep and rows have one entry point at every
    width). The shared-memory
    entry points pick their own launch plan (``fwd_plan``, ``bwd_plan``,
    ``exp_plan``)."""
    if device.type == "cpu":
        return None
    wide = ("_wide" if W > MAX_KERNEL_WIDTH and kernel not in ("prep", "rows")
            else "")
    return f"cpecan_wavefront_{kernel}{wide}"


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


_NULL = ctypes.c_void_p(None)


def streams(tables, sx_pad, sy_pad, LY: int, pad_off: int, rows, bits,
            width: int) -> dict:
    """The slot part of the stream prep: ``streams_reference`` for CPU
    tensors, the CUDA kernel ``wavefront_prep`` for CUDA tensors. Same
    contract as ``streams_reference``; the tables, rows and bits are the
    row part's (``prep_rows``, ``prep_rows_window``), which the kernel
    reads where they lie."""
    W = int(width)
    entry = kernel_route("prep", rows.device, W)
    if entry is None:
        return streams_reference(tables, sx_pad, sy_pad, LY, pad_off, rows,
                                 bits, W)
    B, R = rows.shape[:2]
    f32, i8 = torch.float32, torch.int8
    nx, ny = sx_pad.shape[1], sy_pad.shape[1]
    for key, x in (("sx_pad", sx_pad), ("sy_pad", sy_pad)):
        if x.dim() != 2 or x.shape[0] not in (1, B) or x.shape[1] < W + 1:
            raise ValueError(f"prep: {key} has shape {tuple(x.shape)}, "
                             f"expected (1 or {B}, >= {W + 1})")
    _check_launch("prep", None, W, (), {
        "sx_pad": (sx_pad, i8, tuple(sx_pad.shape)),
        "sy_pad": (sy_pad, i8, tuple(sy_pad.shape)),
        "rows": (rows, torch.int32, (B, R, 4)), "bits": (bits, i8, (B, R)),
        "tables": (tables, f32, (_TABLES,))})
    dev = rows.device
    out = {k: torch.empty(B, R, W, dtype=f32, device=dev)
           for k in ("ex", "ey", "em", "efx", "efy", "efm")}
    out.update({k: torch.empty(B, R, W, dtype=i8, device=dev)
                for k in ("pm", "wx", "wy")})
    if B * R == 0:
        return out
    stride = lambda x: 0 if x.shape[0] == 1 else x.shape[1]
    at = lambda i: ctypes.c_void_p(tables.data_ptr() + 4 * i)
    _launch("prep", entry, dev, _ptr(sx_pad), _ptr(sy_pad), stride(sx_pad),
            stride(sy_pad), nx, ny, int(LY), int(pad_off), _ptr(rows),
            _ptr(bits), at(0), at(5), at(10),
            *(_ptr(v) for v in out.values()), B, R, W)
    LAUNCHES["prep"] += 1
    return out


_TABLES = 35  # emission_tables' length

# element types of the row kernel's integer inputs (load_int in
# csrc/wavefront.cu): the size in bytes, -1 for an unsigned byte
_INT_TYPES = {torch.int8: 1, torch.uint8: -1, torch.bool: -1,
              torch.int16: 2, torch.int32: 4, torch.int64: 8}


def _int_type(key: str, x) -> int:
    if x.dtype not in _INT_TYPES:
        raise TypeError(f"rows: {key} is {x.dtype}, expected an integer or "
                        f"bool dtype")
    return _INT_TYPES[x.dtype]


def _model_specs(hmm) -> dict:
    f32, S = torch.float32, hmm.state_number
    specs = {k: (getattr(hmm, k), f32, (S,))
             for k in ("start", "ragged_start", "end", "ragged_end")}
    specs.update(em_gap_x=(hmm.em_gap_x, f32, (5,)),
                 em_gap_y=(hmm.em_gap_y, f32, (5,)),
                 em_match=(hmm.em_match, f32, (5, 5)))
    return specs


def _model_ptrs(hmm) -> list:
    return [_ptr(getattr(hmm, k)) for k in (
        "em_gap_x", "em_gap_y", "em_match", "start", "ragged_start", "end",
        "ragged_end")]


def _row_outputs(B: int, R: int, dev) -> dict:
    """The outputs both forms of the row kernel write: the selects as
    views of one (8, B, R) int8 tensor, tables, rows and bits."""
    out = dict(zip(SELECTS, torch.empty(8, B, R, dtype=torch.int8,
                                        device=dev).unbind(0)))
    out.update(tables=torch.empty(_TABLES, dtype=torch.float32, device=dev),
               rows=torch.empty(B, R, 4, dtype=torch.int32, device=dev),
               bits=torch.empty(B, R, dtype=torch.int8, device=dev))
    return out


def prep_rows(hmm, sx, sy, offsets, widths, lx, ly, ragged_left,
              ragged_right, width: int) -> dict:
    """The row part of ``precompute``: ``rows_reference`` for CPU tensors,
    the CUDA kernel ``wavefront_rows`` (batch form) for CUDA tensors. Same
    contract as ``rows_reference``; the integer inputs may have any
    integer (or bool) dtype, as there."""
    W = int(width)
    entry = kernel_route("rows", offsets.device, W)
    if entry is None:
        return rows_reference(hmm, sx, sy, offsets, widths, lx, ly,
                              ragged_left, ragged_right, W)
    S = hmm.state_number
    B, R = offsets.shape
    LX, LY = sx.shape[1], sy.shape[1]
    inputs = {"sx": (sx, (B, LX)), "sy": (sy, (B, LY)),
              "offsets": (offsets, (B, R)), "widths": (widths, (B, R)),
              "lx": (lx, (B,)), "ly": (ly, (B,)),
              "ragged_left": (ragged_left, (B,)),
              "ragged_right": (ragged_right, (B,))}
    types = [_int_type(k, x) for k, (x, _) in inputs.items()]
    specs = {k: (x, x.dtype, shape) for k, (x, shape) in inputs.items()}
    specs.update(_model_specs(hmm))
    _check_launch("rows", S, W, (), specs)
    if R < 1:
        raise ValueError("rows: a band of no diagonals")
    dev = offsets.device
    i8, i64, f32 = torch.int8, torch.int64, torch.float32
    out = _row_outputs(B, R, dev)
    out.update(
        sx_pad=torch.empty(B, LX + 2 * (W + 1), dtype=i8, device=dev),
        sy_pad=torch.empty(B, LY + 2 * (W + 1), dtype=i8, device=dev),
        **{k: torch.empty(B, R, dtype=i64, device=dev)
           for k in ("xoff", "jlo", "jhi")},
        L=torch.empty(B, dtype=i64, device=dev),
        F0=torch.empty(B, S, W, dtype=f32, device=dev),
        m0log=torch.empty(B, dtype=f32, device=dev),
        end_row=torch.empty(B, S, W, dtype=f32, device=dev))
    if B == 0:
        return out
    sel = out["a"]  # the first view: the (8, B, R) tensor's start
    _launch("rows", entry, dev, S, *_model_ptrs(hmm),
            *(_ptr(x) for x, _ in inputs.values()), *types, LX, LY,
            *[_NULL] * 4, 0, _NULL, _NULL, _NULL, 0,
            *map(_ptr, (out["tables"], out["rows"], out["bits"], sel,
                        out["sx_pad"], out["sy_pad"], out["xoff"], out["jlo"],
                        out["jhi"], out["L"], out["F0"], out["m0log"],
                        out["end_row"])), B, R, W)
    LAUNCHES["rows"] += 1
    return out


def prep_rows_window(hmm, frame: dict, L: int, starts, rows: int, base=None,
                     emit=None) -> dict:
    """The row part of ``precompute_window``: ``rows_window_reference`` for
    CPU tensors, the CUDA kernel ``wavefront_rows`` (window form) for CUDA
    tensors. Same contract as ``rows_window_reference``; the frame,
    starts, base and emit are int64."""
    entry = kernel_route("rows", starts.device, 1)
    if entry is None:
        return rows_window_reference(hmm, frame, L, starts, rows, base, emit)
    n, R = starts.shape[0], int(rows)
    nf = frame["xoff"].shape[0]
    i64 = torch.int64
    specs = {k: (frame[k], i64, (nf,)) for k in ("xoff", "delta", "jlo", "jhi")}
    specs["starts"] = (starts, i64, (n,))
    if base is not None:
        specs["base"] = (base, i64, (n,))
    if emit is not None:
        specs["emit"] = (emit, i64, (n, 2))
    specs.update(_model_specs(hmm))
    _check_launch("rows", None, 1, (), specs)
    if nf < 1:
        raise ValueError("rows: an empty frame")
    out = _row_outputs(n, R, starts.device)
    if n * R == 0:
        return out
    opt = lambda x: _NULL if x is None else _ptr(x)
    _launch("rows", entry, starts.device, hmm.state_number, *_model_ptrs(hmm),
            *[_NULL] * 8, *[0] * 8, 0, 0,
            *(_ptr(frame[k]) for k in ("xoff", "delta", "jlo", "jhi")), nf,
            _ptr(starts), opt(base), opt(emit), int(L),
            _ptr(out["tables"]), _ptr(out["rows"]), _ptr(out["bits"]),
            _ptr(out["a"]), *[_NULL] * 9, n, R, 1)
    LAUNCHES["rows"] += 1
    return out


def _fwd_carry_specs(carry, B, S, W) -> dict:
    f32 = torch.float32
    return {"carry f1": (carry[0], f32, (B, S, W)),
            "carry f2": (carry[1], f32, (B, S, W)),
            "carry 1/m": (carry[2], f32, (B,))}


def _bwd_carry_specs(carry, B, S, W) -> dict:
    f32 = torch.float32
    return {"carry b1": (carry[0], f32, (B, S, W)),
            "carry b2": (carry[1], f32, (B, S, W)),
            "carry 1/mb": (carry[2], f32, (B,)),
            "carry em": (carry[3], f32, (B, W)),
            "carry bv": (carry[4], f32, (B, W))}


def _carry_ptrs(carry, n: int) -> list:
    """The pointers of a carry tuple (in or out), or n null pointers."""
    return [_NULL] * n if carry is None else [_ptr(x) for x in carry]


def _empty_like_carry(carry):
    return None if carry is None else tuple(torch.empty_like(x) for x in carry)


def fwd(t, ex, ey, em, a, b1, b0, F0, nz, carry=None, k0=0, site="fwd"):
    """Forward wavefront: ``fwd_reference`` for CPU tensors, the CUDA
    kernel ``wavefront_fwd`` (above MAX_KERNEL_WIDTH the entry point of
    ``wavefront_fwd_wide``, whose plan runs the cluster kernel
    ``wavefront_fwd_cluster`` where it holds the band) for CUDA tensors.
    Same contract as ``fwd_reference`` (a window of a long pair passes
    ``carry`` and its first row's diagonal ``k0``); ``t`` may live on the
    host (no device sync). ``site`` names the launch count the call adds
    to."""
    B, R, W = ex.shape
    entry = kernel_route("fwd", ex.device, W)
    if entry is None:
        return fwd_reference(t, ex, ey, em, a, b1, b0, F0, nz, carry, k0)
    S = (F0 if carry is None else carry[0]).shape[1]
    f32, i8 = torch.float32, torch.int8
    row, rows = (B, R, W), (B, R)
    specs = {
        "ex": (ex, f32, row), "ey": (ey, f32, row), "em": (em, f32, row),
        "a": (a, i8, rows), "b1": (b1, i8, rows), "b0": (b0, i8, rows)}
    specs.update({"F0": (F0, f32, (B, S, W))} if carry is None
                 else _fwd_carry_specs(carry, B, S, W))
    _check_launch("fwd", S, W, nz, specs)
    th = _host_transitions(t, S)
    F = torch.empty(B, R, S, W, dtype=f32, device=ex.device)
    bv = torch.empty(B, R, W, dtype=f32, device=ex.device)
    mf = torch.empty(B, R, dtype=f32, device=ex.device)
    co = _empty_like_carry(carry)
    _launch("fwd", entry, ex.device, S, _ptr(th),
            _ptr(ex), _ptr(ey), _ptr(em), _ptr(a), _ptr(b1), _ptr(b0),
            _ptr(F0) if carry is None else _NULL, *_carry_ptrs(carry, 3),
            _ptr(F), _ptr(bv), _ptr(mf), *_carry_ptrs(co, 3), B, R, W, k0)
    _count(site, "fwd", entry, S, W)
    return (F, bv, mf) if carry is None else (F, bv, mf, co)


def bwd(t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1, bm0, pm, end_row, nz,
        mode: str = "posterior_match", carry=None, k0=0, site="bwd"):
    """Backward+posterior wavefront: ``bwd_reference`` for CPU tensors,
    the CUDA kernel ``wavefront_bwd`` (above MAX_KERNEL_WIDTH the entry
    point of ``wavefront_back_wide``, whose plan runs the cluster kernel
    ``wavefront_back_cluster`` where it holds the band) for CUDA tensors.
    Same contract as ``bwd_reference``."""
    B, R, W = efx.shape
    entry = kernel_route("bwd", efx.device, W)
    if entry is None:
        return bwd_reference(t, efx, efy, efm, em, F, bv, abw, c1, c0, bm1,
                             bm0, pm, end_row, nz, mode, carry, k0)
    S = F.shape[2]
    f32, i8 = torch.float32, torch.int8
    row, rows = (B, R, W), (B, R)
    specs = {
        "efx": (efx, f32, row), "efy": (efy, f32, row),
        "efm": (efm, f32, row), "em": (em, f32, row),
        "F": (F, f32, (B, R, S, W)), "bv": (bv, f32, row),
        "abw": (abw, i8, rows), "c1": (c1, i8, rows), "c0": (c0, i8, rows),
        "bm1": (bm1, i8, rows), "bm0": (bm0, i8, rows), "pm": (pm, i8, row),
        "end_row": (end_row, f32, (B, S, W))}
    if carry is not None:
        specs.update(_bwd_carry_specs(carry, B, S, W))
    _check_launch("bwd", S, W, nz, specs)
    th = _host_transitions(t, S)
    n_out = 3 if mode == "posterior_all" else 1
    posts = [torch.empty(B, R, W, dtype=f32, device=efx.device)
             for _ in range(n_out)]
    mb = torch.empty(B, R, dtype=f32, device=efx.device)
    tot = torch.empty(B, R, dtype=f32, device=efx.device)
    px, py = ((_ptr(posts[1]), _ptr(posts[2])) if n_out == 3
              else (_NULL, _NULL))
    co = _empty_like_carry(carry)
    scratch = _wide_scratch(entry, B, S, W, efx.device)
    _launch("bwd", entry, efx.device, S, _ptr(th),
            _ptr(efx), _ptr(efy), _ptr(efm), _ptr(em), _ptr(F), _ptr(bv),
            _ptr(abw), _ptr(c1), _ptr(c0), _ptr(bm1), _ptr(bm0), _ptr(pm),
            _ptr(end_row), _ptr(posts[0]), px, py, _ptr(mb), _ptr(tot),
            *_carry_ptrs(carry, 5), *_carry_ptrs(co, 5),
            *map(_ptr, scratch), B, R, W, k0)
    _count(site, "bwd", entry, S, W)
    return (posts, mb, tot) if carry is None else (posts, mb, tot, co)


def _wide_scratch(entry: str, B: int, S: int, W: int, device) -> list:
    """The wide variants' extra argument: [a (B, 3, S, W) fp32 scratch]
    for the backward carries, [] for the shared-memory variants."""
    if not entry.endswith("_wide"):
        return []
    return [torch.empty(B, 3, S, W, dtype=torch.float32, device=device)]


def _count(site: str, kernel: str, entry: str, S: int, W: int) -> None:
    LAUNCHES[site] += 1
    if entry.endswith("_wide"):
        LAUNCHES[f"wide_{kernel}"] += 1
        plan = (fwd_wide_plan(S, W) if kernel == "fwd"
                else back_wide_plan(S, W, kernel == "exp"))
        if plan["cluster"]:
            LAUNCHES[f"cluster_{kernel}"] += 1


def _plan(kernel: str, S: int, W: int, aligned: bool) -> dict:
    out = (ctypes.c_int * 4)()
    err = getattr(_kernels.load(), f"cpecan_wavefront_{kernel}_plan")(
        S, W, int(aligned), ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise ValueError(f"{kernel}_plan: no launch for S={S}, W={W}")
    return dict(zip(("threads", "slots", "depth", "smem"), out))


def fwd_plan(S: int, W: int, aligned: bool = True) -> dict:
    """The launch ``wavefront_fwd`` takes at (S, W) <= MAX_KERNEL_WIDTH,
    for streams that start on 16-byte boundaries (``aligned``) or not:
    threads, band slots per compute thread, the depth of its ring of
    streams in shared memory (0: the variant that loads them directly)
    and its dynamic shared memory in bytes. Builds the kernel library on
    first use."""
    return _plan("fwd", S, W, aligned)


def bwd_plan(S: int, W: int, aligned: bool = True) -> dict:
    """The launch ``wavefront_bwd`` takes at (S, W) <= MAX_KERNEL_WIDTH,
    for streams that start on 16-byte boundaries (``aligned``) or not:
    threads, band slots per compute thread, the depth of its ring of
    streams in shared memory (0: the variant that loads them directly)
    and its dynamic shared memory in bytes. Builds the kernel library on
    first use."""
    return _plan("bwd", S, W, aligned)


def exp_plan(S: int, W: int, aligned: bool = True) -> dict:
    """``bwd_plan``'s counterpart for ``wavefront_exp`` (1, 2, 4 or 8
    slots per thread; a ring of at least 3 stages)."""
    return _plan("exp", S, W, aligned)


def _wide_plan(name: str, S: int, W: int, *extra) -> dict:
    out = (ctypes.c_int * 5)()
    err = getattr(_kernels.load(), f"cpecan_wavefront_{name}")(
        S, W, *extra, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise ValueError(f"{name}: no launch for S={S}, W={W}")
    return dict(zip(("cluster", "slots", "slice", "threads", "smem"), out))


def back_wide_plan(S: int, W: int, exp: bool = False) -> dict:
    """The launch ``wavefront_back_wide``'s entry points (bwd, or exp) take
    at (S, W) > MAX_KERNEL_WIDTH: cluster (CTAs per pair in the cluster
    variant ``wavefront_back_cluster``; 0: the global-scratch kernel),
    slots (band slots per thread), slice (band slots per CTA), threads
    per CTA and dynamic shared memory in bytes. Builds the kernel library
    on first use."""
    return _wide_plan("back_wide_plan", S, W, int(exp))


def fwd_wide_plan(S: int, W: int) -> dict:
    """``back_wide_plan``'s counterpart for ``wavefront_fwd_wide``'s entry
    point: cluster (CTAs per pair in ``wavefront_fwd_cluster``; 0: the
    global-scratch kernel ``wavefront_fwd_wide``), slots, slice, threads
    and shared memory."""
    return _wide_plan("fwd_wide_plan", S, W)


def set_cluster_limit(cluster: int) -> int:
    """Sets the cluster size that ``fwd_wide_plan`` and ``back_wide_plan``
    use (2..8, default 8; 0 runs the global-scratch kernels at every
    width) and returns the one before: for measurements and tests of the
    two variants."""
    before = _kernels.load().cpecan_wavefront_set_cluster_limit(cluster)
    if before < 0:
        raise ValueError(f"cluster size {cluster} is not 0 or 2..8")
    return before


def exp(t, efx, efy, efm, em, ex, ey, F, bv, abw, c1, c0, bm1, bm0, a, b1,
        b0, pm, end_row, adj1, adj2, wx, wy, nz, halo=None, carry=None, k0=0,
        site="exp"):
    """Backward recursion plus expected counts: ``exp_reference`` for CPU
    tensors, the CUDA kernel ``wavefront_exp`` (``wavefront_back_wide``'s
    entry point above MAX_KERNEL_WIDTH, as ``bwd``) for CUDA tensors. Same
    contract as ``exp_reference`` (per-pair trans and emis)."""
    B, R, W = efx.shape
    entry = kernel_route("exp", efx.device, W)
    if entry is None:
        return exp_reference(t, efx, efy, efm, em, ex, ey, F, bv, abw, c1, c0,
                             bm1, bm0, a, b1, b0, pm, end_row, adj1, adj2,
                             wx, wy, nz, halo, carry, k0)
    S = F.shape[2]
    f32, i8 = torch.float32, torch.int8
    row, rows = (B, R, W), (B, R)
    specs = {
        "efx": (efx, f32, row), "efy": (efy, f32, row),
        "efm": (efm, f32, row), "em": (em, f32, row), "ex": (ex, f32, row),
        "ey": (ey, f32, row), "F": (F, f32, (B, R, S, W)),
        "bv": (bv, f32, row), "abw": (abw, i8, rows), "c1": (c1, i8, rows),
        "c0": (c0, i8, rows), "bm1": (bm1, i8, rows), "bm0": (bm0, i8, rows),
        "a": (a, i8, rows), "b1": (b1, i8, rows), "b0": (b0, i8, rows),
        "pm": (pm, i8, row), "end_row": (end_row, f32, (B, S, W)),
        "adj1": (adj1, f32, rows), "adj2": (adj2, f32, rows),
        "wx": (wx, i8, row), "wy": (wy, i8, row)}
    if halo is not None:
        specs["halo"] = (halo, f32, (B, 2, S, W))
    if carry is not None:
        specs.update(_bwd_carry_specs(carry, B, S, W))
    _check_launch("exp", S, W, nz, specs)
    th = _host_transitions(t, S)
    dev = efx.device
    trans = torch.empty(B, S, S, dtype=f32, device=dev)
    emis = torch.empty(B, S, 4, 4, dtype=f32, device=dev)
    eacc = (torch.empty(B, S * 16, EXP_WIDE_THREADS, dtype=f32, device=dev)
            if W > EXP_SHARED_WIDTH else None)
    mb = torch.empty(B, R, dtype=f32, device=dev)
    tot = torch.empty(B, R, dtype=f32, device=dev)
    co = _empty_like_carry(carry)
    scratch = _wide_scratch(entry, B, S, W, dev)
    _launch("exp", entry, dev, S, _ptr(th), _ptr(efx),
            _ptr(efy), _ptr(efm), _ptr(em), _ptr(ex), _ptr(ey), _ptr(F),
            _ptr(bv), _ptr(abw), _ptr(c1), _ptr(c0), _ptr(bm1), _ptr(bm0),
            _ptr(a), _ptr(b1), _ptr(b0), _ptr(pm), _ptr(end_row), _ptr(adj1),
            _ptr(adj2), _ptr(wx), _ptr(wy), _ptr(trans), _ptr(emis),
            _ptr(eacc) if eacc is not None else _NULL,
            _ptr(mb), _ptr(tot), _ptr(halo) if halo is not None else _NULL,
            *_carry_ptrs(carry, 5), *_carry_ptrs(co, 5),
            *map(_ptr, scratch), B, R, W, k0)
    _count(site, "exp", entry, S, W)
    return ((trans, emis, mb, tot) if carry is None
            else (trans, emis, mb, tot, co))


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

MODES = ("forward", "posterior_match", "posterior_all", "expectation")


def scale_adjustments(mf):
    """adj1 = exp(-mf_k)*[k>=1] and adj2 = exp(-(mf_k+mf_{k-1}))*[k>=2],
    (B, R): the factors that bring F_{k-1} and F_{k-2} into diagonal k's
    frame (cpecan_tpu/ops/fb_wavefront.py:1132-1138)."""
    ks = torch.arange(mf.shape[1], device=mf.device)
    mf_km1 = tF.pad(mf[:, :-1], (1, 0))
    return (torch.exp(-mf) * (ks >= 1),
            torch.exp(-(mf + mf_km1)) * (ks >= 2))


def fb_pass_batch_wavefront(hmm, sx, sy, offsets, widths, lx, ly,
                            ragged_left, ragged_right,
                            mode: str = "posterior_match", width: int = 0):
    """Batched banded FB pass through the wavefront kernels (plain
    versions on CPU tensors).

    Same keys as cpecan_tpu's ``fb_pass_batch_wavefront``: mf and log_fwd,
    plus mb, total_raw and post_match (and post_gap_x/post_gap_y in
    posterior_all mode), each sliced to P+1 rows; in expectation mode mb,
    total_raw and the expected counts trans (S, S) and emis (S, 4, 4)
    summed over the batch. All tensors and the PairHMM must be on one
    device."""
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
        return {k: (torch.stack([o[k] for o in outs]).sum(dim=0)
                    if k in ("trans", "emis")
                    else torch.cat([o[k] for o in outs], dim=0))
                for k in outs[0]}

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
    if mode == "expectation":
        adj1, adj2 = scale_adjustments(mf)  # row 0 (with m0log) is masked
        trans, emis, mb, tot = exp(
            t, pre["efx"], pre["efy"], pre["efm"], pre["em"], pre["ex"],
            pre["ey"], F, bv, pre["abw"], pre["c1"], pre["c0"], pre["bm1"],
            pre["bm0"], pre["a"], pre["b1"], pre["b0"], pre["pm"],
            pre["end_row"], adj1, adj2, pre["wx"], pre["wy"], hmm.nz)
        out["mb"] = mb
        out["total_raw"] = tot
        # the batch sum: a fixed-order reduction of the per-pair counts
        out["trans"] = trans.sum(dim=0)
        out["emis"] = emis.sum(dim=0)
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
