"""Stream-preparation helpers of the banded pair-HMM engine.

Counterpart of the helpers in cpecan_tpu/ops/fb.py that the wavefront
stream preparation needs: probability-space parameters, the x-frame of a
band, per-diagonal symbol windows and emission lookups. Everything is
batched over a leading pair axis and runs on whatever device its inputs
live on.

x-frame (as in cpecan_tpu): slot j of diagonal k holds the cell with
x = xoff[k] + j, where xoff is the cummax of the band's left x edge, so
xoff advances by delta in {0, 1} per diagonal.

The JAX package builds symbol windows three ways (one-hot matmul, slab,
scan) because gathers are slow on a TPU; here one plain gather serves,
for a batch of pairs (``precompute``) and for windows of one long pair
(``precompute_window``). The scan engine is not ported: the kernels'
plain versions are the port's CPU engine.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

# Sentinel symbol for out-of-sequence positions: every emission table
# lookup maps it to probability 0.
_SENTINEL = 5


def _prob_params(hmm) -> dict:
    """Log-space PairHMM buffers -> probability space."""
    return {
        "t": torch.exp(hmm.t),  # (3, S, S)
        "em_match": torch.exp(hmm.em_match),  # (5, 5)
        "em_gap_x": torch.exp(hmm.em_gap_x),  # (5,)
        "em_gap_y": torch.exp(hmm.em_gap_y),
        "start": torch.exp(hmm.start),
        "ragged_start": torch.exp(hmm.ragged_start),
        "end": torch.exp(hmm.end),
        "ragged_end": torch.exp(hmm.ragged_end),
    }


def _frame_from_band(offsets, widths):
    """x-frame tensors from (B, P+1) band tensors: xoff (window start),
    delta = xoff step in {0, 1}, jlo/jhi slot bounds; all (B, P+1) int64."""
    offsets = offsets.long()
    ks = torch.arange(offsets.shape[-1], device=offsets.device)
    xlo = torch.div(ks + offsets, 2, rounding_mode="floor")
    xhi = xlo + widths.long() - 1
    xoff = torch.cummax(xlo, dim=-1).values
    delta = torch.diff(xoff, dim=-1, prepend=xoff[..., :1])
    return xoff, delta, xlo - xoff, xhi - xoff


def _symbol_windows(sx_pad, sy_pad, xoff, LY, W: int, ks=None,
                    pad_off: int | None = None):
    """Per-diagonal symbol windows by gather.

    sx_pad / sy_pad: (B, pad + n + pad) symbols (sy reversed), padded with
    pad_off (default W+1) sentinels on both sides; B may be 1 for rows of
    one pair. Returns (wx, wy), each xoff's shape plus a last axis of W+1:
      wx[b, r, j] = sx_pad[b, xoff[r] - 1 + j + pad]           (x-1 at j, x at j+1)
      wy[b, r, j] = sy_pad[b, LY - k_r + xoff[r] - 1 + j + pad] (y at j, y-1 at j+1)
    where k_r is row r's diagonal: ks[b, r] when given, else r.
    """
    if pad_off is None:
        pad_off = W + 1
    if ks is None:
        ks = torch.arange(xoff.shape[1], device=xoff.device)
    bi = torch.arange(sx_pad.shape[0], device=xoff.device)[:, None]

    def gather(seq_pad, origin):
        win = seq_pad.unfold(1, W + 1, 1)  # (B, n, W+1) sliding view
        return win[bi, origin.clamp(0, win.shape[1] - 1)]

    wx = gather(sx_pad, xoff - 1 + pad_off)
    wy = gather(sy_pad, LY - ks + xoff - 1 + pad_off)
    return wx, wy


def _lookup1(sym, table5):
    """Elementwise 5-entry table lookup; the sentinel maps to 0."""
    return torch.cat([table5, table5.new_zeros(1)])[sym.long()]


def _lookup2(symx, symy, table55):
    """Elementwise 5x5 table lookup; any sentinel symbol maps to 0."""
    tab = tF.pad(table55, (0, 1, 0, 1)).reshape(-1)  # (6 * 6,)
    return tab[symx.long() * 6 + symy.long()]


def _emissions(prob, wsymx, wsymy):
    """Per-slot emission probabilities for symbol windows: returns
    (e_x, e_y, e_m), each with the windows' shape."""
    e_x = _lookup1(wsymx, prob["em_gap_x"])
    e_y = _lookup1(wsymy, prob["em_gap_y"])
    e_m = _lookup2(wsymx, wsymy, prob["em_match"])
    return e_x, e_y, e_m
