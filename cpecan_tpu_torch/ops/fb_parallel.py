"""Burn-in-parallel posterior decoding of ONE long banded pair.

Counterpart of cpecan_tpu/ops/fb_parallel.py (TPU kernel sites 7-8:
``_par_slice_jit``'s forward and backward launches). The exact engine
(ops/fb_segmented.py) walks one pair's diagonals in series, one block of
the card for the whole pair. Here the diagonal range is cut into windows
of K diagonals that run side by side as the pairs (blocks) of one
batched launch of the wavefront kernels, each window with a burn-in
halo of B rows on either side:

  * forward: window w computes rows [s, s + Kp), s = max(k0 - B, 1),
    Kp = K + 2B rounded up to 8, from a neutral (uniform in-band) carry
    two rows before s, or from the exact start row for the window at
    s = 1; after ~B rows the normalised forward vector has forgotten the
    neutral start;
  * backward: the same rows high to low from a neutral carry, or from
    zeros (the natural start) where the range reaches past L;
  * posteriors come only from the window's own rows [k0, k0 + K) (the pm
    bits); the halo rows only converge the state.

This is the reference's own approximation (a fresh backward matrix at
every traceback point, trusted after traceBackDiagonals burn-in
diagonals, impl/pairwiseAligner.c:797-817), applied to both directions.
The per-diagonal scales are window-local, so no global mf/mb/log_fwd or
counts come out: posterior modes only.

Each window is rebased to its own local band width and windows are
grouped by the port's width ladder (``fb_batch.width_bucket``);
a group runs in slices whose forward intermediate stays under a budget,
each slice with arrays of its own. The TPU's log2 lane buckets, pow2
slice ladder, tile picking and VMEM self-healing have no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from cpecan_tpu_torch.ops import fb as _fb
from cpecan_tpu_torch.ops import fb_batch
from cpecan_tpu_torch.ops import fb_wavefront as _wf
from cpecan_tpu_torch.ops.fb_segmented import POST_KEYS, _to_host
from cpecan_tpu_torch.ops.fb_streaming import (
    _device_pair, _host_frame, _pad_frame)

# Diagonals per window: enough windows on a 50 kb pair to fill the card,
# long enough that the 2*burnin halo stays a minor share.
WINDOW_ROWS = 1024

# Device-memory budget for one slice's (windows, Kp, S, W) forward block.
_F_BUDGET = 1 << 30


def supported(mode: str) -> bool:
    return mode in ("posterior_match", "posterior_all")


def burnin_rows(p) -> int:
    """Burn-in halo rows from the config: the reference trusts a freshly
    seeded backward matrix after traceBackDiagonals diagonals
    (impl/pairwiseAligner.c:797-817); the slowest-mixing direction is a
    long-gap state, so 6.4x that margin with a 256-row floor (the JAX
    package measured 96 rows leaving a 0.028 error on one case, 256
    exact: tests/test_parallel.py)."""
    return max((32 * int(p.traceBackDiagonals)) // 5, 256)


def _neutral(jlo, jhi, S: int, W: int):
    """Uniform in-band carry rows (n, S, W) from per-window bounds (n,)."""
    js = torch.arange(W, device=jlo.device)
    ok = ((js >= jlo[:, None]) & (js <= jhi[:, None])).to(torch.float32)
    return ok[:, None, :].expand(-1, S, -1).contiguous()


def fb_pass_parallel(hmm, seq_x_codes, seq_y_codes, offsets: np.ndarray,
                     widths: np.ndarray, lx: int, ly: int,
                     ragged_left: bool, ragged_right: bool, mode: str,
                     width: int, burnin: int, threshold: float,
                     window: int = 0):
    """Burn-in-parallel banded posterior decode of ONE long pair on the
    PairHMM's device. Arguments as ``fb_streaming.fb_pass_streaming``;
    ``burnin`` is the halo length (``burnin_rows(p)``), ``window`` the
    rows per window (default WINDOW_ROWS; rounded up to 8, as the burn-in
    is, so every window starts on the same rescale phase). Returns
    {"post_entries": {key: (vals, ks, js)}, "xoff", "windows"}."""
    if not supported(mode):
        raise ValueError(f"parallel engine does not support mode={mode!r}")
    dev = hmm.t.device
    S = hmm.state_number
    W = int(width)
    L = int(lx) + int(ly)
    if L == 0:
        raise ValueError("empty pair")
    B = -(-max(int(burnin), 8) // 8) * 8
    K = max(-(-int(window or WINDOW_ROWS) // 8) * 8, B)
    Kp = K + 2 * B
    nW = -(-L // K)
    rows_total = 1 + nW * K
    frame = _pad_frame(*_host_frame(np.asarray(offsets), np.asarray(widths)),
                       rows_total + Kp)
    pad_off = Kp + W + 1
    sx_pad, sy_pad, fr = _device_pair(seq_x_codes, seq_y_codes, frame,
                                      pad_off, dev)
    jlo_h, jhi_h = frame[2], frame[3]
    last = len(jlo_h) - 1

    k0s = 1 + K * np.arange(nW, dtype=np.int64)
    ss = np.maximum(k0s - B, 1)
    # Per-window rebasing: a window spans only its own rows' slots (plus
    # rows s-2, s-1, whose neutral rows seed its forward carry). Window 0
    # keeps base 0: its exact start row addresses global slot 0.
    bases = np.zeros(nW, np.int64)
    groups: dict = {}
    for w in range(nW):
        lo = max(int(ss[w]) - 2, 0)
        hi = int(ss[w]) + Kp
        bases[w] = max(int(jlo_h[lo:hi].min()), 0) if w > 0 else 0
        local = max(int(jhi_h[lo:hi].max()) - int(bases[w]) + 1, 1)
        groups.setdefault(min(fb_batch.width_bucket(local), W), []).append(w)

    prob = _fb._prob_params(hmm)
    t, nz = hmm.t_prob_host, hmm.nz
    keys = POST_KEYS[:3 if mode == "posterior_all" else 1]
    thr = max(float(threshold), 1e-9)
    entries = {k: [] for k in keys}
    F0, _ = _wf.start_rows(prob, torch.tensor([ragged_left], device=dev),
                           S, W)
    for Wb, wins in sorted(groups.items()):
        per_window = Kp * S * Wb * 4
        step = max(1, _F_BUDGET // per_window)
        for i in range(0, len(wins), step):
            sl = np.asarray(wins[i:i + step])
            _run_slice(hmm, t, nz, prob, sx_pad, sy_pad, fr, int(ly), L,
                       ragged_right, F0[..., :Wb], ss[sl], k0s[sl], bases[sl],
                       K, Kp, Wb, pad_off, last, mode, thr, keys, entries)
    return {"windows": nW, "xoff": frame[0],
            "post_entries": {k: _to_host(entries[k]) for k in keys}}


def _run_slice(hmm, t, nz, prob, sx_pad, sy_pad, fr, LY, L, ragged_right,
               F0, ss, k0s, bases, K, Kp, W, pad_off, last, mode, thr, keys,
               entries):
    """One slice of windows (one width group) through the forward and
    backward kernels as a batch; appends their >= thr entries."""
    dev = sx_pad.device
    S = F0.shape[1]
    n = len(ss)
    s = torch.from_numpy(ss).to(dev)
    base = torch.from_numpy(bases).to(dev)
    k0 = torch.from_numpy(k0s).to(dev)
    st = _wf.precompute_window(hmm, sx_pad, sy_pad, fr, LY, L, s, Kp, W,
                               pad_off, base=base,
                               emit=torch.stack([k0, k0 + K], 1))
    row = lambda r: r.clamp(0, last)
    band = lambda r: (fr["jlo"][row(r)] - base, fr["jhi"][row(r)] - base)

    # forward carries: the exact start for the window at row 1, else
    # neutral rows s-1 and s-2
    exact = (s == 1)[:, None, None]
    f1 = torch.where(exact, F0, _neutral(*band(s - 1), S, W))
    f2 = torch.where(exact, 0.0, _neutral(*band(s - 2), S, W))
    # one k0 serves the whole batch: every window starts at s = 1 or
    # k0 - B with K and B multiples of 8, so all share s % 4 (the phase)
    F, bv, _, _ = _wf.fwd(t, st["ex"], st["ey"], st["em"], st["a"], st["b1"],
                          st["b0"], None, nz,
                          carry=(f1, f2, torch.ones(n, device=dev)),
                          k0=int(ss[0]), site="par_fwd")

    # backward carries: neutral rows above the range, or zeros (the
    # natural start) where the range reaches past L
    top = s + Kp
    live = (top <= L).to(torch.float32)[:, None, None]
    b1 = live * _neutral(*band(top), S, W)
    b2 = live * _neutral(*band(top + 1), S, W)
    zero = torch.zeros(n, W, device=dev)
    js = torch.arange(W, device=dev)
    jlo_L, jhi_L = band(torch.full_like(s, L))
    end_row = _wf.end_rows(
        prob, torch.full((n,), bool(ragged_right), device=dev),
        ((js >= jlo_L[:, None]) & (js <= jhi_L[:, None])).to(torch.float32))
    posts, _, _, _ = _wf.bwd(
        t, st["efx"], st["efy"], st["efm"], st["em"], F, bv, st["abw"],
        st["c1"], st["c0"], st["bm1"], st["bm0"], st["pm"], end_row, nz, mode,
        carry=(b1, b2, torch.ones(n, device=dev), zero, zero),
        k0=int(ss[0]), site="par_bwd")
    for key, post in zip(keys, posts):
        wi, kl, j = torch.nonzero(post >= thr, as_tuple=True)
        entries[key].append((post[wi, kl, j], s[wi] + kl, j + base[wi]))
