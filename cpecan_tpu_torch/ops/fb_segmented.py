"""Exact streaming forward-backward of ONE long pair, window by window.

Counterpart of cpecan_tpu/ops/fb_segmented.py (TPU kernel sites 4-6:
``_fwd_call``, ``_seg_bwd_jit``, ``_seg_exp_jit``): the checkpoint/
recompute scheme of the reference's traceback windowing
(impl/pairwiseAligner.c:756-877), every window of K diagonals a launch
of the wavefront kernels (ops/fb_wavefront.py) with carry-in and
carry-out; on CPU tensors the wrappers run the kernels' plain versions.

  Pass A (forward), windows low to high: the forward kernel from the
    carry (F_{k0-1}, F_{k0-2}, 1/m_{k0-1}), keeping only each window's
    entry carry (the checkpoint, 2*S*W floats), its mf rows and, in the
    window that holds diagonal L, the end-row dot (log_fwd).
  Pass B (backward), windows high to low: the forward kernel again from
    the window's checkpoint, then the backward kernel (posterior modes)
    or the expectation kernel (with the checkpoint's two rows as the F
    halo below the window and adj1/adj2 from the global mf) from the
    TRUE backward carry (B_{k1}, B_{k1+1}, 1/mb_{k1}, em_{k1},
    bridgevec_{k1}) of the window above. Posterior blocks are compacted
    on the device (``torch.nonzero``); counts sum over the windows.

Only one window's streams and F block live on the device at a time, so
memory stays O(K * W) for any pair length. The numbers are the two-pass
engine's: same recursion, same rescale schedule (set by each window's
first global diagonal). One block walks one pair, so the card runs this
as a serial chain of diagonals (see PERF.md for its time per diagonal).
The TPU's host-link discipline and fixed-capacity compaction have no
counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from cpecan_tpu_torch.ops import fb as _fb
from cpecan_tpu_torch.ops import fb_wavefront as _wf
from cpecan_tpu_torch.ops.fb_streaming import (
    _device_pair, _host_frame, _pad_frame)

MODES = ("forward", "posterior_match", "posterior_all", "expectation")
POST_KEYS = ("post_match", "post_gap_x", "post_gap_y")


def supported(mode: str) -> bool:
    return mode in MODES


def _entries(posts, thr, k0, keys, entries):
    """Append a window's (1, K, W) posterior blocks' >= thr entries as
    device tensors (vals, global ks, js) to ``entries``."""
    for key, post in zip(keys, posts):
        ks, js = torch.nonzero(post[0] >= thr, as_tuple=True)
        entries[key].append((post[0, ks, js], ks + k0, js))


def _to_host(parts):
    """(vals, ks, js) device parts -> concatenated numpy arrays."""
    if not parts:
        return np.zeros(0, np.float32), np.zeros(0, np.int64), \
            np.zeros(0, np.int64)
    return tuple(torch.cat(c).cpu().numpy() for c in zip(*parts))


def fb_pass_segmented(hmm, seq_x_codes, seq_y_codes, offsets: np.ndarray,
                      widths: np.ndarray, lx: int, ly: int,
                      ragged_left: bool, ragged_right: bool, mode: str,
                      width: int, window: int, threshold: float = 0.0):
    """Exact streaming banded FB for ONE long pair on the PairHMM's
    device; arguments and return contract as
    ``fb_streaming.fb_pass_streaming``."""
    if not supported(mode):
        raise ValueError(f"segmented engine does not support mode={mode!r}")
    dev = hmm.t.device
    S = hmm.state_number
    W = int(width)
    K = int(window)
    L = int(lx) + int(ly)
    if L == 0:
        raise ValueError("empty pair")
    nW = -(-L // K)  # windows cover rows [1, 1 + nW*K) ⊇ [1, L]
    frame = _pad_frame(*_host_frame(np.asarray(offsets), np.asarray(widths)),
                       1 + nW * K)
    sx_pad, sy_pad, fr = _device_pair(seq_x_codes, seq_y_codes, frame,
                                      K + W + 1, dev)
    prob = _fb._prob_params(hmm)
    t, nz = hmm.t_prob_host, hmm.nz
    js = torch.arange(W, device=dev)
    end_row = _wf.end_rows(
        prob, torch.tensor([ragged_right], device=dev),
        ((js >= fr["jlo"][L]) & (js <= fr["jhi"][L])).float()[None])

    # each window's first diagonal, made on the device once (a host
    # tensor per window would be a pageable copy that waits for the queue)
    starts = torch.arange(1, 1 + nW * K, K, device=dev)

    def streams(w):
        return _wf.precompute_window(
            hmm, sx_pad, sy_pad, fr, int(ly), L, starts[w:w + 1], K, W,
            K + W + 1)

    def forward(st, carry, k0):
        return _wf.fwd(t, st["ex"], st["ey"], st["em"], st["a"], st["b1"],
                       st["b0"], None, nz, carry=carry, k0=k0,
                       site="seg_fwd")

    # ---- pass A: forward windows, keeping checkpoints and mf
    F0, m0log = _wf.start_rows(prob, torch.tensor([ragged_left], device=dev),
                               S, W)
    carry = (F0, torch.zeros_like(F0), torch.ones(1, device=dev))
    checkpoints, mf_parts = [], [m0log]
    for w in range(nW):
        k0 = 1 + w * K
        checkpoints.append(carry)
        F, _, mf_w, carry = forward(streams(w), carry, k0)
        mf_parts.append(mf_w[0])
        if k0 <= L < k0 + K:
            end_dot = torch.log(torch.sum(F[0, L - k0] * end_row[0]))
    mf_full = torch.cat(mf_parts).double().cpu().numpy()  # rows 0..nW*K
    out = {"log_fwd": float(end_dot), "mf": mf_full[:L + 1], "windows": nW}
    if mode == "forward":
        out["mb"] = np.zeros(L + 1)
        return out

    # ---- pass B: backward windows high to low, from the exact carry
    zeros = torch.zeros(1, S, W, device=dev)
    carry_b = (zeros, zeros, torch.ones(1, device=dev),
               torch.zeros(1, W, device=dev), torch.zeros(1, W, device=dev))
    mb_parts, tot_parts = [None] * nW, [None] * nW
    if mode == "expectation":
        ks = np.arange(len(mf_full))
        adj = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        adj1 = adj(np.exp(-mf_full) * (ks >= 1))
        adj2 = adj(np.exp(-(mf_full + np.concatenate([[0.0], mf_full[:-1]])))
                   * (ks >= 2))
        trans = torch.zeros(S, S, dtype=torch.float64, device=dev)
        emis = torch.zeros(S, 4, 4, dtype=torch.float64, device=dev)
    else:
        keys = POST_KEYS[:3 if mode == "posterior_all" else 1]
        entries = {k: [] for k in keys}
        thr = max(float(threshold), 1e-9)
    for w in range(nW - 1, -1, -1):
        k0 = 1 + w * K
        st = streams(w)
        F, bv, _, _ = forward(st, checkpoints[w], k0)
        back = (t, st["efx"], st["efy"], st["efm"], st["em"])
        masks = (st["abw"], st["c1"], st["c0"], st["bm1"], st["bm0"])
        if mode == "expectation":
            f1, f2, _ = checkpoints[w]
            tr, em_w, mb_w, tot_w, carry_b = _wf.exp(
                *back, st["ex"], st["ey"], F, bv, *masks, st["a"], st["b1"],
                st["b0"], st["pm"], end_row, adj1[None, k0:k0 + K],
                adj2[None, k0:k0 + K], st["wx"], st["wy"], nz,
                halo=torch.stack([f2, f1], 1), carry=carry_b, k0=k0,
                site="seg_exp")
            trans += tr[0].double()
            emis += em_w[0].double()
        else:
            posts, mb_w, tot_w, carry_b = _wf.bwd(
                *back, F, bv, *masks, st["pm"], end_row, nz, mode,
                carry=carry_b, k0=k0, site="seg_bwd")
            _entries(posts, thr, k0, keys, entries)
        mb_parts[w], tot_parts[w] = mb_w[0], tot_w[0]

    # rows 1..L of the windows' mb/total_raw; row 0 stays a placeholder
    mb = np.zeros(L + 1)
    total_raw = np.full(L + 1, -np.inf)
    mb[1:] = torch.cat(mb_parts).double().cpu().numpy()[:L]
    total_raw[1:] = torch.cat(tot_parts).double().cpu().numpy()[:L]
    out["mb"], out["total_raw"] = mb, total_raw
    if mode == "expectation":
        out["trans"] = trans.cpu().numpy()
        out["emis"] = emis.cpu().numpy()
    else:
        out["xoff"] = frame[0]
        out["post_entries"] = {k: _to_host(entries[k]) for k in keys}
    return out
