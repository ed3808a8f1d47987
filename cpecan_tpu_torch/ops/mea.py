"""Maximal-expected-accuracy decoding and left-shift normalization.

Host-side sequential decoders (the TPU computes the posteriors; these are
pointer-chasing DPs over the sparse pair list). Semantics:
  - MEA (Schwartz & Pachter): reference impl/pairwiseAligner.c:1628-1724,
    including the cumulative-gap-prob arrays (:1603-1626) and the
    isHighScore back-scan prune (:1683-1688).
  - left-shift: shifts indels maximally left when flanking bases match
    (reference :1726-1762).
"""

from __future__ import annotations

import numpy as np

from cpecan_tpu_torch.ops.pairs import PAIR_DTYPE, make_pairs, empty_pairs


def _cumulative_gap_probs(gap_pairs: np.ndarray, seq_length: int, x_axis: bool) -> np.ndarray:
    """Cumulative per-position gap posterior mass (reference :1603-1620)."""
    probs = np.zeros(seq_length, dtype=np.int64)
    if len(gap_pairs):
        key = "x" if x_axis else "y"
        np.add.at(probs, gap_pairs[key], gap_pairs["prob"])
    return np.cumsum(probs)


def _indel_prob(cum: np.ndarray, start: int, length: int) -> int:
    if length <= 0:
        return 0
    return int(cum[start + length - 1] - (cum[start - 1] if start > 0 else 0))


def _mea_core_python(probs, xs, ys, cum_gap_x, cum_gap_y, lx, ly,
                     gap_gamma):
    """The MEA DP loop in numpy/Python — the parity oracle for the
    native decoder (native/mea.cpp), same float64 op order."""
    n = len(probs)
    scores = np.zeros(n + 1)
    back = np.full(n + 1, -1, dtype=np.int64)
    is_high = np.zeros(n + 1, dtype=bool)
    max_score = 0.0

    for i in range(n + 1):
        if i == n:
            match_prob, x, y = 0, lx, ly
        else:
            match_prob, x, y = int(probs[i]), int(xs[i]), int(ys[i])

        score = match_prob + (_indel_prob(cum_gap_x, 0, x)
                              + _indel_prob(cum_gap_y, 0, y)) * gap_gamma
        bp = -1
        for j in range(i - 1, -1, -1):
            x2, y2 = int(xs[j]), int(ys[j])
            if x2 < x and y2 < y:
                s = match_prob + scores[j] + (
                    _indel_prob(cum_gap_x, x2 + 1, x - x2 - 1)
                    + _indel_prob(cum_gap_y, y2 + 1, y - y2 - 1)) * gap_gamma
                if s > score:
                    score = s
                    bp = j
                if is_high[j]:
                    break
        back[i] = bp
        scores[i] = score

        s = score + ((_indel_prob(cum_gap_x, x + 1, lx - x - 1) if x < lx else 0)
                     + (_indel_prob(cum_gap_y, y + 1, ly - y - 1) if y < ly else 0)) * gap_gamma
        if s >= max_score:
            max_score = s
            is_high[i] = True

    # Traceback
    chosen = []
    i = back[n]
    while i >= 0:
        chosen.append(i)
        i = back[i]
    chosen.reverse()
    return np.asarray(chosen, dtype=np.int64), max_score


def mea_alignment(aligned_pairs: np.ndarray, gap_x_pairs: np.ndarray,
                  gap_y_pairs: np.ndarray, lx: int, ly: int,
                  gap_gamma: float):
    """Sparse MEA DP over the posterior pair list.

    aligned_pairs must be in a topological order of the (x<x', y<y')
    partial order (the diagonal-major emission order is). Returns
    (alignment pairs, score). Score = match posterior + gamma * skipped gap
    posterior, exactly the reference recurrence (:1647-1702). Runs the
    native C++ decoder when available (bit-compatible), else the Python
    loop."""
    from cpecan_tpu_torch.align import native

    cum_gap_x = _cumulative_gap_probs(gap_x_pairs, lx, True)
    cum_gap_y = _cumulative_gap_probs(gap_y_pairs, ly, False)

    probs = np.ascontiguousarray(aligned_pairs["prob"], np.int64)
    xs = np.ascontiguousarray(aligned_pairs["x"], np.int64)
    ys = np.ascontiguousarray(aligned_pairs["y"], np.int64)

    if native.available():
        idx, max_score = native.mea_decode(
            probs, xs, ys, cum_gap_x, cum_gap_y, lx, ly, gap_gamma)
    else:
        idx, max_score = _mea_core_python(
            probs, xs, ys, cum_gap_x, cum_gap_y, lx, ly, gap_gamma)
    if not len(idx):
        return empty_pairs(), max_score
    return make_pairs(probs[idx], xs[idx], ys[idx]), max_score


def left_shift_alignment(aligned_pairs: np.ndarray, seq_x: str, seq_y: str) -> np.ndarray:
    """Shift indels maximally left where flanking bases match (reference
    :1726-1762). Walks pairs right-to-left; inserted pairs borrow the score
    of the pair being considered."""
    lx, ly = len(seq_x), len(seq_y)
    sx = seq_x.upper()
    sy = seq_y.upper()
    out_p, out_x, out_y = [], [], []

    x, y = lx, ly
    for i in range(len(aligned_pairs) - 1, -1, -1):
        prob = int(aligned_pairs["prob"][i])
        x2, y2 = int(aligned_pairs["x"][i]), int(aligned_pairs["y"][i])
        while (x - x2 > 1 or y - y2 > 1) and sx[x - 1] == sy[y - 1]:
            out_p.append(prob)
            out_x.append(x - 1)
            out_y.append(y - 1)
            x -= 1
            y -= 1
            if x2 == x or y2 == y:
                break
        if x2 < x and y2 < y:
            out_p.append(prob)
            out_x.append(x2)
            out_y.append(y2)
            x, y = x2, y2

    # boundary at the beginning of the alignment
    while x > 0 and y > 0 and sx[x - 1] == sy[y - 1]:
        score = int(aligned_pairs["prob"][0]) if len(aligned_pairs) else 1
        out_p.append(score)
        out_x.append(x - 1)
        out_y.append(y - 1)
        x -= 1
        y -= 1

    if not out_p:
        return empty_pairs()
    return make_pairs(out_p[::-1], out_x[::-1], out_y[::-1])
