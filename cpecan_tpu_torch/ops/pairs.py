"""Aligned-pair post-processing: extraction, AMAP reweighting, scoring.

Aligned pairs follow the reference convention: (prob, x, y) with prob a
fixed-point int in [0, PAIR_ALIGNMENT_PROB_1=1e7]
(inc/pairwiseAligner.h:26; addPosteriorProb impl/pairwiseAligner.c:655-664).
Here a pair list is a structured numpy array for vectorized host math.
"""

from __future__ import annotations

import numpy as np

from cpecan_tpu_torch.utils.logmath import PAIR_ALIGNMENT_PROB_1

PAIR_DTYPE = np.dtype([("prob", np.int64), ("x", np.int64), ("y", np.int64)])


def make_pairs(probs, xs, ys) -> np.ndarray:
    out = np.empty(len(probs), dtype=PAIR_DTYPE)
    out["prob"], out["x"], out["y"] = probs, xs, ys
    return out


def empty_pairs() -> np.ndarray:
    return np.empty(0, dtype=PAIR_DTYPE)


def concat_pairs(lists) -> np.ndarray:
    lists = [l for l in lists if len(l)]
    if not lists:
        return empty_pairs()
    return np.concatenate(lists)


def frame_offsets(offsets: np.ndarray) -> np.ndarray:
    """x-frame window starts from band xmy offsets (matches the engine's
    _frame_from_band): xoff[k] = cummax over k of the left x edge."""
    ks = np.arange(len(offsets), dtype=np.int64)
    return np.maximum.accumulate((ks + offsets) // 2)


def frame_offsets_batch(offsets: np.ndarray) -> np.ndarray:
    """frame_offsets over a (B, P+1) offsets matrix, vectorized."""
    ks = np.arange(offsets.shape[1], dtype=np.int64)
    return np.maximum.accumulate((ks[None, :] + offsets) // 2, axis=1)


def extract_pairs_from_posteriors(post, offsets, L, threshold,
                                  offset_x=0, offset_y=0) -> np.ndarray:
    """Threshold a dense (P+1, W) x-frame-slot posterior array into a pair
    list (addPosteriorProb semantics: clamp to 1, floor(p*1e7), store x-1,y-1;
    reference impl/pairwiseAligner.c:655-664). Slot j of diagonal k holds
    the cell with x = xoff[k] + j."""
    post = np.asarray(post)
    xoff = frame_offsets(offsets)
    ks, js = np.nonzero(post >= threshold)
    keep = ks <= L
    ks, js = ks[keep], js[keep]
    p = np.minimum(post[ks, js], 1.0)
    xs = xoff[ks] + js
    ys = ks - xs
    return make_pairs(
        np.floor(p * PAIR_ALIGNMENT_PROB_1).astype(np.int64),
        xs - 1 + offset_x, ys - 1 + offset_y,
    )


def sort_pairs(pairs: np.ndarray) -> np.ndarray:
    return pairs[np.lexsort((pairs["prob"], pairs["y"], pairs["x"]))]


# ---------------------------------------------------------------- reweighting

def get_indel_probabilities(pairs: np.ndarray, seq_length: int, x_axis: bool) -> np.ndarray:
    """Per-position indel prob = 1e7 minus summed match posterior, clamped
    at 0 (reference getIndelProbabilities :1519-1534)."""
    indel = np.full(seq_length, PAIR_ALIGNMENT_PROB_1, dtype=np.int64)
    key = "x" if x_axis else "y"
    np.subtract.at(indel, pairs[key], pairs["prob"])
    np.maximum(indel, 0, out=indel)
    return indel


def reweight_aligned_pairs(pairs: np.ndarray, lx: int, ly: int, gap_gamma: float) -> np.ndarray:
    """AMAP reweighting: prob -= gamma*(indelProbX[x] + indelProbY[y])
    (reference reweightAlignedPairs2 :1550-1560; no-op when gamma <= 0)."""
    if gap_gamma <= 0.0 or len(pairs) == 0:
        return pairs
    indel_x = get_indel_probabilities(pairs, lx, True)
    indel_y = get_indel_probabilities(pairs, ly, False)
    out = pairs.copy()
    # C computes int64 = int64 - double * (...): truncation toward zero
    out["prob"] = (pairs["prob"]
                   - (gap_gamma * (indel_x[pairs["x"]] + indel_y[pairs["y"]])).astype(np.int64))
    return out


# ------------------------------------------------------------------- scoring

def _matching(seq_x: str, seq_y: str, pairs: np.ndarray) -> int:
    """Count pairs whose bases match case-insensitively (N never matches);
    reference getNumberOfMatchingAlignedPairs :1562-1570."""
    n = 0
    for p in pairs:
        cx, cy = seq_x[p["x"]].upper(), seq_y[p["y"]].upper()
        n += cx == cy and cx != "N"
    return int(n)


def score_by_identity(seq_x: str, seq_y: str, pairs: np.ndarray) -> float:
    lx, ly = len(seq_x), len(seq_y)
    m = _matching(seq_x, seq_y, pairs)
    return 100.0 * (0 if lx + ly == 0 else 2.0 * m / (lx + ly))


def score_by_identity_ignoring_gaps(seq_x: str, seq_y: str, pairs: np.ndarray) -> float:
    if len(pairs) == 0:
        return 0.0
    return 100.0 * _matching(seq_x, seq_y, pairs) / len(pairs)


def score_by_posterior_probability(lx: int, ly: int, pairs: np.ndarray) -> float:
    total = float(pairs["prob"].sum())
    return 100.0 * (0 if lx + ly == 0 else 2.0 * total / ((lx + ly) * PAIR_ALIGNMENT_PROB_1))


def score_by_posterior_probability_ignoring_gaps(pairs: np.ndarray) -> float:
    if len(pairs) == 0:
        return 0.0
    return 100.0 * float(pairs["prob"].sum()) / (len(pairs) * PAIR_ALIGNMENT_PROB_1)
