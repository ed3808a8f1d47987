"""Large-gap problem splitting.

Gaps between consecutive anchors whose sub-matrix exceeds
splitMatrixBiggerThanThis split the alignment into independent chunks
(reference getSplitPoints, impl/pairwiseAligner.c:1206-1257); ragged-end
flags propagate to the outermost chunks only (:1311-1312).

Anchors arrive as an (N, k>=2) numpy array (or tuple list); both
functions are vectorized over anchors — splits are located with one
scan over inter-anchor gap areas, so per-base anchor lists (realign
feeds one anchor per matched base) cost O(N) numpy, not O(N) Python.
"""

from __future__ import annotations

import math

import numpy as np


def _as_array(anchor_pairs) -> np.ndarray:
    arr = np.asarray(anchor_pairs, dtype=np.int64)
    if arr.ndim == 1:
        arr = arr.reshape(0, 3)
    return arr


def get_split_points(anchor_pairs, lx: int, ly: int,
                     split_matrix_bigger_than_this: int,
                     ragged_left: bool, ragged_right: bool) -> list:
    """Returns a list of (x1, y1, x2, y2) sub-rectangles covering the
    alignment path."""
    assert lx >= 0 and ly >= 0
    anchors = _as_array(anchor_pairs)
    n = len(anchors)

    # gap i (0..n) runs from exclusive predecessor (x2_i, y2_i) to
    # anchor i (or the corner for i == n)
    ax = anchors[:, 0]
    ay = anchors[:, 1]
    x2 = np.concatenate([[0], ax + 1])
    y2 = np.concatenate([[0], ay + 1])
    x3 = np.concatenate([ax, [lx]])
    y3 = np.concatenate([ay, [ly]])
    if n:
        assert np.all(ax[:-1] <= ax[1:]) and np.all(ay[:-1] <= ay[1:])
        assert ax[-1] < lx and ay[-1] < ly and ax[0] >= 0 and ay[0] >= 0
    areas = (x3 - x2) * (y3 - y2)
    big = np.flatnonzero(areas > split_matrix_bigger_than_this)

    max_len = int(math.sqrt(split_matrix_bigger_than_this))
    split_points: list = []
    x1, y1 = 0, 0
    closed_by_split = False
    for gi in big:
        gx2, gy2 = int(x2[gi]), int(y2[gi])
        gx3, gy3 = int(x3[gi]), int(y3[gi])
        hx = min((gx3 - gx2) // 2, max_len)
        hy = min((gy3 - gy2) // 2, max_len)
        skip_block = ragged_left and gi == 0
        if not skip_block:
            split_points.append((x1, y1, gx2 + hx, gy2 + hy))
        x1, y1 = gx3 - hx, gy3 - hy
        closed_by_split = gi == n
    if not (closed_by_split and ragged_right):
        split_points.append((x1, y1, lx, ly))
    return split_points


def split_anchors(anchor_pairs, split_points):
    """Partition anchors among split rectangles, shifting into local
    coordinates (reference :1294-1308). Yields (rect, local_anchors) with
    local_anchors an (M, k) array."""
    anchors = _as_array(anchor_pairs)
    xy = anchors[:, 0] + anchors[:, 1]
    assert np.all(xy[:-1] <= xy[1:])
    j = 0
    n = len(anchors)
    for (x1, y1, x2, y2) in split_points:
        j2 = j + int(np.searchsorted(xy[j:], x2 + y2, side="left"))
        local = anchors[j:j2].copy()
        if len(local):
            assert local[0, 0] + local[0, 1] >= x1 + y1
            assert (local[:, 0] >= x1).all() and (local[:, 0] < x2).all()
            assert (local[:, 1] >= y1).all() and (local[:, 1] < y2).all()
            local[:, 0] -= x1
            local[:, 1] -= y1
        j = j2
        yield (x1, y1, x2, y2), local
    assert j == n
