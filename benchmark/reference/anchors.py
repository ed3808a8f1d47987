"""Frozen copy of the port's numpy anchoring (align/anchors.py), kept with
the benchmark so that no later change to the program moves the
yardstick. It differs from the original in its imports, in taking the
parameters as arguments, in finding the seeds' cross products in array
operations instead of one Python iteration per shared k-mer (the same
set of seeds), and in having neither the native fast path nor the lastz
route.

cPecanAlign anchors a pair with lastz (impl/pairwiseAligner.c:1032-1061);
the port and this copy chain exact k-mer seeds instead: 12-mer seeds
(k-mers seen more than 32 times in either sequence dropped, no seed in
lowercase) -> runs along a diagonal -> the heaviest chain of runs
increasing in both sequences -> same-diagonal neighbours bridged over up
to 64 mismatching bases -> per-base anchors with constraintDiagonalTrim
bases trimmed off each run end -> the overlap filter
(filterToRemoveOverlap, :1095-1135) -> every gap between anchors larger
than anchorMatrixBiggerThanThis anchored again (:1162-1196), with the
repeat mask lifted in gaps no larger than repeatMaskMatrixBiggerThanThis.
"""

from __future__ import annotations

import numpy as np

KMER = 12
MAX_KMER_OCCURRENCES = 32
MAX_BRIDGE_GAP = 64


def _kmer_codes(seq: str, k: int, respect_mask: bool):
    """Packed 2-bit k-mer codes per position (length len-k+1); -1 where the
    window holds an N or (when respect_mask) a lowercase base."""
    n = len(seq)
    if n < k:
        return np.empty(0, dtype=np.int64)
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    upper = raw & 0xDF
    code = np.full(n, -1, dtype=np.int64)
    for i, b in enumerate(b"ACGT"):
        code[upper == b] = i
    invalid = code < 0
    if respect_mask:
        invalid |= raw >= ord("a")
    out = np.zeros(n - k + 1, dtype=np.int64)
    bad = np.zeros(n - k + 1, dtype=bool)
    c = np.where(invalid, 0, code)
    for j in range(k):
        out = out * 4 + c[j: n - k + 1 + j]
        bad |= invalid[j: n - k + 1 + j]
    out[bad] = -1
    return out


def _positions(codes):
    """(unique codes, positions sorted by code, start of each code's
    positions, their count)."""
    valid = np.nonzero(codes >= 0)[0]
    if len(valid) == 0:
        return (np.empty(0, np.int64),) * 4
    order = valid[np.argsort(codes[valid], kind="stable")]
    sorted_codes = codes[order]
    starts = np.nonzero(np.r_[True, sorted_codes[1:] != sorted_codes[:-1]])[0]
    counts = np.diff(np.r_[starts, len(sorted_codes)])
    return sorted_codes[starts], order, starts, counts


def find_seeds(seq_x: str, seq_y: str, k: int = KMER,
               respect_mask: bool = True,
               max_occ: int = MAX_KMER_OCCURRENCES) -> np.ndarray:
    """Exact k-mer matches (x, y) of X and Y, sorted by x then y, without
    the k-mers seen more than max_occ times in either sequence."""
    empty = np.empty((0, 2), dtype=np.int64)
    kx = _kmer_codes(seq_x, k, respect_mask)
    ky = _kmer_codes(seq_y, k, respect_mask)
    if len(kx) == 0 or len(ky) == 0:
        return empty
    cx, ox, sx, nx = _positions(kx)
    cy, oy, sy, ny = _positions(ky)
    if len(cx) == 0 or len(cy) == 0:
        return empty
    iy = np.clip(np.searchsorted(cy, cx), 0, len(cy) - 1)
    shared = np.nonzero((cy[iy] == cx) & (nx <= max_occ)
                        & (ny[iy] <= max_occ))[0]
    if len(shared) == 0:
        return empty
    ax, ay = nx[shared], ny[iy[shared]]
    cnt = ax * ay  # each shared k-mer's cross product of positions
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    within = np.arange(int(cnt.sum()), dtype=np.int64) - first
    ay_r = np.repeat(ay, cnt)
    xs = ox[np.repeat(sx[shared], cnt) + within // ay_r]
    ys = oy[np.repeat(sy[iy[shared]], cnt) + within % ay_r]
    seeds = np.stack([xs, ys], axis=1)
    return seeds[np.lexsort((seeds[:, 1], seeds[:, 0]))]


def merge_seeds_to_runs(seeds: np.ndarray, k: int) -> np.ndarray:
    """Diagonal-adjacent or overlapping seeds merged into maximal runs
    (x, y, length), sorted by x then y."""
    if len(seeds) == 0:
        return np.empty((0, 3), dtype=np.int64)
    diag = seeds[:, 0] - seeds[:, 1]
    order = np.lexsort((seeds[:, 0], diag))
    s = seeds[order]
    d = diag[order]
    new_run = np.r_[True, (d[1:] != d[:-1]) | (s[1:, 0] > s[:-1, 0] + k)]
    starts = np.nonzero(new_run)[0]
    last_in_run = np.r_[starts[1:] - 1, len(s) - 1]
    run_end = s[last_in_run, 0] + k
    runs = np.stack([s[starts, 0], s[starts, 1], run_end - s[starts, 0]],
                    axis=1)
    return runs[np.lexsort((runs[:, 1], runs[:, 0]))]


class _FenwickMax:
    """Fenwick tree over y-ranks holding (best score, its index)."""

    def __init__(self, n: int):
        self.n = n
        self.score = np.zeros(n + 1, dtype=np.int64)
        self.idx = np.full(n + 1, -1, dtype=np.int64)

    def update(self, i: int, score: int, idx: int):
        i += 1
        while i <= self.n:
            if score > self.score[i]:
                self.score[i] = score
                self.idx[i] = idx
            i += i & (-i)

    def query(self, i: int):
        i += 1
        best, bidx = 0, -1
        while i > 0:
            if self.score[i] > best:
                best, bidx = self.score[i], self.idx[i]
            i -= i & (-i)
        return best, bidx


def chain_runs(runs: np.ndarray) -> np.ndarray:
    """The chain of runs strictly increasing in both sequences whose
    matched bases sum highest."""
    n = len(runs)
    if n == 0:
        return runs
    x0, y0, ln = runs[:, 0], runs[:, 1], runs[:, 2]
    x1, y1 = x0 + ln, y0 + ln
    y_vals = np.unique(y1)
    y_rank_of = {v: i for i, v in enumerate(y_vals)}
    insert_order = np.argsort(x1, kind="stable")
    fen = _FenwickMax(len(y_vals))
    score = np.zeros(n, dtype=np.int64)
    back = np.full(n, -1, dtype=np.int64)
    ins_ptr = 0
    for i in np.argsort(x0, kind="stable"):
        while ins_ptr < n and x1[insert_order[ins_ptr]] <= x0[i]:
            j = insert_order[ins_ptr]
            fen.update(y_rank_of[y1[j]], score[j], j)
            ins_ptr += 1
        r = int(np.searchsorted(y_vals, y0[i], side="right")) - 1
        best, bidx = fen.query(r) if r >= 0 else (0, -1)
        score[i] = best + ln[i]
        back[i] = bidx
    best_i = int(np.argmax(score))
    chain = []
    while best_i >= 0:
        chain.append(best_i)
        best_i = int(back[best_i])
    chain.reverse()
    return runs[chain]


def merge_colinear_runs(runs: np.ndarray,
                        max_gap: int = MAX_BRIDGE_GAP) -> np.ndarray:
    """Consecutive chained runs on one diagonal, at most max_gap bases
    apart, merged into one run across the mismatches between them."""
    if len(runs) <= 1:
        return runs
    runs = np.asarray(runs, dtype=np.int64)
    x, y, ln = runs[:, 0], runs[:, 1], runs[:, 2]
    same_diag = (x[1:] - y[1:]) == (x[:-1] - y[:-1])
    bridged = same_diag & (x[1:] - (x[:-1] + ln[:-1]) <= max_gap)
    starts = np.flatnonzero(np.r_[True, ~bridged])
    last = np.r_[starts[1:] - 1, len(runs) - 1]
    return np.stack([x[starts], y[starts], x[last] + ln[last] - x[starts]],
                    axis=1)


def runs_to_anchor_pairs(runs: np.ndarray, trim: int,
                         expansion: int) -> np.ndarray:
    """Per-base (x, y, expansion) anchors of the runs, trim bases off each
    run end."""
    if len(runs) == 0:
        return np.empty((0, 3), np.int64)
    runs = np.asarray(runs, dtype=np.int64)
    lens = np.maximum(runs[:, 2] - 2 * trim, 0)
    if lens.sum() == 0:
        return np.empty((0, 3), np.int64)
    off = (np.arange(lens.sum(), dtype=np.int64)
           - np.repeat(np.cumsum(lens) - lens, lens))
    out = np.empty((len(off), 3), np.int64)
    out[:, 0] = np.repeat(runs[:, 0] + trim, lens) + off
    out[:, 1] = np.repeat(runs[:, 1] + trim, lens) + off
    out[:, 2] = expansion
    return out


def filter_to_remove_overlap(pairs) -> np.ndarray:
    """The anchors (sorted by x then y) strictly above every earlier one
    and strictly below every later one in both sequences; of exact
    duplicates the first."""
    arr = np.asarray(pairs, dtype=np.int64)
    if arr.ndim == 1:
        arr = arr.reshape(0, 3)
    if len(arr) <= 1:
        return arr
    xs, ys = arr[:, 0], arr[:, 1]
    first = np.r_[True, (xs[1:] != xs[:-1]) | (ys[1:] != ys[:-1])]
    srcs = None if first.all() else np.flatnonzero(first)
    if srcs is not None:
        xs, ys = xs[srcs], ys[srcs]
    big, small = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    suf_x = np.r_[np.minimum.accumulate(xs[::-1])[::-1][1:], big]
    suf_y = np.r_[np.minimum.accumulate(ys[::-1])[::-1][1:], big]
    pre_x = np.r_[small, np.maximum.accumulate(xs)[:-1]]
    pre_y = np.r_[small, np.maximum.accumulate(ys)[:-1]]
    kept = np.flatnonzero((xs < suf_x) & (ys < suf_y)
                          & (xs > pre_x) & (ys > pre_y))
    return arr[kept if srcs is None else srcs[kept]]


def blast_pairs(seq_x: str, seq_y: str, trim: int, expansion: int,
                repeat_mask: bool) -> np.ndarray:
    """One rectangle's anchors, sorted by x + y (getBlastPairs)."""
    seeds = find_seeds(seq_x, seq_y, respect_mask=repeat_mask)
    chained = merge_colinear_runs(chain_runs(merge_seeds_to_runs(seeds, KMER)))
    pairs = runs_to_anchor_pairs(chained, trim, expansion)
    return pairs[np.argsort(pairs[:, 0] + pairs[:, 1], kind="stable")]


def _sort_rows(arr: np.ndarray) -> np.ndarray:
    return arr[np.lexsort((arr[:, 1], arr[:, 0]))]


def get_anchors(seq_x: str, seq_y: str, trim: int, expansion: int,
                anchor_area: int, repeat_mask_area: int) -> np.ndarray:
    """(x, y, expansion) anchors of a pair, strictly increasing in both
    sequences: the whole pair's, then each gap of area above anchor_area
    anchored again inside its rectangle."""
    lx, ly = len(seq_x), len(seq_y)
    if lx * ly <= anchor_area:
        return np.empty((0, 3), np.int64)
    top = filter_to_remove_overlap(_sort_rows(
        blast_pairs(seq_x, seq_y, trim, expansion, True)))
    ax, ay = top[:, 0], top[:, 1]
    px = np.concatenate([[0], ax + 1])
    py = np.concatenate([[0], ay + 1])
    ex = np.concatenate([ax, [lx]])
    ey = np.concatenate([ay, [ly]])
    pieces, prev = [], 0
    for gi in np.flatnonzero((ex - px) * (ey - py) > anchor_area):
        gx1, gy1, gx2, gy2 = int(px[gi]), int(py[gi]), int(ex[gi]), int(ey[gi])
        sub = filter_to_remove_overlap(_sort_rows(blast_pairs(
            seq_x[gx1:gx2], seq_y[gy1:gy2], trim, expansion,
            (gx2 - gx1) * (gy2 - gy1) > repeat_mask_area)))
        pieces.append(top[prev:gi])
        if len(sub):
            pieces.append(sub + np.array([gx1, gy1, 0], np.int64))
        prev = gi
    pieces.append(top[prev:])
    return np.concatenate(pieces, axis=0)
