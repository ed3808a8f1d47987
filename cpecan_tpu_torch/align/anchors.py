"""Anchor generation: k-mer seed-and-chain, the lastz-subprocess replacement.

The reference anchors large problems by piping sequences through a vendored
lastz binary (`cPecanLastz --hspthresh=800 --chain --strand=plus --gapped
--format=cigar`, impl/pairwiseAligner.c:1032-1061), converting the chained
cigars to per-base match pairs (:979-1003), overlap-filtering (:1095-1135)
and recursively re-anchoring large gaps (:1137-1196).

Here anchoring is a host-side vectorized numpy stage (with an optional
native C++ fast path): exact k-mer seeds -> diagonal-run merging -> weighted
monotone chaining (Fenwick-tree LIS over y-ranks) -> per-base pairs with
trim. The banding parameters downstream are forgiving (posteriors, not hard
constraints), so chain quality, not exact lastz parity, is what matters;
`filter_to_remove_overlap` and the gap recursion match the C semantics
exactly.

Repeat masking: lastz does not seed inside soft-masked (lowercase) repeat
regions; we mirror that by skipping seeds whose k-mer window is lowercase,
and the recursion unmasks (uppercases) small gap matrices exactly like the
reference (getBlastPairs :1016-1019).
"""

from __future__ import annotations

import os

import numpy as np

from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.io.cigar import alignment_to_anchor_pairs, cigar_read

DEFAULT_KMER = 12
MAX_KMER_OCCURRENCES = 32


def _kmer_codes(seq: str, k: int, respect_mask: bool):
    """Packed 2-bit k-mer codes per position (length len-k+1); -1 where the
    window contains N or (when respect_mask) any lowercase base."""
    n = len(seq)
    if n < k:
        return np.empty(0, dtype=np.int64)
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    upper = raw & 0xDF  # ascii uppercase
    code = np.full(n, -1, dtype=np.int64)
    for i, b in enumerate(b"ACGT"):
        code[upper == b] = i
    invalid = code < 0
    if respect_mask:
        invalid |= raw >= ord("a")  # lowercase = repeat-masked

    # rolling pack: kmer[i] = sum code[i+j] * 4^(k-1-j)
    out = np.zeros(n - k + 1, dtype=np.int64)
    bad = np.zeros(n - k + 1, dtype=bool)
    c = np.where(invalid, 0, code)
    for j in range(k):
        out = out * 4 + c[j : n - k + 1 + j]
        bad |= invalid[j : n - k + 1 + j]
    out[bad] = -1
    return out


def find_seeds(seq_x: str, seq_y: str, k: int = DEFAULT_KMER,
               respect_mask: bool = True,
               max_occ: int = MAX_KMER_OCCURRENCES) -> np.ndarray:
    """Exact k-mer matches between X and Y as an (n, 2) array of (x, y)
    start positions. K-mers occurring more than max_occ times in either
    sequence are dropped (repeat suppression, lastz's seed-count limiting)."""
    kx = _kmer_codes(seq_x, k, respect_mask)
    ky = _kmer_codes(seq_y, k, respect_mask)
    if len(kx) == 0 or len(ky) == 0:
        return np.empty((0, 2), dtype=np.int64)

    def positions(codes):
        valid = np.nonzero(codes >= 0)[0]
        if len(valid) == 0:
            return (np.empty(0, np.int64),) * 4
        order = valid[np.argsort(codes[valid], kind="stable")]
        sorted_codes = codes[order]
        starts = np.nonzero(np.r_[True, sorted_codes[1:] != sorted_codes[:-1]])[0]
        counts = np.diff(np.r_[starts, len(sorted_codes)])
        return sorted_codes[starts], order, starts, counts

    cx, ox, sx_starts, sx_counts = positions(kx)
    cy, oy, sy_starts, sy_counts = positions(ky)
    if len(cx) == 0 or len(cy) == 0:
        return np.empty((0, 2), dtype=np.int64)

    # join the two sorted unique-code lists
    ix = np.searchsorted(cy, cx)
    ix_valid = (ix < len(cy))
    shared = np.nonzero(ix_valid & (cy[np.clip(ix, 0, len(cy) - 1)] == cx))[0]

    xs_list, ys_list = [], []
    for ci in shared:
        nx = sx_counts[ci]
        yj = ix[ci]
        ny = sy_counts[yj]
        if nx > max_occ or ny > max_occ:
            continue
        px = ox[sx_starts[ci] : sx_starts[ci] + nx]
        py = oy[sy_starts[yj] : sy_starts[yj] + ny]
        grid = np.meshgrid(px, py, indexing="ij")
        xs_list.append(grid[0].ravel())
        ys_list.append(grid[1].ravel())
    if not xs_list:
        return np.empty((0, 2), dtype=np.int64)
    seeds = np.stack([np.concatenate(xs_list), np.concatenate(ys_list)], axis=1)
    return seeds[np.lexsort((seeds[:, 1], seeds[:, 0]))]


def merge_seeds_to_runs(seeds: np.ndarray, k: int) -> np.ndarray:
    """Merge diagonal-adjacent/overlapping seeds into maximal runs.
    Returns (n, 3) array of (x, y, length)."""
    if len(seeds) == 0:
        return np.empty((0, 3), dtype=np.int64)
    diag = seeds[:, 0] - seeds[:, 1]
    order = np.lexsort((seeds[:, 0], diag))
    s = seeds[order]
    d = diag[order]
    # a seed continues a run if same diagonal and x within k of previous end
    new_run = np.r_[True, (d[1:] != d[:-1]) | (s[1:, 0] > s[:-1, 0] + k)]
    run_id = np.cumsum(new_run) - 1
    starts = np.nonzero(new_run)[0]
    n_runs = len(starts)
    run_x = s[starts, 0]
    run_y = s[starts, 1]
    last_in_run = np.r_[starts[1:] - 1, len(s) - 1]
    run_end = s[last_in_run, 0] + k
    runs = np.stack([run_x, run_y, run_end - run_x], axis=1)
    return runs[np.lexsort((runs[:, 1], runs[:, 0]))]


class _FenwickMax:
    """Fenwick tree over y-ranks holding (best score, best index)."""

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
        """Max over ranks [0, i]."""
        i += 1
        best, bidx = 0, -1
        while i > 0:
            if self.score[i] > best:
                best, bidx = self.score[i], self.idx[i]
            i -= i & (-i)
        return best, bidx


def chain_runs(runs: np.ndarray) -> np.ndarray:
    """Highest-weight chain of runs strictly monotone in both coordinates
    (weight = matched bases). O(n log n) sparse DP, the --chain step."""
    n = len(runs)
    if n == 0:
        return runs
    # order by run END x so predecessors (whole run before our start) come first
    x0, y0, ln = runs[:, 0], runs[:, 1], runs[:, 2]
    x1, y1 = x0 + ln, y0 + ln

    y_rank_of = {v: i for i, v in enumerate(np.unique(y1))}
    y_vals = np.unique(y1)

    order = np.argsort(x1, kind="stable")
    fen = _FenwickMax(len(y_vals))
    score = np.zeros(n, dtype=np.int64)
    back = np.full(n, -1, dtype=np.int64)

    # sweep by x-start; insert runs whose x-end <= current x-start
    insert_order = order
    ins_ptr = 0
    proc_order = np.argsort(x0, kind="stable")
    for i in proc_order:
        while ins_ptr < n and x1[insert_order[ins_ptr]] <= x0[i]:
            j = insert_order[ins_ptr]
            fen.update(y_rank_of[y1[j]], score[j], j)
            ins_ptr += 1
        # best predecessor with y-end <= our y-start
        r = int(np.searchsorted(y_vals, y0[i], side="right")) - 1
        if r >= 0:
            best, bidx = fen.query(r)
        else:
            best, bidx = 0, -1
        score[i] = best + ln[i]
        back[i] = bidx

    best_i = int(np.argmax(score))
    chain = []
    while best_i >= 0:
        chain.append(best_i)
        best_i = int(back[best_i])
    chain.reverse()
    return runs[chain]


def runs_to_anchor_pairs(runs: np.ndarray, trim: int,
                         expansion: int) -> np.ndarray:
    """Per-base (x, y, expansion) triples from match runs, trimming `trim`
    bases off each run end (reference anchor conversion :985-998).
    Returns an (N, 3) int64 array — anchors stay numpy end-to-end through
    filter/split/band construction (no per-base Python tuples on the
    host critical path)."""
    if len(runs) == 0:
        return np.empty((0, 3), np.int64)
    runs = np.asarray(runs, dtype=np.int64)
    lens = np.maximum(runs[:, 2] - 2 * trim, 0)
    if lens.sum() == 0:
        return np.empty((0, 3), np.int64)
    starts = np.repeat(runs[:, 0] + trim, lens)
    ys = np.repeat(runs[:, 1] + trim, lens)
    # offset within each run: arange restarted at every run boundary
    idx = np.arange(lens.sum(), dtype=np.int64)
    run_start = np.repeat(np.cumsum(lens) - lens, lens)
    off = idx - run_start
    out = np.empty((len(idx), 3), np.int64)
    out[:, 0] = starts + off
    out[:, 1] = ys + off
    out[:, 2] = expansion
    return out


def filter_to_remove_overlap(pairs) -> np.ndarray:
    """Keep the maximal subset of pairs strictly monotone in both coords.
    Same semantics as the two-pass backward/forward filter (reference
    filterToRemoveOverlap, impl/pairwiseAligner.c:1095-1135), vectorized:
    the backward pass keeps pairs strictly below the exclusive suffix
    minima of both coords, the forward pass those strictly above the
    exclusive prefix maxima — prefix/suffix scans instead of the running
    min/max loop. (Index-wise AND of the two passes equals the
    reference's value-set intersection: a duplicate (x, y) can never pass
    the strict prefix-max test twice.) Input must be sorted ascending
    (row order); accepts an (N, k>=2) array or a tuple list, returns an
    (N, k) int64 array."""
    arr = np.asarray(pairs, dtype=np.int64)
    if arr.ndim == 1:
        arr = arr.reshape(0, 3)
    n = len(arr)
    if n <= 1:
        return arr
    xs = arr[:, 0]
    ys = arr[:, 1]
    # exact duplicates (adjacent when sorted): the reference's value-set
    # intersection keeps the first copy; collapse to one before the scans
    first = np.r_[True, (xs[1:] != xs[:-1]) | (ys[1:] != ys[:-1])]
    if not first.all():
        srcs = np.flatnonzero(first)
        xs, ys = xs[srcs], ys[srcs]
    else:
        srcs = None
    big = np.iinfo(np.int64).max
    small = np.iinfo(np.int64).min
    # exclusive suffix minima (backward pass running minima)
    suf_x = np.r_[np.minimum.accumulate(xs[::-1])[::-1][1:], big]
    suf_y = np.r_[np.minimum.accumulate(ys[::-1])[::-1][1:], big]
    # exclusive prefix maxima (forward pass running maxima)
    pre_x = np.r_[small, np.maximum.accumulate(xs)[:-1]]
    pre_y = np.r_[small, np.maximum.accumulate(ys)[:-1]]
    keep = (xs < suf_x) & (ys < suf_y) & (xs > pre_x) & (ys > pre_y)
    kept = np.flatnonzero(keep)
    if srcs is not None:
        kept = srcs[kept]
    return arr[kept]


# Max mismatch stretch bridged when merging same-diagonal chained runs
# into one match run (the gapped-extension analog; lastz's x-drop stops
# extension through long non-matching stretches).
MAX_BRIDGE_GAP = 64


def merge_colinear_runs(runs: np.ndarray,
                        max_gap: int = MAX_BRIDGE_GAP) -> np.ndarray:
    """Merge consecutive chained runs on the same diagonal into single
    match runs spanning the substitutions between them.

    This is the gapped-extension step of the anchor pipeline: lastz's
    cigar M runs include substitutions — only indels break them
    (--gapped, reference command line impl/pairwiseAligner.c:1034) — so
    the reference's anchor runs span mismatches too. Exact-seed chains
    break at every mismatch instead, and the downstream anchor trim
    (constraintDiagonalTrim, default 14/side) would erase them entirely;
    bridging same-diagonal neighbors (up to max_gap mismatch bases)
    restores the M-run structure the trim semantics assume."""
    if len(runs) <= 1:
        return runs
    runs = np.asarray(runs, dtype=np.int64)
    x, y, ln = runs[:, 0], runs[:, 1], runs[:, 2]
    same_diag = (x[1:] - y[1:]) == (x[:-1] - y[:-1])
    bridged = same_diag & (x[1:] - (x[:-1] + ln[:-1]) <= max_gap)
    new_run = np.r_[True, ~bridged]
    starts = np.flatnonzero(new_run)
    last = np.r_[starts[1:] - 1, len(runs) - 1]
    return np.stack([x[starts], y[starts], x[last] + ln[last] - x[starts]],
                    axis=1)


def get_chained_runs(seq_x: str, seq_y: str, repeat_mask: bool,
                     k: int = DEFAULT_KMER,
                     max_occ: int = MAX_KMER_OCCURRENCES) -> np.ndarray:
    """Chained match runs (n, 3) of (x, y, len): native C++ fast path
    (native/anchors.cpp via align/native.py) with numpy fallback, followed
    by same-diagonal bridging (merge_colinear_runs)."""
    from cpecan_tpu_torch.align import native

    if native.available():
        chained = native.chained_runs(seq_x, seq_y, k, max_occ, repeat_mask)
    else:
        seeds = find_seeds(seq_x, seq_y, k=k, respect_mask=repeat_mask,
                           max_occ=max_occ)
        runs = merge_seeds_to_runs(seeds, k)
        chained = chain_runs(runs)
    return merge_colinear_runs(chained)


LASTZ_ENV = "CPECAN_TPU_LASTZ"


def _lastz_blast_pairs(exe: str, seq_x: str, seq_y: str, trim: int,
                       expansion: int, repeat_mask: bool) -> list:
    """Exact-anchor parity mode: pipe the sequences through a real lastz
    binary with the reference's flags (impl/pairwiseAligner.c:1032-1041)
    and convert its chained cigars to anchor triples (:979-1003,
    :1048-1056). Enabled by pointing $CPECAN_TPU_LASTZ at the binary."""
    import io as _io
    import subprocess
    import tempfile

    if not repeat_mask:
        seq_x, seq_y = seq_x.upper(), seq_y.upper()
    with tempfile.TemporaryDirectory(prefix="cpecan_lastz") as d:
        fx, fy = os.path.join(d, "x.fa"), os.path.join(d, "y.fa")
        for path, name, seq in ((fx, "a", seq_x), (fy, "b", seq_y)):
            with open(path, "w") as fh:
                fh.write(f">{name}\n{seq}\n")
        out = subprocess.run(
            [exe, "--hspthresh=800", "--chain", "--strand=plus", "--gapped",
             "--format=cigar", "--ambiguous=iupac,100,100", fx, fy],
            check=True, capture_output=True, text=True)
    pairs = [alignment_to_anchor_pairs(pa, trim, expansion)
             for pa in cigar_read(_io.StringIO(out.stdout))]
    if not pairs:
        return np.empty((0, 3), np.int64)
    return np.concatenate(pairs, axis=0)


def get_blast_pairs(seq_x: str, seq_y: str, trim: int, expansion: int,
                    repeat_mask: bool, k: int = DEFAULT_KMER) -> np.ndarray:
    """Seed-and-chain anchor pairs for one rectangle as an (N, 3) int64
    array sorted by x+y (the getBlastPairs contract, reference
    :1005-1080). When repeat_mask is False the sequences are treated as
    unmasked (uppercased). If $CPECAN_TPU_LASTZ names a lastz binary,
    anchors come from it instead of the built-in seeder (exact anchor
    parity with the reference)."""
    exe = os.environ.get(LASTZ_ENV)
    if exe:
        pairs = np.asarray(_lastz_blast_pairs(exe, seq_x, seq_y, trim,
                                              expansion, repeat_mask),
                           dtype=np.int64)
        if pairs.ndim == 1:
            pairs = pairs.reshape(0, 3)
    else:
        chained = get_chained_runs(seq_x, seq_y, repeat_mask, k=k)
        pairs = runs_to_anchor_pairs(chained, trim, expansion)
    return pairs[np.argsort(pairs[:, 0] + pairs[:, 1], kind="stable")]


def _sort_rows(arr: np.ndarray) -> np.ndarray:
    """Lexicographic row sort (x, then y) — the list.sort() the filter
    pass requires, on the array representation."""
    return arr[np.lexsort((arr[:, 1], arr[:, 0]))]


def get_anchors(seq_x: str, seq_y: str, p: PairwiseAlignmentParameters,
                k: int = DEFAULT_KMER) -> np.ndarray:
    """Two-level anchoring with recursive re-anchoring of large gaps
    (reference getBlastPairsForPairwiseAlignmentParameters :1162-1196).
    Returns (x, y, expansion) triples as an (N, 3) int64 array, strictly
    monotone in both coords."""
    from cpecan_tpu_torch.utils import metrics

    with metrics.stage("host_anchoring"):
        return _get_anchors(seq_x, seq_y, p, k)


def _get_anchors(seq_x: str, seq_y: str, p: PairwiseAlignmentParameters,
                 k: int = DEFAULT_KMER) -> np.ndarray:
    lx, ly = len(seq_x), len(seq_y)
    if lx * ly <= p.anchorMatrixBiggerThanThis:
        return np.empty((0, 3), np.int64)

    top = get_blast_pairs(seq_x, seq_y, p.constraintDiagonalTrim,
                          p.diagonalExpansion, repeat_mask=True, k=k)
    top = filter_to_remove_overlap(_sort_rows(top))

    # Gap rectangles between consecutive top anchors (N anchors -> N+1
    # gaps, gap i preceding anchor i).  Only gaps whose area exceeds the
    # anchor threshold get re-anchored — locate those with one
    # vectorized scan and splice sub-anchor arrays around the untouched
    # stretches, keeping the whole path free of per-base Python work.
    n = len(top)
    ax, ay = top[:, 0], top[:, 1]
    px = np.concatenate([[0], ax + 1])
    py = np.concatenate([[0], ay + 1])
    ex = np.concatenate([ax, [lx]])
    ey = np.concatenate([ay, [ly]])
    areas = (ex - px) * (ey - py)
    big_gaps = np.flatnonzero(areas > p.anchorMatrixBiggerThanThis)

    pieces: list = []
    prev = 0
    for gi in big_gaps:
        gx1, gy1, gx2, gy2 = int(px[gi]), int(py[gi]), int(ex[gi]), int(ey[gi])
        sub = get_blast_pairs(
            seq_x[gx1:gx2], seq_y[gy1:gy2], p.constraintDiagonalTrim,
            p.diagonalExpansion,
            repeat_mask=(gx2 - gx1) * (gy2 - gy1)
            > p.repeatMaskMatrixBiggerThanThis, k=k)
        sub = filter_to_remove_overlap(_sort_rows(sub))
        pieces.append(top[prev:gi])
        if len(sub):
            pieces.append(sub + np.array([gx1, gy1, 0], np.int64))
        prev = gi
    pieces.append(top[prev:n])
    return np.concatenate(pieces, axis=0) if pieces else top
