"""What the realign and EM paths derive from a cigar record, worked out
again for the reference.

The steps follow cPecanRealign (cPecanRealign.c) as the port's CLI
states them: the record's subsequences (reverse-complemented on a minus
strand), its coordinates rebased to the forward strand, anchors at every
matched base of the cigar that is an exact base match, splitting at
large gaps between anchors (split.py), one band per chunk (band.py). The
decode of a record's posteriors is the default path: AMAP reweighting,
then the heaviest chain of pairs of weight matchGamma or more that is
increasing in both sequences (the poset filter on two sequences).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import band as band_mod
from benchmark.reference import cigar as cigar_io
from benchmark.reference import split as split_mod

PROB_ONE = 10_000_000  # fixed-point posterior scale (pairwiseAligner.h)
JITTER = 1e-5  # tie-break jitter of a pair's weight (makeAlignmentWeight)
_CODE = np.full(256, 4, np.int64)
for _chars, _c in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3)):
    for _ch in _chars:
        _CODE[ord(_ch)] = _c
_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def encode(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode("latin-1"), np.uint8)]


def reverse_complement(seq: str) -> str:
    out = seq.encode("latin-1").translate(_COMP)[::-1]
    keep = np.frombuffer(out, np.uint8)
    bad = ~np.isin(keep, np.frombuffer(b"ACGTacgt", np.uint8))
    if bad.any():
        keep = keep.copy()
        keep[bad] = ord("N")
    return keep.tobytes().decode("latin-1")


def sub_sequence(seq: str, start: int, end: int, strand: bool) -> str:
    return seq[start:end] if strand else reverse_complement(seq[end:start])


def forward_record(pa: cigar_io.PairwiseAlignment, sequences: dict):
    """(sub_x, sub_y, forward-strand alignment of the two subsequences)."""
    sub_x = sub_sequence(sequences[pa.contig1], pa.start1, pa.end1, pa.strand1)
    sub_y = sub_sequence(sequences[pa.contig2], pa.start2, pa.end2, pa.strand2)
    fwd = cigar_io.PairwiseAlignment(pa.contig1, 0, len(sub_x), True,
                                     pa.contig2, 0, len(sub_y), True,
                                     pa.score, list(pa.operations))
    return sub_x, sub_y, fwd


def match_anchors(fwd, sub_x: str, sub_y: str, trim: int, expansion: int):
    """Anchors of the cigar's match runs that are exact base matches."""
    anchors = cigar_io.alignment_to_anchor_pairs(fwd, trim, expansion)
    if len(anchors) == 0:
        return anchors.reshape(0, 3)
    bx = np.frombuffer(sub_x.upper().encode("latin-1"), np.uint8)
    by = np.frombuffer(sub_y.upper().encode("latin-1"), np.uint8)
    cx = bx[anchors[:, 0]]
    keep = (cx == by[anchors[:, 1]]) & (cx != ord("N"))
    return anchors[keep]


def chunks_of(sub_x: str, sub_y: str, anchors, split_area: int,
              expansion: int) -> list:
    """The record's chunks with ragged ends (both paths pass ragged 1, 1):
    dicts with the DP inputs and the chunk origin (x1, y1)."""
    lx, ly = len(sub_x), len(sub_y)
    points = split_mod.get_split_points(anchors, lx, ly, split_area, True, True)
    out = []
    n = len(points)
    for i, ((x1, y1, x2, y2), local) in enumerate(
            split_mod.split_anchors(anchors, points)):
        if x2 - x1 == 0 and y2 - y1 == 0:
            continue
        cx, cy = sub_x[x1:x2], sub_y[y1:y2]
        band = band_mod.construct_band(np.asarray(local)[:, :2], len(cx),
                                       len(cy), expansion)
        out.append({"sx": encode(cx), "sy": encode(cy),
                    "offsets": band.offsets, "widths": band.widths,
                    "rl": True, "rr": True, "x1": x1, "y1": y1})
    return out


def record_chunks(pa, sequences, settings: dict):
    """(sub_x, sub_y, chunks) of a record under a configuration's
    settings (constraintDiagonalTrim, diagonalExpansion and the split
    area splitMatrixBiggerThanThis)."""
    sub_x, sub_y, fwd = forward_record(pa, sequences)
    anchors = match_anchors(fwd, sub_x, sub_y,
                            settings["constraintDiagonalTrim"],
                            settings["diagonalExpansion"])
    return sub_x, sub_y, chunks_of(sub_x, sub_y, anchors,
                                   settings["splitMatrixBiggerThanThis"],
                                   settings["diagonalExpansion"])


def pairs_from_posteriors(chunks, posts, threshold: float):
    """Pairs (x, y, prob) of the record, prob fixed-point, for cells whose
    posterior is at least threshold."""
    xs, ys, ps = [], [], []
    for c, (x, y, p) in zip(chunks, posts):
        keep = p >= threshold
        xs.append(x[keep] - 1 + c["x1"])
        ys.append(y[keep] - 1 + c["y1"])
        ps.append(np.floor(np.minimum(p[keep], 1.0) * PROB_ONE).astype(np.int64))
    cat = lambda a: np.concatenate(a) if a else np.zeros(0, np.int64)
    return cat(xs), cat(ys), cat(ps)


def reweight(xs, ys, probs, lx: int, ly: int, gap_gamma: float):
    """AMAP reweighting, in fixed point as cPecan does it:
    prob - int(gamma * (indelX[x] + indelY[y])), indel = 1 - summed match
    posterior at that position, clamped at 0."""
    if gap_gamma <= 0 or len(probs) == 0:
        return probs
    ix = np.full(lx, PROB_ONE, np.int64)
    iy = np.full(ly, PROB_ONE, np.int64)
    np.subtract.at(ix, xs, probs)
    np.subtract.at(iy, ys, probs)
    np.maximum(ix, 0, out=ix)
    np.maximum(iy, 0, out=iy)
    return probs - (gap_gamma * (ix[xs] + iy[ys])).astype(np.int64)


def heaviest_chain(xs, ys, weights):
    """The chain of pairs strictly increasing in x and y whose weights sum
    highest: (total, indices). Weights are floats."""
    n = len(xs)
    if n == 0:
        return 0.0, np.zeros(0, np.int64)
    ymax = int(ys.max()) + 2
    tree_v = [0.0] * (ymax + 1)  # Fenwick tree of prefix maxima over y
    tree_i = [-1] * (ymax + 1)
    best = [0.0] * n
    prev = [-1] * n
    order = np.lexsort((-ys, xs))  # by x, and y descending within one x
    xs_l, ys_l, w_l = xs.tolist(), ys.tolist(), weights.tolist()
    for i in order.tolist():
        q = ys_l[i]  # best chain ending at y' < y: prefix up to y - 1
        v, vi = 0.0, -1
        while q > 0:
            if tree_v[q] > v:
                v, vi = tree_v[q], tree_i[q]
            q -= q & -q
        best[i] = v + w_l[i]
        prev[i] = vi
        q = ys_l[i] + 1
        while q <= ymax:
            if best[i] > tree_v[q]:
                tree_v[q], tree_i[q] = best[i], i
            q += q & -q
    end = int(np.argmax(best))
    chain = []
    while end >= 0:
        chain.append(end)
        end = prev[end]
    chain.reverse()
    return float(best[chain[-1]]), np.asarray(chain, np.int64)


def cigar_pairs(pa: cigar_io.PairwiseAlignment):
    """The matched pairs of a cigar, in the coordinates of its two
    subsequences read in the cigar's own order (local, from 0)."""
    x = y = 0
    xs, ys = [], []
    for op, n in pa.operations:
        if op == cigar_io.MATCH:
            xs.append(np.arange(x, x + n))
            ys.append(np.arange(y, y + n))
        if op != cigar_io.INDEL_Y:
            x += n
        if op != cigar_io.INDEL_X:
            y += n
    if not xs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(xs), np.concatenate(ys)


def tasks_of_corpus(cigars, sequences, settings: dict) -> list:
    """Every chunk of every record, as the EM path's expectation tasks."""
    out = []
    for pa in cigars:
        out.extend(record_chunks(pa, sequences, settings)[2])
    return out
