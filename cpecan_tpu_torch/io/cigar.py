"""Exonerate/lastz-style cigar text I/O.

Format (lastz src/cigar.c print_cigar_align :303-310 — note it prints
name2/query FIRST — as consumed by sonLib cigarRead/cigarWrite interop
at cPecanRealign.c:509/593):

  cigar: contig2 start2 end2 strand2 contig1 start1 end1 strand1 score \
         M n D n I n ...

The QUERY (lastz's second input, our contig2/Y) leads the line; the
TARGET (lastz's first input, our contig1/X) follows.  Op semantics:
M consumes both sequences; D consumes contig1 (X, the target) only;
I consumes contig2 (Y, the query) only — so in the production pipe
`cPecanLastz seq1 seq2 | cPecanRealign seq1 seq2` the reference's
assert(contig1 == "a") and checkPairwiseAlignment both hold.  Minus
strand: start > end, coordinates count backwards on the forward strand
(half-open, exclusive end).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, TextIO

MATCH = "M"
INDEL_X = "D"  # gap op consuming contig1/X
INDEL_Y = "I"  # gap op consuming contig2/Y


@dataclasses.dataclass
class PairwiseAlignment:
    contig1: str
    start1: int
    end1: int
    strand1: bool  # True == '+'
    contig2: str
    start2: int
    end2: int
    strand2: bool
    score: float
    operations: list[tuple[str, int]]  # (op, length)

    def check(self) -> None:
        """Coordinate/oplength consistency (sonLib checkPairwiseAlignment)."""
        l1 = sum(n for op, n in self.operations if op != INDEL_Y)
        l2 = sum(n for op, n in self.operations if op != INDEL_X)
        span1 = self.end1 - self.start1 if self.strand1 else self.start1 - self.end1
        span2 = self.end2 - self.start2 if self.strand2 else self.start2 - self.end2
        if l1 != span1 or l2 != span2:
            raise ValueError(f"cigar op lengths {l1},{l2} != spans {span1},{span2}")


def cigar_read(fh: TextIO) -> Iterator[PairwiseAlignment]:
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if not line.startswith("cigar:"):
            continue
        tokens = line.split()
        if len(tokens) < 10:
            raise ValueError(f"Bad cigar line: {line}")
        ops = []
        for i in range(10, len(tokens), 2):
            op = tokens[i]
            if op not in (MATCH, INDEL_X, INDEL_Y):
                raise ValueError(f"Bad cigar op {op!r} in: {line}")
            ops.append((op, int(tokens[i + 1])))
        # the line leads with contig2/query (see module docstring)
        yield PairwiseAlignment(
            contig2=tokens[1], start2=int(tokens[2]), end2=int(tokens[3]),
            strand2=tokens[4] == "+",
            contig1=tokens[5], start1=int(tokens[6]), end1=int(tokens[7]),
            strand1=tokens[8] == "+",
            score=float(tokens[9]), operations=ops,
        )


def cigar_format(pa: PairwiseAlignment) -> str:
    parts = [
        "cigar:", pa.contig2, str(pa.start2), str(pa.end2), "+" if pa.strand2 else "-",
        pa.contig1, str(pa.start1), str(pa.end1), "+" if pa.strand1 else "-",
        f"{pa.score:g}",
    ]
    for op, n in pa.operations:
        parts += [op, str(n)]
    return " ".join(parts)


def cigar_write(fh: TextIO, pa: PairwiseAlignment) -> None:
    fh.write(cigar_format(pa) + "\n")


def alignment_to_anchor_pairs(pa: PairwiseAlignment, trim: int,
                              expansion: int):
    """Match-run positions -> (x, y, expansion) anchor triples as an
    (N, 3) int64 array, trimming `trim` bases off each end of every
    match run (reference convertPairwiseForwardStrandAlignmentToAnchorPairs,
    impl/pairwiseAligner.c:979-1003). Requires forward-strand coords.
    Vectorized per run (the loop is over cigar ops, not bases)."""
    import numpy as np

    assert pa.strand1 and pa.strand2
    x, y = pa.start1, pa.start2
    runs = []  # (x_start, y_start, usable_len) per match run
    for op, n in pa.operations:
        if op == MATCH and n - 2 * trim > 0:
            runs.append((x + trim, y + trim, n - 2 * trim))
        if op != INDEL_Y:
            x += n
        if op != INDEL_X:
            y += n
    assert x == pa.end1 and y == pa.end2
    if not runs:
        return np.empty((0, 3), np.int64)
    r = np.asarray(runs, np.int64)
    lens = r[:, 2]
    idx = np.arange(lens.sum(), dtype=np.int64)
    off = idx - np.repeat(np.cumsum(lens) - lens, lens)
    out = np.empty((len(idx), 3), np.int64)
    out[:, 0] = np.repeat(r[:, 0], lens) + off
    out[:, 1] = np.repeat(r[:, 1], lens) + off
    out[:, 2] = expansion
    return out


def aligned_pairs_to_alignment(pairs, contig1, contig2, start1, end1,
                               start2, end2, score=0.0) -> PairwiseAlignment:
    """Convert an (ordered, strictly increasing in both coords) aligned-pair
    list into a gapped alignment covering [start1,end1) x [start2,end2)
    (cPecanRealign convertAlignedPairsToPairwiseAlignment, :220-275).

    In array operations over the pairs' x and y. Each pair adds an
    INDEL_X gap, an INDEL_Y gap and one MATCH, and the end gaps follow,
    zero lengths dropped and equal neighbours merged. Since every gap is
    followed by a MATCH, only matches merge: a pair with no gap before it
    extends the previous pair's match run."""
    import numpy as np

    n = len(pairs)
    x = np.asarray(pairs["x"] if n else (), np.int64)
    y = np.asarray(pairs["y"] if n else (), np.int64)
    # the gap before each pair, after the previous pair (or the start)
    gap_x = np.diff(x, prepend=start1 - 1) - 1
    gap_y = np.diff(y, prepend=start2 - 1) - 1
    assert (gap_x >= 0).all() and (gap_y >= 0).all(), \
        "aligned pairs must be totally ordered"
    px = int(x[-1]) + 1 if n else start1
    py = int(y[-1]) + 1 if n else start2

    # the pairs that open a match run: the first, and each after a gap
    opens = (gap_x > 0) | (gap_y > 0)
    opens[:1] = True
    first = np.flatnonzero(opens)
    # lengths in the op order D, I, M at each run, then the end gaps D, I
    lens = np.empty(3 * len(first) + 2, np.int64)
    lens[0:-2:3] = gap_x[first]
    lens[1:-2:3] = gap_y[first]
    lens[2:-2:3] = np.diff(first, append=n)
    lens[-2:] = end1 - px, end2 - py
    codes = np.tile(np.arange(3, dtype=np.int8), len(first) + 1)[:-1]
    keep = lens > 0
    names = (INDEL_X, INDEL_Y, MATCH)
    ops = [(names[c], m)
           for c, m in zip(codes[keep].tolist(), lens[keep].tolist())]

    return PairwiseAlignment(
        contig1=contig1, start1=start1, end1=end1, strand1=True,
        contig2=contig2, start2=start2, end2=end2, strand2=True,
        score=score, operations=ops,
    )
