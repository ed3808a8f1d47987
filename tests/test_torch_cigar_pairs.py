"""The port's aligned_pairs_to_alignment (array operations over the
pairs' x and y) against the JAX package's per-pair loop: the whole
returned alignment equal, its operations Python (str, int) tuples, and
an unordered pair set raising AssertionError as the loop does."""

import dataclasses

import numpy as np
import pytest

import cpecan_tpu.io.cigar as j_cigar
import cpecan_tpu_torch.io.cigar as t_cigar
from cpecan_tpu_torch.ops.pairs import make_pairs


def _pairs(xs, ys):
    xs = np.asarray(xs, np.int64)
    return make_pairs(np.full(len(xs), 9_000_000, np.int64), xs,
                      np.asarray(ys, np.int64))


def _read_like(seed, kb):
    """An ordered pair set of a ~kb read at the read traffic's rates
    (insertions 4.9%, deletions 7.8%, substitutions 5.1% dropped as an
    ordered filter drops weak pairs), 1-3-base gaps; starts 0-2, end gaps
    0-3."""
    rng = np.random.default_rng(seed)
    start1, start2 = (int(v) for v in rng.integers(0, 3, 2))
    x, y = start1 + int(rng.integers(0, 4)), start2 + int(rng.integers(0, 4))
    xs, ys = [], []
    while y < start2 + kb * 1000:
        u = rng.random()
        if u < 0.078:
            x += int(rng.integers(1, 4))
        elif u < 0.078 + 0.049:
            y += int(rng.integers(1, 4))
        elif u < 0.078 + 0.049 + 0.051:
            x, y = x + 1, y + 1
        else:
            xs.append(x)
            ys.append(y)
            x, y = x + 1, y + 1
    end1, end2 = x + int(rng.integers(0, 4)), y + int(rng.integers(0, 4))
    return _pairs(xs, ys), start1, end1, start2, end2


_CASES = {
    "empty": (_pairs([], []), 0, 0, 0, 0),
    "empty_end_gaps": (_pairs([], []), 0, 5, 0, 3),
    "empty_start_gaps": (_pairs([], []), 2, 6, 1, 1),
    "empty_x_only": (_pairs([], []), 0, 4, 0, 0),
    "single_at_starts": (_pairs([3], [7]), 3, 4, 7, 8),
    "single_at_starts_end_gaps": (_pairs([3], [7]), 3, 9, 7, 10),
    "touch_end1": (_pairs([0, 2, 5], [1, 2, 4]), 0, 6, 0, 9),
    "touch_end2": (_pairs([0, 2, 5], [1, 2, 4]), 0, 9, 0, 5),
    "touch_both_ends": (_pairs([1, 2, 3], [0, 1, 2]), 0, 4, 0, 3),
    "leading_x_gap": (_pairs([4, 5], [0, 1]), 0, 6, 0, 2),
    "leading_y_gap": (_pairs([0, 1], [4, 5]), 0, 2, 0, 6),
    "leading_both_gaps": (_pairs([3, 4], [2, 3]), 0, 5, 0, 4),
    "trailing_x_gap": (_pairs([0, 1], [0, 1]), 0, 7, 0, 2),
    "trailing_y_gap": (_pairs([0, 1], [0, 1]), 0, 2, 0, 7),
    "trailing_both_gaps": (_pairs([0, 1], [0, 1]), 0, 5, 0, 4),
    "match_runs": (_pairs([0, 1, 2, 3, 6, 7, 8, 9, 10],
                          [0, 1, 2, 3, 4, 5, 8, 9, 10]), 0, 11, 0, 11),
    "gap_x_then_y_between": (_pairs([0, 3, 4], [0, 2, 3]), 0, 5, 0, 4),
    "nonzero_starts": (_pairs([12, 13, 15, 16], [40, 42, 43, 44]),
                       10, 20, 38, 47),
}
for _seed in range(3):
    for _kb in (0.5, 2, 10):
        _CASES[f"random_{_kb}kb_seed{_seed}"] = _read_like(
            3000000037 + _seed, _kb)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_aligned_pairs_to_alignment_matches_loop(case):
    pairs, start1, end1, start2, end2 = _CASES[case]
    args = (pairs, "chrX", "read", start1, end1, start2, end2, 2.5)
    ref = j_cigar.aligned_pairs_to_alignment(*args)
    new = t_cigar.aligned_pairs_to_alignment(*args)
    assert dataclasses.asdict(new) == dataclasses.asdict(ref)
    assert all(type(op) is str and type(n) is int
               for op, n in new.operations)
    assert all(n > 0 for _, n in new.operations)
    assert all(a[0] != b[0]
               for a, b in zip(new.operations, new.operations[1:]))


_UNORDERED = {
    "x_repeats": (_pairs([0, 2, 2], [0, 1, 2]), 0, 4, 0, 4),
    "y_falls": (_pairs([0, 1, 2], [0, 3, 2]), 0, 4, 0, 4),
    "before_start1": (_pairs([1, 3], [5, 6]), 2, 5, 5, 8),
    "before_start2": (_pairs([2, 3], [4, 6]), 2, 5, 5, 8),
}


@pytest.mark.parametrize("case", sorted(_UNORDERED))
def test_unordered_pairs_raise(case):
    pairs, start1, end1, start2, end2 = _UNORDERED[case]
    for mod in (j_cigar, t_cigar):
        with pytest.raises(AssertionError):
            mod.aligned_pairs_to_alignment(pairs, "a", "b", start1, end1,
                                           start2, end2)
