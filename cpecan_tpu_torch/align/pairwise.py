"""Top-level pairwise alignment APIs.

Counterpart of cpecan_tpu/align/pairwise.py for the posterior APIs of
the realign path:

  get_aligned_pairs(_using_anchors)            -> posterior match pairs
  get_aligned_pairs_with_indels(_using_anchors) -> match + gapX + gapY pairs
  get_shifted_mea_alignment                     -> MEA decode + left shift

Every call runs the batched chunk runner (align/batch.py) on ``device``.
The expectation and forward-probability APIs belong to the EM slice.
"""

from __future__ import annotations

import numpy as np

from cpecan_tpu.align.anchors import get_anchors
from cpecan_tpu.align.split import get_split_points, split_anchors
from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.models.state_machine import StateMachine


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (few distinct batch shapes)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# Band-width buckets: warp multiples up to 128, then multiples of 128.
# Padding slots are masked out of every stream, so the bucket changes
# which pairs share a launch and nothing in the results.
WIDTH_LADDER = (32, 64, 128)


def _width_bucket(w: int) -> int:
    for b in WIDTH_LADDER:
        if w <= b:
            return b
    return ((w + 127) // 128) * 128


def _iterate_chunks(seq_x: str, seq_y: str, anchor_pairs,
                    p: PairwiseAlignmentParameters,
                    ragged_left: bool, ragged_right: bool):
    """Split by large gaps and yield (rect, local anchors, ragged flags)
    (reference getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps
    :1273-1326: ragged flags propagate to the outermost chunks only)."""
    lx, ly = len(seq_x), len(seq_y)
    split_points = get_split_points(
        anchor_pairs, lx, ly, p.splitMatrixBiggerThanThis, ragged_left,
        ragged_right)
    n = len(split_points)
    for i, (rect, local_anchors) in enumerate(
            split_anchors(anchor_pairs, split_points)):
        rl = ragged_left or i > 0
        rr = ragged_right or i < n - 1
        yield rect, local_anchors, rl, rr


def get_aligned_pairs_using_anchors(sm: StateMachine, seq_x: str, seq_y: str,
                                    anchor_pairs,
                                    p: PairwiseAlignmentParameters,
                                    ragged_left: bool = False,
                                    ragged_right: bool = False,
                                    device="cuda") -> np.ndarray:
    """Posterior match pairs (prob, x, y) above p.threshold."""
    from cpecan_tpu_torch.align import batch as batch_mod

    return batch_mod.batch_posteriors(
        sm, [(seq_x, seq_y, anchor_pairs, ragged_left, ragged_right)], p,
        mode="posterior_match", device=device)[0]


def get_aligned_pairs_with_indels_using_anchors(
        sm: StateMachine, seq_x: str, seq_y: str, anchor_pairs,
        p: PairwiseAlignmentParameters, ragged_left: bool = False,
        ragged_right: bool = False, device="cuda"):
    """(match_pairs, gap_x_pairs, gap_y_pairs)."""
    from cpecan_tpu_torch.align import batch as batch_mod

    return batch_mod.batch_posteriors(
        sm, [(seq_x, seq_y, anchor_pairs, ragged_left, ragged_right)], p,
        mode="posterior_all", device=device)[0]


def get_shifted_mea_alignment(sm: StateMachine, seq_x: str, seq_y: str,
                              anchor_pairs, p: PairwiseAlignmentParameters,
                              ragged_left: bool = False,
                              ragged_right: bool = False, device="cuda"):
    """Posteriors -> MEA decode -> left-shift, returning (pairs, score)
    (reference getShiftedMEAAlignment, impl/pairwiseAligner.c:1767-1790)."""
    from cpecan_tpu.ops import mea as mea_mod

    match, gap_x, gap_y = get_aligned_pairs_with_indels_using_anchors(
        sm, seq_x, seq_y, anchor_pairs, p, ragged_left, ragged_right,
        device=device)
    # MEA wants a topological order of the (x<x', y<y') partial order;
    # diagonal-major is one (batch chunks may interleave emission order)
    match = match[np.lexsort((match["x"], match["x"] + match["y"]))]
    alignment, score = mea_mod.mea_alignment(
        match, gap_x, gap_y, len(seq_x), len(seq_y), p.gapGamma)
    return mea_mod.left_shift_alignment(alignment, seq_x, seq_y), score


def get_aligned_pairs(sm: StateMachine, seq_x: str, seq_y: str,
                      p: PairwiseAlignmentParameters,
                      ragged_left: bool = False, ragged_right: bool = False,
                      device="cuda") -> np.ndarray:
    anchors = get_anchors(seq_x, seq_y, p)
    return get_aligned_pairs_using_anchors(
        sm, seq_x, seq_y, anchors, p, ragged_left, ragged_right, device)


def get_aligned_pairs_with_indels(sm: StateMachine, seq_x: str, seq_y: str,
                                  p: PairwiseAlignmentParameters,
                                  ragged_left: bool = False,
                                  ragged_right: bool = False,
                                  device="cuda"):
    anchors = get_anchors(seq_x, seq_y, p)
    return get_aligned_pairs_with_indels_using_anchors(
        sm, seq_x, seq_y, anchors, p, ragged_left, ragged_right, device)
