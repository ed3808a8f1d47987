"""Top-level pairwise alignment APIs.

Counterpart of cpecan_tpu/align/pairwise.py for the posterior APIs of
the realign path:

  get_aligned_pairs(_using_anchors)            -> posterior match pairs
  get_aligned_pairs_with_indels(_using_anchors) -> match + gapX + gapY pairs
  get_shifted_mea_alignment                     -> MEA decode + left shift
  get_expectations(_using_anchors)              -> EM expected counts into an Hmm
  compute_forward_probability                   -> banded forward log-prob

The posterior APIs run the batched chunk runner (align/batch.py) on
``device``; the expectation and forward APIs run one chunk at a time as
a batch of one.
"""

from __future__ import annotations

import numpy as np
import torch

from cpecan_tpu_torch.align.anchors import get_anchors
from cpecan_tpu_torch.align.split import get_split_points, split_anchors
from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.hmm import Hmm
from cpecan_tpu_torch.models.state_machine import PairHMM, StateMachine
from cpecan_tpu_torch.ops import fb_batch
from cpecan_tpu_torch.ops.band import construct_bands, pad_band
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils.symbols import encode


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


def anchored_bands(anchor_arrays, lxs, lys, p: PairwiseAlignmentParameters):
    """ops.band.construct_bands at p's expansion: each anchor's own (the
    third column) under dynamicAnchorExpansion, else diagonalExpansion."""
    return construct_bands(anchor_arrays, lxs, lys,
                           None if p.dynamicAnchorExpansion
                           else p.diagonalExpansion)


def _run_chunk(sm: StateMachine, seq_x: str, seq_y: str, anchors,
               p: PairwiseAlignmentParameters, ragged_left: bool,
               ragged_right: bool, mode: str, device):
    """One banded FB chunk on ``device`` as a batch of one; returns (engine
    outputs of the pair as numpy arrays, band)."""
    lx, ly = len(seq_x), len(seq_y)
    (band,), (frame,) = anchored_bands([anchors], [lx], [ly], p)
    P = _bucket(band.diagonal_number)
    W = _width_bucket(int(frame))
    offsets, widths, L = pad_band(band, P)

    sx = np.zeros((1, P), dtype=np.int32)
    sy = np.zeros((1, P), dtype=np.int32)
    sx[0, :lx] = encode(seq_x)
    sy[0, :ly] = encode(seq_y)
    args = (sx, sy, offsets[None], widths[None], np.array([lx], np.int32),
            np.array([ly], np.int32), np.array([ragged_left]),
            np.array([ragged_right]))
    device = torch.device(device)
    with metrics.stage("fb_pass"):
        out = fb_batch.fb_pass_batch(
            PairHMM.from_state_machine(sm).to(device),
            *[torch.from_numpy(a).to(device) for a in args], mode=mode,
            width=W)
        out = {k: v.cpu().numpy() if k in ("trans", "emis")
               else v[0].cpu().numpy() for k, v in out.items()}
    metrics.add("dp_cells", int(band.widths.sum()))
    return out, band


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
    from cpecan_tpu_torch.ops import mea as mea_mod

    match, gap_x, gap_y = get_aligned_pairs_with_indels_using_anchors(
        sm, seq_x, seq_y, anchor_pairs, p, ragged_left, ragged_right,
        device=device)
    # MEA wants a topological order of the (x<x', y<y') partial order;
    # diagonal-major is one (batch chunks may interleave emission order)
    match = match[np.lexsort((match["x"], match["x"] + match["y"]))]
    alignment, score = mea_mod.mea_alignment(
        match, gap_x, gap_y, len(seq_x), len(seq_y), p.gapGamma)
    return mea_mod.left_shift_alignment(alignment, seq_x, seq_y), score


def get_expectations_using_anchors(sm: StateMachine, hmm: Hmm, seq_x: str,
                                   seq_y: str, anchor_pairs,
                                   p: PairwiseAlignmentParameters,
                                   ragged_left: bool = False,
                                   ragged_right: bool = False,
                                   device="cuda") -> None:
    """Accumulate Baum-Welch expected counts into hmm (reference
    getExpectationsUsingAnchors :1500-1505). Likelihood accumulates the
    per-diagonal total log-prob, mirroring the reference's per-diagonal
    accumulation hack (:743)."""
    for (x1, y1, x2, y2), local, rl, rr in _iterate_chunks(
            seq_x, seq_y, anchor_pairs, p, ragged_left, ragged_right):
        if x2 - x1 == 0 and y2 - y1 == 0:
            continue
        out, band = _run_chunk(sm, seq_x[x1:x2], seq_y[y1:y2], local, p, rl,
                               rr, "expectation", device)
        hmm.transitions += np.asarray(out["trans"], dtype=np.float64)
        hmm.emissions += np.asarray(out["emis"], dtype=np.float64)
        L = band.diagonal_number
        cf = np.cumsum(out["mf"][: L + 1].astype(np.float64))
        cb = np.cumsum(out["mb"][: L + 1][::-1].astype(np.float64))[::-1]
        totals = out["total_raw"][1 : L + 1].astype(np.float64) + cf[1:] + cb[1:]
        hmm.likelihood += float(np.sum(totals))


def compute_forward_probability(seq_x: str, seq_y: str, anchor_pairs,
                                p: PairwiseAlignmentParameters,
                                sm: StateMachine,
                                ragged_left: bool = False,
                                ragged_right: bool = False,
                                device="cuda") -> float:
    """Banded forward log-probability (reference computeForwardProbability
    :936-949 — no large-gap splitting, single banded pass)."""
    lx, ly = len(seq_x), len(seq_y)
    if lx + ly == 0:
        return 0.0
    out, band = _run_chunk(sm, seq_x, seq_y, anchor_pairs, p, ragged_left,
                           ragged_right, "forward", device)
    L = band.diagonal_number
    return float(out["log_fwd"]) + float(np.sum(out["mf"][: L + 1], dtype=np.float64))


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


def get_expectations(sm: StateMachine, hmm: Hmm, seq_x: str, seq_y: str,
                     p: PairwiseAlignmentParameters,
                     ragged_left: bool = False,
                     ragged_right: bool = False, device="cuda") -> None:
    anchors = get_anchors(seq_x, seq_y, p)
    get_expectations_using_anchors(
        sm, hmm, seq_x, seq_y, anchors, p, ragged_left, ragged_right, device)
