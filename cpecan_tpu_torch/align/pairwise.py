"""Top-level pairwise alignment APIs.

Counterpart of cpecan_tpu/align/pairwise.py for the posterior APIs of
the realign path:

  get_aligned_pairs(_using_anchors)            -> posterior match pairs
  get_aligned_pairs_with_indels(_using_anchors) -> match + gapX + gapY pairs
  get_shifted_mea_alignment                     -> MEA decode + left shift
  get_expectations(_using_anchors)              -> EM expected counts into an Hmm
  compute_forward_probability                   -> banded forward log-prob

Every API runs through the batch layer (align/batch.py) on ``device``:
the posterior APIs through ``batch_posteriors``, the expectation APIs
through ``expectation_step``; the forward API's one unsplit pass (as in
the reference) is a launch of one pair, shaped by ops/fb_batch.py.
"""

from __future__ import annotations

import numpy as np

from cpecan_tpu_torch.align import batch as batch_mod
from cpecan_tpu_torch.align.anchors import get_anchors
from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.hmm import Hmm
from cpecan_tpu_torch.models.state_machine import PairHMM, StateMachine
from cpecan_tpu_torch.ops import fb_batch
from cpecan_tpu_torch.utils import metrics


def get_aligned_pairs_using_anchors(sm: StateMachine, seq_x: str, seq_y: str,
                                    anchor_pairs,
                                    p: PairwiseAlignmentParameters,
                                    ragged_left: bool = False,
                                    ragged_right: bool = False,
                                    device="cuda") -> np.ndarray:
    """Posterior match pairs (prob, x, y) above p.threshold."""
    return batch_mod.batch_posteriors(
        sm, [(seq_x, seq_y, anchor_pairs, ragged_left, ragged_right)], p,
        mode="posterior_match", device=device)[0]


def get_aligned_pairs_with_indels_using_anchors(
        sm: StateMachine, seq_x: str, seq_y: str, anchor_pairs,
        p: PairwiseAlignmentParameters, ragged_left: bool = False,
        ragged_right: bool = False, device="cuda"):
    """(match_pairs, gap_x_pairs, gap_y_pairs)."""
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
    tasks = batch_mod.chunk_tasks(
        [(seq_x, seq_y, anchor_pairs, ragged_left, ragged_right)], p)
    batch_mod.expectation_step(sm, tasks, p, hmm, device=device)


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
    task = batch_mod.Task(0, 0, 0, seq_x, seq_y, anchor_pairs, ragged_left,
                          ragged_right)
    ((band, frame),) = batch_mod.build_bands([task], p)
    L = band.diagonal_number
    arrays = batch_mod.launch_arrays([(task, band)],
                                     fb_batch.diagonal_bucket(L))
    with metrics.stage("fb_pass"):
        out = batch_mod.launch(PairHMM.from_state_machine(sm).to(device),
                               arrays, "forward", fb_batch.width_bucket(frame),
                               device)
        log_fwd, mf = float(out["log_fwd"][0]), out["mf"][0].cpu().numpy()
    metrics.add("dp_cells", int(band.widths.sum()))
    return log_fwd + float(np.sum(mf[: L + 1], dtype=np.float64))


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
