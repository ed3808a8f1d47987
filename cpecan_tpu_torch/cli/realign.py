"""`cpecan-realign` on PyTorch — cigar-in/cigar-out posterior realigner.

Counterpart of cpecan_tpu/cli/realign.py with the same interface and
semantics (reference cPecanRealign.c): fasta files as arguments, cigars
on stdin, realigned (or rescored) cigars out. ``--device`` (default
``cuda``) picks where the forward-backward pass runs; ``cuda`` without a
CUDA device raises, and nothing falls back to the CPU.
``--outputExpectations`` is the EM pipeline's worker mode: the records'
expected counts, in batched expectation passes, go to an HMM file instead
of cigars to stdout.

Usage: python -m cpecan_tpu_torch.cli.realign [options] seq1.fasta [...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.io.fasta import fasta_read_file
from cpecan_tpu_torch.models.hmm import Hmm, StateMachineType
from cpecan_tpu_torch.models.state_machine import (
    state_machine5, state_machine_from_hmm)
from cpecan_tpu_torch.msa.aligner import filter_pairwise_alignment_to_make_pairs_ordered
from cpecan_tpu_torch.ops import mea as mea_mod
from cpecan_tpu_torch.ops import pairs as pairs_mod
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils.logmath import PAIR_ALIGNMENT_PROB_1
from cpecan_tpu_torch.utils.symbols import reverse_complement
from cpecan_tpu_torch.align import batch as batch_align


def read_sequences(fasta_paths) -> dict:
    """Sequences keyed by first header token; a longer sequence under the
    same key replaces the old one (reference addToSequencesHash :242-269)."""
    sequences: dict[str, str] = {}
    for path in fasta_paths:
        for header, seq in fasta_read_file(path):
            key = header.split()[0] if header.split() else header
            if key not in sequences or len(seq) > len(sequences[key]):
                sequences[key] = seq
    return sequences


def get_sub_sequence(seq: str, start: int, end: int, strand: bool) -> str:
    """Forward-strand subsequence; minus strand reads [end, start) and
    reverse-complements (reference getSubSequence :232-240)."""
    if strand:
        return seq[start:end]
    return reverse_complement(seq[end:start])


def rebase(start: int, end: int, strand: bool, shift: int, flip: bool):
    """reference rebasePairwiseAlignmentCoordinates :220-230."""
    start += shift
    end += shift
    if flip:
        strand = not strand
        start, end = end, start
    return start, end, strand


def filter_anchors_to_matches(anchors, seq_x: str, seq_y: str):
    """Keep anchors whose bases match exactly (never N) — reference matchFn
    :277-281.  Vectorized: one bytes-level gather per sequence instead of
    a per-anchor Python loop (realign feeds one anchor per matched base)."""
    anchors = np.asarray(anchors, dtype=np.int64)
    if anchors.ndim == 1 or len(anchors) == 0:
        return anchors.reshape(0, 3)
    bx = np.frombuffer(seq_x.upper().encode("latin-1"), np.uint8)
    by = np.frombuffer(seq_y.upper().encode("latin-1"), np.uint8)
    cx = bx[anchors[:, 0]]
    keep = (cx == by[anchors[:, 1]]) & (cx != ord("N"))
    return anchors[keep]


def score_anchor_pairs(anchors, aligned_pairs, diagonal_expansion):
    """Posterior-score the original alignment's match pairs; pairs with no
    computed posterior get score 0 (reference scoreAnchorPairs :318-348)."""
    anchor_set = {(int(a[0]), int(a[1])) for a in anchors}
    probs, xs, ys = [], [], []
    for q in aligned_pairs:
        key = (int(q["x"]), int(q["y"]))
        if key in anchor_set:
            probs.append(int(q["prob"]))
            xs.append(key[0])
            ys.append(key[1])
            anchor_set.remove(key)
    for x, y in sorted(anchor_set):
        probs.append(0)
        xs.append(x)
        ys.append(y)
    return pairs_mod.make_pairs(probs, xs, ys)


def mea_decode(aligned, gap_x, gap_y, sub_x: str, sub_y: str,
               gap_gamma: float):
    """--mea's decode: (MEA alignment pairs, MEA score) of a record's
    match and gap posteriors, the match pairs in diagonal-major order."""
    aligned = aligned[np.lexsort((aligned["x"], aligned["x"] + aligned["y"]))]
    return mea_mod.mea_alignment(aligned, gap_x, gap_y, len(sub_x),
                                 len(sub_y), gap_gamma)


def has_long_indel(ops, max_indel_length: int) -> bool:
    run = 0
    for op, n in ops:
        if op == cigar_io.MATCH:
            run = 0
        else:
            run += n
            if run > max_indel_length:
                return True
    return False


def split_pairwise_alignment(pa: cigar_io.PairwiseAlignment,
                             max_indel_length: int) -> list:
    """Split at indel runs longer than max_indel_length (reference
    splitPairwiseAlignment :116-218). Alignments never start or end with
    indels."""
    out = []
    pos1, pos2 = pa.start1, pa.start2
    cur_start1, cur_start2 = pa.start1, pa.start2
    cur_end1, cur_end2 = 0, 0
    cur_ops: list = []
    indel_ops: list = []
    indel_run = 0

    def step(op, n):
        nonlocal pos1, pos2
        if op != cigar_io.INDEL_Y:
            pos1 += n if pa.strand1 else -n
        if op != cigar_io.INDEL_X:
            pos2 += n if pa.strand2 else -n

    for op, n in pa.operations:
        if op == cigar_io.MATCH:
            if indel_run > max_indel_length and cur_ops:
                out.append(cigar_io.PairwiseAlignment(
                    pa.contig1, cur_start1, cur_end1, pa.strand1,
                    pa.contig2, cur_start2, cur_end2, pa.strand2,
                    pa.score, cur_ops))
                cur_ops = []
                indel_ops = []
                cur_start1, cur_start2 = pos1, pos2
                cur_end1, cur_end2 = cur_start1, cur_start2
            elif not cur_ops:
                indel_ops = []
                cur_start1, cur_start2 = pos1, pos2
                cur_end1, cur_end2 = cur_start1, cur_start2
            indel_run = 0
            cur_ops.extend(indel_ops)
            indel_ops = []
            step(op, n)
            cur_end1, cur_end2 = pos1, pos2
            cur_ops.append((op, n))
        else:
            indel_run += n
            step(op, n)
            indel_ops.append((op, n))

    assert pos1 == pa.end1 and pos2 == pa.end2
    if cur_ops:
        out.append(cigar_io.PairwiseAlignment(
            pa.contig1, cur_start1, cur_end1, pa.strand1,
            pa.contig2, cur_start2, cur_end2, pa.strand2, pa.score, cur_ops))
    for a in out:
        a.check()
    return out


def transform_coordinate(coord, shift, flip, seq_length):
    return shift + (seq_length - 1 - coord if flip else coord)


def write_posterior_probs(path, aligned_pairs, shift1, flip1, l1, shift2, flip2, l2):
    """Tab-separated X, Y, posterior dump (reference :299-316)."""
    with open(path, "w") as fh:
        for q in aligned_pairs:
            fh.write("{}\t{}\t{:f}\n".format(
                transform_coordinate(int(q["x"]), shift1, flip1, l1),
                transform_coordinate(int(q["y"]), shift2, flip2, l2),
                int(q["prob"]) / PAIR_ALIGNMENT_PROB_1))


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="cpecan-realign",
        description="Realigns pairwise alignments, as cigars, read from "
                    "stdin and written to stdout")
    ap.add_argument("fastas", nargs="+", help="fasta file(s) with the sequences")
    ap.add_argument("--logLevel", default=None)
    ap.add_argument("--gapGamma", type=float, default=0.5)
    ap.add_argument("--matchGamma", type=float, default=0.85)
    ap.add_argument("--splitMatrixBiggerThanThis", type=int, default=None,
                    help="No dp matrix bigger than this number squared is computed")
    ap.add_argument("--diagonalExpansion", type=int, default=4)
    ap.add_argument("--constraintDiagonalTrim", type=int, default=0)
    ap.add_argument("--alignAmbiguityCharacters", action="store_true")
    ap.add_argument("--rescoreOriginalAlignment", action="store_true")
    ap.add_argument("--rescoreByIdentity", action="store_true")
    ap.add_argument("--rescoreByPosteriorProb", action="store_true")
    ap.add_argument("--rescoreByIdentityIgnoringGaps", action="store_true")
    ap.add_argument("--rescoreByPosteriorProbIgnoringGaps", action="store_true")
    ap.add_argument("--splitIndelsLongerThanThis", type=int, default=-1)
    ap.add_argument("--mea", action="store_true",
                    help="decode with maximal-expected-accuracy + left-shift "
                         "(getShiftedMEAAlignment, reference "
                         "impl/pairwiseAligner.c:1767-1790) instead of the "
                         "poset-consistency filter")
    ap.add_argument("--outputPosteriorProbs", default=None)
    ap.add_argument("--outputAllPosteriorProbs", default=None)
    ap.add_argument("--outputExpectations", default=None)
    ap.add_argument("--loadHmm", default=None)
    ap.add_argument("--batchPairs", type=int, default=32,
                    help="records per cross-pair device batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the forward-backward pass "
                         "(default cuda; cpu runs the kernels' plain "
                         "PyTorch versions)")
    return ap


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return device


def alignment_parameters(args) -> PairwiseAlignmentParameters:
    """The alignment parameters of parsed arguments; the CLI defaults
    override the library defaults (reference :354-357)."""
    return PairwiseAlignmentParameters(
        constraintDiagonalTrim=args.constraintDiagonalTrim,
        diagonalExpansion=args.diagonalExpansion,
        gapGamma=args.gapGamma,
        splitMatrixBiggerThanThis=(
            args.splitMatrixBiggerThanThis ** 2
            if args.splitMatrixBiggerThanThis is not None else 10),
        alignAmbiguityCharacters=args.alignAmbiguityCharacters,
    )


def main(argv=None, stdin=None, stdout=None) -> int:
    args = make_parser().parse_args(argv)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    device = resolve_device(args.device)
    p = alignment_parameters(args)

    if args.loadHmm:
        sm = state_machine_from_hmm(Hmm.load(args.loadHmm))
    else:
        sm = state_machine5(StateMachineType.fiveState)

    hmm_expectations = None
    if args.outputExpectations:
        # tiny pseudocount prevents overflow (reference :493)
        hmm_expectations = Hmm(sm.type, pseudo_expectation=1e-12)

    sequences = read_sequences(args.fastas)

    def emit_record(pa, sub_x, sub_y, anchors, aligned,
                    shift1, flip1, shift2, flip2, gaps=None):
        if args.outputAllPosteriorProbs:
            write_posterior_probs(
                args.outputAllPosteriorProbs, aligned,
                shift1, flip1, pa.end1 - pa.start1,
                shift2, flip2, pa.end2 - pa.start2)

        if args.rescoreOriginalAlignment:
            aligned = score_anchor_pairs(anchors, aligned, p.diagonalExpansion)
        elif args.mea:
            gap_x, gap_y = gaps
            alignment, _score = mea_decode(
                aligned, gap_x, gap_y, sub_x, sub_y, p.gapGamma)
            aligned = mea_mod.left_shift_alignment(alignment, sub_x, sub_y)
        else:
            aligned = pairs_mod.reweight_aligned_pairs(
                aligned, len(sub_x), len(sub_y), p.gapGamma)
            aligned = filter_pairwise_alignment_to_make_pairs_ordered(
                aligned, sub_x, sub_y, args.matchGamma)

        score = pa.score
        if args.rescoreByPosteriorProb:
            score = pairs_mod.score_by_posterior_probability(
                len(sub_x), len(sub_y), aligned)
        elif args.rescoreByPosteriorProbIgnoringGaps:
            score = pairs_mod.score_by_posterior_probability_ignoring_gaps(aligned)
        elif args.rescoreByIdentity:
            score = pairs_mod.score_by_identity(sub_x, sub_y, aligned)
        elif args.rescoreByIdentityIgnoringGaps:
            score = pairs_mod.score_by_identity_ignoring_gaps(sub_x, sub_y, aligned)

        if args.outputPosteriorProbs:
            write_posterior_probs(
                args.outputPosteriorProbs, aligned,
                shift1, flip1, pa.end1 - pa.start1,
                shift2, flip2, pa.end2 - pa.start2)

        aligned = pairs_mod.sort_pairs(aligned)
        rpa = cigar_io.aligned_pairs_to_alignment(
            aligned, pa.contig1, pa.contig2, 0, pa.end1, 0, pa.end2, score)
        rpa.start1, rpa.end1, rpa.strand1 = rebase(rpa.start1, rpa.end1, rpa.strand1, shift1, flip1)
        rpa.start2, rpa.end2, rpa.strand2 = rebase(rpa.start2, rpa.end2, rpa.strand2, shift2, flip2)
        rpa.check()

        if args.splitIndelsLongerThanThis != -1:
            for sub_pa in split_pairwise_alignment(rpa, args.splitIndelsLongerThanThis):
                cigar_io.cigar_write(stdout, sub_pa)
        else:
            cigar_io.cigar_write(stdout, rpa)

    def prepare(pa):
        """Per-record preprocessing: subsequences, rebasing, anchors."""
        seq_x = sequences[pa.contig1]
        seq_y = sequences[pa.contig2]
        flip1, flip2 = not pa.strand1, not pa.strand2
        shift1 = pa.start1 if pa.strand1 else pa.end1
        shift2 = pa.start2 if pa.strand2 else pa.end2
        sub_x = get_sub_sequence(seq_x, pa.start1, pa.end1, pa.strand1)
        sub_y = get_sub_sequence(seq_y, pa.start2, pa.end2, pa.strand2)
        pa.start1, pa.end1, pa.strand1 = rebase(pa.start1, pa.end1, pa.strand1, -shift1, flip1)
        pa.start2, pa.end2, pa.strand2 = rebase(pa.start2, pa.end2, pa.strand2, -shift2, flip2)
        pa.check()
        anchors = cigar_io.alignment_to_anchor_pairs(
            pa, p.constraintDiagonalTrim, p.diagonalExpansion)
        filtered_anchors = filter_anchors_to_matches(anchors, sub_x, sub_y)
        return (pa, sub_x, sub_y, anchors, filtered_anchors,
                shift1, flip1, shift2, flip2)

    def batches(it, n):
        group = []
        for rec in it:
            group.append(rec)
            if len(group) >= n:
                yield group
                group = []
        if group:
            yield group

    # prepare group i+1 on a worker thread while group i's device batch
    # runs (torch releases the GIL inside its operators; utils/pipeline.py)
    from cpecan_tpu_torch.utils.pipeline import prefetch_map

    for prepared in prefetch_map(
            lambda group: [prepare(pa) for pa in group],
            batches(cigar_io.cigar_read(stdin), max(args.batchPairs, 1))):
        if hmm_expectations is not None:
            # bucketed cross-record batches (em.expectation_step): this
            # mode is the reference EM pipeline's worker
            # (cPecanEm.py:178-180)
            from cpecan_tpu_torch.align.pairwise import _iterate_chunks
            from cpecan_tpu_torch.em.em import _Task, expectation_step

            tasks = []
            for (pa, sub_x, sub_y, anchors, filtered_anchors,
                 *_rest) in prepared:
                for (x1, y1, x2, y2), local, rl, rr in _iterate_chunks(
                        sub_x, sub_y, filtered_anchors, p, True, True):
                    if x2 - x1 == 0 and y2 - y1 == 0:
                        continue
                    tasks.append(_Task(sub_x[x1:x2], sub_y[y1:y2],
                                       local, rl, rr))
            expectation_step(sm, tasks, p, hmm_expectations, device=device)
            continue

        # one cross-record device batch per group (reference realigns one
        # cigar at a time, cPecanRealign.c:509)
        jobs = [(sub_x, sub_y, filtered_anchors, True, True)
                for (pa, sub_x, sub_y, anchors, filtered_anchors,
                     *_rest) in prepared]
        if args.mea:
            triples = batch_align.get_aligned_pairs_with_indels_batch(
                sm, jobs, p, device=device)
            all_aligned = [t[0] for t in triples]
            all_gaps = [(t[1], t[2]) for t in triples]
        else:
            all_aligned = batch_align.get_aligned_pairs_batch(
                sm, jobs, p, device=device)
            all_gaps = [None] * len(jobs)

        for rec, aligned, gaps in zip(prepared, all_aligned, all_gaps):
            (pa, sub_x, sub_y, anchors, filtered_anchors,
             shift1, flip1, shift2, flip2) = rec
            emit_record(pa, sub_x, sub_y, anchors, aligned,
                        shift1, flip1, shift2, flip2, gaps=gaps)

    if hmm_expectations is not None:
        hmm_expectations.save(args.outputExpectations)
    if metrics.enabled():
        for line in metrics.report_lines():
            print(f"metrics: {line}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
