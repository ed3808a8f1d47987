"""`cpecan-align` on PyTorch — fasta x fasta all-vs-all aligner producing
cigars.

Counterpart of cpecan_tpu/cli/align.py with the same interface and
semantics (reference cPecanAlign.c:93-165): each query aligned to each
target with ragged ends, AMAP-reweighted, poset-filtered at matchGamma
0.9, written as cigars on stdout. ``--device`` (default ``cuda``) picks
where the forward-backward pass runs; ``cuda`` without a CUDA device
raises.

Usage: python -m cpecan_tpu_torch.cli.align fasta_target fasta_query
"""

from __future__ import annotations

import argparse
import sys

from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.hmm import Hmm
from cpecan_tpu_torch.models.state_machine import state_machine5, state_machine_from_hmm
from cpecan_tpu_torch.align import batch as batch_align
from cpecan_tpu_torch.align.anchors import get_anchors
from cpecan_tpu_torch.cli.realign import resolve_device
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.io.fasta import fasta_read_file
from cpecan_tpu_torch.msa.aligner import filter_pairwise_alignment_to_make_pairs_ordered
from cpecan_tpu_torch.ops import pairs as pairs_mod
from cpecan_tpu_torch.utils.pipeline import prefetch_map


def read_fasta_by_first_token(path: str) -> dict:
    out = {}
    for header, seq in fasta_read_file(path):
        key = header.split()[0] if header.split() else header
        out[key] = seq
    return out


def main(argv=None, stdout=None) -> int:
    ap = argparse.ArgumentParser(prog="cpecan-align")
    ap.add_argument("fasta_target")
    ap.add_argument("fasta_query")
    ap.add_argument("--loadHmm", default=None)
    ap.add_argument("--matchGamma", type=float, default=0.9)
    ap.add_argument("--batchPairs", type=int, default=32,
                    help="pairs per cross-pair device batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the forward-backward pass "
                         "(default cuda; cpu runs the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    stdout = stdout or sys.stdout
    device = resolve_device(args.device)

    sm = (state_machine_from_hmm(Hmm.load(args.loadHmm))
          if args.loadHmm else state_machine5())
    p = PairwiseAlignmentParameters()

    targets = read_fasta_by_first_token(args.fasta_target)
    queries = read_fasta_by_first_token(args.fasta_query)

    # all query x target pairs in cross-pair device batches; the next
    # group's anchoring (the heavy host stage here) runs on a worker
    # thread while the current group's device batch executes
    pairs_meta = [(qh, qs, th, ts)
                  for qh, qs in queries.items()
                  for th, ts in targets.items()]
    groups = [pairs_meta[s:s + args.batchPairs]
              for s in range(0, len(pairs_meta), args.batchPairs)]

    def anchor_group(group):
        return [(ts, qs, get_anchors(ts, qs, p), True, True)
                for qh, qs, th, ts in group]

    for group, jobs in zip(groups, prefetch_map(anchor_group, groups)):
        results = batch_align.get_aligned_pairs_batch(sm, jobs, p,
                                                      device=device)
        for (query_header, query_seq, target_header, target_seq), aligned \
                in zip(group, results):
            aligned = pairs_mod.reweight_aligned_pairs(
                aligned, len(target_seq), len(query_seq), p.gapGamma)
            aligned = filter_pairwise_alignment_to_make_pairs_ordered(
                aligned, target_seq, query_seq, args.matchGamma)
            aligned = pairs_mod.sort_pairs(aligned)
            pa = cigar_io.aligned_pairs_to_alignment(
                aligned, target_header, query_header,
                0, len(target_seq), 0, len(query_seq), 0)
            cigar_io.cigar_write(stdout, pa)
    return 0


if __name__ == "__main__":
    sys.exit(main())
