"""`cpecan-em` on PyTorch — Baum-Welch EM training CLI (cPecanEm equivalent).

Counterpart of cpecan_tpu/cli/em.py with the same flags and file
formats. ``--device`` (default ``cuda``) picks where the expectation
passes run; ``cuda`` without a CUDA device raises, and nothing falls
back to the CPU. The data-parallel and multi-host flags (--dataParallel,
--coordinator, --numProcesses > 1) raise NotImplementedError: they are
the port's data-parallel item (ROADMAP Queue 1 item 10).

Usage: python -m cpecan_tpu_torch.cli.em --sequences "a.fa b.fa" \
           --alignments c.cigar --outputModel hmm.txt [options]
"""

from __future__ import annotations

import argparse
import os
import sys

from cpecan_tpu_torch.em import em as em_mod
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.cli.realign import read_sequences, resolve_device


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cpecan-em")
    ap.add_argument("--sequences", required=True,
                    help="Quoted list of fasta files containing sequences")
    ap.add_argument("--alignments", required=True, help="Cigar file")
    ap.add_argument("--outputModel", default="hmm.txt")
    ap.add_argument("--outputXMLModelFile", default=None)
    ap.add_argument("--modelType", default="fiveState")
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--outputTrialHmms", action="store_true")
    ap.add_argument("--randomStart", action="store_true")
    ap.add_argument("--inputModel", default=None)
    ap.add_argument("--updateTheBand", action="store_true")
    ap.add_argument("--maxAlignmentLengthPerJob", type=int, default=1_000_000)
    ap.add_argument("--maxAlignmentLengthToSample", type=int, default=50_000_000)
    ap.add_argument("--useDefaultModelAsStart", action="store_true")
    ap.add_argument("--setJukesCantorStartingEmissions", type=float, default=None)
    ap.add_argument("--trainEmissions", action="store_true")
    ap.add_argument("--tieEmissions", action="store_true")
    ap.add_argument("--blastScoringMatrixFile", default=None)
    ap.add_argument("--diagonalExpansion", type=int, default=10)
    ap.add_argument("--splitMatrixBiggerThanThis", type=int, default=3000,
                    help="squared internally, like the realign flag")
    ap.add_argument("--optionsToRealign", default=None,
                    help="quoted realign flags applied to the expectation "
                         "passes (cPecanEm.py:371), e.g. "
                         "'--diagonalExpansion=10 "
                         "--splitMatrixBiggerThanThis=3000'; recognised "
                         "keys: diagonalExpansion, splitMatrixBiggerThanThis,"
                         " constraintDiagonalTrim")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--retryCount", type=int, default=1,
                    help="transient-failure retries per expectation chunk "
                         "(jobTree retryCount analog)")
    ap.add_argument("--dataParallel", action="store_true",
                    help="shard expectation batches over all local devices")
    # multi-host launch (the jobTree-cluster analog, cPecanEm.py:423):
    # run the same command on every host with its --processId; chunks are
    # sharded by process and counts reduced with a collective. Env
    # fallbacks: CPECAN_COORDINATOR / CPECAN_NUM_PROCESSES /
    # CPECAN_PROCESS_ID.
    ap.add_argument("--coordinator",
                    default=os.environ.get("CPECAN_COORDINATOR"),
                    help="coordinator address host:port of a multi-host run")
    ap.add_argument("--numProcesses", type=int,
                    default=int(os.environ.get("CPECAN_NUM_PROCESSES", "1")))
    ap.add_argument("--processId", type=int,
                    default=int(os.environ.get("CPECAN_PROCESS_ID", "0")))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the expectation passes (default "
                         "cuda; cpu runs the kernels' plain PyTorch "
                         "versions)")
    return ap


def parse_options_to_realign(args) -> None:
    """Fold a quoted --optionsToRealign string into the band-shaping args
    (the reference shells these straight to cPecanRealign)."""
    if not args.optionsToRealign:
        return
    for tok in args.optionsToRealign.split():
        key, _, value = tok.lstrip("-").partition("=")
        if key == "diagonalExpansion":
            args.diagonalExpansion = int(value)
        elif key == "splitMatrixBiggerThanThis":
            args.splitMatrixBiggerThanThis = int(value)
        elif key == "constraintDiagonalTrim":
            args.constraintDiagonalTrim = int(value)
        else:
            raise SystemExit(f"unsupported --optionsToRealign flag: {tok}")


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    args.constraintDiagonalTrim = 0
    parse_options_to_realign(args)
    if args.dataParallel or args.coordinator or args.numProcesses > 1:
        raise NotImplementedError(
            "--dataParallel, --coordinator and --numProcesses > 1 need the "
            "port's data-parallel EM (ROADMAP Queue 1 item 10)")
    device = resolve_device(args.device)
    options = em_mod.EmOptions(
        modelType=args.modelType,
        inputModel=args.inputModel,
        iterations=args.iterations,
        trials=args.trials,
        outputTrialHmms=args.outputTrialHmms,
        randomStart=args.randomStart,
        updateTheBand=args.updateTheBand,
        maxAlignmentLengthPerJob=args.maxAlignmentLengthPerJob,
        maxAlignmentLengthToSample=args.maxAlignmentLengthToSample,
        useDefaultModelAsStart=args.useDefaultModelAsStart,
        setJukesCantorStartingEmissions=args.setJukesCantorStartingEmissions,
        tieEmissions=args.tieEmissions,
        trainEmissions=args.trainEmissions,
        outputXMLModelFile=args.outputXMLModelFile,
        blastScoringMatrixFile=args.blastScoringMatrixFile,
        diagonalExpansion=args.diagonalExpansion,
        splitMatrixBiggerThanThis=args.splitMatrixBiggerThanThis ** 2,
        constraintDiagonalTrim=args.constraintDiagonalTrim,
        seed=args.seed,
        retryCount=args.retryCount,
    )
    sequences = read_sequences(args.sequences.split())
    with open(args.alignments) as fh:
        cigars = list(cigar_io.cigar_read(fh))
    em_mod.expectation_maximisation_trials(
        sequences, cigars, args.outputModel, options, device=device)
    return 0


def run_cpecan_em(sequence_files, alignments_file, output_model_file, **kwargs):
    """Programmatic wrapper (the common.py runCPecanEm equivalent)."""
    argv = ["--sequences", " ".join(sequence_files),
            "--alignments", alignments_file,
            "--outputModel", output_model_file]
    for key, value in kwargs.items():
        if value is None or value is False:
            continue
        if value is True:
            argv.append(f"--{key}")
        else:
            argv += [f"--{key}", str(value)]
    return main(argv)


if __name__ == "__main__":
    sys.exit(main())
