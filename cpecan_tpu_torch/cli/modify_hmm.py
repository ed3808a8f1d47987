"""`cpecan-modify-hmm` — post-process a trained HMM (cPecanModifyHmm.py).

Counterpart of cpecan_tpu/cli/modify_hmm.py; host only.

Usage: python -m cpecan_tpu_torch.cli.modify_hmm inputModel outputModel [options]
"""

from __future__ import annotations

import argparse
import sys

from cpecan_tpu_torch.models.hmm import Hmm
from cpecan_tpu_torch.em.modify_hmm import (
    normalise_hmm_by_reference_gc_content,
    modify_hmm_emissions_by_expected_variation_rate,
    set_hmm_indel_emissions_to_be_flat,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cpecan-modify-hmm")
    ap.add_argument("inputModel")
    ap.add_argument("outputModel")
    ap.add_argument("--substitutionRate", type=float, default=0.0)
    ap.add_argument("--gcContent", type=float, default=None)
    ap.add_argument("--setFlatIndelEmissions", action="store_true")
    args = ap.parse_args(argv)

    hmm = Hmm.load(args.inputModel)
    if args.gcContent is not None:
        if not 0.0 <= args.gcContent <= 1.0:
            raise RuntimeError(f"gcContent not in [0,1]: {args.gcContent}")
        normalise_hmm_by_reference_gc_content(hmm, args.gcContent)
    if not 0.0 <= args.substitutionRate <= 1.0:
        raise RuntimeError(f"substitutionRate not in [0,1]: {args.substitutionRate}")
    modify_hmm_emissions_by_expected_variation_rate(hmm, args.substitutionRate)
    if args.setFlatIndelEmissions:
        set_hmm_indel_emissions_to_be_flat(hmm)
    hmm.save(args.outputModel, precise=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
