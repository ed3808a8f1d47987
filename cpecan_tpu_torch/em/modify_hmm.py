"""Post-processing transforms for trained HMMs (cPecanModifyHmm.py).

Counterpart of cpecan_tpu/em/modify_hmm.py; host only."""

from __future__ import annotations

import numpy as np

from cpecan_tpu_torch.models.hmm import Hmm


def normalise_hmm_by_reference_gc_content(hmm: Hmm, gc_content: float) -> None:
    """Renormalise each non-insert state's match emissions so reference-base
    (row) marginals match the target GC fraction (cPecanModifyHmm.py:14-19).
    States 2 and 4 (the Y-insert states) are skipped — they emit no
    reference base."""
    for state in range(hmm.state_number):
        if state in (2, 4):
            continue
        e = hmm.emissions[state]
        row_sums = e.sum(axis=1, keepdims=True)
        target = np.array([(1.0 - gc_content) / 2.0, gc_content / 2.0,
                           gc_content / 2.0, (1.0 - gc_content) / 2.0])
        hmm.emissions[state] = (e / row_sums) * target[:, None]


def modify_hmm_emissions_by_expected_variation_rate(hmm: Hmm,
                                                    substitution_rate: float) -> None:
    """Convolve the match-state emissions with a uniform substitution-rate
    matrix (cPecanModifyHmm.py:21-24)."""
    n = np.full((4, 4), substitution_rate / 3.0)
    np.fill_diagonal(n, 1.0 - substitution_rate)
    hmm.emissions[0] = hmm.emissions[0] @ n


def set_hmm_indel_emissions_to_be_flat(hmm: Hmm) -> None:
    """Flat emissions for all gap states (cPecanModifyHmm.py:26-29)."""
    for state in range(1, hmm.state_number):
        hmm.emissions[state] = 1.0 / 16.0
