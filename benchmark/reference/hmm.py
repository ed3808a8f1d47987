"""Frozen copy of the port's models/hmm.py, kept with the benchmark so that
no later change to the program moves the yardstick.

Hmm parameter/expectation container, cut to what the benchmark's
reference uses: construction with a pseudocount (impl/stateMachine.c:
23-48), normalisation (:88-112), the equalised start (cPecanEm.py
Hmm.equalise :82-86), and the type enum (inc/stateMachine.h:28-33).
"""

from __future__ import annotations

import enum

import numpy as np

SYMBOL_NUMBER_NO_N = 4


class StateMachineType(enum.IntEnum):
    fiveState = 0
    fiveStateAsymmetric = 1
    threeState = 2
    threeStateAsymmetric = 3

    @property
    def state_number(self) -> int:
        return 5 if self in (StateMachineType.fiveState, StateMachineType.fiveStateAsymmetric) else 3


class Hmm:
    """Dense transition/emission parameter (or expectation-count) store.

    transitions: (S, S) float64, row = from-state.
    emissions:   (S, 4, 4) float64, indexed [state, symX, symY].
    """

    def __init__(self, type: StateMachineType, pseudo_expectation: float = 0.0):
        self.type = StateMachineType(type)
        s = self.type.state_number
        self.state_number = s
        self.transitions = np.full((s, s), pseudo_expectation, dtype=np.float64)
        self.emissions = np.full(
            (s, SYMBOL_NUMBER_NO_N, SYMBOL_NUMBER_NO_N), pseudo_expectation, dtype=np.float64
        )
        self.likelihood = 0.0

    # ------------------------------------------------------------------ math
    def normalise(self) -> None:
        """Row-normalise transitions; normalise each state's emission matrix
        to sum to 1 (reference impl/stateMachine.c:88-112)."""
        self.transitions /= self.transitions.sum(axis=1, keepdims=True)
        self.emissions /= self.emissions.sum(axis=(1, 2), keepdims=True)

    def equalise(self) -> None:
        """All-equal probabilities (cPecanEm.py Hmm.equalise :82-86)."""
        s = self.state_number
        self.transitions = np.full((s, s), 1.0 / s)
        self.emissions = np.full(self.emissions.shape, 1.0 / 16.0)
