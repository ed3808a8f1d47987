"""Hmm parameter/expectation container with reference-compatible I/O.

Parity targets (reference impl/stateMachine.c):
  - construct with pseudocount            :23-48
  - normalise (row transitions, global
    per-state emissions)                  :88-112
  - randomise                             :114-131
  - 2-line text format write/load         :133-202
  - JSON load                             :204-253
and type enum values (inc/stateMachine.h:28-33).
"""

from __future__ import annotations

import enum
import io
import json
from typing import TextIO

import numpy as np

from cpecan_tpu_torch.utils.symbols import SYMBOL_NUMBER_NO_N


class StateMachineType(enum.IntEnum):
    fiveState = 0
    fiveStateAsymmetric = 1
    threeState = 2
    threeStateAsymmetric = 3

    @property
    def state_number(self) -> int:
        return 5 if self in (StateMachineType.fiveState, StateMachineType.fiveStateAsymmetric) else 3

    @property
    def symmetric(self) -> bool:
        return self in (StateMachineType.fiveState, StateMachineType.threeState)


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
        # per-EM-iteration likelihood trace (cPecanEm.py Hmm:26,49)
        self.running_likelihoods: list[float] = []

    # ------------------------------------------------------------------ math
    def normalise(self) -> None:
        """Row-normalise transitions; normalise each state's emission matrix
        to sum to 1 (reference impl/stateMachine.c:88-112)."""
        self.transitions /= self.transitions.sum(axis=1, keepdims=True)
        self.emissions /= self.emissions.sum(axis=(1, 2), keepdims=True)

    def randomise(self, rng: np.random.Generator | None = None) -> None:
        rng = rng or np.random.default_rng()
        self.transitions = rng.random(self.transitions.shape)
        self.emissions = rng.random(self.emissions.shape)
        self.normalise()

    def equalise(self) -> None:
        """All-equal probabilities (cPecanEm.py Hmm.equalise :82-86)."""
        s = self.state_number
        self.transitions = np.full((s, s), 1.0 / s)
        self.emissions = np.full(self.emissions.shape, 1.0 / 16.0)

    def set_emissions_to_jukes_cantor(self, divergence: float) -> None:
        """Jukes-Cantor match/mismatch emission init for every state
        (cPecanEm.py :88-94)."""
        same = (0.25 + 0.75 * np.exp(-4.0 * divergence / 3.0)) / 4.0
        diff = (0.25 - 0.25 * np.exp(-4.0 * divergence / 3.0)) / 4.0
        e = np.full((SYMBOL_NUMBER_NO_N, SYMBOL_NUMBER_NO_N), diff)
        np.fill_diagonal(e, same)
        self.emissions[:] = e[None, :, :]

    def tie_emissions(self) -> None:
        """Replace each state's emissions with identity/difference tied
        values preserving overall identity expectation (cPecanEm.py :96-105)."""
        for state in range(self.state_number):
            e = self.emissions[state]
            identity = float(np.trace(e))
            tied = np.full((4, 4), (1.0 - identity) / 12.0)
            np.fill_diagonal(tied, identity / 4.0)
            self.emissions[state] = tied

    def add_expectations(self, other: "Hmm") -> None:
        """Sum another Hmm's expectation counts into this one (the EM gather
        reduction; cPecanEm.py:37-43)."""
        if other.type != self.type:
            raise ValueError("Hmm type mismatch")
        self.transitions += other.transitions
        self.emissions += other.emissions
        self.likelihood += other.likelihood

    # ------------------------------------------------------------------- I/O
    def write(self, fh: TextIO, precise: bool = False) -> None:
        """Reference 2-line text format (impl/stateMachine.c:133-143):
        line 1: type, S*S transitions, likelihood; line 2: S*16 emissions.
        precise=True writes full-precision floats (the EM pipeline's model
        files, cPecanEm.py Hmm.write :31-35); otherwise C's '%f'. A third
        line with running likelihoods is appended when present."""
        fmt = (lambda v: repr(float(v))) if precise else (lambda v: f"{v:f}")
        parts = [f"{int(self.type)}"]
        parts += [fmt(v) for v in self.transitions.reshape(-1)]
        parts += [fmt(self.likelihood)]
        fh.write("\t".join(parts) + "\n")
        fh.write("\t".join(fmt(v) for v in self.emissions.reshape(-1)) + "\t\n")
        if self.running_likelihoods:
            fh.write("\t".join(repr(float(v)) for v in self.running_likelihoods) + "\n")

    def save(self, path: str, precise: bool = False) -> None:
        with open(path, "w") as fh:
            self.write(fh, precise=precise)

    def dumps(self) -> str:
        buf = io.StringIO()
        self.write(buf)
        return buf.getvalue()

    @classmethod
    def read(cls, fh: TextIO) -> "Hmm":
        line1 = fh.readline().split()
        if len(line1) < 2:
            raise ValueError("Empty/short transitions line in HMM file")
        hmm = cls(StateMachineType(int(line1[0])))
        s = hmm.state_number
        if len(line1) != s * s + 2:
            raise ValueError(
                f"Wrong number of transitions: got {len(line1)}, expected {s * s + 2}"
            )
        hmm.transitions = np.array([float(v) for v in line1[1 : 1 + s * s]], dtype=np.float64).reshape(s, s)
        hmm.likelihood = float(line1[-1])
        line2 = fh.readline().split()
        n_emissions = s * SYMBOL_NUMBER_NO_N * SYMBOL_NUMBER_NO_N
        if len(line2) != n_emissions:
            raise ValueError(
                f"Wrong number of emissions: got {len(line2)}, expected {n_emissions}"
            )
        hmm.emissions = np.array([float(v) for v in line2], dtype=np.float64).reshape(
            s, SYMBOL_NUMBER_NO_N, SYMBOL_NUMBER_NO_N
        )
        line3 = fh.readline().split()
        if line3:
            hmm.running_likelihoods = [float(v) for v in line3]
        return hmm

    @classmethod
    def load(cls, path: str) -> "Hmm":
        with open(path) as fh:
            return cls.read(fh)

    @classmethod
    def loads(cls, text: str) -> "Hmm":
        return cls.read(io.StringIO(text))

    @classmethod
    def from_json(cls, text: str) -> "Hmm":
        """Reference JSON format (impl/stateMachine.c:204-253): keys
        type / transitions / emissions / likelihood; transitions and
        emissions are required."""
        data = json.loads(text)
        unknown = set(data) - {"type", "transitions", "emissions", "likelihood"}
        if unknown:
            raise ValueError(f"Unrecognised keys in hmm json: {sorted(unknown)}")
        hmm = cls(StateMachineType(int(data["type"])))
        s = hmm.state_number
        if "transitions" not in data:
            raise ValueError("Did not find transitions specified in json HMM")
        if "emissions" not in data:
            raise ValueError("Did not find emissions specified in json HMM")
        hmm.transitions = np.asarray(data["transitions"], dtype=np.float64).reshape(s, s)
        hmm.emissions = np.asarray(data["emissions"], dtype=np.float64).reshape(
            s, SYMBOL_NUMBER_NO_N, SYMBOL_NUMBER_NO_N
        )
        hmm.likelihood = float(data.get("likelihood", 0.0))
        return hmm

    def to_json(self) -> str:
        return json.dumps(
            {
                "type": int(self.type),
                "transitions": list(self.transitions.reshape(-1)),
                "emissions": list(self.emissions.reshape(-1)),
                "likelihood": self.likelihood,
            }
        )
