"""Alignment parameter config.

Mirrors the reference `PairwiseAlignmentParameters` struct exactly — the
keys are part of the behavioral surface (defaults at
impl/pairwiseAligner.c:1334-1348, JSON keys at :1354-1409).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class PairwiseAlignmentParameters:
    threshold: float = 0.01
    minDiagsBetweenTraceBack: int = 1000
    traceBackDiagonals: int = 40
    diagonalExpansion: int = 20
    constraintDiagonalTrim: int = 14
    anchorMatrixBiggerThanThis: int = 500 * 500
    repeatMaskMatrixBiggerThanThis: int = 500 * 500
    splitMatrixBiggerThanThis: int = 3000 * 3000
    # Stored-but-unread, faithfully: the reference parses and stores this
    # flag (cPecanRealign.c:435, json key impl/pairwiseAligner.c:1379) but
    # nothing in impl/ ever reads it — N is always scored through the
    # wildcard emission rows (impl/stateMachine.c:351-366), which this
    # framework mirrors in models/state_machine.py.
    alignAmbiguityCharacters: bool = False
    gapGamma: float = 0.5
    dynamicAnchorExpansion: bool = False

    def __post_init__(self):
        if self.diagonalExpansion % 2 != 0:
            raise ValueError("diagonalExpansion must be even")
        if not (0.0 <= self.threshold <= 1.0):
            raise ValueError("threshold must be in [0, 1]")

    @classmethod
    def from_json(cls, text: str) -> "PairwiseAlignmentParameters":
        """Parse the reference JSON format (impl/pairwiseAligner.c:1354-1409).

        Unknown keys are an error, matching the reference's st_errAbort.
        """
        data = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"Unrecognised pairwise alignment parameter keys: {sorted(unknown)}")
        return cls(**data)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def replace(self, **kwargs: Any) -> "PairwiseAlignmentParameters":
        return dataclasses.replace(self, **kwargs)
