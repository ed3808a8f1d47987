"""DNA alphabet encoding and test-sequence generators.

Behavioral parity targets:
  - symbol codes {a,c,g,t,n} = 0..4 (reference inc/stateMachine.h:13-22)
  - char<->symbol conversion (reference impl/pairwiseAligner.c:317-349)
  - random/evolved sequence generators (reference impl/randomSequences.c)

TPU-first design note: sequences are encoded once on the host into dense
int8 numpy arrays; all device code consumes integer symbol tensors, never
strings.
"""

from __future__ import annotations

import random

import numpy as np

SYMBOL_NUMBER = 5
SYMBOL_NUMBER_NO_N = 4

A, C, G, T, N = 0, 1, 2, 3, 4

_CHAR_TO_SYMBOL = np.full(256, N, dtype=np.int8)
for _chars, _code in (("Aa", A), ("Cc", C), ("Gg", G), ("Tt", T)):
    for _ch in _chars:
        _CHAR_TO_SYMBOL[ord(_ch)] = _code

_SYMBOL_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.int8)


def encode(sequence: str) -> np.ndarray:
    """Encode a DNA string to an int8 symbol array (unknown chars -> N)."""
    raw = np.frombuffer(sequence.encode("latin-1"), dtype=np.uint8)
    return _CHAR_TO_SYMBOL[raw]


def decode(symbols: np.ndarray) -> str:
    return _SYMBOL_TO_CHAR[np.asarray(symbols, dtype=np.int64)].tobytes().decode("ascii")


_COMPLEMENT = {"A": "T", "T": "A", "C": "G", "G": "C", "a": "t", "t": "a",
               "c": "g", "g": "c"}


def reverse_complement(sequence: str) -> str:
    """Reverse complement preserving case; non-ACGT chars map to N."""
    return "".join(_COMPLEMENT.get(ch, "N") for ch in reversed(sequence))


def get_random_sequence(length: int, rng: random.Random | None = None) -> str:
    """Random DNA with ~1/11 N chars and mixed case.

    Mirrors the reference test-data generator (impl/randomSequences.c:13-45):
    each position is chosen from {A,C,G,T}*2 cases + {N,n} with N having
    weight 1 of 11 total (the reference picks char class uniformly from
    aAcCgGtTNn-ish distribution with p(N) ~ 1/11).
    """
    rng = rng or random
    chars = "AaCcGgTt" + "Nn"
    # 8 case-variant ACGT chars weighted 10/11 total, N/n weighted 1/11
    out = []
    for _ in range(length):
        if rng.random() < 1.0 / 11.0:
            out.append("Nn"[rng.random() < 0.5])
        else:
            out.append(chars[int(rng.random() * 8)])
    return "".join(out)


def evolve_sequence(sequence: str, rng: random.Random | None = None) -> str:
    """Mutate a sequence: ~20% substitutions plus random short indels.

    Mirrors reference impl/randomSequences.c:50-73: walks the input, each
    base deleted with p=0.1, duplicated-with-insertion with p=0.1, and
    substituted with p=0.2.
    """
    rng = rng or random
    out = []
    bases = "ACGTacgt"
    for ch in sequence:
        r = rng.random()
        if r < 0.1:
            continue  # deletion
        if r < 0.2:
            out.append(bases[int(rng.random() * 8)])  # insertion
        if rng.random() < 0.2:
            out.append(bases[int(rng.random() * 8)])  # substitution
        else:
            out.append(ch)
    return "".join(out)


def tracked_evolve(sequence: str, rng: random.Random | None = None,
                   sub_rate: float = 0.1, indel_rate: float = 0.02,
                   max_indel: int = 5):
    """Evolve a sequence with substitutions and short indels, returning
    (mutant, true_pairs) where true_pairs is the exact list of (x, y)
    aligned (possibly substituted) base pairs — a planted-truth generator
    for accuracy tests and benchmarks (the repo-local stand-in for the
    reference long test's curated ENCODE alignments,
    tests/pairwiseAlignerLongTest.c:40-121)."""
    rng = rng or random
    out = []
    true_pairs = []
    y = 0
    x = 0
    n = len(sequence)
    while x < n:
        r = rng.random()
        if r < indel_rate:  # deletion: skip input bases
            x += rng.randint(1, max_indel)
            continue
        if r < 2 * indel_rate:  # insertion: emit random bases
            ins = rng.randint(1, max_indel)
            out.extend(rng.choice("ACGT") for _ in range(ins))
            y += ins
            continue
        c = sequence[x]
        if rng.random() < sub_rate:
            c = rng.choice("ACGT")
        out.append(c)
        true_pairs.append((x, y))
        x += 1
        y += 1
    return "".join(out), true_pairs


def genomic_like_sequence(length: int, rng: random.Random | None = None,
                          repeat_fraction: float = 0.3,
                          n_families: int = 3,
                          family_len: int = 300,
                          tandem_fraction: float = 0.05,
                          gc_segments: int = 8):
    """Repeat-rich soft-masked test sequence — the repo-local stand-in for
    real ENCODE genomic structure (the reference's long test input,
    tests/pairwiseAlignerLongTest.c:40-121): interspersed repeat families
    (diverged copies of a few master elements, LOWERCASE soft-masked as
    RepeatMasker output would be), short tandem repeats (lowercase), and
    GC-skewed unique segments.  This is the regime where k-mer anchoring
    genuinely differs from lastz: seeds inside repeats must be masked or
    overwhelmed, and anchoring must come from the unique stretches."""
    rng = rng or random
    # SINE-like short families plus one LINE-like long element, so repeat
    # content by LENGTH lands near repeat_fraction (human-like mix)
    families = []
    for i in range(n_families):
        fl = family_len if i + 1 < n_families else family_len * 10
        families.append("".join(rng.choice("ACGT") for _ in range(fl)))

    def diverged_copy(master: str) -> str:
        out = []
        for c in master:
            r = rng.random()
            if r < 0.08:
                c = rng.choice("ACGT")
            elif r < 0.10:
                continue  # small deletions
            out.append(c.lower())  # soft-masked
        return "".join(out)

    def gc_segment(n: int, gc: float) -> str:
        return "".join(
            rng.choice("GC") if rng.random() < gc else rng.choice("AT")
            for _ in range(n))

    parts = []
    total = 0
    rep_total = 0
    seg_len = max(min(length // max(gc_segments, 1), 2000), 600)
    while total < length:
        behind = rep_total < (repeat_fraction + tandem_fraction) * total
        r = rng.random()
        if behind and r < 0.85:
            if r < 0.85 * tandem_fraction / (repeat_fraction +
                                             tandem_fraction):
                unit = "".join(rng.choice("ACGT")
                               for _ in range(rng.randint(2, 6)))
                t = (unit * rng.randint(10, 60)).lower()
            else:
                t = diverged_copy(rng.choice(families))
            parts.append(t)
            total += len(t)
            rep_total += len(t)
        else:
            n = min(rng.randint(seg_len // 2, seg_len), length - total + 200)
            seg = gc_segment(n, rng.choice([0.35, 0.45, 0.55, 0.65]))
            parts.append(seg)
            total += n
    return "".join(parts)[:length]
