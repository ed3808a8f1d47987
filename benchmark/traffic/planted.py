"""The benchmark's one traffic generator: genomic-like sequences and
records evolved from them with a planted alignment, all from one seed.

Vectorised numpy counterparts of the port's ``utils/symbols``
generators (``genomic_like_sequence``: GC-skewed unique segments,
diverged copies of a few repeat families, short tandem repeats;
``tracked_evolve``: substitutions and short indels with the true
alignment kept) and of the record builders of ``bench.py`` and
``chip_smoke.py``. They are copies in intent, not in their random
streams, so that no later change to the program moves the traffic.

A traffic file (``benchmark/traffic/<name>.json``) names this generator
and its parameters:

- ``kind``: ``reads`` (records drawn from one reference sequence, half
  of them on the minus strand) or ``blocks`` (each record a block of
  its own sequence against its evolved copy);
- ``lengths``: how the record lengths are drawn. Lengths come from
  fixed quantiles of the distribution, so every seed gives the same
  lengths in the same order and only the sequences differ;
- ``records`` (a pool, cycled by realign) or ``corpus_bases`` (records
  until their lengths reach it, EM's corpus);
- ``evolve``: ``sub_rate``, ``del_rate``, ``ins_rate`` (events per base)
  and ``max_indel`` (indel lengths uniform in 1..max_indel).

A record's cigar is not the planted alignment itself but that alignment
with every indel shifted as far left as an equally good alignment
allows, where a mapper puts it.
"""

from __future__ import annotations

import math

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def _bases(rng, n: int, gc: float = 0.5) -> np.ndarray:
    """n random bases with GC content gc."""
    strong = rng.random(n) < gc
    pick = rng.integers(0, 2, n)
    return np.where(strong, np.where(pick, BASES[1], BASES[2]),
                    np.where(pick, BASES[0], BASES[3])).astype(np.uint8)


def _diverged(rng, master: np.ndarray, sub: float = 0.08,
              dele: float = 0.02) -> np.ndarray:
    r = rng.random(len(master))
    out = np.where(r < sub, _bases(rng, len(master)), master)
    return out[~((r >= sub) & (r < sub + dele))]


def genomic_like(rng, length: int, repeat_fraction: float = 0.3,
                 tandem_fraction: float = 0.05, family_len: int = 300,
                 n_families: int = 3) -> np.ndarray:
    """A repeat-rich sequence of length bases (uint8 ASCII): unique
    segments of GC content 35-65%, diverged copies of repeat families
    (two of family_len, one ten times longer) and tandem repeats, in
    proportion to repeat_fraction and tandem_fraction."""
    families = [_bases(rng, family_len * (10 if i == n_families - 1 else 1))
                for i in range(n_families)]
    seg_len = max(min(length // 8, 2000), 600)
    parts, total, rep = [], 0, 0
    while total < length:
        behind = rep < (repeat_fraction + tandem_fraction) * total
        r = rng.random()
        if behind and r < 0.85:
            if r < 0.85 * tandem_fraction / (repeat_fraction + tandem_fraction):
                unit = _bases(rng, int(rng.integers(2, 7)))
                t = np.tile(unit, int(rng.integers(10, 61)))
            else:
                t = _diverged(rng, families[int(rng.integers(n_families))])
            rep += len(t)
        else:
            n = min(int(rng.integers(seg_len // 2, seg_len + 1)),
                    length - total + 200)
            t = _bases(rng, n, float(rng.choice([0.35, 0.45, 0.55, 0.65])))
        parts.append(t)
        total += len(t)
    return np.concatenate(parts)[:length]


def evolve(rng, x: np.ndarray, sub_rate: float, del_rate: float,
           ins_rate: float, max_indel: int):
    """(y, ops): x mutated by substitutions, deletions and insertions, and
    the planted alignment as cigar operations (M, D consuming x, I
    consuming y) that covers both sequences whole. Deletion runs start at
    a base with probability del_rate; an insertion goes before a kept
    base with probability ins_rate; lengths are uniform in 1..max_indel.
    The first and last bases are kept, with no insertion before the
    first."""
    n = len(x)
    idx = np.arange(n)
    dstart = rng.random(n) < del_rate
    reach = np.where(dstart, idx + rng.integers(1, max_indel + 1, n), 0)
    deleted = dstart.copy()
    deleted[1:] |= np.maximum.accumulate(reach)[:-1] > idx[1:]
    deleted[0] = deleted[-1] = False
    keep = ~deleted
    ins = (rng.random(n) < ins_rate) & keep
    ins[0] = False
    ilen = np.where(ins, rng.integers(1, max_indel + 1, n), 0)
    mutant = np.where(rng.random(n) < sub_rate, _bases(rng, n), x)
    # y: for every kept base its insertion first, then the base
    pos = np.cumsum(np.where(keep, ilen + 1, 0)) - 1
    y = _bases(rng, int(pos[-1]) + 1)
    y[pos[keep]] = mutant[keep]
    # one slot per base (M or D) and one before each insertion's base (I)
    base_slot = idx + np.cumsum(ins)
    codes = np.empty(n + int(ins.sum()), np.int64)
    lens = np.ones(len(codes), np.int64)
    codes[base_slot] = deleted
    codes[base_slot[ins] - 1] = 2
    lens[base_slot[ins] - 1] = ilen[ins]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(codes)) + 1])
    run_lens = np.add.reduceat(lens, starts)
    return y, [("MDI"[c], int(m)) for c, m in zip(codes[starts], run_lens)]


def left_align(x: np.ndarray, y: np.ndarray, ops: list) -> list:
    """ops with every indel shifted left while the base before it equals
    the indel's last base (the alignment's matches and mismatches stay
    the same), keeping at least one M before it."""
    xb, yb = x.tobytes(), y.tobytes()
    out, xi, yi = [], 0, 0
    for op, n in ops:
        m = out[-1][1] if out and out[-1][0] == "M" else 0
        seq, pos = (xb, xi) if op == "D" else (yb, yi)
        s = 0
        if op != "M":
            while s < m - 1 and seq[pos - 1 - s] == seq[pos + n - 1 - s]:
                s += 1
        if s:
            out[-1] = ("M", m - s)
            out += [(op, n), ("M", s)]
        elif out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + n)
        else:
            out.append((op, n))
        xi += n if op != "I" else 0
        yi += n if op != "D" else 0
    return out


def _quantile_lengths(spec: dict, count: int) -> np.ndarray:
    """count lengths at evenly spaced quantiles of the distribution,
    arranged by a golden-ratio stride so that every prefix has a mix."""
    q = (np.arange(count) + 0.5) / count
    if spec["dist"] == "lognormal":
        from scipy.special import ndtri

        lens = spec["median"] * np.exp(spec["sigma"] * ndtri(q))
    elif spec["dist"] == "uniform":
        lens = spec["low"] + q * (spec["high"] - spec["low"])
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lens = np.clip(np.rint(lens), spec.get("min", 1), spec.get("max", 1 << 40))
    stride = int(round(count * (math.sqrt(5) - 1) / 2)) or 1
    while math.gcd(stride, count) != 1:
        stride += 1
    return lens.astype(np.int64)[(np.arange(count) * stride) % count]


def _count_for(spec: dict, traffic: dict) -> int:
    if "records" in traffic:
        return int(traffic["records"])
    mean = (spec["median"] * math.exp(spec["sigma"] ** 2 / 2)
            if spec["dist"] == "lognormal" else (spec["low"] + spec["high"]) / 2)
    return max(1, int(round(traffic["corpus_bases"] / mean)))


def _text(a: np.ndarray) -> str:
    return a.tobytes().decode("ascii")


def generate(traffic: dict, seed: int):
    """(sequences {name: str}, records [dict]) of a traffic file's mix.
    A record holds its cigar fields: contig1, start1, end1, strand1 (the
    reference side), contig2, start2, end2, strand2 (the query), ops."""
    rng = np.random.default_rng([seed, 0x62656e63])
    spec = traffic["lengths"]
    ev = traffic["evolve"]
    lengths = _quantile_lengths(spec, _count_for(spec, traffic))
    seqs, records = {}, []
    if traffic["kind"] == "reads":
        ref = genomic_like(rng, int(traffic["reference_bases"]))
        seqs["ref"] = _text(ref)
        starts = rng.integers(0, len(ref) - lengths + 1)
        minus = rng.random(len(lengths)) < traffic.get("minus_fraction", 0.5)
        for i, (n, s, neg) in enumerate(zip(lengths, starts, minus)):
            x = ref[s:s + n]
            y, ops = evolve(rng, x, ev["sub_rate"], ev["del_rate"],
                            ev["ins_rate"], ev["max_indel"])
            ops = left_align(x, y, ops)
            name = f"read{i}"
            if neg:  # the read as sequenced is the reverse complement
                seqs[name] = _text(_COMP[y[::-1]])
                records.append(dict(contig1="ref", start1=int(s),
                                    end1=int(s + n), strand1=True,
                                    contig2=name, start2=len(y), end2=0,
                                    strand2=False, ops=ops))
            else:
                seqs[name] = _text(y)
                records.append(dict(contig1="ref", start1=int(s),
                                    end1=int(s + n), strand1=True,
                                    contig2=name, start2=0, end2=len(y),
                                    strand2=True, ops=ops))
    elif traffic["kind"] == "blocks":
        for i, n in enumerate(lengths):
            x = genomic_like(rng, int(n))
            y, ops = evolve(rng, x, ev["sub_rate"], ev["del_rate"],
                            ev["ins_rate"], ev["max_indel"])
            ops = left_align(x, y, ops)
            nx, ny = f"block{i}x", f"block{i}y"
            seqs[nx], seqs[ny] = _text(x), _text(y)
            records.append(dict(contig1=nx, start1=0, end1=len(x),
                                strand1=True, contig2=ny, start2=0,
                                end2=len(y), strand2=True, ops=ops))
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    return seqs, records


def cigar_line(rec: dict, score: float = 0.0) -> str:
    """A record as a cigar line (the query, contig2, leads the line)."""
    head = ["cigar:", rec["contig2"], str(rec["start2"]), str(rec["end2"]),
            "+" if rec["strand2"] else "-", rec["contig1"], str(rec["start1"]),
            str(rec["end1"]), "+" if rec["strand1"] else "-", f"{score:g}"]
    return " ".join(head + [f"{op} {n}" for op, n in rec["ops"]])


def query_bases(rec: dict) -> int:
    return abs(rec["end2"] - rec["start2"])
