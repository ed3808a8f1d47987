"""Minimal fasta reader/writer (sonLib bioioC fastaRead/fastaWrite
equivalents used at cPecanRealign.c:497-503)."""

from __future__ import annotations

from typing import Iterator, TextIO


def fasta_read(fh: TextIO) -> Iterator[tuple[str, str]]:
    """Yield (header, sequence). Header is the full line after '>' —
    cPecanRealign keys sequences by the first '>'-line token string."""
    name = None
    chunks: list[str] = []
    for line in fh:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(chunks)
            name = line[1:].strip()
            chunks = []
        elif line and name is not None:
            chunks.append(line.strip())
    if name is not None:
        yield name, "".join(chunks)


def fasta_read_file(path: str) -> Iterator[tuple[str, str]]:
    with open(path) as fh:
        yield from fasta_read(fh)


def fasta_write(fh: TextIO, name: str, sequence: str, width: int = 0) -> None:
    fh.write(f">{name}\n")
    if width <= 0:
        fh.write(sequence + "\n")
    else:
        for i in range(0, len(sequence), width):
            fh.write(sequence[i : i + width] + "\n")
