"""What cPecanAlign derives from a pair of sequences, worked out again
for the reference.

cPecanAlign (cPecanAlign.c:104-150) aligns each query to each target at
the library's defaults: ``getAlignedPairs`` with ragged ends on both
sides (anchors by lastz, here the port's k-mer chaining, frozen in
anchors.py, then the split at unanchored areas above
splitMatrixBiggerThanThis, one band per chunk at diagonalExpansion),
the AMAP reweight at gapGamma (``reweightAlignedPairs2``), and the poset
filter at matchGamma: the heaviest chain of pairs of weight matchGamma
or more that is increasing in both sequences. The posteriors come from
fb_long.py.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import anchors as anchors_mod
from benchmark.reference import fb_long
from benchmark.reference import records


def pair_chunks(target: str, query: str, settings: dict) -> list:
    """The chunks of one pair (target along x), ragged on both sides."""
    anchors = anchors_mod.get_anchors(
        target, query, settings["constraintDiagonalTrim"],
        settings["diagonalExpansion"], settings["anchorMatrixBiggerThanThis"],
        settings["repeatMaskMatrixBiggerThanThis"])
    return records.chunks_of(target, query, anchors,
                             settings["splitMatrixBiggerThanThis"],
                             settings["diagonalExpansion"])


def band_cells(chunks) -> int:
    return sum(int(np.sum(c["widths"])) for c in chunks)


def weighted_pairs(pairs, model: dict, settings: dict, dtype=torch.float64,
                   device="cpu", chunks=None, cell_budget: int = 1 << 26) -> list:
    """Per (target, query) pair: its pairs (x, y) at or above the
    threshold and their AMAP-reweighted weights in [0, 1], from the
    posteriors computed in dtype. ``chunks``, given, are each pair's
    pair_chunks."""
    chunks = chunks or [pair_chunks(t, q, settings) for t, q in pairs]
    flat = [c for cs in chunks for c in cs]
    posts = fb_long.posteriors(flat, model, dtype=dtype, device=device,
                               threshold=settings["threshold"],
                               cell_budget=cell_budget)
    out, a = [], 0
    for (target, query), cs in zip(pairs, chunks):
        xs, ys, ps = records.pairs_from_posteriors(cs, posts[a:a + len(cs)],
                                                   settings["threshold"])
        a += len(cs)
        w = records.reweight(xs, ys, ps, len(target), len(query),
                             settings["gapGamma"])
        out.append((xs, ys, w / records.PROB_ONE))
    return out


def decode(xs, ys, weights, floor: float):
    """The poset filter's answer: the heaviest chain, increasing in both
    sequences, of the pairs of weight floor or more."""
    keep = weights >= floor
    xs, ys, weights = xs[keep], ys[keep], weights[keep]
    order = np.lexsort((-ys, xs))
    if np.all(np.diff(xs[order]) > 0) and np.all(np.diff(ys[order]) > 0):
        # the pairs already form one chain, which every weight (all above
        # zero) makes the heaviest
        return xs[order], ys[order]
    _, chain = records.heaviest_chain(xs, ys, weights)
    return xs[chain], ys[chain]
