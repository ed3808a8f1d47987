"""Anti-diagonal band construction.

Re-expresses the reference's Band/BandIterator (impl/pairwiseAligner.c:
89-277) as dense per-diagonal tensors: for each anti-diagonal xay = x+y in
[0, lX+lY], the band is the xmy = x-y interval [offset, offset + 2*(width-1)].
The parity invariant (xay+xmy) % 2 == 0 holds for every cell; a diagonal's
cells map to slots j with xmy = offset + 2*j.

The host computes (offsets, widths) once per pair (vectorized numpy over
anchor segments — no per-diagonal Python loop); device kernels consume the
tensors. Semantics match the C band math exactly (validated against the
reference's hand-computed band walk, tests/pairwiseAlignerTest.c:69-132).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BandTensors:
    """Per-diagonal band description for one pair.

    offsets[k] = min xmy of diagonal k (xmyL), widths[k] = cell count.
    len(offsets) == lX + lY + 1.
    """

    offsets: np.ndarray  # int32 (L+1,)
    widths: np.ndarray  # int32 (L+1,)
    lx: int
    ly: int

    @property
    def diagonal_number(self) -> int:
        return self.lx + self.ly

    @property
    def max_width(self) -> int:
        return int(self.widths.max()) if len(self.widths) else 0

    def frame_width(self) -> int:
        """Slot-window width of the engine's x-frame: max over diagonals of
        (right x edge) - cummax(left x edge) + 1. Equals max_width except
        where the band's left edge locally retreats (anchor boundaries)."""
        ks = np.arange(len(self.offsets), dtype=np.int64)
        xlo = (ks + self.offsets) // 2
        xhi = xlo + self.widths - 1
        xoff = np.maximum.accumulate(xlo)
        return int((xhi - xoff + 1).max()) if len(ks) else 0

    def max_xmy(self) -> np.ndarray:
        return self.offsets + 2 * (self.widths - 1)


def _set_diagonals(xay: np.ndarray, xL, yL, xU, yU):
    """Vectorized band_setCurrentDiagonal (reference impl/pairwiseAligner.c:
    104-122): intersect diagonal xay with the anchor rectangle, fixing
    parity and clipping both ends. The rectangle coordinates may be scalars
    or per-diagonal arrays."""
    xmyL = np.broadcast_to(np.asarray(xL - yL, dtype=xay.dtype),
                           xay.shape).copy()
    xmyR = np.broadcast_to(np.asarray(xU - yU, dtype=xay.dtype),
                           xay.shape).copy()
    # band_avoidOffByOne (:94-96)
    xmyL = np.where((xay + xmyL) % 2 != 0, xmyL + 1, xmyL)
    xmyR = np.where((xay + xmyR) % 2 != 0, xmyR + 1, xmyR)
    # Clip left end: X(xay, xmyL) >= xL and Y(xay, xmyL) <= yL (:116-117)
    x = (xay + xmyL) // 2
    xmyL = np.where(x < xL, xmyL + 2 * (xL - x), xmyL)
    y = (xay - xmyL) // 2
    xmyL = np.where(yL < y, xmyL + 2 * (y - yL), xmyL)
    # Clip right end: X(xay, xmyR) <= xU and Y(xay, xmyR) >= yU (:118-119)
    x = (xay + xmyR) // 2
    xmyR = np.where(xU < x, xmyR - 2 * (x - xU), xmyR)
    y = (xay - xmyR) // 2
    xmyR = np.where(y < yU, xmyR - 2 * (yU - y), xmyR)
    return xmyL, xmyR


def _bound(z: int, l: int) -> int:
    return 0 if z < 0 else (l if z > l else z)


def construct_band(anchor_pairs, lx: int, ly: int, expansion: int | None = None) -> BandTensors:
    """Build band tensors from anchor pairs.

    anchor_pairs: sequence of (x, y) sequence coordinates (static expansion,
    reference band_construct :183-234) or (x, y, expansion) triples when
    `expansion` is None (dynamic, band_constructDynamic :128-181). Anchors
    must be strictly monotone in both coordinates.
    """
    assert lx >= 0 and ly >= 0
    dynamic = expansion is None
    if not dynamic:
        assert expansion % 2 == 0

    n_diag = lx + ly

    if not isinstance(anchor_pairs, np.ndarray):
        anchor_pairs = list(anchor_pairs)
    anchors = np.asarray(anchor_pairs, dtype=np.int64)
    if anchors.size == 0:
        anchors = anchors.reshape(0, 3 if dynamic else 2)
    n_anch = len(anchors)
    # matrix coordinates are +1 the sequence ones; append the (lx, ly)
    # terminal pseudo-anchor closing the last segment
    ax = np.concatenate([anchors[:, 0] + 1, [lx]])
    ay = np.concatenate([anchors[:, 1] + 1, [ly]])
    if dynamic:
        exps = anchors[:, 2] if n_anch else np.empty(0, np.int64)
        assert np.all(exps >= 0) and np.all(exps % 2 == 0)
        # past the last anchor the expansion stays at its last value
        exps = np.concatenate([exps, [exps[-1] if n_anch else 0]])
    else:
        exps = np.full(n_anch + 1, expansion, dtype=np.int64)
    if n_anch:
        assert np.all(ax[:-1] > 0) and np.all(ax[:-1] <= lx)
        assert np.all(ay[:-1] > 0) and np.all(ay[:-1] <= ly)

    # Per-segment anchor rectangles (reference :226-229): segment i spans
    # diagonals (nxay_{i-1}, nxay_i] between consecutive anchors (0,0)
    # prepended. Expansion is even and (xay+xmy) parity holds, so the
    # divisions are exact.
    nxay = ax + ay
    nxmy = ax - ay
    pxay = np.concatenate([[0], nxay[:-1]])
    pxmy = np.concatenate([[0], nxmy[:-1]])
    bnd = lambda z, l: np.clip(z, 0, l)
    xLs = bnd((pxay + pxmy - exps) // 2, lx)
    yLs = bnd((nxay - nxmy + exps) // 2, ly)
    xUs = bnd((nxay + nxmy + exps) // 2, lx)
    yUs = bnd((pxay - pxmy - exps) // 2, ly)

    # map each diagonal to its segment: k = 0 uses the degenerate (0,0,0,0)
    # start rectangle, k in (nxay_{i-1}, nxay_i] uses segment i
    bs = np.concatenate([[0], nxay])
    rect_xL = np.concatenate([[0], xLs])
    rect_yL = np.concatenate([[0], yLs])
    rect_xU = np.concatenate([[0], xUs])
    rect_yU = np.concatenate([[0], yUs])
    ks = np.arange(n_diag + 1, dtype=np.int64)
    seg = np.searchsorted(bs, ks, side="left")

    xmyL, xmyR = _set_diagonals(
        ks, rect_xL[seg], rect_yL[seg], rect_xU[seg], rect_yU[seg])
    offsets = xmyL
    widths = (xmyR - xmyL) // 2 + 1

    return BandTensors(
        offsets=offsets.astype(np.int32), widths=widths.astype(np.int32), lx=lx, ly=ly
    )


def full_band(lx: int, ly: int) -> BandTensors:
    """Band covering the entire lx x ly matrix (no anchors)."""
    ks = np.arange(lx + ly + 1, dtype=np.int64)
    # Diagonal k spans x in [max(0, k-ly), min(k, lx)], xmy = 2x - k.
    x_min = np.maximum(0, ks - ly)
    x_max = np.minimum(ks, lx)
    offsets = 2 * x_min - ks
    widths = x_max - x_min + 1
    return BandTensors(offsets=offsets.astype(np.int32), widths=widths.astype(np.int32), lx=lx, ly=ly)


def pad_band(band: BandTensors, n_diag_padded: int, width_padded: int | None = None):
    """Pad band tensors to a static bucket size for batched device use.

    Padding diagonals repeat the final diagonal with width clamped to 1 so
    padded scan steps are cheap no-ops; outputs there are masked by
    valid_length.
    Returns (offsets[int32 P+1], widths[int32 P+1], valid_length).
    """
    L = band.diagonal_number
    assert n_diag_padded >= L
    offsets = np.empty(n_diag_padded + 1, dtype=np.int32)
    widths = np.empty(n_diag_padded + 1, dtype=np.int32)
    offsets[: L + 1] = band.offsets
    widths[: L + 1] = band.widths
    if n_diag_padded > L:
        # keep parity consistent with diagonal index so slot math stays exact
        ks = np.arange(L + 1, n_diag_padded + 1, dtype=np.int32)
        last = int(band.offsets[L])
        offsets[L + 1 :] = last + ((ks - L) % 2)
        widths[L + 1 :] = 1
    if width_padded is not None and band.frame_width() > width_padded:
        raise ValueError(
            f"band frame width {band.frame_width()} exceeds padded width {width_padded}")
    return offsets, widths, L
