// Anti-diagonal bands of many pairs in one call.
//
// Native fast path for ops/band.py:construct_band plus
// BandTensors.frame_width — identical semantics (the reference's
// band_construct / band_constructDynamic segment rectangles and
// band_setCurrentDiagonal's parity fix-up and clipping,
// impl/pairwiseAligner.c:89-234), so the numpy functions are the oracle.
// Each pair's diagonals are walked once, segment by segment: O(diagonals
// + anchors) a pair, with no per-pair allocation.

#include <algorithm>
#include <cstdint>

namespace {

// floor(z / 2): g++ shifts signed integers arithmetically
inline int64_t floor_div2(int64_t z) { return z >> 1; }

inline int64_t clip(int64_t z, int64_t l) { return z < 0 ? 0 : (z > l ? l : z); }

}  // namespace

// anchors: rows of `ncols` int64 (x, y[, expansion]), the pairs' anchors
// concatenated; pair i owns rows [anchor_starts[i], anchor_starts[i+1]).
// Static: every segment expands by `expansion`. Dynamic: each anchor's
// segment by its column 2 (past the last anchor the last one's, 0 without
// anchors). Pair i's lx[i] + ly[i] + 1 diagonals go to
// offsets/widths at band_starts[i]; frame_widths[i] is its frame width.
// Returns 0, or 1 + the first pair whose anchors construct_band would
// reject (out of the matrix, an odd or negative expansion) or whose
// anchor diagonals decrease; that pair's outputs are unset.
extern "C" int64_t cpecan_build_bands(
    int64_t n_pairs, const int64_t* anchors, int64_t ncols,
    const int64_t* anchor_starts, const int64_t* lx_in, const int64_t* ly_in,
    int64_t dynamic, int64_t expansion, const int64_t* band_starts,
    int32_t* offsets, int32_t* widths, int64_t* frame_widths) {
    for (int64_t i = 0; i < n_pairs; i++) {
        const int64_t lx = lx_in[i], ly = ly_in[i];
        const int64_t a0 = anchor_starts[i], n = anchor_starts[i + 1] - a0;
        const int64_t* a = anchors + a0 * ncols;
        if (lx < 0 || ly < 0 || (!dynamic && expansion % 2 != 0)) return i + 1;
        int32_t* off = offsets + band_starts[i];
        int32_t* wid = widths + band_starts[i];

        int64_t xoff = INT64_MIN, frame = 0;
        auto set_diagonals = [&](int64_t k_lo, int64_t k_hi, int64_t xL,
                                 int64_t yL, int64_t xU, int64_t yU) {
            for (int64_t k = k_lo; k <= k_hi; k++) {
                int64_t xmyL = xL - yL, xmyR = xU - yU;
                xmyL += (k + xmyL) & 1;
                xmyR += (k + xmyR) & 1;
                int64_t x = floor_div2(k + xmyL);
                if (x < xL) xmyL += 2 * (xL - x);
                int64_t y = floor_div2(k - xmyL);
                if (yL < y) xmyL += 2 * (y - yL);
                x = floor_div2(k + xmyR);
                if (xU < x) xmyR -= 2 * (x - xU);
                y = floor_div2(k - xmyR);
                if (y < yU) xmyR -= 2 * (yU - y);
                const int64_t w = floor_div2(xmyR - xmyL) + 1;
                off[k] = (int32_t)xmyL;
                wid[k] = (int32_t)w;
                const int64_t xlo = floor_div2(k + xmyL);
                xoff = std::max(xoff, xlo);
                frame = std::max(frame, xlo + w - xoff);
            }
        };

        // diagonal 0: the degenerate (0, 0, 0, 0) start rectangle; segment
        // j (anchor j, or the (lx, ly) corner for j == n) takes diagonals
        // (previous anchor's x + y, its x + y] in matrix coordinates
        set_diagonals(0, 0, 0, 0, 0, 0);
        int64_t pxay = 0, pxmy = 0, done = 0, e = dynamic ? 0 : expansion;
        for (int64_t j = 0; j <= n; j++) {
            int64_t ax = lx, ay = ly;
            if (j < n) {
                ax = a[j * ncols] + 1;
                ay = a[j * ncols + 1] + 1;
                if (ax <= 0 || ax > lx || ay <= 0 || ay > ly) return i + 1;
                if (dynamic) {
                    e = a[j * ncols + 2];
                    if (e < 0 || e % 2 != 0) return i + 1;
                }
            }
            const int64_t nxay = ax + ay, nxmy = ax - ay;
            if (nxay < pxay) return i + 1;
            const int64_t xL = clip(floor_div2(pxay + pxmy - e), lx);
            const int64_t yL = clip(floor_div2(nxay - nxmy + e), ly);
            const int64_t xU = clip(floor_div2(nxay + nxmy + e), lx);
            const int64_t yU = clip(floor_div2(pxay - pxmy - e), ly);
            if (nxay > done) {
                set_diagonals(done + 1, nxay, xL, yL, xU, yU);
                done = nxay;
            }
            pxay = nxay;
            pxmy = nxmy;
        }
        frame_widths[i] = frame;
    }
    return 0;
}
