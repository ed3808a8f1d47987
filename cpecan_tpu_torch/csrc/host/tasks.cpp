// The anchors of many alignments in one call.
//
// Native fast path for the expectation tasks' anchors of a job
// (align/batch.py:alignment_anchors): per alignment, the match-run
// positions of its cigar ops trimmed by `trim` at each end of a run
// (io/cigar.py:alignment_to_anchor_pairs, the reference's
// convertPairwiseForwardStrandAlignmentToAnchorPairs,
// impl/pairwiseAligner.c:979-1003), kept where the two upper-cased bases
// are equal and not N (align/batch.py:filter_anchors_to_matches, the
// reference's matchFn, cPecanRealign.c:277-281). Without this library
// align/batch.py builds the same anchors record by record. One walk of
// the ops, O(ops + matched bases), no allocation.

#include <cstdint>

// Alignment i owns ops [op_starts[i], op_starts[i+1]) of `codes` ('M',
// 'D' consumes x only, 'I' consumes y only; any other code consumes both
// and anchors nothing, as the Python path treats it) and `lens`, and
// bases [x_starts[i], x_starts[i+1]) of `sx`, [y_starts[i], y_starts[i+1])
// of `sy` (upper-cased). Writes its kept anchors as (x, y, expansion)
// int64 rows in its own coordinates, the alignments' one after another,
// their number to counts[i], and to max_gaps[i] the largest area of the
// gaps between its kept anchors, before the first and after the last
// (lx * ly without anchors): the areas align/split.py:get_split_points
// compares with the split limit. `anchors` holds at least
// sum_i min(lx_i, ly_i) rows. Returns 0, or 1 + the first alignment whose
// ops do not end at (lx, ly), run past it or have a negative length; the
// outputs from that alignment on are unset.
extern "C" int64_t cpecan_alignment_anchors(
    int64_t n_alignments, const int64_t* op_starts, const uint8_t* codes,
    const int64_t* lens, const uint8_t* sx, const int64_t* x_starts,
    const uint8_t* sy, const int64_t* y_starts, int64_t trim,
    int64_t expansion, int64_t* anchors, int64_t* counts,
    int64_t* max_gaps) {
    int64_t* out = anchors;
    for (int64_t i = 0; i < n_alignments; i++) {
        const int64_t lx = x_starts[i + 1] - x_starts[i];
        const int64_t ly = y_starts[i + 1] - y_starts[i];
        const uint8_t* bx = sx + x_starts[i];
        const uint8_t* by = sy + y_starts[i];
        const int64_t* first = out;
        int64_t x = 0, y = 0, px = -1, py = -1, gap = 0;
        for (int64_t k = op_starts[i]; k < op_starts[i + 1]; k++) {
            const int64_t n = lens[k];
            const uint8_t c = codes[k];
            const int64_t nx = c != 'I' ? x + n : x;
            const int64_t ny = c != 'D' ? y + n : y;
            if (n < 0 || nx > lx || ny > ly) return i + 1;
            if (c == 'M') {
                for (int64_t j = trim; j < n - trim; j++) {
                    const uint8_t b = bx[x + j];
                    if (b == by[y + j] && b != 'N') {
                        const int64_t area =
                            (x + j - px - 1) * (y + j - py - 1);
                        if (out == first || area > gap) gap = area;
                        px = out[0] = x + j;
                        py = out[1] = y + j;
                        out[2] = expansion;
                        out += 3;
                    }
                }
            }
            x = nx;
            y = ny;
        }
        if (x != lx || y != ly) return i + 1;
        const int64_t last = (lx - px - 1) * (ly - py - 1);
        counts[i] = (out - first) / 3;
        max_gaps[i] = (out == first || last > gap) ? last : gap;
    }
    return 0;
}
