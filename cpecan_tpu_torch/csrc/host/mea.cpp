// Maximal-expected-accuracy decode over a sparse posterior pair list.
//
// Native fast path for cpecan_tpu/ops/mea.py:mea_alignment — identical
// semantics (the Schwartz & Pachter MEA recurrence of the reference,
// impl/pairwiseAligner.c:1628-1724, with the cumulative-gap-prob arrays
// :1603-1626 and the isHighScore back-scan prune :1683-1688). Inputs are
// pairs in a topological order of the (x<x', y<y') partial order; the
// Python wrapper keeps the same float64 op order so results match the
// numpy fallback bit for bit.

#include <cstdint>
#include <vector>

namespace {

inline int64_t indel_prob(const int64_t* cum, int64_t start, int64_t length) {
    if (length <= 0) return 0;
    return cum[start + length - 1] - (start > 0 ? cum[start - 1] : 0);
}

}  // namespace

extern "C" int64_t cpecan_mea(
    const int64_t* probs, const int64_t* xs, const int64_t* ys, int64_t n,
    const int64_t* cum_gap_x, int64_t lx,
    const int64_t* cum_gap_y, int64_t ly,
    double gap_gamma,
    int64_t* chosen_out, double* score_out) {
    std::vector<double> scores(n + 1, 0.0);
    std::vector<int64_t> back(n + 1, -1);
    std::vector<unsigned char> is_high(n + 1, 0);
    double max_score = 0.0;

    for (int64_t i = 0; i <= n; i++) {
        int64_t match_prob, x, y;
        if (i == n) {
            match_prob = 0; x = lx; y = ly;
        } else {
            match_prob = probs[i]; x = xs[i]; y = ys[i];
        }

        double score = (double)match_prob +
            (double)(indel_prob(cum_gap_x, 0, x) +
                     indel_prob(cum_gap_y, 0, y)) * gap_gamma;
        int64_t bp = -1;
        for (int64_t j = i - 1; j >= 0; j--) {
            int64_t x2 = xs[j], y2 = ys[j];
            if (x2 < x && y2 < y) {
                double s = (double)match_prob + scores[j] +
                    (double)(indel_prob(cum_gap_x, x2 + 1, x - x2 - 1) +
                             indel_prob(cum_gap_y, y2 + 1, y - y2 - 1)) *
                        gap_gamma;
                if (s > score) { score = s; bp = j; }
                if (is_high[j]) break;
            }
        }
        back[i] = bp;
        scores[i] = score;

        double s = score +
            (double)((x < lx ? indel_prob(cum_gap_x, x + 1, lx - x - 1) : 0) +
                     (y < ly ? indel_prob(cum_gap_y, y + 1, ly - y - 1) : 0)) *
                gap_gamma;
        if (s >= max_score) { max_score = s; is_high[i] = 1; }
    }

    // traceback (emit in increasing index order)
    int64_t count = 0;
    for (int64_t i = back[n]; i >= 0; i = back[i]) chosen_out[count++] = i;
    for (int64_t a = 0, b = count - 1; a < b; a++, b--) {
        int64_t t = chosen_out[a];
        chosen_out[a] = chosen_out[b];
        chosen_out[b] = t;
    }
    *score_out = max_score;
    return count;
}
