// Native seed-and-chain anchor generator: the framework's lastz-analog.
//
// The reference anchors large alignment problems with a vendored ~64k LoC
// lastz binary invoked over a pipe (impl/pairwiseAligner.c:1032-1061).
// This library implements the same role natively — exact k-mer seeding,
// diagonal-run merging and highest-weight monotone chaining — behind a C
// ABI consumed through ctypes (cpecan_tpu/align/native.py). The Python
// numpy implementation in cpecan_tpu/align/anchors.py has identical
// semantics and serves as fallback and test oracle.
//
// Pipeline (mirrors anchors.py:find_seeds/merge_seeds_to_runs/chain_runs):
//  1. 2-bit rolling k-mer codes; windows containing N (or lowercase when
//     respect_mask, lastz's soft-mask behavior) are invalid.
//  2. Hash join of X and Y k-mer positions; codes occurring more than
//     max_occ times on either side are dropped (repeat suppression).
//  3. Seeds on the same diagonal within k bases merge into maximal runs.
//  4. Sparse LIS-style DP over runs (Fenwick tree over y-end ranks),
//     weight = matched bases; returns the best strictly-monotone chain.
//
// Build: g++ -O3 -shared -fPIC -o libcpecan_anchors.so anchors.cpp

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Run {
  int64_t x, y, len;
};

// 2-bit codes per position; -1 marks invalid windows.
static std::vector<int64_t> kmer_codes(const char* seq, int64_t n, int k,
                                       bool respect_mask) {
  std::vector<int64_t> out;
  if (n < k) return out;
  out.assign(n - k + 1, -1);
  const int64_t mask = (k == 32) ? -1 : ((int64_t(1) << (2 * k)) - 1);
  int64_t code = 0;
  int valid_len = 0;  // consecutive valid bases ending at i
  for (int64_t i = 0; i < n; i++) {
    unsigned char c = seq[i];
    bool lower = c >= 'a';
    unsigned char u = c & 0xDF;
    int b;
    switch (u) {
      case 'A': b = 0; break;
      case 'C': b = 1; break;
      case 'G': b = 2; break;
      case 'T': b = 3; break;
      default: b = -1;
    }
    if (b < 0 || (respect_mask && lower)) {
      valid_len = 0;
      code = 0;
      continue;
    }
    code = ((code << 2) | b) & mask;
    valid_len++;
    if (valid_len >= k) out[i - k + 1] = code;
  }
  return out;
}

class FenwickMax {
 public:
  explicit FenwickMax(int64_t n)
      : n_(n), score_(n + 1, 0), idx_(n + 1, -1) {}
  void update(int64_t i, int64_t score, int64_t idx) {
    for (i++; i <= n_; i += i & (-i)) {
      if (score > score_[i]) {
        score_[i] = score;
        idx_[i] = idx;
      }
    }
  }
  // max over ranks [0, i]
  void query(int64_t i, int64_t* best, int64_t* bidx) const {
    *best = 0;
    *bidx = -1;
    for (i++; i > 0; i -= i & (-i)) {
      if (score_[i] > *best) {
        *best = score_[i];
        *bidx = idx_[i];
      }
    }
  }

 private:
  int64_t n_;
  std::vector<int64_t> score_;
  std::vector<int64_t> idx_;
};

}  // namespace

extern "C" {

// Seed, merge and chain. Returns the number of chained runs; *out_runs is a
// malloc'd array of 3*n int64 (x, y, len) triples the caller frees with
// cpecan_anchors_free. Returns -1 on allocation failure.
int64_t cpecan_anchor_chain(const char* seq_x, int64_t lx, const char* seq_y,
                            int64_t ly, int32_t k, int32_t max_occ,
                            int32_t respect_mask, int64_t** out_runs) {
  *out_runs = nullptr;
  std::vector<int64_t> kx = kmer_codes(seq_x, lx, k, respect_mask);
  std::vector<int64_t> ky = kmer_codes(seq_y, ly, k, respect_mask);
  if (kx.empty() || ky.empty()) return 0;

  // positions per code in Y (cap at max_occ + 1 so over-limit codes are
  // recognizable and dropped, matching the numpy implementation)
  std::unordered_map<int64_t, std::vector<int32_t>> ypos;
  ypos.reserve(ky.size());
  for (int64_t i = 0; i < (int64_t)ky.size(); i++) {
    if (ky[i] < 0) continue;
    auto& v = ypos[ky[i]];
    if ((int64_t)v.size() <= max_occ) v.push_back((int32_t)i);
  }
  std::unordered_map<int64_t, int32_t> xcount;
  xcount.reserve(kx.size());
  for (int64_t i = 0; i < (int64_t)kx.size(); i++)
    if (kx[i] >= 0) xcount[kx[i]]++;

  // seeds (x, y), collected in x order then sorted by (diag, x)
  std::vector<std::pair<int64_t, int64_t>> seeds;
  for (int64_t i = 0; i < (int64_t)kx.size(); i++) {
    int64_t code = kx[i];
    if (code < 0) continue;
    auto it = ypos.find(code);
    if (it == ypos.end()) continue;
    if ((int64_t)it->second.size() > max_occ) continue;
    if (xcount[code] > max_occ) continue;
    for (int32_t y : it->second) seeds.emplace_back(i, y);
  }
  if (seeds.empty()) return 0;
  std::sort(seeds.begin(), seeds.end(),
            [](const std::pair<int64_t, int64_t>& a,
               const std::pair<int64_t, int64_t>& b) {
              int64_t da = a.first - a.second, db = b.first - b.second;
              if (da != db) return da < db;
              return a.first < b.first;
            });

  // merge same-diagonal seeds within k into maximal runs
  std::vector<Run> runs;
  for (auto& s : seeds) {
    int64_t d = s.first - s.second;
    if (!runs.empty()) {
      Run& r = runs.back();
      if (r.x - r.y == d && s.first <= r.x + r.len) {
        r.len = std::max(r.len, s.first + k - r.x);
        continue;
      }
    }
    runs.push_back({s.first, s.second, (int64_t)k});
  }

  // chain: sparse DP, strict monotonicity (whole predecessor run before
  // our start in both coordinates), weight = run length
  int64_t n = runs.size();
  std::vector<int64_t> x0(n), y0(n), x1(n), y1(n);
  for (int64_t i = 0; i < n; i++) {
    x0[i] = runs[i].x;
    y0[i] = runs[i].y;
    x1[i] = runs[i].x + runs[i].len;
    y1[i] = runs[i].y + runs[i].len;
  }
  std::vector<int64_t> yv(y1);
  std::sort(yv.begin(), yv.end());
  yv.erase(std::unique(yv.begin(), yv.end()), yv.end());
  auto yrank = [&](int64_t v) {
    return (int64_t)(std::lower_bound(yv.begin(), yv.end(), v) - yv.begin());
  };

  std::vector<int64_t> by_end(n), by_start(n);
  for (int64_t i = 0; i < n; i++) by_end[i] = by_start[i] = i;
  std::stable_sort(by_end.begin(), by_end.end(),
                   [&](int64_t a, int64_t b) { return x1[a] < x1[b]; });
  std::stable_sort(by_start.begin(), by_start.end(),
                   [&](int64_t a, int64_t b) { return x0[a] < x0[b]; });

  FenwickMax fen(yv.size());
  std::vector<int64_t> score(n, 0), back(n, -1);
  int64_t ins = 0;
  for (int64_t pi = 0; pi < n; pi++) {
    int64_t i = by_start[pi];
    while (ins < n && x1[by_end[ins]] <= x0[i]) {
      int64_t j = by_end[ins];
      fen.update(yrank(y1[j]), score[j], j);
      ins++;
    }
    // best predecessor with y-end <= our y-start
    int64_t r = (int64_t)(std::upper_bound(yv.begin(), yv.end(), y0[i]) -
                          yv.begin()) - 1;
    int64_t best = 0, bidx = -1;
    if (r >= 0) fen.query(r, &best, &bidx);
    score[i] = best + runs[i].len;
    back[i] = bidx;
  }

  int64_t best_i = 0;
  for (int64_t i = 1; i < n; i++)
    if (score[i] > score[best_i]) best_i = i;
  std::vector<int64_t> chain;
  for (int64_t i = best_i; i >= 0; i = back[i]) chain.push_back(i);
  std::reverse(chain.begin(), chain.end());

  int64_t m = chain.size();
  int64_t* out = (int64_t*)malloc(sizeof(int64_t) * 3 * m);
  if (!out) return -1;
  for (int64_t i = 0; i < m; i++) {
    out[3 * i] = runs[chain[i]].x;
    out[3 * i + 1] = runs[chain[i]].y;
    out[3 * i + 2] = runs[chain[i]].len;
  }
  *out_runs = out;
  return m;
}

void cpecan_anchors_free(int64_t* ptr) { free(ptr); }

}  // extern "C"
