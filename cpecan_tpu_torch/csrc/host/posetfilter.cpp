// Native pairwise poset-consistency filter: the default decode path of
// realign/align (reference filterPairwiseAlignmentToMakePairsOrdered,
// impl/multipleAligner.c:945-971, via the two-sequence progressive MSA
// pairwiseAlignColumns :304-492).
//
// For two sequences the progressive MSA reduces to a sparse
// Pareto-frontier DP choosing the maximum-weight strictly-monotone chain
// of posterior pairs (weight = posterior + tie-breaking jitter, thresholded
// at matchGamma); kept pairs are exactly those whose column pair lands on
// the chain. This mirrors cpecan_tpu/msa/aligner.py bit-for-bit, including
// the CPython-Mersenne-Twister jitter sequence of WeightGraph.add_pair
// (msa/aligner.py:82, random.Random(0)), so the native and Python decoders
// return identical pair sets. The Python path doubles as the test oracle
// (tests/test_native_posetfilter.py).
//
// Build: part of libcpecan_anchors.so (see native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// --- CPython-compatible MT19937 (random.Random(seed).random()) ---------
class PyRandom {
 public:
  explicit PyRandom(uint32_t seed) {
    uint32_t key[1] = {seed};
    init_by_array(key, 1);
  }
  double random() {
    uint32_t a = genrand() >> 5, b = genrand() >> 6;
    return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0);
  }

 private:
  static const int N = 624, M = 397;
  uint32_t mt_[N];
  int mti_ = N + 1;

  void init_genrand(uint32_t s) {
    mt_[0] = s;
    for (mti_ = 1; mti_ < N; mti_++)
      mt_[mti_] = 1812433253u * (mt_[mti_ - 1] ^ (mt_[mti_ - 1] >> 30)) + mti_;
  }
  void init_by_array(const uint32_t* key, int key_length) {
    init_genrand(19650218u);
    int i = 1, j = 0;
    int k = N > key_length ? N : key_length;
    for (; k; k--) {
      mt_[i] = (mt_[i] ^ ((mt_[i - 1] ^ (mt_[i - 1] >> 30)) * 1664525u)) +
               key[j] + j;
      i++; j++;
      if (i >= N) { mt_[0] = mt_[N - 1]; i = 1; }
      if (j >= key_length) j = 0;
    }
    for (k = N - 1; k; k--) {
      mt_[i] = (mt_[i] ^ ((mt_[i - 1] ^ (mt_[i - 1] >> 30)) * 1566083941u)) - i;
      i++;
      if (i >= N) { mt_[0] = mt_[N - 1]; i = 1; }
    }
    mt_[0] = 0x80000000u;
  }
  uint32_t genrand() {
    const uint32_t UPPER = 0x80000000u, LOWER = 0x7fffffffu;
    static const uint32_t mag01[2] = {0u, 0x9908b0dfu};
    uint32_t y;
    if (mti_ >= N) {
      int kk;
      for (kk = 0; kk < N - M; kk++) {
        y = (mt_[kk] & UPPER) | (mt_[kk + 1] & LOWER);
        mt_[kk] = mt_[kk + M] ^ (y >> 1) ^ mag01[y & 1];
      }
      for (; kk < N - 1; kk++) {
        y = (mt_[kk] & UPPER) | (mt_[kk + (M - N)] & LOWER);
        mt_[kk] = mt_[kk + (M - N)] ^ (y >> 1) ^ mag01[y & 1];
      }
      y = (mt_[N - 1] & UPPER) | (mt_[0] & LOWER);
      mt_[N - 1] = mt_[M - 1] ^ (y >> 1) ^ mag01[y & 1];
      mti_ = 0;
    }
    y = mt_[mti_++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= (y >> 18);
    return y;
  }
};

struct Edge {
  int64_t x, y;
  double avg;
  double n;
};

}  // namespace

extern "C" {

// probs/xs/ys: n posterior pairs (prob fixed-point 1e7). keep (out, n
// bytes) marks pairs on the chosen consistent chain. Returns kept count.
int64_t cpecan_filter_pairs_ordered(const int64_t* probs, const int64_t* xs,
                                    const int64_t* ys, int64_t n,
                                    double match_gamma, uint8_t* keep) {
  std::memset(keep, 0, n);
  if (n == 0) return 0;

  // weights with jitter, duplicates combined in input order
  // (WeightGraph.add_pair, msa/aligner.py:78-95)
  PyRandom rng(0);
  std::vector<Edge> edges;
  edges.reserve(n);
  std::unordered_map<int64_t, int64_t> by_xy;  // (x<<32|y) -> edge index
  std::vector<int64_t> pair_edge(n);
  for (int64_t i = 0; i < n; i++) {
    double avg = probs[i] / 1e7 + rng.random() * 0.00001;
    int64_t k = (xs[i] << 32) | (uint32_t)ys[i];
    auto it = by_xy.find(k);
    if (it != by_xy.end()) {
      Edge& e = edges[it->second];
      e.avg = (e.avg * e.n + avg) / (e.n + 1.0);
      e.n += 1.0;
      pair_edge[i] = it->second;
    } else {
      pair_edge[i] = edges.size();
      by_xy.emplace(k, (int64_t)edges.size());
      edges.push_back({xs[i], ys[i], avg, 1.0});
    }
  }

  // group edges per x (in first-seen order, matching dict insertion order)
  std::unordered_map<int64_t, std::vector<int64_t>> per_x;
  std::vector<int64_t> x_order;
  for (int64_t ei = 0; ei < (int64_t)edges.size(); ei++) {
    auto& v = per_x[edges[ei].x];
    if (v.empty()) x_order.push_back(edges[ei].x);
    v.push_back(ei);
  }
  std::sort(x_order.begin(), x_order.end());

  // sparse Pareto-frontier DP (pairwiseAlignColumns :358-441)
  struct Node {
    int64_t yi;
    double score;
    int64_t prev;  // node index
    int64_t edge;  // edge index or -1
  };
  std::vector<Node> nodes;
  nodes.push_back({-1, 0.0, -1, -1});  // min sentinel (index 0)
  std::vector<int64_t> frontier_y = {-1};  // parallel arrays, ascending y
  std::vector<int64_t> frontier_n = {0};

  std::vector<std::pair<int64_t, int64_t>> cands;  // (yi, edge)
  for (int64_t x : x_order) {
    cands.clear();
    for (int64_t ei : per_x[x]) {
      const Edge& e = edges[ei];
      if (e.avg >= match_gamma && e.avg > 0.0) cands.emplace_back(e.y, ei);
    }
    if (cands.empty()) continue;
    std::sort(cands.begin(), cands.end());
    // snapshot predecessor for each candidate before any insertion? No —
    // the Python code computes prev per candidate first (all against the
    // pre-insertion frontier), then inserts right-to-left.
    std::vector<Node> staged;
    staged.reserve(cands.size());
    for (auto& [yi, ei] : cands) {
      // best frontier point strictly left of yi
      int64_t k = (int64_t)(std::lower_bound(frontier_y.begin(),
                                             frontier_y.end(), yi) -
                            frontier_y.begin()) - 1;
      const Node& prev = nodes[frontier_n[k]];
      staged.push_back({yi, prev.score + edges[ei].avg * edges[ei].n,
                        frontier_n[k], ei});
    }
    for (int64_t ci = (int64_t)staged.size() - 1; ci >= 0; ci--) {
      Node nd = staged[ci];
      int64_t k = (int64_t)(std::lower_bound(frontier_y.begin(),
                                             frontier_y.end(), nd.yi) -
                            frontier_y.begin());
      bool right_is_greater = k < (int64_t)frontier_y.size()
                                  ? frontier_y[k] > nd.yi
                                  : false;
      bool dominates = k < (int64_t)frontier_y.size()
                           ? nd.score >= nodes[frontier_n[k]].score
                           : true;
      if (dominates || right_is_greater) {
        while (k < (int64_t)frontier_y.size() &&
               nd.score >= nodes[frontier_n[k]].score) {
          frontier_y.erase(frontier_y.begin() + k);
          frontier_n.erase(frontier_n.begin() + k);
        }
        int64_t idx = nodes.size();
        nodes.push_back(nd);
        frontier_y.insert(frontier_y.begin() + k, nd.yi);
        frontier_n.insert(frontier_n.begin() + k, idx);
      }
    }
  }

  // traceback from the rightmost frontier point; mark chain edges
  std::vector<uint8_t> edge_kept(edges.size(), 0);
  int64_t node_i = frontier_n.back();
  while (node_i > 0) {
    const Node& nd = nodes[node_i];
    if (nd.edge >= 0) edge_kept[nd.edge] = 1;
    node_i = nd.prev;
  }
  int64_t kept = 0;
  for (int64_t i = 0; i < n; i++) {
    if (edge_kept[pair_edge[i]]) {
      keep[i] = 1;
      kept++;
    }
  }
  return kept;
}

}  // extern "C"
