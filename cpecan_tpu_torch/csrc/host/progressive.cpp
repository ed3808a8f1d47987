// Progressive multiple-alignment column merge, C++ fast path.
//
// Exact port of the Python progressive path in cpecan_tpu/msa/aligner.py
// (_make_graph edge aggregation, _pairwise_align_columns sparse
// Pareto-frontier DP, WeightGraph.merge_columns) — semantics of the
// reference pairwiseAlignColumns / mergeColumns / progressive driver
// (impl/multipleAligner.c:213-270, :304-556).  The host merge dominates
// MSA wall-clock once pair posteriors come off the TPU in milliseconds;
// this runs the whole per-round merge loop natively and returns the
// final union-find parent array.
//
// Parity notes (tests/test_native_progressive.py diffs partitions vs the
// Python implementation on random inputs):
//  * adjacency iteration follows Python dict insertion order (vector of
//    entries with tombstones + index map), so candidate order and the
//    stable sort by y-index match exactly;
//  * weight combining uses the identical double arithmetic in the
//    identical order;
//  * the caller supplies pre-jittered weights in add order, keeping the
//    tie-breaking RNG stream in Python.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

struct Weight {
    int64_t c1, c2;
    double avg;
    double n;
    bool alive;
};

struct Adj {
    // Python-dict-like: insertion-ordered entries with tombstones
    std::vector<std::pair<int64_t, int32_t>> items;  // (key, weight idx)
    std::unordered_map<int64_t, int32_t> pos;        // key -> items idx
    int64_t live = 0;

    int32_t get(int64_t key) const {
        auto it = pos.find(key);
        if (it == pos.end()) {
            return -1;
        }
        return items[it->second].second;
    }
    void put(int64_t key, int32_t widx) {
        auto it = pos.find(key);
        if (it != pos.end()) {
            if (items[it->second].second < 0) {
                live++;
            }
            items[it->second].second = widx;
            return;
        }
        pos.emplace(key, (int32_t)items.size());
        items.emplace_back(key, widx);
        live++;
    }
    void erase(int64_t key) {
        auto it = pos.find(key);
        if (it == pos.end()) {
            return;
        }
        if (items[it->second].second >= 0) {
            live--;
        }
        items[it->second].second = -1;  // tombstone keeps iteration order
        pos.erase(it);
    }
};

struct Engine {
    std::vector<int64_t> parent;
    std::vector<Weight> weights;
    std::unordered_map<int64_t, Adj> adj;

    int64_t find(int64_t x) {
        int64_t root = x;
        while (parent[root] != root) {
            root = parent[root];
        }
        while (parent[x] != root) {
            int64_t nxt = parent[x];
            parent[x] = root;
            x = nxt;
        }
        return root;
    }

    Adj* adj_of(int64_t c) {
        auto it = adj.find(c);
        return it == adj.end() ? nullptr : &it->second;
    }

    int64_t degree(int64_t c) {
        Adj* a = adj_of(find(c));
        return a ? a->live : 0;
    }

    void add_edge_weight(int64_t c1, int64_t c2, double w) {
        if (c1 == c2) {
            return;
        }
        Adj& a1 = adj[c1];
        int32_t existing = a1.get(c2);
        if (existing >= 0) {
            Weight& e = weights[existing];
            e.avg = (e.avg * e.n + w) / (e.n + 1.0);
            e.n += 1.0;
            return;
        }
        int32_t widx = (int32_t)weights.size();
        weights.push_back({c1, c2, w, 1.0, true});
        a1.put(c2, widx);
        adj[c2].put(c1, widx);
    }

    void remove_edge(Weight& w) {
        int64_t c1 = find(w.c1), c2 = find(w.c2);
        if (Adj* a = adj_of(c1)) {
            a->erase(c2);
        }
        if (Adj* a = adj_of(c2)) {
            a->erase(c1);
        }
        w.alive = false;
    }

    // WeightGraph.merge_columns (no DAG: the progressive path never
    // consults it; the union IS the only store side effect)
    int64_t merge_columns(int32_t widx) {
        Weight& w = weights[widx];
        int64_t c1 = find(w.c1), c2 = find(w.c2);
        int64_t d1 = degree(c1), d2 = degree(c2);
        if (d1 < d2) {
            std::swap(c1, c2);
        }
        remove_edge(w);
        parent[c2] = c1;  // union b into a
        Adj edges2 = std::move(adj[c2]);
        adj.erase(c2);
        for (auto& [other_c, w2idx] : edges2.items) {
            if (w2idx < 0) {
                continue;  // tombstone
            }
            Weight& w2 = weights[w2idx];
            int64_t other_root = find(other_c);
            if (other_root == c1) {
                w2.alive = false;
                continue;
            }
            if (Adj* ao = adj_of(other_root)) {
                ao->erase(c2);
            }
            w2.c1 = c1;
            w2.c2 = other_root;
            Adj& edges1 = adj[c1];
            int32_t existing = edges1.get(other_root);
            if (existing >= 0) {
                Weight& e = weights[existing];
                e.avg = (e.avg * e.n + w2.avg * w2.n) / (e.n + w2.n);
                e.n += w2.n;
                w2.alive = false;
            } else {
                edges1.put(other_root, w2idx);
                adj[other_root].put(c1, w2idx);
            }
        }
        return c1;
    }
};

struct Node {
    int64_t xi, yi;
    double score;
    int32_t prev;  // node pool index, -1 = none
    int32_t widx;  // weight pool index, -1 = none
};

// _pairwise_align_columns: returns the merged column sequence
std::vector<int64_t> pairwise_align_columns(Engine& g,
                                            std::vector<int64_t> x_cols,
                                            std::vector<int64_t> y_cols,
                                            double match_gamma) {
    auto total_weights = [&](const std::vector<int64_t>& cols) {
        int64_t t = 0;
        for (int64_t c : cols) {
            t += g.degree(c);
        }
        return t;
    };
    if (total_weights(x_cols) > total_weights(y_cols)) {
        std::swap(x_cols, y_cols);
    }

    std::unordered_map<int64_t, int64_t> y_index;
    for (size_t i = 0; i < y_cols.size(); i++) {
        y_index[g.find(y_cols[i])] = (int64_t)i;  // later index wins
    }

    std::vector<Node> pool;
    pool.push_back({-1, -1, 0.0, -1, -1});  // min_node = 0
    const int32_t MIN_NODE = 0;

    // frontier: ys ascending, scores ascending; entries are node indices
    std::vector<int64_t> frontier_y = {-1, (int64_t)y_cols.size()};
    pool.push_back({(int64_t)x_cols.size(), (int64_t)y_cols.size(),
                    std::numeric_limits<double>::infinity(), MIN_NODE, -1});
    std::vector<int32_t> frontier_n = {MIN_NODE, 1};

    struct Cand {
        int64_t xi, yi;
        double score;
        int32_t prev;
        int32_t widx;
    };
    for (size_t i = 0; i < x_cols.size(); i++) {
        int64_t cxr = g.find(x_cols[i]);
        Adj* edges = g.adj_of(cxr);
        if (!edges || edges->live == 0) {
            continue;
        }
        std::vector<Cand> candidates;
        for (auto& [other_c, widx] : edges->items) {
            if (widx < 0) {
                continue;
            }
            Weight& w = g.weights[widx];
            if (!w.alive) {
                continue;
            }
            if (w.avg >= match_gamma && w.avg > 0.0) {
                auto it = y_index.find(g.find(other_c));
                if (it == y_index.end()) {
                    continue;
                }
                int64_t yi = it->second;
                // best frontier point strictly left of yi
                size_t k = std::lower_bound(frontier_y.begin(),
                                            frontier_y.end(), yi)
                           - frontier_y.begin() - 1;
                int32_t prev = frontier_n[k];
                double score = pool[prev].score + w.avg * w.n;
                candidates.push_back({(int64_t)i, yi, score, prev, widx});
            }
        }
        std::stable_sort(candidates.begin(), candidates.end(),
                         [](const Cand& a, const Cand& b) {
                             return a.yi < b.yi;
                         });
        for (auto it = candidates.rbegin(); it != candidates.rend(); ++it) {
            const Cand& cand = *it;
            size_t k = std::lower_bound(frontier_y.begin(), frontier_y.end(),
                                        cand.yi)
                       - frontier_y.begin();
            if (cand.score >= pool[frontier_n[k]].score
                || frontier_y[k] > cand.yi) {
                while (cand.score >= pool[frontier_n[k]].score) {
                    frontier_y.erase(frontier_y.begin() + k);
                    frontier_n.erase(frontier_n.begin() + k);
                }
                pool.push_back({cand.xi, cand.yi, cand.score, cand.prev,
                                cand.widx});
                frontier_y.insert(frontier_y.begin() + k, cand.yi);
                frontier_n.insert(frontier_n.begin() + k,
                                  (int32_t)pool.size() - 1);
            }
        }
    }

    // link the max sentinel to the right-most real point
    int32_t last = frontier_n[frontier_n.size() - 2];
    pool.push_back({(int64_t)x_cols.size(), (int64_t)y_cols.size(),
                    std::numeric_limits<double>::infinity(), last, -1});
    int32_t node = (int32_t)pool.size() - 1;

    std::vector<int64_t> alignment;
    while (true) {
        int64_t xi = pool[node].xi, yi = pool[node].yi;
        int32_t prev = pool[node].prev;
        int64_t py = pool[prev].yi;
        while (yi - 1 > py) {
            yi--;
            alignment.push_back(y_cols[yi]);
        }
        int64_t px = pool[prev].xi;
        while (xi - 1 > px) {
            xi--;
            alignment.push_back(x_cols[xi]);
        }
        node = prev;
        if (node == MIN_NODE) {
            break;
        }
        int32_t widx = pool[node].widx;
        Weight& w = g.weights[widx];
        int64_t merged;
        if (w.alive) {
            merged = g.merge_columns(widx);
        } else {
            int64_t a = g.find(w.c1), b = g.find(w.c2);
            if (a == b) {
                merged = a;
            } else {
                Adj* aa = g.adj_of(a);
                int32_t surviving = aa ? aa->get(b) : -1;
                if (surviving < 0) {
                    surviving = (int32_t)g.weights.size();
                    g.weights.push_back({a, b, 0.0, 0.0, true});
                    g.adj[a].put(b, surviving);
                    g.adj[b].put(a, surviving);
                }
                merged = g.merge_columns(surviving);
            }
        }
        alignment.push_back(merged);
    }
    std::reverse(alignment.begin(), alignment.end());
    return alignment;
}

}  // namespace

extern "C" int64_t cpecan_progressive_msa(
    int64_t n_seqs, const int64_t* seq_lengths, int64_t n_edges,
    const int64_t* ea, const int64_t* eb, const double* ew, int64_t n_order,
    const int64_t* order_x, const int64_t* order_y, double match_gamma,
    int64_t* parent_out) {
    Engine g;
    int64_t total = 0;
    std::vector<int64_t> offsets((size_t)n_seqs);
    for (int64_t s = 0; s < n_seqs; s++) {
        offsets[(size_t)s] = total;
        total += seq_lengths[s];
    }
    g.parent.resize((size_t)total);
    for (int64_t i = 0; i < total; i++) {
        g.parent[(size_t)i] = i;
    }
    for (int64_t e = 0; e < n_edges; e++) {
        // positions are singleton columns during graph build (the Python
        // path also aggregates before any merge), so find() is identity
        g.add_edge_weight(ea[e], eb[e], ew[e]);
    }

    // column sequences per group
    std::vector<std::vector<int64_t>> col_seqs((size_t)n_seqs);
    for (int64_t s = 0; s < n_seqs; s++) {
        col_seqs[(size_t)s].resize((size_t)seq_lengths[s]);
        for (int64_t p = 0; p < seq_lengths[s]; p++) {
            col_seqs[(size_t)s][(size_t)p] = offsets[(size_t)s] + p;
        }
    }
    std::vector<int64_t> group((size_t)n_seqs);
    for (int64_t s = 0; s < n_seqs; s++) {
        group[(size_t)s] = s;
    }

    for (int64_t o = 0; o < n_order; o++) {
        int64_t gx = group[(size_t)order_x[o]];
        int64_t gy = group[(size_t)order_y[o]];
        if (gx == gy) {
            continue;
        }
        col_seqs.push_back(pairwise_align_columns(
            g, col_seqs[(size_t)gx], col_seqs[(size_t)gy], match_gamma));
        int64_t new_g = (int64_t)col_seqs.size() - 1;
        for (size_t s = 0; s < group.size(); s++) {
            if (group[s] == gx || group[s] == gy) {
                group[s] = new_g;
            }
        }
    }

    for (int64_t i = 0; i < total; i++) {
        parent_out[i] = g.find(i);
    }
    return 0;
}
