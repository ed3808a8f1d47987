"""The pairwise poset-consistency decode of the realign path.

Counterpart of the part of cpecan_tpu/msa/aligner.py that
``filter_pairwise_alignment_to_make_pairs_ordered`` needs (reference
impl/multipleAligner.c): the AlignmentWeight graph between columns
(weight = posterior/1e7 plus a tiny jitter to break ties, :140-147, with
weighted-average combining on column merge, :242-246), the progressive
merge of two column-sequences by a sparse Pareto-frontier DP (:304-492,
:512-556), and the filter that keeps the pairs landing in one column
(:569-602, :945-971). The native C++ decoder (csrc/host/posetfilter.cpp)
is the fast path; the Python path here is its oracle. The MSA drivers
(make_alignment and the native progressive merge) belong to the MSA
slice.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from bisect import bisect_left

import numpy as np

from cpecan_tpu_torch.msa.columns import ColumnStore, ColumnDag
from cpecan_tpu_torch.ops import pairs as pairs_mod
from cpecan_tpu_torch.utils.logmath import PAIR_ALIGNMENT_PROB_1


@dataclasses.dataclass
class SeqFrag:
    """Sequence + end ids; differing end ids between two frags => ragged
    alignment ends (reference :24-36, used at :660-661)."""
    seq: str
    left_end_id: int = 0
    right_end_id: int = 0

    @property
    def length(self) -> int:
        return len(self.seq)


MULTIPLE_PAIR_DTYPE = np.dtype([
    ("prob", np.int64), ("seq1", np.int64), ("pos1", np.int64),
    ("seq2", np.int64), ("pos2", np.int64),
])


class _Weight:
    """Edge between two columns (column roots tracked via the store)."""

    __slots__ = ("c1", "c2", "avg", "n", "alive")

    def __init__(self, c1, c2, avg, n=1.0):
        self.c1 = c1
        self.c2 = c2
        self.avg = avg
        self.n = n
        self.alive = True


class WeightGraph:
    """Column adjacency with weight-combining merges and a lazy max-heap."""

    def __init__(self, store: ColumnStore, rng: random.Random,
                 jitter: float = 0.00001):
        self.store = store
        self.adj: dict[int, dict[int, _Weight]] = {}
        self.heap: list = []
        self.rng = rng
        self.jitter = jitter

    def add_pair(self, prob, seq1, pos1, seq2, pos2):
        c1 = self.store.find_pos(seq1, pos1)
        c2 = self.store.find_pos(seq2, pos2)
        # jitter breaks ties (reference :145); the rng draw happens even
        # at scale 0 so the MT19937 stream stays aligned with the native
        # decoders' (posetfilter.cpp)
        avg = (prob / PAIR_ALIGNMENT_PROB_1
               + self.rng.random() * self.jitter)
        if c1 == c2:
            return
        existing = self.adj.get(c1, {}).get(c2)
        if existing is not None:
            # combine duplicate edges between the same columns up front
            existing.avg = (existing.avg * existing.n + avg) / (existing.n + 1)
            existing.n += 1
            self._push(existing)
            return
        w = _Weight(c1, c2, avg)
        self.adj.setdefault(c1, {})[c2] = w
        self.adj.setdefault(c2, {})[c1] = w
        self._push(w)

    def _push(self, w: _Weight):
        heapq.heappush(self.heap, (-w.avg, id(w), w))

    def pop_max(self):
        """Highest-weight live edge, or None."""
        while self.heap:
            neg_avg, _, w = heapq.heappop(self.heap)
            if w.alive and -neg_avg == w.avg:
                return w
        return None

    def degree(self, c: int) -> int:
        return len(self.adj.get(self.store.find(c), {}))

    def other(self, w: _Weight, c: int) -> int:
        c1, c2 = self.store.find(w.c1), self.store.find(w.c2)
        return c2 if c1 == self.store.find(c) else c1

    def remove_edge(self, w: _Weight):
        c1, c2 = self.store.find(w.c1), self.store.find(w.c2)
        self.adj.get(c1, {}).pop(c2, None)
        self.adj.get(c2, {}).pop(c1, None)
        w.alive = False

    def merge_columns(self, w: _Weight, dag: ColumnDag) -> int:
        """Merge the two columns of w, re-targeting and weight-averaging
        incident edges (reference mergeColumns :213-270). Smaller-degree
        column merges into larger."""
        c1, c2 = self.store.find(w.c1), self.store.find(w.c2)
        if len(self.adj.get(c1, {})) < len(self.adj.get(c2, {})):
            c1, c2 = c2, c1
        self.remove_edge(w)
        root = dag.merge(c1, c2)  # root is c1 (store unions b into a)
        assert root == c1
        edges2 = self.adj.pop(c2, {})
        edges1 = self.adj.setdefault(c1, {})
        for other_c, w2 in edges2.items():
            other_root = self.store.find(other_c)
            if other_root == c1:
                w2.alive = False
                continue
            self.adj.get(other_root, {}).pop(c2, None)
            w2.c1, w2.c2 = c1, other_root
            existing = edges1.get(other_root)
            if existing is not None:
                existing.avg = (existing.avg * existing.n + w2.avg * w2.n) / (existing.n + w2.n)
                existing.n += w2.n
                w2.alive = False
                self._push(existing)
            else:
                edges1[other_root] = w2
                self.adj.setdefault(other_root, {})[c1] = w2
                self._push(w2)
        return c1


def _jitter_scale() -> float:
    """Tie-break jitter scale (reference makeAlignmentWeight :145,
    1e-5).  CPECAN_TPU_MSA_JITTER overrides it — the C-parity tests set
    it to 0 alongside the refparity harness's PARITY_ZERO_RANDOM so both
    implementations break ties deterministically."""
    import os

    try:
        return float(os.environ.get("CPECAN_TPU_MSA_JITTER", "1e-5"))
    except ValueError:
        return 1e-5


def _make_graph(seq_frags, multiple_aligned_pairs, seed=0):
    store = ColumnStore([f.length for f in seq_frags])
    dag = ColumnDag(store)
    graph = WeightGraph(store, random.Random(seed), _jitter_scale())
    for p in multiple_aligned_pairs:
        graph.add_pair(int(p["prob"]), int(p["seq1"]), int(p["pos1"]),
                       int(p["seq2"]), int(p["pos2"]))
    return store, dag, graph


def _pairwise_align_columns(x_cols: list, y_cols: list, graph: WeightGraph,
                            dag: ColumnDag, match_gamma: float) -> list:
    """Sparse Pareto-frontier DP aligning two column-sequences, then merge
    the chosen column pairs (reference pairwiseAlignColumns :358-492).
    Returns the merged column sequence."""
    store = graph.store

    def total_weights(cols):
        return sum(graph.degree(c) for c in cols)

    if total_weights(x_cols) > total_weights(y_cols):
        x_cols, y_cols = y_cols, x_cols

    y_index = {store.find(c): i for i, c in enumerate(y_cols)}

    # frontier: list of (yIndex, score, node) sorted by yIndex with scores
    # increasing; node = (xIndex, yIndex, score, prev_node, weight)
    min_node = (-1, -1, 0.0, None, None)
    frontier_y = [-1, len(y_cols)]
    max_node = (len(x_cols), len(y_cols), float("inf"), min_node, None)
    frontier_n = [min_node, max_node]

    for i, cx in enumerate(x_cols):
        cxr = store.find(cx)
        edges = graph.adj.get(cxr)
        if not edges:
            continue
        candidates = []
        for other_c, w in list(edges.items()):
            if not w.alive:
                continue
            if w.avg >= match_gamma and w.avg > 0.0:
                yi = y_index.get(store.find(other_c))
                if yi is None:
                    continue
                # best frontier point strictly left of yi
                k = bisect_left(frontier_y, yi) - 1
                prev = frontier_n[k]
                score = prev[2] + w.avg * w.n
                candidates.append((i, yi, score, prev, w))
        # insert candidates right-to-left along Y
        candidates.sort(key=lambda t: t[1])
        for cand in reversed(candidates):
            _, yi, score, _, _ = cand
            k = bisect_left(frontier_y, yi)
            # frontier point equal-or-right of yi
            if score >= frontier_n[k][2] or frontier_y[k] > yi:
                while score >= frontier_n[k][2]:
                    frontier_y.pop(k)
                    frontier_n.pop(k)
                frontier_y.insert(k, yi)
                frontier_n.insert(k, cand)

    # link the max sentinel to the right-most real point
    last = frontier_n[-2]
    max_node = (len(x_cols), len(y_cols), float("inf"), last, None)

    # traceback, emitting columns right-to-left
    alignment = []
    node = max_node
    while True:
        xi, yi, _, prev, _ = node
        assert prev is not None
        py = prev[1]
        while yi - 1 > py:
            yi -= 1
            alignment.append(y_cols[yi])
        px = prev[0]
        while xi - 1 > px:
            xi -= 1
            alignment.append(x_cols[xi])
        node = prev
        if node is min_node:
            break
        w = node[4]
        if w.alive:
            merged = graph.merge_columns(w, dag)
        else:
            # edge was combined away by an earlier merge in this traceback;
            # merge via the surviving edge between the same column roots
            a, b = store.find(w.c1), store.find(w.c2)
            if a == b:
                merged = a
            else:
                surviving = graph.adj.get(a, {}).get(b)
                if surviving is None:
                    surviving = _Weight(a, b, 0.0, 0.0)
                    graph.adj.setdefault(a, {})[b] = surviving
                    graph.adj.setdefault(b, {})[a] = surviving
                merged = graph.merge_columns(surviving, dag)
        alignment.append(merged)
    alignment.reverse()
    return alignment


def get_multiple_sequence_alignment_progressive(
        seq_frags, multiple_aligned_pairs, match_gamma: float,
        seq_pair_similarity_scores) -> ColumnStore:
    """Progressive MSA merging sequences in descending similarity order
    (reference :512-556). seq_pair_similarity_scores: (score, seq1, seq2).
    The Python path of cpecan_tpu's version (its native merge,
    native/progressive.cpp, waits for the MSA slice)."""
    store, dag, graph = _make_graph(seq_frags, multiple_aligned_pairs)
    col_seqs = [
        [store.pid(s, p) for p in range(f.length)] for s, f in enumerate(seq_frags)
    ]
    group = list(range(len(seq_frags)))  # seq -> column-sequence group id

    order = sorted(seq_pair_similarity_scores)
    while order:
        _, seq_x, seq_y = order.pop()
        gx, gy = group[seq_x], group[seq_y]
        if gx == gy:
            continue
        merged_cols = _pairwise_align_columns(
            col_seqs[gx], col_seqs[gy], graph, dag, match_gamma)
        col_seqs.append(merged_cols)
        new_g = len(col_seqs) - 1
        for s in range(len(group)):
            if group[s] in (gx, gy):
                group[s] = new_g
    return store


def filter_multiple_aligned_pairs(store: ColumnStore, multiple_aligned_pairs):
    """Keep pairs whose two positions landed in the same column
    (reference :569-602).  Vectorized: one path-compressing sweep turns
    the union-find into a flat root array, then pids index it."""
    if len(multiple_aligned_pairs) == 0:
        return multiple_aligned_pairs
    # resolve the union-find by pointer doubling (log-depth numpy passes)
    roots = np.asarray(store.parent, np.int64)
    while True:
        nxt = roots[roots]
        if np.array_equal(nxt, roots):
            break
        roots = nxt
    mp = multiple_aligned_pairs
    offs = np.asarray(store.offsets, np.int64)
    c1 = roots[offs[mp["seq1"]] + mp["pos1"]]
    c2 = roots[offs[mp["seq2"]] + mp["pos2"]]
    return mp[c1 == c2]


def filter_pairwise_alignment_to_make_pairs_ordered(aligned_pairs, seq_x, seq_y,
                                                    match_gamma: float):
    """Default pairwise decode path: run the 2-seq progressive MSA over the
    posterior pairs and keep the consistent subset (reference :945-971).
    Uses the native C++ decoder when available (bit-identical, including
    the MT19937 tie-break jitter; native/posetfilter.cpp)."""
    from cpecan_tpu_torch.align import native

    # the C++ decoder hard-codes the default jitter scale; a non-default
    # scale (parity tests) routes through the Python oracle path below
    if native.available() and _jitter_scale() == 1e-5:
        keep = native.filter_pairs_ordered(aligned_pairs, match_gamma)
        return aligned_pairs[keep]

    mpairs = np.empty(len(aligned_pairs), dtype=MULTIPLE_PAIR_DTYPE)
    mpairs["prob"] = aligned_pairs["prob"]
    mpairs["seq1"] = 0
    mpairs["pos1"] = aligned_pairs["x"]
    mpairs["seq2"] = 1
    mpairs["pos2"] = aligned_pairs["y"]
    frags = [SeqFrag(seq_x), SeqFrag(seq_y)]
    store = get_multiple_sequence_alignment_progressive(
        frags, mpairs, match_gamma, [(0, 0, 1)])
    kept = filter_multiple_aligned_pairs(store, mpairs)
    return pairs_mod.make_pairs(kept["prob"], kept["pos1"], kept["pos2"])
