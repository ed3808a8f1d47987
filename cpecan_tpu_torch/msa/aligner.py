"""Multiple sequence alignment drivers.

Counterpart of cpecan_tpu/msa/aligner.py: host-side greedy/progressive
column merging over pairwise posterior matrices computed by the port's
batch path (on the card unless the caller passes ``device="cpu"``).
Reference semantics (impl/multipleAligner.c):

  - AlignmentWeight graph between columns, weight = posterior/1e7 (+ tiny
    jitter to break ties, :140-147), weighted-average combining on column
    merge (:242-246)
  - greedy MSA: pop highest weight >= matchGamma, merge iff partial order
    stays consistent (:272-297)
  - progressive MSA: sparse weight-driven pairwise DP between two
    column-sequences with a Pareto frontier of best scoring ColumnPairs
    (:304-492), sequences merged in descending similarity order (:512-556);
    the whole loop runs natively (csrc/host/progressive.cpp), the Python
    path here is its oracle
  - spanning-tree pair selection (:717-782), distance matrix (:809-839),
    Dijkstra-gain next-best pair (:841-885)
  - makeAlignment: spanning-tree rounds (:887-939)
  - filterPairwiseAlignmentToMakePairsOrdered: 2-seq progressive MSA as the
    default pairwise decode path (:945-971)
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from bisect import bisect_left, bisect_right, insort

import numpy as np

from cpecan_tpu_torch.utils import metrics

from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.state_machine import StateMachine
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


def get_multiple_sequence_alignment(seq_frags, multiple_aligned_pairs,
                                    match_gamma: float) -> ColumnStore:
    """Greedy poset MSA (reference :272-297)."""
    store, dag, graph = _make_graph(seq_frags, multiple_aligned_pairs)
    while True:
        w = graph.pop_max()
        if w is None or w.avg < match_gamma:
            break
        c1, c2 = store.find(w.c1), store.find(w.c2)
        if c1 != c2 and dag.can_merge(c1, c2):
            graph.merge_columns(w, dag)
        else:
            graph.remove_edge(w)
    return store


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


def _progressive_native(seq_frags, multiple_aligned_pairs, match_gamma,
                        seq_pair_similarity_scores, seed=0):
    """Whole progressive merge loop in C++ (csrc/host/progressive.cpp) —
    the host merge dominates MSA wall-clock once posteriors come off the
    device.  Returns the resulting ColumnStore, or None when the native
    library is unavailable (callers fall back to the Python path, which
    doubles as the parity oracle: tests/test_native_progressive.py)."""
    from cpecan_tpu_torch.align import native as native_mod

    if not native_mod.available():
        return None
    store = ColumnStore([f.length for f in seq_frags])
    mp = np.asarray(multiple_aligned_pairs, MULTIPLE_PAIR_DTYPE)
    offs = np.asarray(store.offsets, np.int64)
    pid1 = offs[mp["seq1"]] + mp["pos1"]
    pid2 = offs[mp["seq2"]] + mp["pos2"]
    # identical jitter stream to WeightGraph.add_pair (one draw per pair,
    # in pair order)
    rng = random.Random(seed)
    jit = np.fromiter((rng.random() for _ in range(len(mp))), np.float64,
                      len(mp))
    weights = mp["prob"] / PAIR_ALIGNMENT_PROB_1 + jit * _jitter_scale()
    order = list(reversed(sorted(seq_pair_similarity_scores)))
    ox = np.asarray([s1 for _s, s1, _s2 in order], np.int64)
    oy = np.asarray([s2 for _s, _s1, s2 in order], np.int64)
    parent = native_mod.progressive_msa(
        np.asarray(store.seq_lengths, np.int64), pid1, pid2, weights,
        ox, oy, match_gamma)
    store.parent = parent.tolist()
    members: dict = {}
    for pid, r in enumerate(store.parent):
        members.setdefault(r, []).append(pid)
    store.members = {r: m for r, m in members.items() if len(m) > 1}
    return store


def get_multiple_sequence_alignment_progressive(
        seq_frags, multiple_aligned_pairs, match_gamma: float,
        seq_pair_similarity_scores) -> ColumnStore:
    """Progressive MSA merging sequences in descending similarity order
    (reference :512-556). seq_pair_similarity_scores: (score, seq1, seq2)."""
    store = _progressive_native(seq_frags, multiple_aligned_pairs,
                                match_gamma, seq_pair_similarity_scores)
    if store is not None:
        return store
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


# ---------------------------------------------------------------------------
# Pair selection and the top-level makeAlignment drivers
# ---------------------------------------------------------------------------

def _get_alignment_score(aligned_pairs, l1: int, l2: int) -> int:
    """Normalised avg posterior that a position in the shorter seq is
    aligned (reference getAlignmentScore :604-619)."""
    total = int(aligned_pairs["prob"].sum()) if len(aligned_pairs) else 0
    j = max(1, min(l1, l2))
    d = min(1.0, max(0.0, total / (j * PAIR_ALIGNMENT_PROB_1)))
    return int(d * PAIR_ALIGNMENT_PROB_1)


def _add_multiple_aligned_pairs_batch(sm, id_pairs, seq_frags, pair_lists, p,
                                      device="cuda"):
    """Pairwise align many frag pairs in one cross-pair device batch,
    reweight, convert to 5-tuples; returns the similarity scores
    (semantics of addMultipleAlignedPairs, reference :653-666, batched —
    the reference aligns the chosen pairs one at a time)."""
    from cpecan_tpu_torch.align import batch as batch_align
    from cpecan_tpu_torch.align.anchors import get_anchors

    id_pairs = list(id_pairs)
    jobs = []
    for s1, s2 in id_pairs:
        f1, f2 = seq_frags[s1], seq_frags[s2]
        jobs.append((f1.seq, f2.seq, get_anchors(f1.seq, f2.seq, p),
                     f1.left_end_id != f2.left_end_id,
                     f1.right_end_id != f2.right_end_id))
    results = batch_align.get_aligned_pairs_batch(sm, jobs, p, device=device)
    scores = []
    for (s1, s2), aligned in zip(id_pairs, results):
        f1, f2 = seq_frags[s1], seq_frags[s2]
        aligned = pairs_mod.reweight_aligned_pairs(
            aligned, f1.length, f2.length, p.gapGamma)
        scores.append(_get_alignment_score(aligned, f1.length, f2.length))
        m = np.empty(len(aligned), dtype=MULTIPLE_PAIR_DTYPE)
        m["prob"] = aligned["prob"]
        m["seq1"] = s1
        m["pos1"] = aligned["x"]
        m["seq2"] = s2
        m["pos2"] = aligned["y"]
        pair_lists.append(m)
    return scores


def get_reference_pairwise_alignments(seq_frags) -> list:
    """n-1 seed pairs grouped by shared right-end ids with middle-element
    references (reference :717-770)."""
    chosen: list = []
    if not seq_frags:
        return chosen
    l = sorted((f.right_end_id, f.length, i) for i, f in enumerate(seq_frags))

    def pick(sub):
        ref = sub[len(sub) // 2][2]
        for item in sub:
            if item[2] != ref:
                a, b = ref, item[2]
                chosen.append((min(a, b), max(a, b)))
        return sub[len(sub) // 2]

    groups = []
    start = 0
    for j in range(1, len(l) + 1):
        if j == len(l) or l[j][0] != l[start][0]:
            groups.append(pick(l[start:j]))
            start = j
    pick(groups)
    assert len(chosen) == len(seq_frags) - 1
    return chosen


def _distance_matrix_naive(store: ColumnStore, seq_frags,
                           max_pairs_to_consider: int):
    """Direct per-pair loop over column members — the parity oracle for
    the vectorized get_distance_matrix (reference :809-839 structure)."""
    n = len(seq_frags)
    subs = np.zeros((n, n), dtype=np.int64)
    idents = np.zeros((n, n), dtype=np.int64)
    considered = 0
    for _, members in store.all_columns().items():
        if considered >= max_pairs_to_consider:
            break
        for a in range(len(members)):
            s1, p1 = members[a]
            b1 = seq_frags[s1].seq[p1]
            for b in range(a + 1, len(members)):
                s2, p2 = members[b]
                b2 = seq_frags[s2].seq[p2]
                if b1 == b2:
                    idents[s1, s2] += 1
                    idents[s2, s1] += 1
                else:
                    subs[s1, s2] += 1
                    subs[s2, s1] += 1
                considered += 1
    return subs, idents


def get_distance_matrix(store: ColumnStore, seq_frags, max_pairs_to_consider: int):
    """Substitution/identity counts from columns (reference :809-839).
    Returns (subs, identities) matrices: subs[i,j] for i>j, identities for
    i<j in the reference's packed layout; here two symmetric matrices.

    Vectorized: roots by pointer-jumping over the union-find array, member
    pairs expanded per column-size bucket — the O(n_positions * members)
    work stays in numpy (the host-side hot spot of the 100-sequence MSA
    config; parity with _distance_matrix_naive is tested)."""
    n = len(seq_frags)
    subs = np.zeros((n, n), dtype=np.int64)
    idents = np.zeros((n, n), dtype=np.int64)
    N = store.n_positions
    if N == 0:
        return subs, idents

    roots = np.asarray(store.parent, dtype=np.int64)
    while True:  # pointer jumping to the union-find roots, log rounds
        nxt = roots[roots]
        if np.array_equal(nxt, roots):
            break
        roots = nxt

    seq_starts = np.asarray(store.offsets, dtype=np.int64)
    seq_of = np.searchsorted(seq_starts, np.arange(N), side="right") - 1
    base = np.concatenate([
        np.frombuffer(f.seq.encode("latin-1"), dtype=np.uint8)
        for f in seq_frags])

    # columns as groups of pids sorted by root, ties by pid; group order =
    # ascending min pid (= the all_columns first-encounter order the
    # max_pairs cutoff is defined over)
    order = np.argsort(roots, kind="stable")
    rs = roots[order]
    gstart = np.flatnonzero(np.r_[True, rs[1:] != rs[:-1]])
    counts = np.diff(np.r_[gstart, N])
    gorder = np.argsort(order[gstart], kind="stable")
    gstart, counts = gstart[gorder], counts[gorder]

    # cutoff: a column's pairs count iff fewer than max pairs were
    # considered before it (per-column granularity, like the loop above)
    cum_before = np.r_[0, np.cumsum(counts * (counts - 1) // 2)[:-1]]
    keep = (cum_before < max_pairs_to_consider) & (counts >= 2)
    gstart, counts = gstart[keep], counts[keep]

    for k in np.unique(counts):
        g = gstart[counts == k]
        ii, jj = np.triu_indices(int(k), 1)
        pa = order[(g[:, None] + ii[None, :]).ravel()]
        pb = order[(g[:, None] + jj[None, :]).ravel()]
        s1, s2 = seq_of[pa], seq_of[pb]
        eq = base[pa] == base[pb]
        np.add.at(idents, (s1[eq], s2[eq]), 1)
        np.add.at(idents, (s2[eq], s1[eq]), 1)
        ne = ~eq
        np.add.at(subs, (s1[ne], s2[ne]), 1)
        np.add.at(subs, (s2[ne], s1[ne]), 1)
    return subs, idents


def subs_per_site(subs, idents, s1, s2) -> float:
    tot = subs[s1, s2] + idents[s1, s2]
    return 0.0 if tot == 0 else subs[s1, s2] / tot


def _dijkstra(n, edges, src):
    dist = [float("inf")] * n
    dist[src] = 0.0
    q = [(0.0, src)]
    while q:
        d, u = heapq.heappop(q)
        if d > dist[u]:
            continue
        for v, w in edges.get(u, ()):  # (neighbor, weight)
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(q, (nd, v))
    return dist


def get_next_best_pair(seq1, subs, idents, chosen_pairs, rng: random.Random):
    """Max (path distance - direct distance) gain pair via Dijkstra over the
    chosen-pair graph (reference :858-885)."""
    n = subs.shape[0]
    edges: dict[int, list] = {}
    for a, b in chosen_pairs:
        w = subs_per_site(subs, idents, a, b)
        edges.setdefault(a, []).append((b, w))
        edges.setdefault(b, []).append((a, w))
    dist = _dijkstra(n, edges, seq1)
    max_gain, best = float("-inf"), None
    for seq2 in range(n):
        if seq2 == seq1:
            continue
        gain = dist[seq2] - subs_per_site(subs, idents, seq1, seq2)
        if gain > max_gain or (gain == max_gain and rng.random() > 0.5):
            pair = (min(seq1, seq2), max(seq1, seq2))
            if pair not in chosen_pairs:
                max_gain, best = gain, seq2
    return best


@dataclasses.dataclass
class MultipleAlignment:
    """Result bundle (reference inc/multipleAligner.h MultipleAlignment)."""
    columns: ColumnStore
    aligned_pairs: np.ndarray  # consistent 5-tuples
    chosen_pairwise_alignments: list  # (score, seq1, seq2)

    def column_list(self):
        """Columns as lists of (seq, pos), sorted for deterministic output."""
        cols = [sorted(m) for m in self.columns.all_columns().values()]
        cols.sort()
        return cols


def make_alignment_using_all_pairs(sm: StateMachine, seq_frags,
                                   use_progressive_merging: bool,
                                   match_gamma: float,
                                   p: PairwiseAlignmentParameters,
                                   device="cuda") -> MultipleAlignment:
    """All-vs-all MSA (reference :683-699)."""
    pair_lists: list = []
    n = len(seq_frags)
    id_pairs = [(s1, s2) for s1 in range(n) for s2 in range(s1 + 1, n)]
    got = _add_multiple_aligned_pairs_batch(sm, id_pairs, seq_frags,
                                            pair_lists, p, device)
    scores = [(sc, s1, s2) for sc, (s1, s2) in zip(got, id_pairs)]
    mpairs = (np.concatenate(pair_lists) if pair_lists
              else np.empty(0, dtype=MULTIPLE_PAIR_DTYPE))
    with metrics.stage("msa_merge"):
        if n == 2 or use_progressive_merging:
            store = get_multiple_sequence_alignment_progressive(
                seq_frags, mpairs, match_gamma, scores)
        else:
            store = get_multiple_sequence_alignment(
                seq_frags, mpairs, match_gamma)
    return MultipleAlignment(
        columns=store,
        aligned_pairs=filter_multiple_aligned_pairs(store, mpairs),
        chosen_pairwise_alignments=scores)


def make_alignment(sm: StateMachine, seq_frags, spanning_trees: int,
                   max_pairs_to_consider: int, use_progressive_merging: bool,
                   match_gamma: float, p: PairwiseAlignmentParameters,
                   seed: int = 0, device="cuda") -> MultipleAlignment:
    """Spanning-tree MSA rounds (reference makeAlignment :887-939)."""
    n = len(seq_frags)
    if spanning_trees * (n - 1) >= (n * (n - 1)) // 2:
        return make_alignment_using_all_pairs(
            sm, seq_frags, use_progressive_merging, match_gamma, p, device)

    rng = random.Random(seed)
    pair_lists: list = []
    chosen_set = set(get_reference_pairwise_alignments(seq_frags))
    seed_pairs = sorted(chosen_set)
    got = _add_multiple_aligned_pairs_batch(sm, seed_pairs, seq_frags,
                                            pair_lists, p, device)
    chosen_scored = [(sc, s1, s2) for sc, (s1, s2) in zip(got, seed_pairs)]

    iteration = 0
    while True:
        mpairs = (np.concatenate(pair_lists) if pair_lists
                  else np.empty(0, dtype=MULTIPLE_PAIR_DTYPE))
        with metrics.stage("msa_merge"):
            if n == 2 or use_progressive_merging:
                store = get_multiple_sequence_alignment_progressive(
                    seq_frags, mpairs, match_gamma, chosen_scored)
            else:
                store = get_multiple_sequence_alignment(
                    seq_frags, mpairs, match_gamma)
        iteration += 1
        if iteration >= spanning_trees:
            return MultipleAlignment(
                columns=store,
                aligned_pairs=filter_multiple_aligned_pairs(store, mpairs),
                chosen_pairwise_alignments=chosen_scored)
        subs, idents = get_distance_matrix(store, seq_frags, max_pairs_to_consider)
        # pair selection stays sequential (each choice updates chosen_set,
        # reference :925-937); the alignments run as one device batch
        new_pairs = []
        for seq in range(n):
            other = get_next_best_pair(seq, subs, idents, chosen_set, rng)
            if other is not None:
                pair = (min(seq, other), max(seq, other))
                new_pairs.append(pair)
                chosen_set.add(pair)
        got = _add_multiple_aligned_pairs_batch(sm, new_pairs, seq_frags,
                                                pair_lists, p, device)
        chosen_scored.extend(
            (sc, s1, s2) for sc, (s1, s2) in zip(got, new_pairs))
