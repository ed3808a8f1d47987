"""Column store + partial-order consistency for multiple alignment.

Re-expresses the reference's Column linked-lists + sonLib stPosetAlignment
(impl/multipleAligner.c:50-91, :272-297) as a union-find column store over
(seq, pos) positions plus an explicit column DAG used for the
transitive-consistency test: merging two columns is allowed iff it keeps
the column graph (with edges from each column to the columns of successor
sequence positions) acyclic — equivalent to stPosetAlignment_add's check
that the aligned positions remain embeddable in a common total order.
"""

from __future__ import annotations


class ColumnStore:
    """Union-find over positions; a column is a set of (seq, pos)."""

    def __init__(self, seq_lengths):
        self.seq_lengths = list(seq_lengths)
        self.offsets = []
        total = 0
        for l in self.seq_lengths:
            self.offsets.append(total)
            total += l
        self.parent = list(range(total))
        # members/head only tracked for roots
        self.members: dict[int, list] = {i: None for i in []}
        self.n_positions = total

    def pid(self, seq: int, pos: int) -> int:
        return self.offsets[seq] + pos

    def seq_pos(self, pid: int):
        # invert pid -> (seq, pos); binary search over offsets
        lo, hi = 0, len(self.offsets) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.offsets[mid] <= pid:
                lo = mid
            else:
                hi = mid - 1
        return lo, pid - self.offsets[lo]

    def find(self, pid: int) -> int:
        root = pid
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[pid] != root:
            self.parent[pid], pid = root, self.parent[pid]
        return root

    def find_pos(self, seq: int, pos: int) -> int:
        return self.find(self.pid(seq, pos))

    def union(self, a: int, b: int) -> int:
        """Merge column roots a <- b (caller decides orientation). Returns a."""
        a, b = self.find(a), self.find(b)
        if a == b:
            return a
        self.parent[b] = a
        ma = self.members.get(a)
        mb = self.members.get(b)
        if ma is not None or mb is not None:
            la = ma if ma is not None else [a]
            lb = mb if mb is not None else [b]
            la.extend(lb)
            self.members[a] = la
            self.members.pop(b, None)
        else:
            self.members[a] = [a, b]
        return a

    def column_members(self, root: int):
        root = self.find(root)
        m = self.members.get(root)
        return m if m is not None else [root]

    def column_positions(self, root: int):
        return [self.seq_pos(p) for p in self.column_members(root)]

    def all_columns(self):
        """All current column roots with their (seq, pos) members."""
        cols = {}
        for pid in range(self.n_positions):
            cols.setdefault(self.find(pid), []).append(self.seq_pos(pid))
        return cols


class ColumnDag:
    """Acyclicity checker over the column graph.

    Edges go from the column of (s, p) to the column of (s, p+1). A merge of
    columns A and B is consistent iff there is no directed path A=>B or
    B=>A. Reachability is a DFS over contracted columns; merged columns'
    adjacency is unioned.
    """

    def __init__(self, store: ColumnStore):
        self.store = store
        # adjacency between column roots derived lazily from positions:
        # succ[root] = set of successor roots; pred mirrors it.
        self.succ: dict[int, set] = {}
        self.pred: dict[int, set] = {}
        for seq, l in enumerate(store.seq_lengths):
            for pos in range(l - 1):
                a = store.pid(seq, pos)
                b = store.pid(seq, pos + 1)
                self.succ.setdefault(a, set()).add(b)
                self.pred.setdefault(b, set()).add(a)

    def _reachable(self, src: int, dst: int) -> bool:
        """DFS src => dst over successor edges (both are roots)."""
        stack = [src]
        seen = {src}
        find = self.store.find
        while stack:
            node = stack.pop()
            for nxt in self.succ.get(node, ()):  # nodes stored as roots
                r = find(nxt)
                if r == dst:
                    return True
                if r not in seen:
                    seen.add(r)
                    stack.append(r)
        return False

    def can_merge(self, a: int, b: int) -> bool:
        a, b = self.store.find(a), self.store.find(b)
        if a == b:
            return True
        return not (self._reachable(a, b) or self._reachable(b, a))

    def merge(self, a: int, b: int) -> int:
        """Union b into a in the DAG (adjacency sets combined, self-loops
        dropped). Caller must have verified can_merge."""
        a, b = self.store.find(a), self.store.find(b)
        if a == b:
            return a
        root = self.store.union(a, b)
        other = b if root == a else a
        find = self.store.find
        # fold adjacency of `other` into `root`, renormalizing to roots
        for d, rev in ((self.succ, self.pred), (self.pred, self.succ)):
            edges = d.pop(other, set())
            cur = d.setdefault(root, set())
            cur |= edges
            d[root] = {find(x) for x in cur if find(x) != root}
        return root

    def add_pair_if_consistent(self, seq1: int, pos1: int, seq2: int, pos2: int) -> bool:
        """stPosetAlignment_add equivalent: test + merge in one step."""
        a = self.store.find_pos(seq1, pos1)
        b = self.store.find_pos(seq2, pos2)
        if a == b:
            return True
        if not self.can_merge(a, b):
            return False
        self.merge(a, b)
        return True


class PosetAlignment:
    """Standalone consistency checker (the test-facing stPosetAlignment
    equivalent): tracks aligned pairs without the weight machinery."""

    def __init__(self, seq_lengths):
        self.store = ColumnStore(seq_lengths)
        self.dag = ColumnDag(self.store)

    def is_possible(self, seq1, pos1, seq2, pos2) -> bool:
        a = self.store.find_pos(seq1, pos1)
        b = self.store.find_pos(seq2, pos2)
        return a == b or self.dag.can_merge(a, b)

    def add(self, seq1, pos1, seq2, pos2) -> bool:
        return self.dag.add_pair_if_consistent(seq1, pos1, seq2, pos2)
