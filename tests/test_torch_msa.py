"""The port's MSA layer (cpecan_tpu_torch.msa.aligner) against the JAX
package's (cpecan_tpu.msa.aligner).

Host parity is exact: the same seeded multiple-aligned pairs, made with
numpy, go through both packages' greedy and progressive merges (native
and Python paths), distance matrices and pair choices, and give
identical union-find roots, columns, matrices, pairs and RNG states.

End to end, on tests/test_msa.py's fixtures with the port on the CPU,
the columns and the chosen pairwise alignments are identical and the
kept pairs sit at identical positions. Posteriors carry the fp32 noise
of the forward-backward pass (within 100/1e7, as in
tests/test_torch_batch_cli.py); kept pairs are AMAP-reweighted, prob -
gapGamma * (indel_x + indel_y), each indel term 1e7 minus the summed
posteriors of its row (column), so a kept pair may move by its own error
plus 0.5 x those of up to 9 pairs in its row and 9 in its column:
KEPT_TOL = 1000, which also bounds the chosen alignments' scores (means
of kept posteriors). The ``cuda`` case holds the card's MSA against the
CPU's and skips without a card.
"""

import random

import numpy as np
import pytest
import torch

import cpecan_tpu.msa.aligner as j_aligner
import cpecan_tpu.msa.columns as j_columns
import cpecan_tpu_torch.msa.aligner as t_aligner
import cpecan_tpu_torch.msa.columns as t_columns
from cpecan_tpu.config import PairwiseAlignmentParameters as JParams
from cpecan_tpu.models.state_machine import state_machine5 as j_sm5
from cpecan_tpu.utils.symbols import evolve_sequence, get_random_sequence
from cpecan_tpu_torch.config import PairwiseAlignmentParameters as TParams
from cpecan_tpu_torch.models.state_machine import state_machine5 as t_sm5
from cpecan_tpu_torch.utils.logmath import PAIR_ALIGNMENT_PROB_1
from test_torch_copies import _assert_same

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PACKAGES = ((j_aligner, j_columns), (t_aligner, t_columns))
KEPT_TOL = 1000


# --------------------------------------------------------------------------
# Exact host parity on seeded pair lists
# --------------------------------------------------------------------------


def _pair_list(seed, n_seqs=6, length=40, n_pairs=300):
    """Fragment lengths and end ids, multiple-aligned pairs (probs, seqs,
    positions) and similarity scores, drawn with numpy."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(length // 2, length + 1, n_seqs)
    ends = rng.integers(0, 2, (n_seqs, 2))
    s = np.sort(np.stack([rng.choice(n_seqs, 2, replace=False)
                          for _ in range(n_pairs)]), axis=1)
    pairs = np.empty(n_pairs, j_aligner.MULTIPLE_PAIR_DTYPE)
    pairs["prob"] = rng.integers(1, PAIR_ALIGNMENT_PROB_1 + 1, n_pairs)
    pairs["seq1"], pairs["seq2"] = s[:, 0], s[:, 1]
    pairs["pos1"] = (rng.random(n_pairs) * lengths[s[:, 0]]).astype(np.int64)
    pairs["pos2"] = (rng.random(n_pairs) * lengths[s[:, 1]]).astype(np.int64)
    scores = [(int(rng.integers(0, PAIR_ALIGNMENT_PROB_1)), a, b)
              for a in range(n_seqs) for b in range(a + 1, n_seqs)
              if rng.random() < 0.7]
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, n)) for n in lengths]
    return seqs, ends, pairs, scores


def _frags(mod, seqs, ends):
    return [mod.SeqFrag(s, int(l), int(r)) for s, (l, r) in zip(seqs, ends)]


def _roots(store):
    return [store.find(p) for p in range(store.n_positions)]


def _columns(mod, store):
    return mod.MultipleAlignment(store, np.empty(0), []).column_list()


def _merge(kind):
    def run(seed, monkeypatch):
        seqs, ends, pairs, scores = _pair_list(seed)
        gamma = (0.0, 0.01, 0.3)[seed % 3]
        if kind == "progressive_python":
            monkeypatch.setenv("CPECAN_TPU_NATIVE", "0")
        for mod, _ in PACKAGES:
            frags = _frags(mod, seqs, ends)
            if kind == "greedy":
                store = mod.get_multiple_sequence_alignment(
                    frags, pairs, gamma)
            else:
                if kind == "progressive_native":
                    # the native merge itself, not a silent Python fallback
                    assert mod._progressive_native(
                        frags, pairs, gamma, scores) is not None
                store = mod.get_multiple_sequence_alignment_progressive(
                    frags, pairs, gamma, scores)
            yield (_roots(store), _columns(mod, store),
                   mod.filter_multiple_aligned_pairs(store, pairs))
    return run


def _distance_matrix(seed, monkeypatch):
    """Both packages' vectorised and naive distance matrices over the same
    randomly merged stores, at several max-pairs cutoffs."""
    rng = random.Random(seed)
    seqs = [get_random_sequence(rng.randint(10, 30), rng)
            for _ in range(6)]
    picks = []
    for _ in range(120):
        s1, s2 = rng.sample(range(len(seqs)), 2)
        picks.append((s1, rng.randrange(len(seqs[s1])),
                      s2, rng.randrange(len(seqs[s2]))))
    for mod, cols in PACKAGES:
        frags = [mod.SeqFrag(s, i, i + 1) for i, s in enumerate(seqs)]
        store = cols.ColumnStore([f.length for f in frags])
        dag = cols.ColumnDag(store)
        for pick in picks:
            dag.add_pair_if_consistent(*pick)
        out = []
        for max_pairs in (0, 3, 17, 1 << 30):
            got = mod.get_distance_matrix(store, frags, max_pairs)
            want = mod._distance_matrix_naive(store, frags, max_pairs)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            out.append(got)
        yield out


def _pair_choice(seed, monkeypatch):
    """Reference pairs by shared right-end ids, then a round of
    next-best pairs as make_alignment picks them: the chosen pairs and
    the RNG state after the ties it broke."""
    rng = np.random.default_rng(seed)
    n = 9
    seqs = ["A" * int(k) for k in rng.integers(1, 30, n)]
    ends = np.stack([np.zeros(n, np.int64), rng.integers(0, 3, n)], axis=1)
    subs = rng.integers(0, 4, (n, n))
    idents = rng.integers(0, 4, (n, n))
    subs, idents = subs + subs.T, idents + idents.T
    for mod, _ in PACKAGES:
        chosen = set(mod.get_reference_pairwise_alignments(
            _frags(mod, seqs, ends)))
        first = sorted(chosen)
        pick_rng = random.Random(seed)
        picks = []
        for seq in range(n):
            other = mod.get_next_best_pair(seq, subs, idents, chosen,
                                           pick_rng)
            picks.append(other)
            if other is not None:
                chosen.add((min(seq, other), max(seq, other)))
        yield first, picks, sorted(chosen), pick_rng.getstate()


HOST_CASES = {
    "greedy": _merge("greedy"),
    "progressive_native": _merge("progressive_native"),
    "progressive_python": _merge("progressive_python"),
    "distance_matrix": _distance_matrix,
    "pair_choice": _pair_choice,
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_copy_matches_original(case, seed, monkeypatch):
    original, copy = list(HOST_CASES[case](seed, monkeypatch))
    _assert_same(copy, original)


# --------------------------------------------------------------------------
# End to end on tests/test_msa.py's fixtures
# --------------------------------------------------------------------------


def check_alignment(seq_frags, mpairs):
    """Validity: every pair insertable into a fresh poset (reference
    checkAlignment, tests/multipleAlignerTest.c:58-86)."""
    poset = t_columns.PosetAlignment([f.length for f in seq_frags])
    for p in mpairs:
        score, s1, p1, s2, p2 = (int(p["prob"]), int(p["seq1"]),
                                 int(p["pos1"]), int(p["seq2"]),
                                 int(p["pos2"]))
        assert score <= PAIR_ALIGNMENT_PROB_1
        assert 0 <= s1 < len(seq_frags)
        assert 0 <= p1 < seq_frags[s1].length
        assert 0 <= s2 < len(seq_frags)
        assert 0 <= p2 < seq_frags[s2].length
        assert poset.add(s1, p1, s2, p2)


def _little(mod):
    # reference fixture (tests/multipleAlignerTest.c:21-47)
    return [mod.SeqFrag("AGTTT", 0, 0), mod.SeqFrag("AGTGTG", 0, 0),
            mod.SeqFrag("AC", 0, 1), mod.SeqFrag("", 1, 1)]


def _random_ends(seed):
    """Four evolved 40 bp fragments with end ids drawn at random (ragged
    ends where they differ), as tests/test_msa.py:80-89."""
    def make(mod):
        rng = random.Random(seed)
        base = get_random_sequence(40, rng)
        return [mod.SeqFrag(evolve_sequence(base, rng),
                            rng.random() > 0.5, rng.random() > 0.5)
                for _ in range(4)]
    return make


def _spanning(mod):
    rng = random.Random(3)
    base = get_random_sequence(50, rng)
    return [mod.SeqFrag(evolve_sequence(base, rng)) for _ in range(6)]


def _all_pairs(make, progressive, gamma):
    def run(mod, sm, p, **device):
        return mod.make_alignment_using_all_pairs(
            sm, make(mod), progressive, gamma, p, **device)
    return make, run


def _make_alignment(progressive):
    def run(mod, sm, p, **device):
        return mod.make_alignment(
            sm, _spanning(mod), spanning_trees=2, max_pairs_to_consider=10000,
            use_progressive_merging=progressive, match_gamma=0.5, p=p,
            **device)
    return _spanning, run


E2E_CASES = {
    "all_pairs_little": _all_pairs(_little, False, 0.0),
    **{f"all_pairs_seed{s}_{'progressive' if pr else 'greedy'}":
       _all_pairs(_random_ends(s), pr, 0.5)
       for s in (0, 1) for pr in (False, True)},
    "spanning_trees_greedy": _make_alignment(False),
    "spanning_trees_progressive": _make_alignment(True),
}


def _assert_alignments_agree(new, ref):
    assert new.column_list() == ref.column_list()
    a, b = new.aligned_pairs, ref.aligned_pairs
    assert len(a) == len(b)
    for k in ("seq1", "pos1", "seq2", "pos2"):
        np.testing.assert_array_equal(a[k], b[k])
    assert np.abs(a["prob"] - b["prob"]).max(initial=0) <= KEPT_TOL
    assert [c[1:] for c in new.chosen_pairwise_alignments] == \
        [c[1:] for c in ref.chosen_pairwise_alignments]
    for c, r in zip(new.chosen_pairwise_alignments,
                    ref.chosen_pairwise_alignments):
        assert abs(c[0] - r[0]) <= KEPT_TOL, (c, r)


@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_msa_matches_jax(case):
    make, run = E2E_CASES[case]
    ref = run(j_aligner, j_sm5(), JParams())
    new = run(t_aligner, t_sm5(), TParams(), device="cpu")
    check_alignment(make(t_aligner), new.aligned_pairs)
    assert len(new.aligned_pairs) > 0
    _assert_alignments_agree(new, ref)


def test_device_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make, run = E2E_CASES["spanning_trees_progressive"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(t_aligner, t_sm5(), TParams(), device="cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_pairs_seed0_progressive",
                                  "spanning_trees_progressive"])
def test_msa_on_card_matches_cpu(cuda_device, case):
    from cpecan_tpu_torch.ops import fb_wavefront

    make, run = E2E_CASES[case]
    fb_wavefront.reset_launch_counts()
    card = run(t_aligner, t_sm5(), TParams(), device=cuda_device)
    assert fb_wavefront.LAUNCHES["fwd"] > 0
    assert fb_wavefront.LAUNCHES["bwd"] > 0
    cpu = run(t_aligner, t_sm5(), TParams(), device="cpu")
    check_alignment(make(t_aligner), card.aligned_pairs)
    _assert_alignments_agree(card, cpu)
