"""The benchmark's reference against cases checked by hand: every
alignment path of a tiny pair enumerated, its probability multiplied out
from the model, and the posteriors and expected counts summed over the
paths."""

from __future__ import annotations

import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib.common import model_of  # noqa: E402
from benchmark.reference import band, fb, hmm, records, state_machine  # noqa: E402

KINDS = {0: "M", 1: "X", 2: "Y", 3: "X", 4: "Y"}  # what each 5-state state consumes


def _paths(lx, ly):
    """Every state sequence that consumes lx x-bases and ly y-bases."""
    def rec(x, y, acc):
        if x == lx and y == ly:
            yield list(acc)
            return
        for s, kind in KINDS.items():
            dx, dy = {"M": (1, 1), "X": (1, 0), "Y": (0, 1)}[kind]
            if x + dx <= lx and y + dy <= ly:
                acc.append((s, x + dx, y + dy))
                yield from rec(x + dx, y + dy, acc)
                acc.pop()
    yield from rec(0, 0, [])


def _brute(sm, x, y, rl, rr):
    """(P, match posterior of each cell, transition counts, emission
    counts) by enumerating paths."""
    sx, sy = records.encode(x), records.encode(y)
    T = {"X": np.exp(sm.t_x), "M": np.exp(sm.t_m), "Y": np.exp(sm.t_y)}
    start = np.exp(sm.ragged_start if rl else sm.start)
    end = np.exp(sm.ragged_end if rr else sm.end)
    em = np.exp(sm.em_match)
    gx, gy = np.exp(sm.em_gap_x), np.exp(sm.em_gap_y)
    P, post = 0.0, {}
    trans, emis = np.zeros((5, 5)), np.zeros((5, 4, 4))
    weighted = []
    for path in _paths(len(x), len(y)):
        for s0 in range(5):
            p, f, steps = start[s0], s0, []
            for to, cx, cy in path:
                kind = KINDS[to]
                e = (em[sx[cx - 1], sy[cy - 1]] if kind == "M"
                     else gx[sx[cx - 1]] if kind == "X" else gy[sy[cy - 1]])
                p *= T[kind][f, to] * e
                steps.append((f, to, cx, cy))
                f = to
            p *= end[f]
            if p > 0:
                weighted.append((p, steps))
                P += p
    for p, steps in weighted:
        for f, to, cx, cy in steps:
            trans[f, to] += p / P
            if cx >= 1 and cy >= 1:
                emis[to, sx[cx - 1], sy[cy - 1]] += p / P
            if to == 0:
                post[(cx, cy)] = post.get((cx, cy), 0.0) + p / P
    return P, post, trans, emis


def _chunk(x, y, rl, rr):
    b = band.full_band(len(x), len(y))
    return {"sx": records.encode(x), "sy": records.encode(y),
            "offsets": b.offsets, "widths": b.widths, "rl": rl, "rr": rr}


CASES = [("A", "C"), ("AC", "A"), ("ACG", "AG"), ("GT", "GTT"), ("CA", "CA")]


@pytest.mark.parametrize("x,y", CASES)
@pytest.mark.parametrize("ragged", [False, True])
def test_posteriors_and_counts_match_path_enumeration(x, y, ragged):
    sm = state_machine.state_machine5()
    P, post, trans, emis = _brute(sm, x, y, ragged, ragged)
    ch = _chunk(x, y, ragged, ragged)
    xs, ys, ps = fb.posteriors([ch], model_of(sm))[0]
    for cx, cy, p in zip(xs, ys, ps):
        assert p == pytest.approx(post.get((int(cx), int(cy)), 0.0),
                                  rel=1e-9, abs=1e-12)
    t, e, like = fb.expectations([ch], model_of(sm))
    np.testing.assert_allclose(t, trans, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(e, emis, rtol=1e-9, atol=1e-12)
    assert like == pytest.approx((len(x) + len(y)) * math.log(P), rel=1e-12)


def test_one_by_one_by_hand():
    """x = A, y = A, no ragged ends: the path starts in the match state
    and the five-state model has no switch between a gap in x and one in
    y, so the one path is a single match: posterior 1, P = t(M, M) e(A, A)
    end(M)."""
    sm = state_machine.state_machine5()
    ch = _chunk("A", "A", False, False)
    xs, ys, ps = fb.posteriors([ch], model_of(sm))[0]
    assert list(zip(xs.tolist(), ys.tolist())) == [(1, 1)]
    assert ps[0] == pytest.approx(1.0, rel=1e-12)
    like = fb.expectations([ch], model_of(sm))[2]
    assert like == pytest.approx(
        2 * (sm.t_m[0, 0] + sm.em_match[0, 0] + sm.end[0]), rel=1e-12)


def test_banded_equals_full_band_inside_a_wide_band():
    """A band from anchors that covers every cell gives the full-band
    answer."""
    sm = state_machine.state_machine5()
    rng = np.random.default_rng(0)
    x = "".join(rng.choice(list("ACGT"), 30))
    y = x[:10] + x[12:25] + "GA" + x[25:]
    full = fb.posteriors([_chunk(x, y, True, True)], model_of(sm))[0]
    b = band.construct_band(np.zeros((0, 2), np.int64), len(x), len(y), 80)
    wide = {"sx": records.encode(x), "sy": records.encode(y),
            "offsets": b.offsets, "widths": b.widths, "rl": True, "rr": True}
    got = fb.posteriors([wide], model_of(sm))[0]
    np.testing.assert_allclose(np.sort(got[2]), np.sort(full[2]), rtol=1e-10)


def test_batches_agree_with_one_at_a_time():
    sm = state_machine.state_machine5()
    rng = np.random.default_rng(1)
    chunks = []
    for n in (5, 17, 9):
        x = "".join(rng.choice(list("ACGT"), n))
        y = "".join(rng.choice(list("ACGT"), n + 2))
        chunks.append(_chunk(x, y, True, False))
    together = fb.posteriors(chunks, model_of(sm))
    for c, t in zip(chunks, together):
        alone = fb.posteriors([c], model_of(sm))[0]
        np.testing.assert_allclose(t[2], alone[2], rtol=1e-12)
    t1, e1, l1 = fb.expectations(chunks, model_of(sm))
    parts = [fb.expectations([c], model_of(sm)) for c in chunks]
    np.testing.assert_allclose(t1, sum(p[0] for p in parts), rtol=1e-12)
    assert l1 == pytest.approx(sum(p[2] for p in parts), rel=1e-12)


def test_lower_precision_reads_differently():
    sm = state_machine.state_machine5()
    rng = np.random.default_rng(2)
    x = "".join(rng.choice(list("ACGT"), 40))
    ch = _chunk(x, x[:18] + x[20:], True, True)
    hi = fb.expectations([ch], model_of(sm))[0]
    lo = fb.expectations([ch], model_of(sm), dtype=torch.bfloat16)[0]
    gap = np.max(np.abs(lo - hi) / np.maximum(np.abs(hi), np.median(np.abs(hi))))
    assert 1e-4 < gap < 0.5


def test_heaviest_chain_against_brute_force():
    rng = np.random.default_rng(3)
    for _ in range(30):
        n = int(rng.integers(1, 8))
        xs = rng.integers(0, 6, n)
        ys = rng.integers(0, 6, n)
        w = rng.random(n)
        total, chain = records.heaviest_chain(xs, ys, w)
        best = 0.0
        for r in range(1, n + 1):
            for sub in itertools.combinations(range(n), r):
                s = sorted(sub, key=lambda i: xs[i])
                if all(xs[a] < xs[b] and ys[a] < ys[b] for a, b in zip(s, s[1:])):
                    best = max(best, float(w[list(sub)].sum()))
        assert total == pytest.approx(best)
        c = list(chain)
        assert all(xs[a] < xs[b] and ys[a] < ys[b] for a, b in zip(c, c[1:]))


def test_reweight_by_hand():
    # x0 pairs with y0 at 0.9 and y1 at 0.05; y1 is otherwise unaligned
    xs, ys = np.array([0, 0]), np.array([0, 1])
    probs = np.array([9_000_000, 500_000])
    w = records.reweight(xs, ys, probs, 1, 2, 0.5)
    # indelX[0] = 1 - 0.95 = 0.05; indelY = [0.1, 0.95]
    assert w.tolist() == [9_000_000 - int(0.5 * (500_000 + 1_000_000)),
                          500_000 - int(0.5 * (500_000 + 9_500_000))]


def test_equalised_model_and_m_step():
    kind = hmm.StateMachineType.fiveState
    m = hmm.Hmm(kind)
    m.equalise()
    assert np.allclose(m.transitions.sum(1), 1)
    counts = hmm.Hmm(kind)
    counts.transitions += np.arange(25.0).reshape(5, 5) + 1
    counts.normalise()
    np.testing.assert_allclose(counts.transitions.sum(1), 1)
