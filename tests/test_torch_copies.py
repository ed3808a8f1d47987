"""The port's own copies of cpecan_tpu's host-side modules against their
originals: the same seeded inputs through both, equal outputs (exact:
these are integer and float64 host paths, and the HMM file text must be
byte-identical). The posterior pairs the decoders take come from the
port's CPU engine and go to both packages unchanged."""

import io
import random

import numpy as np
import pytest
import torch

import cpecan_tpu.align.anchors as j_anchors
import cpecan_tpu.align.split as j_split
import cpecan_tpu.io.cigar as j_cigar
import cpecan_tpu.models.hmm as j_hmm
import cpecan_tpu.models.state_machine as j_sm
import cpecan_tpu.msa.aligner as j_aligner
import cpecan_tpu.ops.band as j_band
import cpecan_tpu.ops.mea as j_mea
import cpecan_tpu.ops.pairs as j_pairs
import cpecan_tpu.utils.symbols as j_symbols
import cpecan_tpu_torch.align.anchors as t_anchors
import cpecan_tpu_torch.align.split as t_split
import cpecan_tpu_torch.io.cigar as t_cigar
import cpecan_tpu_torch.models.hmm as t_hmm
import cpecan_tpu_torch.models.state_machine as t_sm
import cpecan_tpu_torch.msa.aligner as t_aligner
import cpecan_tpu_torch.ops.band as t_band
import cpecan_tpu_torch.ops.mea as t_mea
import cpecan_tpu_torch.ops.pairs as t_pairs
import cpecan_tpu_torch.utils.symbols as t_symbols
from cpecan_tpu.config import PairwiseAlignmentParameters

torch.set_num_threads(1)


def _pair(seed=5, n=300):
    rng = random.Random(seed)
    x = j_symbols.get_random_sequence(n, rng).upper()
    return x, j_symbols.evolve_sequence(x, rng).upper()


def _cigar():
    x, y = _pair()
    m1 = min(len(x), len(y)) - 40
    r = len(y) - m1 - 14  # M and INDEL_Y consume y, M and INDEL_X x
    tail = len(x) - (m1 + 17 + r)
    assert tail > 0
    ops = [(j_cigar.MATCH, m1), (j_cigar.INDEL_X, 7), (j_cigar.MATCH, 10),
           (j_cigar.INDEL_Y, 4), (j_cigar.MATCH, r), (j_cigar.INDEL_X, tail)]
    return (f"cigar: y 0 {len(y)} + x 0 {len(x)} + 3.5 "
            + " ".join(f"{op} {n}" for op, n in ops) + "\n")


def _posteriors():
    """(match, gap_x, gap_y) pair arrays of one evolved pair, from the
    port's CPU engine."""
    from cpecan_tpu_torch.align import batch

    x, y = _pair(seed=9, n=120)
    params = PairwiseAlignmentParameters()
    anchors = t_anchors.get_anchors(x, y, params)
    match, gx, gy = batch.batch_posteriors(
        t_sm.state_machine5(), [(x, y, anchors, False, False)], params,
        mode="posterior_all", device="cpu")[0]
    return x, y, match, gx, gy


def _band():
    x, y = _pair()
    anchors = [(i, i + (i // 50)) for i in range(10, min(len(x), len(y)) - 10, 13)]
    for mod in (j_band, t_band):
        band = mod.construct_band(anchors, len(x), len(y), 6)
        yield (band.offsets, band.widths, band.diagonal_number,
               band.frame_width(), *mod.pad_band(band, 1024, 64),
               mod.full_band(17, 23).widths)


def _cigar_io():
    text = _cigar()
    for mod in (j_cigar, t_cigar):
        pa = next(mod.cigar_read(io.StringIO(text)))
        buf = io.StringIO()
        mod.cigar_write(buf, pa)
        yield buf.getvalue(), mod.alignment_to_anchor_pairs(pa, 3, 5)


def _hmm_text(hmm_type):
    def run():
        for mod in (j_hmm, t_hmm):
            h = mod.Hmm(mod.StateMachineType[hmm_type])
            h.randomise(np.random.default_rng(11))
            h.running_likelihoods = [-3.25, -1.5]
            out = []
            for precise in (False, True):
                buf = io.StringIO()
                h.write(buf, precise=precise)
                out.append(buf.getvalue())
            back = mod.Hmm.loads(out[1])
            yield (*out, back.transitions, back.emissions, h.to_json())
    return run


def _state_machines():
    for mod in (j_sm, t_sm):
        h = mod.Hmm(mod.StateMachineType.threeStateAsymmetric)
        h.randomise(np.random.default_rng(2))
        sms = (mod.state_machine5(), mod.state_machine3(),
               mod.state_machine_from_hmm(h))
        yield [getattr(sm, f) for sm in sms
               for f in ("t_x", "t_m", "t_y", "em_match", "em_gap_x",
                         "start", "ragged_end")]


def _anchors():
    x, y = _pair(seed=3, n=2500)
    p = PairwiseAlignmentParameters()
    for mod in (j_anchors, t_anchors):
        yield mod.get_anchors(x, y, p)


def _split():
    x, y = _pair(seed=3, n=2500)
    anchors = j_anchors.get_anchors(x, y, PairwiseAlignmentParameters())
    for mod in (j_split, t_split):
        points = mod.get_split_points(anchors, len(x), len(y), 40 * 40,
                                      True, False)
        yield points, [(rect, np.asarray(a)) for rect, a in
                       mod.split_anchors(anchors, points)]


def _mea():
    x, y, match, gx, gy = _posteriors()
    match = match[np.lexsort((match["x"], match["x"] + match["y"]))]
    for mod in (j_mea, t_mea):
        alignment, score = mod.mea_alignment(match, gx, gy, len(x), len(y), 0.5)
        yield alignment, score, mod.left_shift_alignment(alignment, x, y)


def _poset_filter(native):
    def run(monkeypatch):
        if not native:
            monkeypatch.setenv("CPECAN_TPU_NATIVE", "0")
        x, y, match, _, _ = _posteriors()
        for mod, pmod in ((j_aligner, j_pairs), (t_aligner, t_pairs)):
            aligned = pmod.reweight_aligned_pairs(match, len(x), len(y), 0.5)
            yield mod.filter_pairwise_alignment_to_make_pairs_ordered(
                aligned, x, y, 0.85)
    return run


def _pair_scores():
    x, y, match, _, _ = _posteriors()
    for mod in (j_pairs, t_pairs):
        aligned = mod.reweight_aligned_pairs(match, len(x), len(y), 0.5)
        yield (aligned, mod.sort_pairs(aligned),
               mod.score_by_identity(x, y, aligned),
               mod.score_by_identity_ignoring_gaps(x, y, aligned),
               mod.score_by_posterior_probability(len(x), len(y), aligned),
               mod.score_by_posterior_probability_ignoring_gaps(aligned))


def _symbols():
    x, _ = _pair()
    for mod in (j_symbols, t_symbols):
        yield mod.encode(x + "Nn"), mod.reverse_complement(x)


def _bench_cells_c():
    """The C comparator of the port's bench: a byte-for-byte copy."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    for path in ("native/bench_cells.c",
                 "cpecan_tpu_torch/csrc/host/bench_cells.c"):
        yield (repo / path).read_bytes()


CASES = {
    "band": _band,
    "bench_cells_c": _bench_cells_c,
    "cigar_io": _cigar_io,
    "hmm_text_five_state": _hmm_text("fiveState"),
    "hmm_text_three_state": _hmm_text("threeState"),
    "state_machines": _state_machines,
    "anchors": _anchors,
    "split_anchors": _split,
    "mea": _mea,
    "poset_filter_native": _poset_filter(True),
    "poset_filter_python": _poset_filter(False),
    "pair_scores": _pair_scores,
    "symbols": _symbols,
}


def _assert_same(a, b, where="out"):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case, monkeypatch):
    fn = CASES[case]
    run = fn(monkeypatch) if case.startswith("poset_filter") else fn()
    original, copy = list(run)
    _assert_same(copy, original)
