"""The align CLI on the long-pair cell's kind of traffic, against the
benchmark's reference (benchmark/reference: the frozen anchoring, the
float64 forward-backward of long chunks and cPecanAlign's decode).

Planted orthologous pairs of the cell's divergence (traffic
pairs-500kb, cut to 0.6-1 kb) go through ``cli/align.main`` on the CPU:
unstreamed, and streamed (CPECAN_TPU_STREAM_BUDGET=1) through the exact
engine and through the burn-in-parallel engine, with the default model
and with a seeded random one through --loadHmm. Each written cigar must
carry its pair's header, and its chain must weigh, under the reference's
weights, what the reference's own decode allows (the cell's chain_gap at
0). Also: the frozen anchoring equals the port's ``get_anchors`` on such
pairs, and a streamed run opens the stages and counters that the cell's
per-layer metrics read.
"""

import functools
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.lib.common import model_of  # noqa: E402
from benchmark.reference import align_records  # noqa: E402
from benchmark.reference import anchors as ref_anchors  # noqa: E402
from benchmark.reference import cigar as ref_cigar  # noqa: E402
from benchmark.reference import hmm as ref_hmm  # noqa: E402
from benchmark.reference import records as ref_records  # noqa: E402
from benchmark.reference import state_machine as ref_sm  # noqa: E402
from benchmark.traffic import planted  # noqa: E402
from cpecan_tpu_torch.align.anchors import get_anchors  # noqa: E402
from cpecan_tpu_torch.cli import align  # noqa: E402
from cpecan_tpu_torch.config import PairwiseAlignmentParameters  # noqa: E402
from cpecan_tpu_torch.models.hmm import Hmm, StateMachineType  # noqa: E402
from cpecan_tpu_torch.ops import fb_streaming  # noqa: E402
from cpecan_tpu_torch.utils import metrics  # noqa: E402

torch.set_num_threads(1)

BENCH = ROOT / "benchmark"
SETTINGS = json.loads((BENCH / "configs" / "align.json").read_text())["settings"]
TRAFFIC = json.loads((BENCH / "traffic" / "pairs-500kb.json").read_text())


@functools.lru_cache(maxsize=None)
def _pair(seed: int, length: int):
    """(target name, target, query name, query) of one planted pair."""
    traffic = dict(TRAFFIC, records=1,
                   lengths={"dist": "uniform", "low": length, "high": length})
    seqs, (rec,) = planted.generate(traffic, seed)
    return (rec["contig1"], seqs[rec["contig1"]], rec["contig2"],
            seqs[rec["contig2"]])


@functools.lru_cache(maxsize=None)
def _random_hmm(seed: int) -> Hmm:
    """Random transitions that lead back to the match state more often
    than not, and Jukes-Cantor emissions, so that the pair still aligns."""
    hmm = Hmm(StateMachineType.fiveState)
    hmm.randomise(np.random.default_rng(seed))
    hmm.transitions[:, 0] += 3.0
    hmm.set_emissions_to_jukes_cantor(0.03)
    hmm.normalise()
    return hmm


def _model(hmm_seed):
    if hmm_seed is None:
        return ref_sm.state_machine5()
    port = _random_hmm(hmm_seed)
    hmm = ref_hmm.Hmm(ref_hmm.StateMachineType(int(port.type)))
    hmm.transitions = port.transitions.copy()
    hmm.emissions = port.emissions.copy()
    return ref_sm.state_machine_from_hmm(hmm)


@functools.lru_cache(maxsize=None)
def _reference(seed: int, length: int, hmm_seed):
    _, target, _, query = _pair(seed, length)
    (got,) = align_records.weighted_pairs(
        [(target, query)], model_of(_model(hmm_seed)), SETTINGS)
    return got


def _align(tmp_path, seed, length, hmm_seed=None):
    """The CLI's one cigar for the pair, read back."""
    tname, target, qname, query = _pair(seed, length)
    (tmp_path / "t.fa").write_text(f">{tname}\n{target}\n")
    (tmp_path / "q.fa").write_text(f">{qname}\n{query}\n")
    argv = [str(tmp_path / "t.fa"), str(tmp_path / "q.fa"), "--device", "cpu"]
    if hmm_seed is not None:
        _random_hmm(hmm_seed).save(str(tmp_path / "random.hmm"))
        argv += ["--loadHmm", str(tmp_path / "random.hmm")]
    out = io.StringIO()
    assert align.main(argv, stdout=out) == 0
    (pa,) = ref_cigar.cigar_read(io.StringIO(out.getvalue()))
    return pa


def _chain_gap(pa, xs, ys, w) -> float:
    """How far the written chain's reference weight lies outside what a
    correct decode allows (the benchmark's chain_gap for one pair)."""
    table = dict(zip(zip(xs.tolist(), ys.tolist()), w.tolist()))
    gamma = SETTINGS["matchGamma"]
    bx, by = align_records.decode(xs, ys, w, gamma)
    best = sum(table[p] for p in zip(bx.tolist(), by.tolist()))
    hx, hy = align_records.decode(xs, ys, w, gamma - ref_records.JITTER)
    high = sum(table[p] for p in zip(hx.tolist(), hy.tolist()))
    x, y = ref_records.cigar_pairs(pa)
    got = sum(table.get(p, 0.0) for p in zip(x.tolist(), y.tolist()))
    low = best - ref_records.JITTER * len(bx)
    assert best > 0.5 * len(x)  # a real alignment, not an empty one
    return max(0.0, low - got, got - high) / best


CASES = {
    # name: (seed, length, stream engine or None, random HMM seed)
    "unstreamed": (2**31 + 17, 1000, None, None),
    "exact_engine": (2**31 + 17, 1000, "wavefront", None),
    "parallel_engine": (2**31 + 17, 1000, "parallel", None),
    "parallel_engine_second_pair": (2**32 + 5, 600, "parallel", None),
    "exact_engine_random_hmm": (2**31 + 23, 600, "wavefront", 11),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_equals_the_reference(tmp_path, monkeypatch, case):
    seed, length, engine, hmm_seed = CASES[case]
    if engine is not None:
        monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", "1")
        monkeypatch.setenv("CPECAN_TPU_STREAM_ENGINE", engine)
    metrics.reset()
    fb_streaming.LAST_ENGINE = None
    pa = _align(tmp_path, seed, length, hmm_seed)
    streamed = metrics.snapshot()["counters"].get("streamed_chunks", 0)
    if engine is None:
        assert streamed == 0 and fb_streaming.LAST_ENGINE is None
    else:
        assert streamed == 1
        assert fb_streaming.LAST_ENGINE == ("parallel" if engine == "parallel"
                                            else "exact")
    tname, target, qname, query = _pair(seed, length)
    assert (pa.contig1, pa.start1, pa.end1, pa.strand1) == (
        tname, 0, len(target), True)
    assert (pa.contig2, pa.start2, pa.end2, pa.strand2) == (
        qname, 0, len(query), True)
    assert _chain_gap(pa, *_reference(seed, length, hmm_seed)) == 0.0


def test_a_planted_fault_reads_a_chain_gap(tmp_path):
    """The comparison sees a chain moved one base along the target."""
    seed, length = 2**31 + 17, 1000
    pa = _align(tmp_path, seed, length)
    shifted = ref_cigar.PairwiseAlignment(
        pa.contig1, pa.start1, pa.end1, pa.strand1, pa.contig2, pa.start2,
        pa.end2, pa.strand2, pa.score,
        [("D", 1)] + list(pa.operations[:-1])
        + [(pa.operations[-1][0], pa.operations[-1][1] - 1)])
    assert _chain_gap(shifted, *_reference(seed, length, None)) > 1e-2


@pytest.mark.parametrize("seed,length", [(2**31 + 17, 20000), (7, 30000)])
def test_frozen_anchors_equal_get_anchors(seed, length):
    _, target, _, query = _pair(seed, length)
    p = PairwiseAlignmentParameters()
    got = ref_anchors.get_anchors(
        target, query, SETTINGS["constraintDiagonalTrim"],
        SETTINGS["diagonalExpansion"], SETTINGS["anchorMatrixBiggerThanThis"],
        SETTINGS["repeatMaskMatrixBiggerThanThis"])
    want = get_anchors(target, query, p)
    assert len(want) > length // 2
    np.testing.assert_array_equal(got, want)


def test_frozen_anchors_recurse_into_an_unanchored_gap():
    """A gap above anchorMatrixBiggerThanThis is anchored again: the
    copy's recursion agrees with the port's where a 900 bp stretch of
    the query is replaced."""
    _, target, _, query = _pair(2**31 + 17, 6000)
    rng = np.random.default_rng(3)
    query = (query[:2000] + planted._text(planted._bases(rng, 900))
             + query[2900:])
    p = PairwiseAlignmentParameters(anchorMatrixBiggerThanThis=400 * 400)
    got = ref_anchors.get_anchors(target, query, 14, 20, 400 * 400,
                                  p.repeatMaskMatrixBiggerThanThis)
    np.testing.assert_array_equal(got, get_anchors(target, query, p))


def test_a_streamed_run_opens_the_cells_stages_and_counters(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", "1")
    monkeypatch.setenv("CPECAN_TPU_STREAM_ENGINE", "parallel")
    metrics.reset()
    _align(tmp_path, 2**32 + 5, 600)
    snap = metrics.snapshot()
    for stage in ("align_decode", "align_cigar_out", "stream_prep",
                  "stream_readback", "fb_stream", "host_anchoring"):
        assert snap["stages"][stage]["calls"] >= 1, stage
    assert snap["stages"]["align_decode"]["calls"] == 1
    c = snap["counters"]
    assert "dp_cells" not in c  # every chunk streamed
    assert c["stream_cells_launched"] > c["stream_cells_useful"] > 0
