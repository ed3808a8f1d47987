"""The long-pair cell on the CPU: a small run of long-pair-500kb prints
the contract line and reads correct; the faults it can have read not
correct; the control fails where the program passes; the reference's
forward-backward of long chunks (reference/fb_long.py) agrees with
fb.py; and BENCHMARK.json, with the cell's entries appended, still meets
the naming rules.

The pairs are cut to 1.5 kb and streamed (CPECAN_TPU_STREAM_BUDGET=1)
through the burn-in-parallel engine that the card runs on the full-size
pairs (CPECAN_TPU_STREAM_ENGINE=parallel; on the CPU the engine's plain
versions).

    python3 -m pytest -q -o addopts="" benchmark/tests
"""

from __future__ import annotations

import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_bench_harness as harness_tests  # noqa: E402
from benchmark.lib import harness, spec  # noqa: E402
from benchmark.lib.common import model_of  # noqa: E402
from benchmark.reference import align_records, fb, fb_long  # noqa: E402
from benchmark.reference import state_machine  # noqa: E402
from benchmark.traffic import planted  # noqa: E402

CELL = "long-pair-500kb"
NEW_METRICS = ("align_decode_pct.align", "align_cigar_out_pct.align",
               "stream_prep_pct.align", "stream_readback_pct.align",
               "fb_stream_pct.align", "anchoring_pct.align",
               "burnin_overhead_pct.align", "launches_per_mb.align",
               "kernel_roofline_pct.align", "device_idle_pct.align",
               "host_prep_pct.align", "prefetch_wait_pct.align",
               "device_wait_pct.align", "unattributed_pct.align")


@pytest.fixture
def streamed(monkeypatch):
    monkeypatch.setenv("CPECAN_TPU_STREAM_BUDGET", "1")
    monkeypatch.setenv("CPECAN_TPU_STREAM_ENGINE", "parallel")


# chain_gap's limit at the cut size: between the program's readings (0)
# and the bfloat16 control's (3.1e-4 and more) on 1.5-5 kb pairs on the
# CPU. The cell's own limit is set from its readings at 500 kb on the
# card, where the control reads far higher.
SMALL_CHAIN_GAP = 1e-4


def _cell(tmp_path, length=1500, records=2) -> spec.Cell:
    base = harness_tests.small_tree(tmp_path)
    p = base / "traffic" / "pairs-500kb.json"
    data = json.loads(p.read_text())
    data.update(records=records,
                lengths={"dist": "uniform", "low": length, "high": length})
    p.write_text(json.dumps(data))
    w = base / "workloads" / f"{CELL}.json"
    data = json.loads(w.read_text())
    data["check"]["limits"]["chain_gap"] = SMALL_CHAIN_GAP
    w.write_text(json.dumps(data))
    return spec.Cell(CELL, bench=spec.load_json(tmp_path / "BENCHMARK.json"),
                     base=base)


def _run(tmp_path, prepare=None):
    return harness.run_cell(_cell(tmp_path), 2**31 + 9, 0.5, False,
                            device="cpu", prepare=prepare)


def test_the_cells_entries_are_appended_and_meet_the_rules():
    harness_tests.test_benchmark_json_meets_the_names_and_units_rules()
    b = spec.benchmark()
    assert b["configs"][-1]["name"] == "align"
    assert b["workloads"][-1] == {
        "name": CELL, "config": "align", "traffic": "pairs-500kb", "chips": 1,
        "why": b["workloads"][-1]["why"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["realign_kb_per_s"]["workloads"][-1] == CELL
    tail = b["per_layer"][-len(NEW_METRICS):]
    assert tuple(m["name"] for m in tail) == NEW_METRICS
    for m in tail:
        assert m["workloads"] == [CELL] and m["moves"] == "realign_kb_per_s"
        assert (ROOT / "benchmark" / "layer_metrics" / f"{m['name']}.py").is_file()
    cell = spec.Cell(CELL)
    assert cell.config["reduced"] == {} and cell.config["argv"] == []
    assert set(cell.workload["check"]["limits"]) == {
        "records_missing", "headers_differ", "chain_gap"}


def test_a_small_run_prints_the_contract_line(tmp_path, streamed, capsys):
    result = _run(tmp_path)
    harness_tests._check_line(result, traced=False)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"realign_kb_per_s", "setup_s"}
    assert set(result["checks"]) == {"records_missing", "headers_differ",
                                     "chain_gap"}
    harness.print_result(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result


def _cigar_writer(change):
    """A stand-in for cli/align's cigar module whose cigar_write passes
    each alignment through change (None: nothing written)."""
    from cpecan_tpu_torch.io import cigar as cigar_io

    def write(fh, pa):
        pa = change(pa)
        if pa is not None:
            cigar_io.cigar_write(fh, pa)

    return types.SimpleNamespace(
        aligned_pairs_to_alignment=cigar_io.aligned_pairs_to_alignment,
        cigar_write=write)


def _dropped_pair(monkeypatch):
    from cpecan_tpu_torch.cli import align

    monkeypatch.setattr(align, "cigar_io", _cigar_writer(lambda pa: None))


def _wrong_header(monkeypatch):
    from cpecan_tpu_torch.cli import align

    monkeypatch.setattr(align, "cigar_io", _cigar_writer(
        lambda pa: dataclasses.replace(pa, contig2=pa.contig1)))


def _posterior_shifted_in_one_window(monkeypatch):
    """In the first window of each window batch, every match posterior
    the burn-in engine reads out moved to the next cell it reads out (the
    next one along the diagonal, or the next diagonal's first)."""
    from cpecan_tpu_torch.ops import fb_parallel

    original = fb_parallel._run_slice

    def shifted(*args):
        entries = args[-1]
        before = len(entries["post_match"])
        original(*args)
        vals, ks, js = entries["post_match"][before]
        k0 = int(args[12][0])  # the batch's first window's first row
        inside = (ks >= k0) & (ks < k0 + args[14])
        vals = vals.clone()
        vals[inside] = torch.roll(vals[inside], 1)
        entries["post_match"][before] = (vals, ks, js)

    monkeypatch.setattr(fb_parallel, "_run_slice", shifted)


@pytest.mark.parametrize("plant", [_dropped_pair, _wrong_header,
                                   _posterior_shifted_in_one_window])
def test_faults_are_caught(tmp_path, streamed, monkeypatch, plant):
    plant(monkeypatch)
    result = _run(tmp_path)
    assert result["correct"] is False, result["checks"]


def test_the_control_fails_where_the_program_passes(tmp_path, streamed):
    box = {}
    result = _run(tmp_path, prepare=lambda d: box.setdefault("d", d))
    assert result["correct"] is True, result["checks"]
    checks = box["d"].control_check(torch.bfloat16)
    assert any(v > lim for _, v, lim in checks), checks


def _chunks(seed, lengths):
    rng = np.random.default_rng(seed)
    settings = spec.Cell(CELL).config["settings"]
    out = []
    for n in lengths:
        x = planted.genomic_like(rng, n)
        y, _ = planted.evolve(rng, x, 0.02, 0.003, 0.003, 10)
        out += align_records.pair_chunks(planted._text(x), planted._text(y),
                                         dict(settings,
                                              anchorMatrixBiggerThanThis=0))
    return out


@pytest.mark.parametrize("lengths,cell_budget", [
    ((200,), 1 << 26),  # one block of diagonals and a short one
    ((140, 300, 90), 1 << 26),  # a batch of unequal chunks
    ((140, 300, 90), 1),  # each chunk alone
])
def test_fb_long_equals_fb_on_small_chunks(lengths, cell_budget):
    chunks = _chunks(len(lengths) + cell_budget, lengths)
    model = model_of(state_machine.state_machine5())
    want = fb.posteriors(chunks, model)
    got = fb_long.posteriors(chunks, model, cell_budget=cell_budget)
    for (x0, y0, p0), (x1, y1, p1) in zip(want, got):
        a, b = np.lexsort((y0, x0)), np.lexsort((y1, x1))
        np.testing.assert_array_equal(x1[b], x0[a])
        np.testing.assert_array_equal(y1[b], y0[a])
        np.testing.assert_allclose(p1[b], p0[a], rtol=1e-12, atol=1e-15)


def test_fb_long_keeps_only_cells_at_the_threshold():
    chunks = _chunks(5, (300,))
    model = model_of(state_machine.state_machine5())
    (x, y, p), = fb_long.posteriors(chunks, model)
    (xt, yt, pt), = fb_long.posteriors(chunks, model, threshold=0.01)
    keep = p >= 0.01
    assert 0 < keep.sum() < len(p)
    np.testing.assert_array_equal(xt, x[keep])
    np.testing.assert_array_equal(pt, p[keep])
