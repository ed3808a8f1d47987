"""The readers of the program's critical-path stages, on a fake run: each
returns its share of the window, and None where its stage or counter is
absent (as on a program that does not open it).

    python3 -m pytest -q benchmark/tests
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import spec  # noqa: E402

STAGES = {"cigar_in": 2.0, "prefetch_wait": 0.5, "decode": 1.0,
          "cigar_out": 3.0, "device_wait": 1.5, "fb_pass": 4.0,
          "em_split": 0.25, "em_counts": 0.75, "em_mstep": 0.1}

# metric, cell, expected share of a 10 s window, what its absence removes
CASES = [
    ("cigar_in_pct.realign", "realign-reads", 20.0, "cigar_in"),
    ("prefetch_wait_pct.realign", "realign-reads", 5.0, "prefetch_wait"),
    ("decode_pct.realign", "realign-reads", 10.0, "decode"),
    ("cigar_out_pct.realign", "realign-reads", 30.0, "cigar_out"),
    ("device_wait_pct.realign", "realign-reads", 15.0, "device_wait"),
    ("fb_host_pct.realign", "realign-reads", 25.0, "device_wait"),
    ("unattributed_pct.realign", "realign-reads", 20.0, "staged_main_s"),
    ("em_split_pct.em", "em-reads", 2.5, "em_split"),
    ("em_counts_pct.em", "em-reads", 7.5, "em_counts"),
    ("em_mstep_pct.em", "em-reads", 1.0, "em_mstep"),
    ("device_wait_pct.em", "em-reads", 15.0, "device_wait"),
    ("fb_host_pct.em", "em-reads", 25.0, "fb_pass"),
    ("unattributed_pct.em", "em-reads", 20.0, "staged_main_s"),
]


def _run(cell, without=None):
    return types.SimpleNamespace(
        cell=cell,
        stages={k: v for k, v in STAGES.items() if k != without},
        counters={k: v for k, v in {"staged_main_s": 8.0,
                                    "dp_cells": 10}.items() if k != without},
        window={"window_s": 10.0, "query_bases": 1_000_000})


@pytest.mark.parametrize("name,cell_name,share,absent", CASES,
                         ids=[c[0] for c in CASES])
def test_a_span_reader_reads_its_share_and_none_without_it(
        name, cell_name, share, absent):
    cell = spec.Cell(cell_name)
    assert name in {m["name"] for m in cell.per_layer}
    reader = cell.reader("layer_metrics", name)
    assert reader.read(_run(cell)) == pytest.approx(share)
    assert reader.read(_run(cell, without=absent)) is None


def test_unattributed_share_is_never_negative():
    cell = spec.Cell("realign-reads")
    run = _run(cell)
    run.counters["staged_main_s"] = 10.5  # a stage opened before the window
    assert cell.reader("layer_metrics",
                       "unattributed_pct.realign").read(run) == 0.0
