"""The control at a size a test run holds: the reference computed in
bfloat16 in the program's place fails the cell's limits, while the
program, on the same inputs, passes them. (On the chip the same
comparison ran at the cells' own sizes: benchmark/control.py, with the
readings in PERF.md.)"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark.lib import harness, spec  # noqa: E402
from test_bench_harness import small_tree  # noqa: E402


def _cell(tmp_path, name, traffic_update):
    base = small_tree(tmp_path)
    if traffic_update:
        mix = next(w["traffic"] for w in spec.benchmark()["workloads"]
                   if w["name"] == name)
        p = base / "traffic" / f"{mix}.json"
        data = json.loads(p.read_text())
        data.update(traffic_update)
        p.write_text(json.dumps(data))
    cell = spec.Cell(name, bench=spec.load_json(tmp_path / "BENCHMARK.json"),
                     base=base)
    cell.workload["check"]["records"] = 1000
    return cell


@pytest.mark.parametrize("name,update", [
    # reads long enough for weights near matchGamma to occur
    ("realign-reads", {"records": 24, "reference_bases": 50000,
                       "lengths": {"dist": "lognormal", "median": 600,
                                   "sigma": 0.6, "min": 100, "max": 3000}}),
    ("em-reads", None),
])
def test_the_control_fails_where_the_program_passes(tmp_path, name, update):
    cell = _cell(tmp_path, name, update)
    box = {}
    result = harness.run_cell(cell, 1, 0.3, False, device="cpu",
                              prepare=lambda d: box.setdefault("d", d))
    assert result["correct"] is True, result["checks"]
    drv = box["d"]
    checks = drv.control_check(torch.bfloat16)
    assert any(v > lim for _, v, lim in checks), checks
