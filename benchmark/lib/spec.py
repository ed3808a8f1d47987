"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one cell, configuration, traffic mix or
metric lives in a file of its own under ``benchmark/``, found by name:

- ``configs/<config>.json``: the deployment (settings, source, cuts,
  guarantees, the driver that runs it, the passes its kernels make);
- ``traffic/<traffic>.json``: the mix, read by the generator it names;
- ``workloads/<cell>.json``: what a cell checks and with what limits;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one
  reader per metric, ``read(run) -> float | None``;
- ``drivers/<driver>.py``: one driver per entry point;
- ``roofline/<pass>.py``: one cost per kernel pass.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with everything its files say."""

    def __init__(self, name: str, bench: dict | None = None,
                 base: Path = BENCH):
        bench = benchmark() if bench is None else bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if len(found) != 1:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.base = base
        self.chips = int(self.entry["chips"])
        cfgs = [c for c in bench["configs"] if c["name"] == self.entry["config"]]
        if len(cfgs) != 1:
            raise KeyError(f"no config {self.entry['config']!r}")
        self.config = load_json(base.parent / cfgs[0]["file"])
        self.traffic = load_json(base / "traffic" / f"{self.entry['traffic']}.json")
        self.workload = load_json(base / "workloads" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self._in(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._in(m)]

    def _in(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def driver(self):
        return _module(self.base / "drivers" / f"{self.config['driver']}.py",
                       f"bench_driver_{self.config['driver']}")

    def generator(self):
        return _module(self.base / "traffic" / f"{self.traffic['generator']}.py",
                       f"bench_traffic_{self.traffic['generator']}")

    def reader(self, kind: str, metric: str):
        return _module(self.base / kind / f"{metric}.py",
                       f"bench_{kind}_{metric.replace('.', '_')}")

    def roofline(self, pass_name: str):
        return _module(self.base / "roofline" / f"{pass_name}.py",
                       f"bench_roofline_{pass_name}")


def peaks(kind: str) -> dict | None:
    """The published peaks of a device by its name, or None."""
    table = load_json(BENCH / "roofline" / "peaks.json")
    return table.get(kind)
