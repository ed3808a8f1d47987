"""Structured per-stage timing and throughput counters.

The reference's only observability is leveled logging plus a clock() call
in its long test (SURVEY.md section 5). Here per-stage wall time and
DP-cell counters are first-class: stages accumulate into a process-global
registry and CLIs report on exit (CPECAN_TPU_METRICS=1).

Counterpart of cpecan_tpu/utils/metrics.py without its JAX-only parts:
the jit-cache count and the `jax.profiler` trace.

Usage:
    with metrics.stage("fb_pass"):
        ...device work...
    metrics.add("dp_cells", band.widths.sum())
    metrics.report_lines()  # ["fb_pass: 12 calls 0.84s", "dp_cells: ..."]
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

_lock = threading.Lock()
_times: dict = {}  # name -> [calls, seconds]
_counters: dict = {}  # name -> value


def enabled() -> bool:
    return os.environ.get("CPECAN_TPU_METRICS", "0") != "0"


@contextlib.contextmanager
def stage(name: str):
    """Accumulate wall time for a named stage (always on; reporting is
    opt-in)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            e = _times.setdefault(name, [0, 0.0])
            e[0] += 1
            e[1] += dt


def add(name: str, value) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def reset() -> None:
    with _lock:
        _times.clear()
        _counters.clear()


def snapshot() -> dict:
    with _lock:
        return {
            "stages": {k: {"calls": v[0], "seconds": v[1]}
                       for k, v in _times.items()},
            "counters": dict(_counters),
        }


def report_lines() -> list:
    """Human-readable metric lines, including derived cells/s when both a
    dp_cells counter and an fb stage time exist."""
    snap = snapshot()
    lines = []
    for k, v in sorted(snap["stages"].items()):
        lines.append(f"{k}: {v['calls']} calls {v['seconds']:.3f}s")
    for k, v in sorted(snap["counters"].items()):
        lines.append(f"{k}: {v}")
    cells = snap["counters"].get("dp_cells")
    fb = snap["stages"].get("fb_pass")
    if cells and fb and fb["seconds"] > 0:
        lines.append(f"dp_cells_per_sec: {cells / fb['seconds']:,.0f}")
    return lines
