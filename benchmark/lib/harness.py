"""One run of one cell: set-up, the measured window, the readers, the
check against the reference, the result line.

``run_cell`` takes the device and whether to look for a chip, so that
tests can drive everything but the chip on the CPU; ``run.py`` is the
command that runs it on the card.
"""

from __future__ import annotations

import gc
import json
import sys
import time
import types

import numpy as np
import torch

from benchmark.lib import spec
from benchmark.lib import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "cpecan_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        import os

        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(chips: int, device: str) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", prepare=None) -> dict:
    """Run a cell once and return its result line (a dict). ``prepare``,
    given, is called with the driver after set-up (tests plant faults
    there)."""
    from cpecan_tpu_torch.ops import fb_wavefront
    from cpecan_tpu_torch.utils import metrics

    on_card = torch.device(device).type == "cuda"
    drv = cell.driver().Driver(cell, seed, device)
    drv.setup()
    if prepare is not None:
        prepare(drv)
    if on_card:
        torch.cuda.synchronize()
        for i in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(i)
    setup_s = process_age()
    metrics.reset()
    fb_wavefront.reset_launch_counts()
    session = trace_mod.Session() if trace else None
    if session is not None:
        with trace_mod.stage_ranges():
            session.start()
            window = drv.window(seconds)
            session.stop()
    else:
        window = drv.window(seconds)
    snap = metrics.snapshot()
    launches = dict(fb_wavefront.LAUNCHES)
    device_out = device_info(cell.chips, device)
    traced = session.reduce() if session is not None else None
    session = None
    run = types.SimpleNamespace(
        cell=cell, driver=drv, setup_s=setup_s, window=window,
        stages={k: v["seconds"] for k, v in snap["stages"].items()},
        counters=snap["counters"], launches=launches, trace=traced,
        device=device_out, peaks=spec.peaks(device_out["kind"]))
    wanted = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in wanted:
        kind = "layer_metrics" if trace else "end_to_end"
        v = cell.reader(kind, m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # the program's state goes before the reference runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = drv.check()
    drv.release()
    print(f"times: setup {setup_s:.2f} s, window {window['window_s']:.2f} s, "
          f"check {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    correct = all(np.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct),
              "attempted": int(getattr(drv, "attempted", 0)),
              "failed": int(drv.failed), "metrics": values,
              "device": device_out}
    if traced is not None:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def print_result(result: dict) -> None:
    """The compared numbers on standard error, then the result line; a
    number that is not finite prints as null."""
    for c in result["checks"].values():
        if not np.isfinite(c["value"]):
            c["value"] = None
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
