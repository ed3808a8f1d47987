"""Arithmetic the per-layer readers share."""

from __future__ import annotations

import numpy as np

# the launch counters of ops/fb_wavefront.LAUNCHES that count launches;
# wide_* and cluster_* sort some of the same launches again
LAUNCH_KEYS = ("fwd", "bwd", "exp", "seg_fwd", "seg_bwd", "seg_exp",
               "par_fwd", "par_bwd", "prep", "rows")


def stage_share(run, stage: str):
    """100 x a program stage's seconds in the window over the window, or
    None where the stage never ran."""
    s = run.stages.get(stage)
    if s is None:
        return None
    return 100.0 * s / run.window["window_s"]


def launches_per_mb(run):
    n = sum(run.launches.get(k, 0) for k in LAUNCH_KEYS)
    mb = run.window["query_bases"] / 1e6
    return n / mb if n and mb > 0 else None


def device_idle_pct(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def useful_cells(run) -> int:
    w = run.window
    if "record_index" in w:
        return run.driver.useful_cells(w["record_index"])
    return run.driver.useful_cells(w["iterations"])


def kernel_roofline_pct(run):
    """100 x the least time the window's work needs on the device (the
    useful band cells times each pass's bytes and fp32 operations per
    cell, against the published peaks) over the traced device time of
    the program's wavefront kernels."""
    t, pk = run.trace, run.peaks
    if t is None or pk is None:
        return None
    kernel_s = sum(v for k, v in t["kernels"].items() if "wavefront_" in k)
    if kernel_s <= 0:
        return None
    from benchmark.reference import state_machine

    sm = state_machine.state_machine5()
    nz = int(sum(np.isfinite(a).sum() for a in (sm.t_x, sm.t_m, sm.t_y)))
    cells = useful_cells(run)
    least = 0.0
    for p in run.cell.config["passes"]:
        nbytes, flops = run.cell.roofline(p).cost(sm.state_number, nz)
        least += cells * max(nbytes / pk["hbm_bytes_per_s"],
                             flops / pk["fp32_flops_per_s"])
    return 100.0 * least / kernel_s
