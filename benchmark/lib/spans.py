"""Arithmetic of the readers of the program's critical-path stages."""

from __future__ import annotations


def fb_host_pct(run):
    """100 x fb_pass's seconds less device_wait's (the host's part of the
    pass: launch inputs, copies, launch wrappers, readback, the sparse
    decode) over the window, or None where either stage never ran."""
    fb, wait = run.stages.get("fb_pass"), run.stages.get("device_wait")
    if fb is None or wait is None:
        return None
    return 100.0 * (fb - wait) / run.window["window_s"]


def unattributed_pct(run):
    """100 x the window's seconds that the main thread spent outside
    every program stage (the window less the staged_main_s counter) over
    the window, or None where the program keeps no such counter."""
    staged = run.counters.get("staged_main_s")
    if staged is None:
        return None
    w = run.window["window_s"]
    return 100.0 * max(0.0, w - staged) / w
