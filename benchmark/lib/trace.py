"""One torch.profiler session over a traced window, reduced in memory.

The session records host activity (the program's stages appear as
ranges: ``stage_ranges`` wraps ``utils.metrics.stage`` so that every
stage also opens a ``record_function`` range of its name) and the
card's. ``reduce`` turns the events into what the per-layer readers and
the result line take: device busy time (the union of the intervals of
every kernel, copy and set on the card), the traced window, device time
by kernel name, and the longest idle gaps named by the innermost host
range open at the gap's middle (the drivers open one around each
entry-point call; the program's stages open theirs). No trace file is written.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import time

import torch

@contextlib.contextmanager
def stage_ranges():
    """Every ``utils.metrics.stage`` of the program also opens a profiler
    range of its name, for the block."""
    from cpecan_tpu_torch.utils import metrics

    original = metrics.stage

    @functools.wraps(original)
    @contextlib.contextmanager
    def stage(name):
        with torch.profiler.record_function(name), original(name):
            yield

    metrics.stage = stage
    try:
        yield
    finally:
        metrics.stage = original


class Session:
    """Start with ``start()``, stop with ``stop()``; then ``reduce()``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None

    def start(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self, top: int = 10) -> dict:
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.t1 - self.t0, top)


def _is_device(e) -> bool:
    """A kernel, copy or set on the card (the profiler also mirrors host
    ranges onto the card's timeline: those are not device work)."""
    return str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()


def reduce_events(events, window_s: float, top: int = 10) -> dict:
    dev, ranges = [], collections.defaultdict(list)
    for e in events:
        if _is_device(e):
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.is_user_annotation() and not str(e.device_type()).endswith("CUDA"):
            ranges[e.start_thread_id()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    dev.sort()
    by_name = collections.Counter()
    busy = 0
    gaps = []
    end = None
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-9
        if end is not None and s > end:
            gaps.append((s - end, (s + end) // 2))
        if end is None or t > end:
            busy += t - max(s, end if end is not None else s)
            end = t
    spans = [r for rs in ranges.values() for r in rs]
    spans.sort()
    starts = [r[0] for r in spans]

    def host_at(t):
        for s, u, name in reversed(spans[:bisect.bisect_right(starts, t)]):
            if u >= t:  # the latest-starting range that holds t
                return name
        return "(no host range)"

    gaps.sort(reverse=True)
    return {
        "busy_s": busy * 1e-9,
        "window_s": window_s,
        "device_span_s": (dev[-1][1] - dev[0][0]) * 1e-9 if dev else 0.0,
        "kernels": dict(by_name),
        "device_ops": [[n, v] for n, v in by_name.most_common(top)],
        "idle_gaps": [[host_at(at), g * 1e-9] for g, at in gaps[:top]],
        "device_events": len(dev),
    }
