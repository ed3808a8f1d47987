"""Structured per-stage timing and throughput counters.

The reference's only observability is leveled logging plus a clock() call
in its long test (SURVEY.md section 5). Here per-stage wall time and
DP-cell counters are first-class: stages accumulate into a process-global
registry, CLIs report on exit (CPECAN_TPU_METRICS=1), and `trace()` wraps
`torch.profiler` for host and device profiles.

Counterpart of cpecan_tpu/utils/metrics.py. Its jit-cache count, an
early warning of shape drift, has no counterpart (the port compiles its
kernels once); the kernel launch counts take its place in report_lines.

The stages the program opens, by the thread they run on:

- realign CLI (``cli/realign.py``, main thread): ``cigar_in`` (read and
  parse one group's cigar lines; on a pipe, also the wait for the
  writer), ``prefetch_wait`` (blocked on the worker's prepared group;
  ``utils/pipeline.prefetch_map``, so the align CLI's too), then per
  record ``decode`` (reweight and poset filter, or MEA and left
  shift, and the ``--rescore*`` scores) and ``cigar_out`` (build, check,
  split and write the cigar, and the ``--output*PosteriorProbs`` dumps);
- EM loop (``em/em.py``, main thread): ``em_split`` (split and sample
  the corpus), ``em_tasks`` (a chunk's tasks), ``em_counts`` (counts and
  likelihood of a bucket or streamed task), ``em_mstep`` (maximisation
  and the model file);
- batch (``align/batch.py``, ``em/em.py``, ``align/pairwise.py``; the
  caller's thread): ``host_prep`` (bands, buckets, EM's launch inputs;
  once a batch or bucket), ``fb_pass`` (the copies, launches, readback
  and sparse decode; in ``align/batch.py`` also the launch inputs, the
  model's copy and the per-job pair arrays), ``fb_stream`` (a long chunk
  through a streaming engine), ``device_wait`` (inside ``fb_pass``, and
  in ``ops/fb_parallel.py`` once a window batch; CUDA only: the host
  blocked until the card has run what it queued);
- streaming (inside ``fb_stream``, the parallel engine's alone):
  ``stream_prep`` (the host's time in a window batch's
  ``precompute_window``, which queues the row and slot kernels' window
  forms; their device time is in the trace) and ``stream_readback`` (a
  streamed chunk's posterior entries copied back, and their conversion
  to pairs in ``align/batch.py``);
- align CLI (``cli/align.py``, main thread, once a pair): ``align_decode``
  (reweight, poset filter and sort) and ``align_cigar_out`` (build and
  write the cigar);
- ``host_anchoring`` (``align/anchors.py``) and ``msa_merge``
  (``msa/aligner.py``), on the caller's thread.

The prefetch worker's ``prepare`` opens no stage. Counters: ``dp_cells``
(the cells of batch launches; streamed chunks count in
``stream_cells_useful``), ``streamed_chunks``, ``stream_windows``,
``stream_cells_launched`` (the cells of every window batch's grid in the
parallel engine, windows x rows x width, as its stream prep is made),
``stream_cells_useful`` (the streamed chunks' band cells, either
engine), ``native_bands`` (bands built by the native builder,
``ops/band.construct_bands``; 0 on the numpy
fallback), and ``staged_main_s``: the
seconds the main thread spent inside at least one stage since
``reset()`` (nested stages once, other threads' stages not at all), so
that a window less ``staged_main_s`` is the main thread's time that no
stage names.

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

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from cpecan_tpu_torch.ops import fb_wavefront

_lock = threading.Lock()
_times: dict = {}  # name -> [calls, seconds]
_counters: dict = {}  # name -> value
_local = threading.local()  # .depth: stages open on this thread


def enabled() -> bool:
    return os.environ.get("CPECAN_TPU_METRICS", "0") != "0"


@contextlib.contextmanager
def stage(name: str):
    """Accumulate wall time for a named stage (always on; reporting is
    opt-in). The outermost stage on the main thread also adds its time to
    the ``staged_main_s`` counter."""
    depth = getattr(_local, "depth", 0)
    _local.depth = depth + 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _local.depth = depth
        outermost = (depth == 0 and threading.current_thread()
                     is threading.main_thread())
        with _lock:
            e = _times.setdefault(name, [0, 0.0])
            e[0] += 1
            e[1] += dt
            if outermost:
                _counters["staged_main_s"] = (
                    _counters.get("staged_main_s", 0.0) + dt)


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
    cells = (snap["counters"].get("dp_cells", 0)
             + snap["counters"].get("stream_cells_useful", 0))
    fb = snap["stages"].get("fb_pass")
    if cells and fb and fb["seconds"] > 0:
        lines.append(f"dp_cells_per_sec: {cells / fb['seconds']:,.0f}")
    lines.append("kernel_launches: " + " ".join(
        f"{k}={v}" for k, v in fb_wavefront.LAUNCHES.items()))
    return lines


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the enclosed block: host activity, and the
    card's when CUDA is available, written to log_dir as a Chrome /
    TensorBoard trace (``*.pt.trace.json``); the counterpart of
    jax.profiler.trace."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
