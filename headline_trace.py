"""Device-time breakdown of the headline's fb_pass_batch on the card.

    python3 headline_trace.py [--passes 3] [--out DIR]

Builds the port's bench headline batch (cpecan_tpu_torch.bench.build_batch
on seed 0: B=256 anchored 1 kb pairs, W=128, the 5-state model), runs two
warm-up passes of fb_batch.fb_pass_batch in posterior_match mode, then
traces --passes passes with cpecan_tpu_torch.utils.metrics.trace, each
pass ended by torch.cuda.synchronize(). The parts of a pass are marked
in this process only, by wrapping fb_wavefront.prep_rows, streams, fwd
and bwd in torch.profiler.record_function ranges; the path's code is the
same.

Prints, as a mean per pass: each device kernel's time by part (rows: the
row part of the stream prep, the kernel wavefront_rows; streams: its
slot part, the kernel wavefront_prep; fwd and bwd: the wrappers, the
kernel and whatever they allocate; rest: the pass's other ops) and by the
outermost aten op that launched it; the device's idle gaps inside the
pass; the bytes the caching allocator handed out in a pass and in one
precompute call beside the bytes precompute returns, with those bytes'
bound at 3.35 TB/s. Writes the same as JSON to DIR/headline_trace.json
beside the trace (``*.pt.trace.json``). Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PARTS = ("rows", "streams", "fwd", "bwd")
WRAPPED = {"prep_rows": "rows", "streams": "streams", "fwd": "fwd",
           "bwd": "bwd"}
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def marked_parts():
    """fb_wavefront's prep_rows, streams, fwd and bwd, each wrapped in a
    record_function range named after its part, for the block."""
    from cpecan_tpu_torch.ops import fb_wavefront

    originals = {name: getattr(fb_wavefront, name) for name in WRAPPED}

    def marked(fn, part):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with torch.profiler.record_function(part):
                return fn(*args, **kwargs)
        return call

    for name, part in WRAPPED.items():
        setattr(fb_wavefront, name, marked(originals[name], part))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(fb_wavefront, name, fn)


def _enclosing(spans, starts, t):
    """The spans (ts, end, name) of one thread that contain time t,
    outermost first."""
    i = bisect.bisect_right(starts, t)
    return [s for s in spans[:i] if s[1] >= t]


def breakdown(events: list, passes: int) -> dict:
    """The per-pass breakdown of a torch.profiler trace's events: device
    time by part and by (part, op, kernel), launches, idle gaps."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation"):
            by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"],
                                     e["cat"]))
    index = {}
    for tid, spans in by_tid.items():
        spans.sort()
        index[tid] = (spans, [s[0] for s in spans])

    rows = collections.defaultdict(lambda: [0.0, 0])
    parts = collections.defaultdict(lambda: [0.0, 0])
    per_pass = collections.defaultdict(list)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        spans, starts = index.get(launch["tid"], ([], []))
        around = _enclosing(spans, starts, launch["ts"])
        names = [s[2] for s in around if s[3] == "user_annotation"]
        pass_names = [n for n in names if n.startswith("pass ")]
        if not pass_names:
            continue
        part = next((n for n in reversed(names) if n in PARTS), "rest")
        ops = [s[2] for s in around if s[3] == "cpu_op"]
        op = ops[0] if ops else "(no aten op)"
        kernel = e["name"] if len(e["name"]) <= 80 else e["name"][:77] + "..."
        rows[(part, op, kernel)][0] += e["dur"]
        rows[(part, op, kernel)][1] += 1
        parts[part][0] += e["dur"]
        parts[part][1] += 1
        per_pass[pass_names[0]].append((e["ts"], e["ts"] + e["dur"], kernel))

    gaps, spans_us, busy_us = [], [], []
    for name, evs in sorted(per_pass.items()):
        evs.sort()
        busy, end, last = 0.0, evs[0][0], None
        for ts, te, kernel in evs:
            if ts > end and last is not None:
                gaps.append({"pass": name, "us": ts - end, "after": last,
                             "before": kernel})
            busy += max(0.0, te - max(ts, end))
            end = max(end, te)
            last = kernel
        spans_us.append(end - evs[0][0])
        busy_us.append(busy)
    gaps.sort(key=lambda g: -g["us"])
    return {
        "passes": passes,
        "parts": {p: {"us": v[0] / passes, "launches": v[1] / passes}
                  for p, v in sorted(parts.items(), key=lambda kv: -kv[1][0])},
        "kernels": [{"part": k[0], "op": k[1], "kernel": k[2],
                     "us": v[0] / passes, "launches": v[1] / passes}
                    for k, v in sorted(rows.items(), key=lambda kv: -kv[1][0])],
        "device_span_us": float(np.mean(spans_us)),
        "device_busy_us": float(np.mean(busy_us)),
        "idle_us": float(np.mean(spans_us) - np.mean(busy_us)),
        "gaps_total_per_pass_us": sum(g["us"] for g in gaps) / passes,
        "largest_gaps": gaps[:12],
    }


def _allocated() -> int:
    return torch.cuda.memory_stats()["allocated_bytes.all.allocated"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", default="build/headline_trace",
                    help="directory of the trace and headline_trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("headline_trace.py needs a CUDA device", file=sys.stderr)
        return 1

    from cpecan_tpu_torch import bench
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_batch, fb_wavefront
    from cpecan_tpu_torch.utils import metrics

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    hmm = PairHMM.from_state_machine(state_machine5()).to(dev)
    sx, sy, offsets, widths, lx, ly, W, cells = bench.build_batch(
        np.random.default_rng(0))
    rl = np.zeros(len(lx), bool)
    batch = [torch.from_numpy(a).to(dev)
             for a in (sx, sy, offsets, widths, lx, ly, rl, rl.copy())]

    def one_pass():
        return fb_batch.fb_pass_batch(hmm, *batch, mode="posterior_match",
                                      width=W)

    for _ in range(2):
        one_pass()
    torch.cuda.synchronize()

    # the stream prep alone: bytes handed out against bytes returned
    a0 = _allocated()
    pre = fb_wavefront.precompute(hmm, *batch, width=W)
    torch.cuda.synchronize()
    prep_alloc = _allocated() - a0
    prep_out = sum(v.nbytes for v in pre.values() if torch.is_tensor(v))
    del pre

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    before = set(out.glob("*.pt.trace.json"))
    a0 = _allocated()
    with marked_parts(), metrics.trace(str(out)):
        for i in range(args.passes):
            with torch.profiler.record_function(f"pass {i}"):
                one_pass()
                torch.cuda.synchronize()
    pass_alloc = (_allocated() - a0) / args.passes
    (trace,) = set(out.glob("*.pt.trace.json")) - before
    events = json.loads(trace.read_text())["traceEvents"]
    walls = [e["dur"] for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("pass ")]

    result = breakdown(events, args.passes)
    result.update(
        card=smi, batch=len(lx), width=W, diagonals=int(offsets.shape[1]),
        cells=cells, trace=trace.name,
        host_pass_us=float(np.mean(walls)),
        allocated_bytes_per_pass=pass_alloc,
        prep_allocated_bytes=prep_alloc, prep_output_bytes=prep_out,
        prep_bound_us=prep_out / HBM_BYTES_PER_S * 1e6)
    (out / "headline_trace.json").write_text(json.dumps(result, indent=1) + "\n")

    print(smi)
    print(f"headline batch B={len(lx)} W={W} diagonals={offsets.shape[1]}; "
          f"{args.passes} traced passes; means per pass:")
    print(f"  host wall {result['host_pass_us']:.1f} us; device span "
          f"{result['device_span_us']:.1f} us, busy "
          f"{result['device_busy_us']:.1f} us, idle {result['idle_us']:.1f} us")
    for p, v in result["parts"].items():
        print(f"  part {p:8s} {v['us']:10.1f} us  {v['launches']:6.1f} launches")
    for k in result["kernels"]:
        print(f"  {k['part']:8s} {k['us']:10.1f} us x{k['launches']:5.1f}  "
              f"{k['op']:28s} {k['kernel']}")
    for g in result["largest_gaps"]:
        print(f"  gap {g['us']:8.1f} us in {g['pass']} after {g['after']} "
              f"before {g['before']}")
    print(f"  allocated per pass {pass_alloc / 1e6:.1f} MB; one precompute "
          f"allocates {prep_alloc / 1e6:.1f} MB and returns "
          f"{prep_out / 1e6:.1f} MB (bound at 3.35 TB/s "
          f"{result['prep_bound_us']:.1f} us)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
