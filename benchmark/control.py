"""The control of a cell's check: the reference, computed in a lower
precision, in the program's place.

    python3 benchmark/control.py --workload CELL --seconds S --seeds N [N ...]

For each seed it runs the cell as run.py does (the program's numbers:
the lower readings) and then compares the control's outputs for the
same sample of answers with the float64 reference (the upper
readings). The configurations state float32, so the control is
bfloat16, on the card. Prints one JSON line per seed. The benchmark's
own runs do not run this; it is how the limits in benchmark/workloads
were set.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark.lib import harness, spec

    cell = spec.Cell(args.workload)
    for seed in args.seeds:
        box = {}
        result = harness.run_cell(cell, seed, args.seconds, False,
                                  prepare=lambda d: box.setdefault("d", d))
        drv = box["d"]
        t0 = time.perf_counter()
        extra = {}
        if hasattr(drv, "record_gaps"):
            extra["program_widest"] = max(drv.record_gaps, default=0.0)
        checks = drv.control_check(torch.bfloat16)
        if hasattr(drv, "record_gaps"):
            extra["control_widest"] = max(drv.record_gaps, default=0.0)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: v["value"] for k, v in result["checks"].items()},
            "control": {n: v for n, v, _ in checks},
            "control_s": time.perf_counter() - t0, **extra,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
