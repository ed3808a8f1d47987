"""Benchmark of cpecan_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the chips the cell
asks for. The cell's configuration, traffic, checks and metrics come
from BENCHMARK.json and the files it names (benchmark/README.md). The
last line of standard output is the result as one JSON object; the
numbers compared with the reference, each beside its limit, are the
last lines of standard error. Exits non-zero, printing no result,
without enough CUDA devices or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CUDA_CACHE = ROOT / "build" / "benchmark_cache" / "cuda"


def _fixed_caches() -> None:
    """Keep the CUDA driver's kernel cache inside the checkout, at a
    fixed path (the program's own nvcc and g++ builds already go to
    build/cpecan_tpu_torch/ there)."""
    os.environ["CUDA_CACHE_PATH"] = str(CUDA_CACHE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    # import the benchmark as a package from the checkout's root, not
    # its modules from the script's folder
    sys.path[0] = str(ROOT)

    from benchmark.lib import harness, spec

    cell = spec.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 1
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
