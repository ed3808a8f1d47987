"""A/B timing of the CUDA kernels of checkouts on one card.

Run from the root of a checkout, with one or more other checkouts of the
repository (for example the parent commit unpacked by `git archive`) as
arguments:

    python3 kernel_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...] [--rounds N]

Builds cpecan_tpu_torch/csrc/wavefront.cu of every checkout with the same
nvcc flags (one nvcc each, all at once), then times each other checkout
against this one on the same card tensors:
  - wavefront_fwd, wavefront_bwd and wavefront_exp on chip_smoke.py's
    headline batch (a) (B=256 anchored 1 kb pairs, W=128, 5-state,
    posterior_match);
  - wavefront_fwd on one launch of site 7's shape (the burn-in-parallel
    engine's windows, fb_parallel.py: B=5 windows of R=1536 rows, W=1664,
    k0 = 9, carries in and out; random streams in [0.1, 1) and shift
    bytes from a fixed seed).
Per round and other checkout: the other, this one, this one, the other,
each a CUDA-event median of 10 launches. Every library goes through this
checkout's wrappers (ops/fb_wavefront.py), so their C entry points must
take the same arguments. Prints the card's name and power limit, every
round's times, and per kernel and shape the median of each side and
their ratio; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke


def _build_all(sources: dict, build: Path) -> dict:
    """{name: loaded library}, one nvcc per source, all started together."""
    from cpecan_tpu_torch.ops import _kernels

    build.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(build / f"{name}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{out}")
    return {name: _load(build / f"{name}.so") for name in sources}


def _load(out: Path):
    from cpecan_tpu_torch.ops import _kernels

    lib = ctypes.CDLL(str(out))
    for name, argtypes in _kernels._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.cpecan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cpecan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _site7_fwd(hmm):
    """One fwd launch of site 7's shape (B=5, R=1536, W=1664, k0 = 9,
    carries in and out), as a closure."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    rng = np.random.default_rng(7)
    B, R, W, S = 5, 1536, 1664, hmm.state_number
    unif = lambda *shape, lo=0.0: torch.from_numpy(
        rng.uniform(lo, 1.0, shape).astype(np.float32)).cuda()
    bits = lambda: torch.from_numpy(
        (rng.random((B, R)) < 0.5).astype(np.int8)).cuda()
    streams = [unif(B, R, W, lo=0.1) for _ in range(3)]
    masks = [bits() for _ in range(3)]
    carry = (unif(B, S, W), unif(B, S, W), 0.5 + unif(B))
    F0 = torch.zeros(B, S, W, device="cuda")
    return lambda: wf.fwd(hmm.t_prob_host, *streams, *masks, F0, hmm.nz,
                          carry=carry, k0=9, site="par_fwd")


def _calls():
    """The timed launches, as closures: {"kernel at shape": fn}."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    bt = chip_smoke._band_batch(np.random.default_rng(0), 256, 2048,
                                "posterior_match", state_machine5,
                                anchor_every=50)
    hmm = PairHMM.from_state_machine(bt["sm"]).cuda()
    pre = wf.precompute(hmm, *bt["args"], width=bt["W"])
    t = hmm.t_prob_host
    fin = (t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"], pre["b0"],
           pre["F0"], hmm.nz)
    F, bv, mf = wf.fwd(*fin)
    adj1, adj2 = wf.scale_adjustments(mf)
    back = (pre["efx"], pre["efy"], pre["efm"], pre["em"])
    masks = (pre["abw"], pre["c1"], pre["c0"], pre["bm1"], pre["bm0"])
    bin_ = (t, *back, F, bv, *masks, pre["pm"], pre["end_row"], hmm.nz,
            bt["mode"])
    ein = (t, *back, pre["ex"], pre["ey"], F, bv, *masks, pre["a"],
           pre["b1"], pre["b0"], pre["pm"], pre["end_row"], adj1, adj2,
           pre["wx"], pre["wy"], hmm.nz)
    return {"fwd at (a)": lambda: wf.fwd(*fin),
            "bwd at (a)": lambda: wf.bwd(*bin_),
            "exp at (a)": lambda: wf.exp(*ein),
            "fwd at site 7": _site7_fwd(hmm)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+",
                    help="roots of the other checkouts")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    card, smi = chip_smoke.phase_device()
    from cpecan_tpu_torch.ops import _kernels

    sources = {f"other{i}": o / "cpecan_tpu_torch/csrc/wavefront.cu"
               for i, o in enumerate(args.others)}
    sources["this"] = _kernels.SOURCE
    libs = _build_all(sources, Path(_kernels.BUILD_DIR) / "ab")
    _kernels._lib = libs["this"]
    calls = _calls()
    times = {(side, k): [] for side in libs for k in calls}
    for r in range(args.rounds):
        for i in range(len(args.others)):
            for side in (f"other{i}", "this", "this", f"other{i}"):
                _kernels._lib = libs[side]
                for k, fn in calls.items():
                    fn()
                    torch.cuda.synchronize()
                    ms = chip_smoke._median_ms(fn, 10)
                    times[(side, k)].append(ms)
                    print(f"round {r} {side} {k} {ms:.3f} ms", flush=True)
    for i, other in enumerate(args.others):
        print(f"{other} (other) vs this checkout on {card}:")
        for k in calls:
            o = statistics.median(times[(f"other{i}", k)])
            t = statistics.median(times[("this", k)])
            print(f"  {k}: other {o:.3f} ms, this {t:.3f} ms, this/other {t / o:.3f}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
