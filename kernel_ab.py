"""A/B timing of the CUDA kernels of two checkouts on one card.

Run from the root of a checkout, with another checkout of the repository
(for example the parent commit unpacked by `git archive`) as argument:

    python3 kernel_ab.py OTHER_CHECKOUT [--rounds N]

Builds cpecan_tpu_torch/csrc/wavefront.cu of both checkouts with the same
nvcc flags, then times wavefront_fwd, wavefront_bwd and wavefront_exp of
each on chip_smoke.py's headline batch (a) (B=256 anchored 1 kb pairs,
W=128, 5-state, posterior_match), the same card tensors for both: per
round the other checkout, this one, this one, the other, each a CUDA-
event median of 10 launches. Both libraries go through this checkout's
wrappers (ops/fb_wavefront.py), so their C entry points must take the
same arguments. Prints the card's name and power limit, every round's
times, and per kernel the median of each side and their ratio; exits
non-zero without a CUDA device.
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


def _build(source: Path, out: Path):
    from cpecan_tpu_torch.ops import _kernels

    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _kernels._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.cpecan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cpecan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _calls():
    """The headline batch's fwd, bwd and exp launches, as closures."""
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
    return {"fwd": lambda: wf.fwd(*fin), "bwd": lambda: wf.bwd(*bin_),
            "exp": lambda: wf.exp(*ein)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    card, smi = chip_smoke.phase_device()
    from cpecan_tpu_torch.ops import _kernels

    build = Path(_kernels.BUILD_DIR) / "ab"
    libs = {"other": _build(args.other / "cpecan_tpu_torch/csrc/wavefront.cu",
                            build / "other.so"),
            "this": _build(_kernels.SOURCE, build / "this.so")}
    _kernels._lib = libs["this"]
    calls = _calls()
    times = {(side, k): [] for side in libs for k in calls}
    for r in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            _kernels._lib = libs[side]
            for k, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                ms = chip_smoke._median_ms(fn, 10)
                times[(side, k)].append(ms)
                print(f"round {r} {side} {k} {ms:.3f} ms", flush=True)
    print(f"{args.other} (other) vs this checkout on {card}, headline batch (a):")
    for k in calls:
        o = statistics.median(times[("other", k)])
        t = statistics.median(times[("this", k)])
        print(f"  {k}: other {o:.3f} ms, this {t:.3f} ms, this/other {t / o:.3f}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
