"""Smoke run of the PyTorch port (cpecan_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the CUDA kernels from cpecan_tpu_torch/csrc with nvcc;
  3. kernels: on four batches (headline, dense anchors, 3-state ragged,
     full band W >= 1024) run the forward and backward kernels and their
     plain PyTorch versions on the same card tensors, check the
     tolerances, and time both per call; on the headline and the 3-state
     batch the same for the expectation kernel, and on a full band of
     2.5 kb pairs with its emission bins in device scratch (W > 2048);
     then the backward kernel across band widths 32-4096 (B=64, R=1025),
     and the expectation kernel across the same and two more: against
     its plain version, its launch plan (ring depth, shared memory), time,
     us per diagonal, share of the bound and ptxas registers/spills, with
     its direct-load variant beside the ring where it has one;
  4. realign main path: cpecan_tpu_torch.cli.realign.main on 1024
     generated 1 kb record pairs (default decode) and 256 of them with
     --mea, with every kernel's launch count reset before and read after;
  5. card against CPU: realign.main with --device cpu (the kernels' plain
     versions) on the first 32 records, default and --mea, must give the
     card run's cigars; batch_posteriors at the main path's parameters on
     those records, on the card and on the CPU, must give the same pairs;
  6. EM main path: the expectation kernel against its plain version on
     the largest launch the EM path builds from the records; then
     cpecan_tpu_torch.cli.em.main (Baum-Welch training) on
     the 1024 records at the EM defaults, 5-state for 3 iterations from a
     random start (the likelihood must not fall) and 3-state for one,
     launch counts reset before and read after each; one more 5-state
     iteration with torch.profiler tracing the device only, for that
     run's device busy share;
  7. EM card against CPU: 2 iterations on the first 32 records, and
     realign --outputExpectations on them, on the card and with
     --device cpu: the HMMs must agree;
  8. long-pair kernels: on a 2 kb evolved pair in windows of 128 rows,
     the exact streaming engine (posterior, expectation and forward
     modes: the kernels with carries, k0 phase and F halo) and the
     burn-in-parallel engine, each through the kernels and again through
     their plain versions on the same card tensors; the exact engine's
     scale streams and posteriors against the two-pass kernels';
  9. long pair: the long_500kb configuration (bench.py:616-622) through
     pairwise.get_aligned_pairs (the parallel engine), with wall and host
     seconds, windows, launches and sensitivity/specificity against the
     planted truth; its longest streamed chunk through the exact engine
     (seconds, us per diagonal), whose pair set must match the parallel
     engine's; each kernel site's largest launch on these paths again
     through the kernel and its plain version (times and bounds);
 10. long records: the realign CLI on 100-200 kb records with planted-
     truth cigars (default decode, and --mea on one), the exact engine
     against the two-pass kernels on one 100 kb chunk, and card against
     CPU with every chunk of two 3 kb records made to stream;
 11. EM with long records: one 5-state iteration over 2 x 100 kb records
     and 32 short ones (segmented exp kernel), the exact engine's counts
     and likelihood on one long chunk against the two-pass kernels', and
     card against CPU (2 iterations) with every chunk made to stream;
 12. wide bands (W > 4096, the kernels' wide variants): the batch path's
     three kernels on a full band of 1 kb pairs padded out to W=4352 and
     to an off-grid 8200 against their plain versions, with times; a record with an
     anchor-free 4.5 kb gap through the realign CLI (parallel engine) and
     one EM iteration (exact engine) with --splitMatrixBiggerThanThis
     5000, launch counts reset before and read after each, the widest
     window launch of each site against its plain version, and the
     record's pairs against the plain versions' on the same card tensors.

The last two lines of standard output are the kernels' JSON summary and
{"ok": true, "device": {...}}. Imports no jax and nothing of cpecan_tpu
(checked at the end on sys.modules), and reaches the system only through
cpecan_tpu_torch. Test data is made with numpy from fixed seeds.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# (rtol, atol): fp32, with sums taken in another order than the plain
# versions'; the same tolerances tests/test_wavefront.py holds the JAX
# kernels to
TOLERANCES = {"log_fwd": (2e-5, 2e-5), "mf": (1e-4, 2e-5),
              "mb": (1e-4, 2e-5), "total_raw": (1e-4, 2e-5),
              "post_match": (1e-3, 2e-5), "post_gap_x": (1e-3, 2e-5),
              "post_gap_y": (1e-3, 2e-5)}
FWD_KEYS = ("mf", "log_fwd")
SEQ_LEN = 1000
RECORDS = 1024
MEA_RECORDS = 256
COMPARE_RECORDS = 32
EM_ITERATIONS = 3
# expected counts: per-slot fp32 sums over the diagonals in the same order
# as the plain version, then a block reduction in another order than
# torch.sum's, with fma contraction in the kernel
EXP_RTOL = 1e-5
# card against CPU after EM iterations (tests/test_em.py:139-141)
EM_RTOL, EM_LIKE_RTOL = 1e-4, 1e-5
# expected counts of the exact streaming engine against the two-pass
# kernels on one chunk (tests/test_streaming.py:246-249): the two sum a
# chunk's 10^4-10^5 diagonals in other orders (per window, then over the
# windows in float64, against one fp32 running sum per slot)
SEG_COUNT_RTOL = 1e-3

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and fp32 (non-tensor)
# operations/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def log(*args):
    print(*args, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {name} ({torch.cuda.device_count()} visible); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi


def _instantiation(kernel, args):
    """A kernel instantiation's name from its mangled template arguments:
    fwd<S,batch|window>, bwd<S,slots,ring|direct,batch|window>,
    exp<S,slots,ring|direct,batch|window>, fwd_wide<S,batch|window>,
    back_wide<S,bwd|exp,batch|window>."""
    vals = [v for _, v in re.findall(r"L([ib])(\d+)E", args)]
    vals[-1] = "window" if vals[-1] == "1" else "batch"
    if kernel in ("wavefront_bwd", "wavefront_exp"):
        vals[2] = "ring" if vals[2] == "1" else "direct"
    if kernel == "wavefront_back_wide":
        vals[1] = "exp" if vals[1] == "1" else "bwd"
    return f"{kernel}<{','.join(vals)}>"


def phase_build():
    """Build and load the kernels; print ptxas' registers and spills per
    instantiation. Returns {instantiation: "registers, spills"} (empty
    when the library was already built)."""
    from cpecan_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    path, diagnostics = _kernels.build()
    _kernels.load()
    log(f"build: {path.name} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if diagnostics else " (already built)"))
    ptxas, name = {}, None
    for line in diagnostics.splitlines():
        m = re.search(r"entry function .*(wavefront_\w+?)I((?:L[ib]\d+E)+)E", line)
        if m:
            name = _instantiation(m[1], m[2])
            log(f"  ptxas: {name}")
        elif "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
            r = re.search(r"Used (\d+) registers", line)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if name and (r or sp):
                ptxas.setdefault(name, {}).update(
                    {"registers": r[1]} if r else {"spills": sp.groups()})
    return {k: f"{v.get('registers', '?')} registers, "
               f"{v.get('spills', ('?', '?'))[0]} B spill stores, "
               f"{v.get('spills', ('?', '?'))[1]} B spill loads"
            for k, v in ptxas.items()}


# ------------------------------------------------------------ batches


_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _random_sequence(rng, n):
    """n random bases, each N with p 1/11 (the reference's test-data mix,
    impl/randomSequences.c:13-45, in upper case)."""
    seq = _ACGT[rng.integers(0, 4, n)]
    return np.where(rng.random(n) < 1 / 11, ord("N"), seq).astype(
        np.uint8).tobytes().decode()


def _evolve(x, rng):
    """x mutated as the reference's test-data generator does
    (impl/randomSequences.c:50-73): each base is deleted with p 0.1, else
    preceded by a random inserted base with p 0.1 and substituted with
    p 0.2."""
    n = len(x)
    r = rng.random(n)
    base = np.where(rng.random(n) < 0.2, _ACGT[rng.integers(0, 4, n)],
                    np.frombuffer(x.encode(), np.uint8))
    out = np.stack([_ACGT[rng.integers(0, 4, n)], base], axis=1)
    keep = np.stack([(r >= 0.1) & (r < 0.2), r >= 0.1], axis=1)
    return out[keep].tobytes().decode()


def _band_batch(rng, B, P, mode, sm_factory, anchor_every=None,
                expansion=20, full=False, evolve=False, ragged=False,
                seq_len=SEQ_LEN, width=None):
    """One launch's inputs, shaped as batch_posteriors builds them (at
    band width ``width`` when given: the bands padded out to it)."""
    from cpecan_tpu_torch.align import batch as port_batch
    from cpecan_tpu_torch.align.pairwise import _width_bucket

    seqs, bands = [], []
    for _ in range(B):
        x = _ACGT[rng.integers(0, 4, seq_len)].tobytes().decode()
        y = _evolve(x, rng)[:P - seq_len] if evolve else x
        if full:
            band = port_batch.full_band(len(x), len(y))
        else:
            m = min(len(x), len(y))
            band = port_batch.construct_band([(i, i) for i in range(
                anchor_every // 2, m - anchor_every // 2, anchor_every)],
                len(x), len(y), expansion)
        seqs.append((x, y))
        bands.append(band)
    W = _width_bucket(max(b.frame_width() for b in bands))
    if width is not None:
        if width < W:
            raise ValueError(f"bands need W={W}, above width={width}")
        W = width
    sx = np.zeros((B, P), np.int32)
    sy = np.zeros((B, P), np.int32)
    offs = np.zeros((B, P + 1), np.int32)
    wids = np.zeros((B, P + 1), np.int32)
    for i, ((x, y), band) in enumerate(zip(seqs, bands)):
        offs[i], wids[i], _ = port_batch.pad_band(band, P, W)
        sx[i, :len(x)] = port_batch.encode(x)
        sy[i, :len(y)] = port_batch.encode(y)
    lx = np.array([len(x) for x, _ in seqs], np.int32)
    ly = np.array([len(y) for _, y in seqs], np.int32)
    rl = rng.random(B) < 0.5 if ragged else np.zeros(B, bool)
    rr = rng.random(B) < 0.5 if ragged else np.zeros(B, bool)
    cells = int(sum(int(b.widths.sum()) for b in bands))
    return {"sm": sm_factory(), "mode": mode, "W": W, "cells": cells,
            "args": [torch.from_numpy(a).cuda()
                     for a in (sx, sy, offs, wids, lx, ly, rl, rr)]}


def _batches():
    from cpecan_tpu_torch.models.state_machine import state_machine3, state_machine5

    rng = np.random.default_rng(0)
    return {
        "a_headline_B256_1kb_anchor50": _band_batch(
            rng, 256, 2048, "posterior_match", state_machine5, anchor_every=50),
        "b_dense_anchor_B256_1kb": _band_batch(
            rng, 256, 2048, "posterior_all", state_machine5, anchor_every=1),
        "c_3state_ragged_B37": _band_batch(
            rng, 37, 2048, "posterior_match", state_machine3, anchor_every=25,
            evolve=True, ragged=True),
        "d_full_band_B16_1kb": _band_batch(
            rng, 16, 2048, "posterior_all", state_machine5, full=True,
            evolve=True),
    }


@contextlib.contextmanager
def _plain_versions():
    """Route the kernel wrappers, for every caller, to their plain
    versions (which take the same arguments but the launch-count site)."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    saved = wf.fwd, wf.bwd, wf.exp
    plain = lambda ref: lambda *a, site=None, **kw: ref(*a, **kw)
    wf.fwd, wf.bwd, wf.exp = (plain(wf.fwd_reference), plain(wf.bwd_reference),
                              plain(wf.exp_reference))
    try:
        yield
    finally:
        wf.fwd, wf.bwd, wf.exp = saved


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(got, want, L):
    """Per-key max abs error after checking TOLERANCES (total_raw on
    rows 1..L of each pair)."""
    errs = {}
    for k, (rtol, atol) in TOLERANCES.items():
        if k not in want:
            continue
        a, b = got[k].float().cpu(), want[k].float().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"kernel output {k} is not finite")
        if k == "total_raw":
            rows = torch.arange(a.shape[1])[None, :]
            keep = (rows >= 1) & (rows <= L.cpu()[:, None])
            a, b = a[keep], b[keep]
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=k)
        errs[k] = float((a - b).abs().max())
    return errs


def _bound(B, R, W, S, nz, kernel, window=False):
    """(bound_ms, bound_by) of one call: the larger of the bytes it must
    move (each input read once, each output written once) over HBM's rate
    and its fp32 operations over the fp32 peak. exp reads only pm's
    row-constant bits (one byte per row), bwd its per-slot bits. A window
    of a long pair (``window``) reads and writes its carries (and exp its
    two-row F halo) in place of F0.
    Operations per band slot and diagonal, counted from the kernels'
    arithmetic: fwd 3S neighbour
    x emission products, 2 per transition, 2 per match (bridge)
    transition and S rescales; bwd the same recursion plus the 2S-op dot
    and up to 3 posteriors; exp bwd's recursion and dot plus 3S products
    with the forward emissions, S posterior weights, 4 per transition
    (two multiply-adds) and 2S for the emission bins."""
    slots = B * R * W
    f32_row, i8_row, f32_col, i8_col = 4 * slots, slots, 4 * B * R, B * R
    F_bytes, end_bytes = 4 * slots * S, 4 * B * S * W
    n_match = sum(1 for c, _, _ in nz if c == 1)
    if kernel == "fwd":
        byts = 3 * f32_row + 3 * i8_col + end_bytes + F_bytes + f32_row + f32_col
        ops = 3 * S + 2 * len(nz) + 2 * n_match + S
    elif kernel == "bwd":
        byts = (5 * f32_row + F_bytes + 5 * i8_col + i8_row + end_bytes
                + f32_row + 2 * f32_col)
        ops = 3 * S + 2 * len(nz) + S + 2 * S + 3 + 3
    else:
        byts = (7 * f32_row + F_bytes + 9 * i8_col + 2 * i8_row + end_bytes
                + 2 * f32_col + 4 * B * (S * S + S * 16) + 2 * f32_col)
        ops = (3 * S + 2 * len(nz) + S + 2 * S + 3) + 3 * S + S + 4 * len(nz) + 2 * S
    if window:
        state = 4 * B * S * W
        carry = (2 * state + 4 * B if kernel == "fwd"
                 else 2 * state + 2 * 4 * B * W + 4 * B)
        byts += 2 * carry - (end_bytes if kernel == "fwd" else 0)
        byts += 2 * state if kernel == "exp" else 0
    t_bytes, t_ops = byts / PEAK_BYTES, ops * slots / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _check_exp(wf, hmm, args, W, name, card, reps=(10, 3)):
    """wavefront_exp against exp_reference on the card (same inputs), and
    its mb/total_raw against wavefront_bwd's; CUDA-event medians of
    reps[0] kernel and reps[1] plain calls."""
    pre = wf.precompute(hmm, *args, width=W)
    t = hmm.t_prob_host
    F, bv, mf = wf.fwd(t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"],
                       pre["b0"], pre["F0"], hmm.nz)
    adj1, adj2 = wf.scale_adjustments(mf)
    ein = (t, pre["efx"], pre["efy"], pre["efm"], pre["em"], pre["ex"],
           pre["ey"], F, bv, pre["abw"], pre["c1"], pre["c0"], pre["bm1"],
           pre["bm0"], pre["a"], pre["b1"], pre["b0"], pre["pm"],
           pre["end_row"], adj1, adj2, pre["wx"], pre["wy"], hmm.nz)
    got = wf.exp(*ein)
    _, mb_b, tot_b = wf.bwd(t, pre["efx"], pre["efy"], pre["efm"], pre["em"],
                            F, bv, pre["abw"], pre["c1"], pre["c0"],
                            pre["bm1"], pre["bm0"], pre["pm"], pre["end_row"],
                            hmm.nz)
    want = wf.exp_reference(*ein)
    torch.cuda.synchronize()
    L = (args[4].long() + args[5].long()).cpu()
    rows = torch.arange(mf.shape[1])[None, :]
    keep = (rows >= 1) & (rows <= L[:, None])
    errs = {}
    for k, g, w_ in zip(("trans", "emis"), got[:2], want[:2]):
        g, w_ = g.cpu(), w_.cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"exp kernel output {k} is not finite")
        torch.testing.assert_close(g, w_, rtol=EXP_RTOL, atol=1e-6, msg=k)
        errs[k] = float((g - w_).abs().max())
        errs[k + "_rel"] = float(((g - w_).abs() / w_.abs().clamp_min(1e-30)).max())
    for k, g, w_, b_ in (("mb", got[2], want[2], mb_b),
                         ("total_raw", got[3], want[3], tot_b)):
        g, w_, b_ = g.cpu(), w_.cpu(), b_.cpu()
        if k == "total_raw":
            g, w_, b_ = g[keep], w_[keep], b_[keep]
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-5, msg=k)
        torch.testing.assert_close(g, b_, rtol=0, atol=1e-5, msg=k + " vs bwd")
        errs[k] = float((g - w_).abs().max())
        errs[k + "_is_bwds"] = bool(torch.equal(g, b_))
    ms = {"exp": _median_ms(lambda: wf.exp(*ein), reps[0]),
          "exp_plain": _median_ms(lambda: wf.exp_reference(*ein), reps[1])}
    B, R, Wd = pre["ex"].shape
    log(f"exp kernel {name}: B={B} P={R - 1} W={Wd} S={hmm.state_number}; "
        f"max abs err " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float)
                                    else f"{k} {v}" for k, v in errs.items()))
    log(f"  {card}: exp {ms['exp']:.3f} ms (plain {ms['exp_plain']:.1f} ms)")
    err = max(v for k, v in errs.items()
              if isinstance(v, float) and not k.endswith("_rel"))
    return ms, err, (B, R, Wd, hmm.state_number, hmm.nz)


def phase_kernels(card):
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    summary = {"fwd": {"err": 0.0}, "bwd": {"err": 0.0}, "exp": {"err": 0.0}}
    wf.reset_launch_counts()
    for name, bt in _batches().items():
        hmm = PairHMM.from_state_machine(bt["sm"]).cuda()
        args, mode, W = bt["args"], bt["mode"], bt["W"]
        B, P1 = args[2].shape
        got = wf.fb_pass_batch_wavefront(hmm, *args, mode=mode, width=W)
        with _plain_versions():
            want = wf.fb_pass_batch_wavefront(hmm, *args, mode=mode, width=W)
        errs = _max_err(got, want, args[4].long() + args[5].long())
        summary["fwd"]["err"] = max(summary["fwd"]["err"],
                                    *(errs[k] for k in FWD_KEYS))
        summary["bwd"]["err"] = max(summary["bwd"]["err"],
                                    *(v for k, v in errs.items()
                                      if k not in FWD_KEYS))

        pre = wf.precompute(hmm, *args, width=W)
        t = hmm.t_prob_host
        # the plain versions take seconds a call; the headline's times go
        # into the summary, the other batches' are one call each
        plain_reps = 3 if name.startswith("a_") else 1
        fin = (t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"],
               pre["b0"], pre["F0"], hmm.nz)
        F, bv, _ = wf.fwd(*fin)
        bin_ = (t, pre["efx"], pre["efy"], pre["efm"], pre["em"], F, bv,
                pre["abw"], pre["c1"], pre["c0"], pre["bm1"], pre["bm0"],
                pre["pm"], pre["end_row"], hmm.nz, mode)
        ms = {"fwd": _median_ms(lambda: wf.fwd(*fin), 10),
              "bwd": _median_ms(lambda: wf.bwd(*bin_), 10),
              "fwd_plain": _median_ms(lambda: wf.fwd_reference(*fin), plain_reps),
              "bwd_plain": _median_ms(lambda: wf.bwd_reference(*bin_), plain_reps)}
        direct = _bwd_direct(bin_, {}, hmm.state_number, W, 10, wf.bwd(*bin_))
        kern_s = (ms["fwd"] + ms["bwd"]) / 1e3
        plain_s = (ms["fwd_plain"] + ms["bwd_plain"]) / 1e3
        log(f"kernels {name}: B={B} P={P1 - 1} W={W} {mode}, "
            f"{bt['cells']} in-band cells; max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        log(f"  {card}: fwd {ms['fwd']:.3f} ms (plain {ms['fwd_plain']:.1f} ms), "
            f"bwd {ms['bwd']:.3f} ms (plain {ms['bwd_plain']:.1f} ms); "
            f"fwd+bwd {bt['cells'] / kern_s:.4g} cells/s "
            f"(plain {bt['cells'] / plain_s:.4g} cells/s); kernel launches "
            f"so far in this phase {wf.LAUNCHES}")
        if direct is not None:
            log(f"  {card}: bwd ring {ms['bwd']:.3f} ms, its direct-load "
                f"variant {direct:.3f} ms ({1e3 * ms['bwd'] / P1:.3f} and "
                f"{1e3 * direct / P1:.3f} us per diagonal)")
        if name.startswith("a_"):
            for k in ("fwd", "bwd"):
                summary[k]["ms"] = ms[k]
                summary[k]["plain_ms"] = ms[k + "_plain"]
                summary[k]["bound"] = _bound(B, P1, W, hmm.state_number,
                                             hmm.nz, k)
        del got, want, pre, F, bv
        torch.cuda.empty_cache()
        if name.startswith(("a_", "c_")):
            ems, err, shape = _check_exp(wf, hmm, args, W, name, card,
                                         reps=(10, plain_reps))
            summary["exp"]["err"] = max(summary["exp"]["err"], err)
            if name.startswith("a_"):
                summary["exp"]["ms"] = ems["exp"]
                summary["exp"]["plain_ms"] = ems["exp_plain"]
                summary["exp"]["bound"] = _bound(*shape, "exp")
            torch.cuda.empty_cache()
    # exp with its emission bins in device scratch (W > 2048: 8 slots on
    # 512 threads): a full band of evolved 2.5 kb pairs, as an unanchored
    # multi-kb gap of an EM chunk gives it
    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    bt = _band_batch(np.random.default_rng(1), 4, 5120, "posterior_match",
                     state_machine5, full=True, evolve=True, seq_len=2500)
    if bt["W"] <= wf.EXP_SHARED_WIDTH:
        raise AssertionError(f"wide batch has W={bt['W']}")
    _, err, _ = _check_exp(wf, hmm, bt["args"], bt["W"],
                           "f_wide_full_band_B4_2500", card, reps=(3, 1))
    summary["exp"]["err"] = max(summary["exp"]["err"], err)
    torch.cuda.empty_cache()
    for k, v in summary.items():
        bms, by = v["bound"]
        log(f"bound {k} at the headline batch: {bms:.3f} ms ({by}); kernel "
            f"{v['ms']:.3f} ms, {100 * bms / v['ms']:.1f}% of the bound")
    return summary


# bwd's width sweep: B pairs of SWEEP_P bases (R = SWEEP_P + 1 diagonals)
SWEEP_B, SWEEP_P = 64, 1024
SWEEP_WIDTHS = (32, 128, 544, 1024, 1664, 2048, 4096)


def _on_grid(args):
    """Whether the streams wavefront_bwd's ring copies (efx, efy, efm,
    em, F, bv, pm in the wrapper's argument order) start on 16-byte
    boundaries, as the ring needs."""
    return all(args[i].data_ptr() % 16 == 0 for i in (1, 2, 3, 4, 5, 6, 12))


def _off_grid(x):
    """A contiguous copy of int8 ``x`` that starts one byte past a 16-byte
    boundary: wavefront_bwd then runs its direct-load variant."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def phase_bwd_sweep(card, ptxas):
    """wavefront_bwd across band widths on one batch shape (B=SWEEP_B
    identical 512 bp pairs, anchors every 50 bp, the bands padded out to
    W; dense anchors at W=32), 5-state, posterior_match: the kernel
    against bwd_reference on the same card tensors, and per width its
    launch plan (threads, slots, ring depth, shared memory), its time and
    us per diagonal, its share of the bound and the ptxas line of the
    instantiation that ran. Where the plan has a ring, the direct-load
    variant (pm off the 16-byte grid) is checked and timed beside it."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    t0 = time.perf_counter()
    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    S, t = hmm.state_number, hmm.t_prob_host
    rng = np.random.default_rng(11)
    for W in SWEEP_WIDTHS:
        bt = _band_batch(rng, SWEEP_B, SWEEP_P, "posterior_match",
                         state_machine5, anchor_every=1 if W == 32 else 50,
                         seq_len=SWEEP_P // 2, width=W)
        pre = wf.precompute(hmm, *bt["args"], width=W)
        F, bv, _ = wf.fwd(t, pre["ex"], pre["ey"], pre["em"], pre["a"],
                          pre["b1"], pre["b0"], pre["F0"], hmm.nz)
        bin_ = [t, pre["efx"], pre["efy"], pre["efm"], pre["em"], F, bv,
                pre["abw"], pre["c1"], pre["c0"], pre["bm1"], pre["bm0"],
                pre["pm"], pre["end_row"], hmm.nz, "posterior_match"]
        want = wf.bwd_reference(*bin_)
        L = bt["args"][4].long() + bt["args"][5].long()
        ring = wf.bwd_plan(S, W)["depth"] > 0 and _on_grid(bin_)
        variants = [("ring" if ring else "direct", bin_)]
        if ring:
            variants.append(("direct", bin_[:12] + [_off_grid(pre["pm"])]
                             + bin_[13:]))
        B, R, _ = pre["efx"].shape
        bms, by = _bound(B, R, W, S, hmm.nz, "bwd")
        log(f"bwd sweep W={W}: B={B} R={R}; bound {bms:.4f} ms ({by})")
        for name, args in variants:
            plan = wf.bwd_plan(S, W, aligned=name == "ring")
            posts, mb, tot = wf.bwd(*args)
            errs = _max_err({"post_match": posts[0], "mb": mb, "total_raw": tot},
                            {"post_match": want[0][0], "mb": want[1],
                             "total_raw": want[2]}, L)
            ms = _median_ms(lambda: wf.bwd(*args), 5)
            inst = f"wavefront_bwd<{S},{plan['slots']},{name},batch>"
            log(f"  {name}: {plan['threads']} threads x {plan['slots']} slots, "
                f"ring depth {plan['depth']}, shared memory {plan['smem']} B "
                f"per block; {ms:.3f} ms ({1e3 * ms / R:.3f} us per diagonal, "
                f"{100 * bms / ms:.1f}% of the bound), max abs err "
                f"{max(errs.values()):.3g} ({card}); ptxas {inst}: "
                f"{ptxas.get(inst, 'not reported (library already built)')}")
        del bt, pre, F, bv, bin_, want, variants
        torch.cuda.empty_cache()
    log(f"bwd sweep: {time.perf_counter() - t0:.1f} s")


# exp's width sweep: bwd's widths and the ones that give its 2-slot ring
# (384) and its 3-stage ring (768)
EXP_SWEEP_WIDTHS = (32, 128, 384, 544, 768, 1024, 1664, 2048, 4096)


def _exp_inputs(wf, hmm, pre):
    """The forward pass on precompute's streams, then exp's arguments."""
    t = hmm.t_prob_host
    F, bv, mf = wf.fwd(t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"],
                       pre["b0"], pre["F0"], hmm.nz)
    adj1, adj2 = wf.scale_adjustments(mf)
    return [t, pre["efx"], pre["efy"], pre["efm"], pre["em"], pre["ex"],
            pre["ey"], F, bv, pre["abw"], pre["c1"], pre["c0"], pre["bm1"],
            pre["bm0"], pre["a"], pre["b1"], pre["b0"], pre["pm"],
            pre["end_row"], adj1, adj2, pre["wx"], pre["wy"], hmm.nz]


def _exp_errs(got, want, L):
    """exp outputs against exp_reference's: counts within EXP_RTOL, mb and
    total_raw (rows 1..L) within 1e-5 absolute. Returns the max abs error
    and the counts' max relative one."""
    rows = torch.arange(got[2].shape[1])[None, :]
    keep = (rows >= 1) & (rows <= L.cpu()[:, None])
    err, rel = 0.0, 0.0
    for k, g, w_ in zip(("trans", "emis", "mb", "total_raw"), got, want):
        g, w_ = g.float().cpu(), w_.float().cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"exp output {k} is not finite")
        if k == "total_raw":
            g, w_ = g[keep], w_[keep]
        tol = (EXP_RTOL, 1e-6) if k in ("trans", "emis") else (0.0, 1e-5)
        torch.testing.assert_close(g, w_, rtol=tol[0], atol=tol[1], msg=k)
        err = max(err, float((g - w_).abs().max()))
        if k in ("trans", "emis"):
            rel = max(rel, float(((g - w_).abs() / w_.abs().clamp_min(1e-30)).max()))
    return err, rel


def phase_exp_sweep(card, ptxas):
    """wavefront_exp across band widths on the bwd sweep's batch shape
    (B=SWEEP_B identical 512 bp pairs, R = 1025, bands padded out to W),
    5-state: the kernel against exp_reference on the same card tensors,
    and per width its launch plan, time and us per diagonal, share of the
    bound and the ptxas line of the instantiation that ran. Where the plan
    has a ring, the direct-load variant (wx off the 16-byte grid) is
    checked and timed beside it. Returns {(W, variant): ms}."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    t0 = time.perf_counter()
    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    S = hmm.state_number
    rng = np.random.default_rng(12)
    out = {}
    for W in EXP_SWEEP_WIDTHS:
        bt = _band_batch(rng, SWEEP_B, SWEEP_P, "expectation", state_machine5,
                         anchor_every=1 if W == 32 else 50,
                         seq_len=SWEEP_P // 2, width=W)
        ein = _exp_inputs(wf, hmm, wf.precompute(hmm, *bt["args"], width=W))
        want = wf.exp_reference(*ein)
        L = bt["args"][4].long() + bt["args"][5].long()
        grid = all(ein[i].data_ptr() % 16 == 0 for i in (1, 2, 3, 4, 5, 6, 7, 8, 21, 22))
        ring = wf.exp_plan(S, W)["depth"] > 0 and grid
        variants = [("ring" if ring else "direct", ein)]
        if ring:
            variants.append(("direct", ein[:21] + [_off_grid(ein[21])] + ein[22:]))
        B, R, _ = ein[1].shape
        bms, by = _bound(B, R, W, S, hmm.nz, "exp")
        log(f"exp sweep W={W}: B={B} R={R}; bound {bms:.4f} ms ({by})")
        for name, args in variants:
            plan = wf.exp_plan(S, W, aligned=name == "ring")
            err, rel = _exp_errs(wf.exp(*args), want, L)
            ms = _median_ms(lambda: wf.exp(*args), 5)
            out[(W, name)] = ms
            inst = f"wavefront_exp<{S},{plan['slots']},{name},batch>"
            log(f"  {name}: {plan['threads']} threads x {plan['slots']} slots, "
                f"ring depth {plan['depth']}, shared memory {plan['smem']} B "
                f"per block; {ms:.3f} ms ({1e3 * ms / R:.3f} us per diagonal, "
                f"{100 * bms / ms:.1f}% of the bound), max abs err {err:.3g}, "
                f"counts {rel:.3g} relative ({card}); ptxas {inst}: "
                f"{ptxas.get(inst, 'not reported (library already built)')}")
        del bt, ein, want, variants
        torch.cuda.empty_cache()
    log(f"exp sweep: {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------ main path


def _records(n, seed=1):
    """n record pairs (a random 1 kb sequence and an evolved copy) with
    identity cigars, as tests/test_cli.py builds them."""
    from cpecan_tpu_torch.cli.realign import cigar_io

    rng = np.random.default_rng(seed)
    seqs, cigars = {}, []
    for i in range(n):
        x = _random_sequence(rng, SEQ_LEN)
        y = _evolve(x, rng)
        seqs[f"x{i}"], seqs[f"y{i}"] = x, y
        m = min(len(x), len(y))
        ops = [(cigar_io.MATCH, m)]
        if len(x) > m:
            ops.append((cigar_io.INDEL_X, len(x) - m))
        if len(y) > m:
            ops.append((cigar_io.INDEL_Y, len(y) - m))
        cigars.append(cigar_io.PairwiseAlignment(
            f"x{i}", 0, len(x), True, f"y{i}", 0, len(y), True, 0.0, ops))
    return seqs, cigars


def _realign(fasta, cigars, device, extra):
    """realign.main on ``cigars``; returns the output cigars."""
    from cpecan_tpu_torch.cli import realign

    stdin = io.StringIO("".join(realign.cigar_io.cigar_format(c) + "\n"
                                for c in cigars))
    stdout = io.StringIO()
    rc = realign.main([fasta, "--device", device, *extra], stdin=stdin,
                      stdout=stdout)
    if rc != 0:
        raise RuntimeError(f"realign exited with {rc}")
    stdout.seek(0)
    return list(realign.cigar_io.cigar_read(stdout))


def _check_cigars(out, cigars):
    """One valid output cigar per input, covering it, with a match."""
    from cpecan_tpu_torch.cli.realign import cigar_io

    if len(out) != len(cigars):
        raise AssertionError(f"{len(out)} cigars out for {len(cigars)} in")
    for o, c in zip(out, cigars):
        o.check()
        if ((o.contig1, o.start1, o.end1, o.strand1, o.contig2, o.start2,
             o.end2, o.strand2) != (c.contig1, c.start1, c.end1, c.strand1,
                                    c.contig2, c.start2, c.end2, c.strand2)):
            raise AssertionError(f"output {o} does not cover input {c}")
        if not any(op == cigar_io.MATCH for op, _ in o.operations):
            raise AssertionError(f"output {o} has no match")


def _run_realign(fasta, cigars, extra, card):
    """The main path on the card, with every kernel's launch count reset
    just before and read just after. Returns (launches, output cigars)."""
    from cpecan_tpu_torch.cli.realign import metrics
    from cpecan_tpu_torch.ops import fb_batch
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    metrics.reset()
    torch.cuda.synchronize()
    wf.reset_launch_counts()
    t0 = time.perf_counter()
    out = _realign(fasta, cigars, "cuda", extra)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(wf.LAUNCHES)
    if fb_batch.LAST_ENGINE != "cuda":
        raise AssertionError(f"engine {fb_batch.LAST_ENGINE!r}, not cuda")
    for k in ("fwd", "bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the main path")
    _check_cigars(out, cigars)
    snap = metrics.snapshot()
    cells = snap["counters"].get("dp_cells", 0)
    stages = ", ".join(f"{k} {v['seconds']:.2f} s"
                       for k, v in sorted(snap["stages"].items()))
    log(f"main path realign {' '.join(extra) or '(default)'}: {len(cigars)} "
        f"records in {dt:.2f} s on {card}: {len(cigars) / dt:.1f} records/s, "
        f"{cells / dt:.4g} DP cells/s; stages {stages}; launches {launches}")
    return launches, out


def _compare_cli(fasta, cigars, card_out, extra, near_ties=frozenset()):
    """The main path on the CPU (the kernels' plain versions) against the
    card's output for the same records: identical cigar operations and
    coordinates, scores within 1e-5 relative. The records are the first
    --batchPairs group of the card run, so both runs launch the same
    batches. Records in ``near_ties`` may differ in their operations."""
    cpu_out = _realign(fasta, cigars, "cpu", extra)
    if len(cpu_out) != len(card_out):
        raise AssertionError(f"{len(cpu_out)} CPU cigars, {len(card_out)} card")
    differ, worst = [], 0.0
    for i, (a, b) in enumerate(zip(card_out, cpu_out)):
        if ((a.contig1, a.start1, a.end1, a.strand1, a.contig2, a.start2,
             a.end2, a.strand2) != (b.contig1, b.start1, b.end1, b.strand1,
                                    b.contig2, b.start2, b.end2, b.strand2)):
            raise AssertionError(f"card cigar {a} has other coordinates "
                                 f"than CPU cigar {b}")
        if a.operations != b.operations:
            if i not in near_ties:
                raise AssertionError(f"card cigar {a} differs from CPU cigar {b}")
            differ.append(i)
        rel = abs(a.score - b.score) / max(abs(b.score), 1e-30)
        if rel > 1e-5:
            raise AssertionError(f"score {a.score} (card) vs {b.score} (CPU)")
        worst = max(worst, rel)
    n_ops = sum(len(a.operations) for a in card_out)
    log(f"card vs CPU realign {' '.join(extra) or '(default)'}: "
        f"{len(card_out)} records, {n_ops} cigar operations; operations "
        f"identical on all records but {differ} (MEA near-ties); max score "
        f"difference {worst:.3g} relative")


def _same_pairs(card, cpu, threshold):
    """Pair sets equal outside 1e-5 of the threshold; returns (pairs,
    threshold flips, max fixed-point difference)."""
    from cpecan_tpu_torch.cli.realign import PAIR_ALIGNMENT_PROB_1

    pa = {(int(x), int(y)): int(q)
          for q, x, y in zip(card["prob"], card["x"], card["y"])}
    pb = {(int(x), int(y)): int(q)
          for q, x, y in zip(cpu["prob"], cpu["x"], cpu["y"])}
    for key in pa.keys() ^ pb.keys():
        q = pa.get(key, pb.get(key))
        if abs(q / PAIR_ALIGNMENT_PROB_1 - threshold) >= 1e-5:
            raise AssertionError(f"pair {key} ({q}) only on one side")
    worst = max((abs(pa[k] - pb[k]) for k in pa.keys() & pb.keys()), default=0)
    return len(pa), len(pa.keys() ^ pb.keys()), worst


def _compare_card_cpu(fasta, seqs, cigars):
    """batch_posteriors on the card and on the CPU for the jobs the main
    path builds from ``cigars``, at the main path's parameters, in the
    default mode and in --mea's (match and gap posteriors). Pair sets
    must agree and fixed-point posteriors differ by at most 100/1e7; each
    record's MEA decode of the card's posteriors must score within 1e-5
    relative of the CPU's. Returns the records whose MEA alignments
    differ all the same (near-ties, which --mea may break either way)."""
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.cli import realign
    from cpecan_tpu_torch.models.state_machine import state_machine5

    p = realign.alignment_parameters(realign.make_parser().parse_args([fasta]))
    jobs = _realign_jobs(seqs, cigars, p)
    sm = state_machine5()
    near_ties, worst_score = set(), 0.0
    for mode in ("posterior_match", "posterior_all"):
        card = batch.batch_posteriors(sm, jobs, p, mode=mode, device="cuda")
        cpu = batch.batch_posteriors(sm, jobs, p, mode=mode, device="cpu")
        n_pairs, flips, worst = 0, 0, 0
        for i, (a, b, (x, y, *_)) in enumerate(zip(card, cpu, jobs)):
            for oa, ob in (zip(a, b) if mode == "posterior_all" else [(a, b)]):
                n, f, w = _same_pairs(oa, ob, p.threshold)
                n_pairs, flips, worst = n_pairs + n, flips + f, max(worst, w)
            if mode == "posterior_all":
                ma, sa = realign.mea_decode(*a, x, y, p.gapGamma)
                mb, sb = realign.mea_decode(*b, x, y, p.gapGamma)
                rel = abs(sa - sb) / max(abs(sb), 1e-30)
                if rel > 1e-5:
                    raise AssertionError(
                        f"record {i}: MEA score {sa} (card) vs {sb} (CPU)")
                worst_score = max(worst_score, rel)
                if not (np.array_equal(ma["x"], mb["x"])
                        and np.array_equal(ma["y"], mb["y"])):
                    near_ties.add(i)
        if worst > 100:
            raise AssertionError(
                f"{mode}: fixed-point posteriors differ by {worst} > 100")
        log(f"card vs CPU batch_posteriors {mode}: {len(jobs)} records, "
            f"{n_pairs} pairs agree ({flips} threshold flips within 1e-5), "
            f"max prob diff {worst} / 1e7")
    log(f"card vs CPU MEA decode: scores within {worst_score:.3g} relative "
        f"on all {len(jobs)} records; alignments differ (near-ties) on "
        f"{sorted(near_ties)}")
    return near_ties


# ------------------------------------------------------------ EM


def _write_cigars(path, cigars):
    from cpecan_tpu_torch.cli.realign import cigar_io

    with open(path, "w") as fh:
        for c in cigars:
            cigar_io.cigar_write(fh, c)


def _em(fasta, cigar_file, out_model, device, extra):
    """cli/em.main at the EM defaults (--diagonalExpansion 10
    --splitMatrixBiggerThanThis 3000); returns the trained model."""
    from cpecan_tpu_torch.cli import em as em_cli
    from cpecan_tpu_torch.models.hmm import Hmm

    rc = em_cli.main([
        "--sequences", fasta, "--alignments", cigar_file,
        "--outputModel", out_model, "--device", device,
        "--diagonalExpansion", "10", "--splitMatrixBiggerThanThis", "3000",
        "--trainEmissions", "--randomStart", "--trials", "1", "--seed", "0",
        *extra])
    if rc != 0:
        raise RuntimeError(f"em exited with {rc}")
    return Hmm.load(out_model)


def phase_em_kernel(seqs, cigars, card, summary):
    """wavefront_exp against exp_reference on the EM main path's largest
    launch: the biggest (P, W) bucket of the first EM chunk at the EM
    defaults, built by em.py's own bucketing."""
    from cpecan_tpu_torch.em import em as em_mod
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    opts = em_mod.EmOptions()
    p = opts.pairwise_params()
    chunk = em_mod.split_alignments(cigars, opts.maxAlignmentLengthPerJob)[0][0]
    buckets, _ = em_mod.bucket_tasks(em_mod.tasks_from_cigars(chunk, seqs, p), p)
    (P, W), items = max(buckets.items(), key=lambda kv: len(kv[1]))
    args = [torch.from_numpy(a).cuda() for a in em_mod.bucket_arrays(items, P)]
    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    _, err, _ = _check_exp(wf, hmm, args, W, f"em_batch_{len(items)}_tasks",
                           card, reps=(10, 1))
    summary["exp"]["err"] = max(summary["exp"]["err"], err)
    torch.cuda.empty_cache()


def _run_em(fasta, cigar_file, out_model, n_records, extra, card):
    """The EM main path on the card, with every kernel's launch count reset
    just before and read just after; per-iteration seconds from the end
    of each maximisation step. Returns (launches, model)."""
    from cpecan_tpu_torch.em import em as em_mod
    from cpecan_tpu_torch.ops import fb_batch
    from cpecan_tpu_torch.ops import fb_wavefront as wf
    from cpecan_tpu_torch.utils import metrics

    marks = []
    real_m_step = em_mod.maximisation_step

    def timed_m_step(*a, **k):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return real_m_step(*a, **k)

    em_mod.maximisation_step = timed_m_step
    try:
        metrics.reset()
        torch.cuda.synchronize()
        wf.reset_launch_counts()
        t0 = time.perf_counter()
        hmm = _em(fasta, cigar_file, out_model, "cuda", extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(wf.LAUNCHES)
    finally:
        em_mod.maximisation_step = real_m_step
    if fb_batch.LAST_ENGINE != "cuda":
        raise AssertionError(f"engine {fb_batch.LAST_ENGINE!r}, not cuda")
    for k in ("fwd", "exp"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the EM path")
    if launches["bwd"] != 0:
        raise AssertionError(f"the EM path launched bwd {launches['bwd']} times")
    for name, arr in (("transitions", hmm.transitions), ("emissions", hmm.emissions)):
        if not np.isfinite(arr).all() or (arr < 0).any():
            raise AssertionError(f"trained {name} are not finite probabilities")
    np.testing.assert_allclose(hmm.transitions.sum(axis=1), 1.0, atol=1e-9)
    lk = hmm.running_likelihoods
    for a, b in zip(lk, lk[1:]):
        # the slack of tests/test_em.py:57-59
        if b < a - 0.05 * abs(a):
            raise AssertionError(f"likelihood fell: {lk}")
    per_iter = np.diff([t0] + marks)
    snap = metrics.snapshot()
    cells = snap["counters"].get("dp_cells", 0)
    stages = ", ".join(f"{k} {v['seconds']:.2f} s"
                       for k, v in sorted(snap["stages"].items()))
    log(f"main path em {' '.join(extra)}: {n_records} records x {len(lk)} "
        f"iterations in {dt:.2f} s on {card}: s per iteration "
        f"{', '.join(f'{s:.2f}' for s in per_iter)}; "
        f"{n_records * len(lk) / dt:.1f} records/s, "
        f"{cells / dt:.4g} expectation DP cells/s ({cells} cells); "
        f"stages {stages}; likelihoods {lk}; launches {launches}")
    return launches, hmm


def phase_em_profile(fasta, cigar_file, tmp, card):
    """One 5-state EM iteration over all records with torch.profiler
    tracing the device only (no host events): that run's device busy time
    (the sum of its kernels' and copies' times; one stream, so they do not
    overlap) against the same run's wall time, and the longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _em(fasta, cigar_file, f"{tmp}/em_profiled.hmm", "cuda",
            ["--iterations", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    if not busy > 0:
        raise AssertionError("the profiler recorded no device time")
    log(f"em profile (1 iteration, device tracing only, {card}): {wall:.3f} s "
        f"wall, device busy {1e3 * busy:.2f} ms in the same run "
        f"({100 * (1 - busy / wall):.2f}% idle); longest: "
        + ", ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.2f} ms x{e.count}"
                    for e in rows[:6]))


def _close_hmms(a, b, what):
    np.testing.assert_allclose(a.transitions, b.transitions, rtol=EM_RTOL,
                               err_msg=what)
    np.testing.assert_allclose(a.emissions, b.emissions, rtol=EM_RTOL,
                               err_msg=what)
    rel = abs(a.likelihood - b.likelihood) / abs(b.likelihood)
    if rel > EM_LIKE_RTOL:
        raise AssertionError(f"{what}: likelihood {a.likelihood} vs {b.likelihood}")
    rel_diff = lambda x, y: float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-300)))
    return rel_diff(a.transitions, b.transitions), rel_diff(a.emissions, b.emissions), rel


def phase_em_card_cpu(tmp, fasta, cigars):
    """EM (2 iterations) and realign --outputExpectations on the same
    records, on the card and with --device cpu."""
    from cpecan_tpu_torch.models.hmm import Hmm

    cig = f"{tmp}/compare.cigar"
    _write_cigars(cig, cigars)
    models = [_em(fasta, cig, f"{tmp}/cmp_{d}.hmm", d, ["--iterations", "2"])
              for d in ("cuda", "cpu")]
    worst = _close_hmms(*models, "em card vs CPU")
    np.testing.assert_allclose(models[0].running_likelihoods,
                               models[1].running_likelihoods, rtol=EM_LIKE_RTOL)
    log(f"card vs CPU em: {len(cigars)} records, 2 iterations; max relative "
        f"difference transitions {worst[0]:.3g}, emissions {worst[1]:.3g}, "
        f"likelihood {worst[2]:.3g}")
    exps = []
    for d in ("cuda", "cpu"):
        path = f"{tmp}/exp_{d}.hmm"
        out = _realign(fasta, cigars, d, ["--outputExpectations", path])
        if out:
            raise AssertionError("--outputExpectations wrote cigars")
        exps.append(Hmm.load(path))
    worst = _close_hmms(*exps, "realign --outputExpectations card vs CPU")
    log(f"card vs CPU realign --outputExpectations: {len(cigars)} records; "
        f"max relative difference transitions {worst[0]:.3g}, emissions "
        f"{worst[1]:.3g}, likelihood {worst[2]:.3g}")


# ------------------------------------------------------------ long pairs

# the long_500kb configuration (bench.py:616-622): one genomic-like pair,
# planted-truth evolved at 8% substitutions, random.Random(3)
LONG_PAIR = 500_000
LONG_RECORDS = (100_000, 150_000, 200_000)
LONG_EM_RECORDS = (100_000, 100_000)
FORCED_RECORDS = (3_000, 3_200)  # streamed by a patched budget, card vs CPU
CHECK_PAIR, CHECK_WINDOW, CHECK_BURNIN = 2_000, 128, 64
# realign through anchor-free gaps up to 3000 x 3000 (the library's and
# EM's split), so a long anchored record stays one chunk
LONG_SPLIT = ["--splitMatrixBiggerThanThis", "3000"]

# launch-count site -> (kernel, TPU kernel site, JSON name)
SITES = {
    "fwd": ("fwd", "cpecan_tpu/ops/fb_wavefront.py:235", "wavefront_fwd"),
    "bwd": ("bwd", "cpecan_tpu/ops/fb_wavefront.py:404", "wavefront_bwd"),
    "exp": ("exp", "cpecan_tpu/ops/fb_wavefront.py:592", "wavefront_exp"),
    "seg_fwd": ("fwd", "cpecan_tpu/ops/fb_segmented.py:189",
                "wavefront_fwd_segmented"),
    "seg_bwd": ("bwd", "cpecan_tpu/ops/fb_segmented.py:301",
                "wavefront_bwd_segmented"),
    "seg_exp": ("exp", "cpecan_tpu/ops/fb_segmented.py:422",
                "wavefront_exp_segmented"),
    "par_fwd": ("fwd", "cpecan_tpu/ops/fb_parallel.py:259",
                "wavefront_fwd_parallel"),
    "par_bwd": ("bwd", "cpecan_tpu/ops/fb_parallel.py:313",
                "wavefront_bwd_parallel"),
    # the wide variants (W > MAX_KERNEL_WIDTH), counted at every site
    "wide_fwd": ("fwd", "cpecan_tpu/ops/fb_wavefront.py:235",
                 "wavefront_fwd_wide"),
    "wide_bwd": ("bwd", "cpecan_tpu/ops/fb_wavefront.py:404",
                 "wavefront_bwd_wide"),
    "wide_exp": ("exp", "cpecan_tpu/ops/fb_wavefront.py:592",
                 "wavefront_exp_wide"),
}
LONG_SITES = ("seg_fwd", "seg_bwd", "seg_exp", "par_fwd", "par_bwd")
WIDE_SITES = ("wide_fwd", "wide_bwd", "wide_exp")


@contextlib.contextmanager
def _capture(sites, size=lambda args: args[1].numel()):
    """Keep, for each launch-count site in ``sites``, the arguments of its
    largest wrapper call (by ``size``: the stream's elements, or another
    measure) while the block runs (every call goes through). Yields
    {site: (args, kwargs)}."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    saved = wf.fwd, wf.bwd, wf.exp
    kept, sizes = {}, {}

    def wrap(fn, default):
        def call(*args, site=default, **kw):
            out = fn(*args, site=site, **kw)
            if site in sites and size(args) > sizes.get(site, -1):
                kept[site], sizes[site] = (args, kw), size(args)
            return out
        return call

    wf.fwd, wf.bwd, wf.exp = (wrap(saved[0], "fwd"), wrap(saved[1], "bwd"),
                              wrap(saved[2], "exp"))
    try:
        yield kept
    finally:
        wf.fwd, wf.bwd, wf.exp = saved


def _flat(out, prefix="out"):
    """Named tensors of a wrapper's (nested) outputs."""
    if torch.is_tensor(out):
        return [(prefix, out)]
    return [t for i, o in enumerate(out) for t in _flat(o, f"{prefix}.{i}")]


# output index -> tolerance key, per kernel (the rest: F, bv, carries)
_OUT_KEYS = {"fwd": {"out.2": "mf"},
             "bwd": {"out.0.0": "post_match", "out.0.1": "post_gap_x",
                     "out.0.2": "post_gap_y", "out.1": "mb", "out.2": "total_raw"},
             "exp": {"out.0": "counts", "out.1": "counts", "out.2": "exp_rows",
                     "out.3": "exp_rows"}}


def _check_site(site, entry, S, nz, what, card, reps=5):
    """One captured launch of ``site`` again, on its own inputs (tensors on
    the card), through the kernel and through its plain version: outputs
    within the tolerances (TOLERANCES; counts EXP_RTOL; F, bv and the
    carries rtol 1e-4 against a row max of 1), CUDA-event medians of both,
    and the bound. Returns (max_abs_err, ms, plain_ms, (bound_ms, by))."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    kind = SITES[site][0]
    args, kw = entry
    kern = getattr(wf, kind)
    plain = getattr(wf, f"{kind}_reference")
    got = _flat(kern(*args, site=site, **kw))
    want = _flat(plain(*args, **kw))
    torch.cuda.synchronize()
    err = 0.0
    for (name, g), (_, w_) in zip(got, want):
        g, w_ = g.float().cpu(), w_.float().cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{site} output {name} is not finite")
        key = _OUT_KEYS[kind].get(name)
        if key == "counts":
            tol = (EXP_RTOL, 1e-6)
        elif key == "exp_rows":
            tol = (0.0, 1e-5)
        else:
            tol = TOLERANCES.get(key, (1e-4, 1e-6))
        torch.testing.assert_close(g, w_, rtol=tol[0], atol=tol[1],
                                   msg=f"{site} {name}")
        err = max(err, float((g - w_).abs().max()) if g.numel() else 0.0)
    ms = _median_ms(lambda: kern(*args, site=site, **kw), reps)
    plain_ms = _median_ms(lambda: plain(*args, **kw), 1)
    B, R, W = args[1].shape
    bound = _bound(B, R, W, S, nz, kind, window=True)
    log(f"  {site} at {what}: B={B} R={R} W={W}; kernel {ms:.3f} ms "
        f"({1e3 * ms / R:.2f} us per diagonal), plain {plain_ms:.1f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]}), max abs err {err:.3g} ({card})")
    if kind == "bwd":
        direct = _bwd_direct(args, kw, S, W, reps, kern(*args, site=site, **kw))
        if direct is not None:
            log(f"    its direct-load variant: {direct:.3f} ms "
                f"({1e3 * direct / R:.2f} us per diagonal)")
    return err, ms, plain_ms, bound


def _bwd_direct(args, kw, S, W, reps, ring_out):
    """Where wavefront_bwd's plan at (S, W) has a ring: the same launch
    with pm off the 16-byte grid, which runs the direct-load variant; its
    outputs within TOLERANCES of ``ring_out`` (the ring variant's) and
    its CUDA-event median in ms. None where the plan has no ring (and for
    the wide variant)."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    if (W > wf.MAX_KERNEL_WIDTH or not wf.bwd_plan(S, W)["depth"]
            or not _on_grid(args)):
        return None
    moved = list(args)
    moved[12] = _off_grid(args[12])
    for (name, g), (_, r) in zip(_flat(wf.bwd(*moved, **kw)), _flat(ring_out)):
        rtol, atol = TOLERANCES.get(_OUT_KEYS["bwd"].get(name), (1e-4, 1e-6))
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol,
                                   msg=f"bwd direct-load variant {name}")
    return _median_ms(lambda: wf.bwd(*moved, **kw), reps)


def _dense(entries, rows, W):
    vals, ks, js = entries
    out = np.zeros((rows, W))
    out[ks, js] = vals
    return out


def _compare_streams(got, want, L, W, what, count_rtol=EXP_RTOL):
    """Exact-engine outputs against another run's: scale streams and
    posteriors within TOLERANCES, counts within ``count_rtol``. Returns
    the largest absolute difference."""
    errs = {}
    for k in ("mf", "mb", "total_raw"):
        if k in want:
            a, b = np.asarray(got[k][1:L + 1]), np.asarray(want[k][1:L + 1])
            np.testing.assert_allclose(a, b, *TOLERANCES[k], err_msg=f"{what} {k}")
            errs[k] = float(np.abs(a - b).max())
    if "log_fwd" in want:
        lf = lambda o: o["log_fwd"] + np.sum(o["mf"][:L + 1], dtype=np.float64)
        np.testing.assert_allclose(lf(got), lf(want), rtol=1e-6, atol=1e-4,
                                   err_msg=f"{what} log-likelihood")
    for k in ("trans", "emis"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=count_rtol,
                                       atol=1e-6, err_msg=f"{what} {k}")
            errs[k] = float(np.abs(got[k] - want[k]).max())
            errs[k + "_rel"] = float(np.max(np.abs(got[k] - want[k])
                                            / np.maximum(np.abs(want[k]), 1e-30)))
    for k, entries in want.get("post_entries", {}).items():
        a = _dense(got["post_entries"][k], L + 1, W)
        b = _dense(entries, L + 1, W)
        np.testing.assert_allclose(a, b, *TOLERANCES[k], err_msg=f"{what} {k}")
        errs[k] = float(np.abs(a - b).max())
    log(f"  {what}: max abs " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return max((v for k, v in errs.items() if not k.endswith("_rel")),
               default=0.0)


def _stream(hmm, x, y, band, mode, W, window, burnin, engine, threshold=0.0):
    from cpecan_tpu_torch.ops import fb_streaming
    from cpecan_tpu_torch.utils.symbols import encode

    return fb_streaming.fb_pass_streaming(
        hmm, encode(x), encode(y), band.offsets, band.widths, len(x), len(y),
        False, False, mode, W, window, burnin, threshold=threshold,
        engine=engine)


def _two_pass(hmm, x, y, band, mode, W):
    """The batch path's kernels on one pair as a batch of one, in the
    streaming engines' return contract."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf
    from cpecan_tpu_torch.ops.band import pad_band
    from cpecan_tpu_torch.utils.symbols import encode

    L = len(x) + len(y)
    o, w, _ = pad_band(band, L, W)
    args = [torch.from_numpy(np.asarray(a)).to(hmm.t.device) for a in (
        encode(x)[None], encode(y)[None], o[None], w[None], [len(x)],
        [len(y)], [False], [False])]
    out = wf.fb_pass_batch_wavefront(hmm, *args, mode=mode, width=W)
    res = {"log_fwd": float(out["log_fwd"][0]), "post_entries": {}}
    for k in ("mf", "mb", "total_raw"):
        if k in out:
            res[k] = out[k][0].double().cpu().numpy()
    for k in ("trans", "emis"):
        if k in out:
            res[k] = out[k].double().cpu().numpy()
    for k in ("post_match", "post_gap_x", "post_gap_y"):
        if k in out:
            ks, js = torch.nonzero(out[k][0] >= 1e-9, as_tuple=True)
            res["post_entries"][k] = tuple(
                v.cpu().numpy() for v in (out[k][0, ks, js], ks, js))
    return res


def _likelihood(o, L):
    """A chunk's EM likelihood contribution (em.py's float64
    recombination of the per-diagonal totals)."""
    cf = np.cumsum(np.asarray(o["mf"][:L + 1], np.float64))
    cb = np.cumsum(np.asarray(o["mb"][:L + 1], np.float64)[::-1])[::-1]
    return float(np.sum(np.asarray(o["total_raw"][1:L + 1], np.float64)
                        + cf[1:] + cb[1:]))


def phase_long_kernels(card, sites):
    """Kernels with carries against their plain versions on a 2 kb
    evolved pair (windows of CHECK_WINDOW rows, tens of them): the exact
    engine in every mode and the parallel engine, each run through the
    kernels and again through their plain versions on the same card
    tensors; the exact engine's scale streams and posteriors against the
    two-pass kernels'. Per site: the error and one window launch's time."""
    from cpecan_tpu_torch.align.anchors import get_anchors
    from cpecan_tpu_torch.align.pairwise import _width_bucket
    from cpecan_tpu_torch.config import PairwiseAlignmentParameters
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_parallel
    from cpecan_tpu_torch.ops import fb_wavefront as wf
    from cpecan_tpu_torch.ops.band import construct_band
    from cpecan_tpu_torch.utils.symbols import encode

    rng = np.random.default_rng(7)
    x = _ACGT[rng.integers(0, 4, CHECK_PAIR)].tobytes().decode()
    y = _evolve(x, rng)
    p = PairwiseAlignmentParameters()
    band = construct_band([(int(a[0]), int(a[1])) for a in get_anchors(x, y, p)],
                          len(x), len(y), p.diagonalExpansion)
    W = _width_bucket(band.frame_width())
    L = len(x) + len(y)
    sm = state_machine5()
    hmm = PairHMM.from_state_machine(sm).cuda()
    log(f"long-pair kernels: a {len(x)} x {len(y)} evolved pair, W={W}, "
        f"{-(-L // CHECK_WINDOW)} windows of {CHECK_WINDOW} rows (burn-in "
        f"{CHECK_BURNIN} for the parallel engine)")
    exact = None
    for mode, engine in (("posterior_all", "exact"), ("expectation", "exact"),
                         ("forward", "exact"), ("posterior_all", "parallel")):
        if engine == "exact":
            run = lambda: _stream(hmm, x, y, band, mode, W, CHECK_WINDOW,
                                  CHECK_BURNIN, engine)
        else:
            run = lambda: fb_parallel.fb_pass_parallel(
                hmm, encode(x), encode(y), band.offsets, band.widths, len(x),
                len(y), False, False, mode, W, burnin=CHECK_BURNIN,
                threshold=0.0, window=CHECK_WINDOW)
        wf.reset_launch_counts()
        with _capture(LONG_SITES) as kept:
            got = run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in wf.LAUNCHES.items() if v}
        with _plain_versions():
            want = run()
        err = _compare_streams(got, want, L, W,
                               f"{engine} {mode} kernels vs plain ({launches})")
        for site, entry in kept.items():
            e, ms, _, _ = _check_site(site, entry, sm.state_number, hmm.nz,
                                      "one 2 kb window", card, reps=10)
            sites[site]["err"] = max(sites[site]["err"], err, e)
            sites[site]["ms_2kb"] = ms
        if (mode, engine) == ("posterior_all", "exact"):
            exact = got
    two = _two_pass(hmm, x, y, band, "posterior_all", W)
    _compare_streams(exact, two, L, W, "exact engine vs two-pass kernels")
    torch.cuda.empty_cache()


def _truth_cigar(truth, lx, ly, names, cigar_io):
    """A planted-truth alignment as a cigar record (runs of aligned pairs,
    gaps between them)."""
    ops = []

    def push(op, n):
        if n > 0:
            if ops and ops[-1][0] == op:
                ops[-1] = (op, ops[-1][1] + n)
            else:
                ops.append((op, n))

    px = py = -1
    for tx, ty in truth:
        push(cigar_io.INDEL_X, tx - px - 1)
        push(cigar_io.INDEL_Y, ty - py - 1)
        push(cigar_io.MATCH, 1)
        px, py = tx, ty
    push(cigar_io.INDEL_X, lx - px - 1)
    push(cigar_io.INDEL_Y, ly - py - 1)
    return cigar_io.PairwiseAlignment(names[0], 0, lx, True, names[1], 0, ly,
                                      True, 0.0, ops)


def _planted_records(lengths, seed, prefix):
    """Genomic-like records (upper case) evolved at 8% substitutions with
    their planted-truth cigars: (sequences, cigars)."""
    import random

    from cpecan_tpu_torch.cli.realign import cigar_io
    from cpecan_tpu_torch.utils.symbols import genomic_like_sequence, tracked_evolve

    rng = random.Random(seed)
    seqs, cigars = {}, []
    for i, n in enumerate(lengths):
        x = genomic_like_sequence(n, rng).upper()
        y, truth = tracked_evolve(x, rng, sub_rate=0.08)
        names = (f"{prefix}x{i}", f"{prefix}y{i}")
        seqs[names[0]], seqs[names[1]] = x, y
        cigars.append(_truth_cigar(truth, len(x), len(y), names, cigar_io))
    return seqs, cigars


def _streamed_tasks(jobs, p):
    """The chunks of ``jobs`` that the batch path streams, longest first:
    [(task, band, W)]."""
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.align.pairwise import _width_bucket
    from cpecan_tpu_torch.ops import fb_streaming

    out = []
    for t in batch._expand_jobs(jobs, p):
        band = batch._band_of(t, p)
        W = _width_bucket(band.frame_width())
        if fb_streaming.should_stream(band.diagonal_number, W):
            out.append((t, band, W))
    return sorted(out, key=lambda e: -e[1].diagonal_number)


def _same_pair_sets(a, b, what):
    """test_parallel.py:122-138's tolerance: symmetric difference at most
    max(2, 2%), common pairs within 2e-2 (fixed point, units of 1e7)."""
    ka = {(int(x), int(y)): int(q) for q, x, y in zip(a["prob"], a["x"], a["y"])}
    kb = {(int(x), int(y)): int(q) for q, x, y in zip(b["prob"], b["x"], b["y"])}
    sym = ka.keys() ^ kb.keys()
    if len(sym) > max(2, len(kb) // 50):
        raise AssertionError(f"{what}: {len(sym)} of {len(kb)} pairs differ")
    worst = max((abs(ka[k] - kb[k]) for k in ka.keys() & kb.keys()), default=0)
    if worst >= 2e-2 * 1e7 + 30:
        raise AssertionError(f"{what}: a pair probability differs by {worst}/1e7")
    log(f"  {what}: {len(kb)} pairs, {len(sym)} differ, max prob diff "
        f"{worst}/1e7")


def phase_long_pair(card, sites):
    """The long_500kb configuration through get_aligned_pairs on the card
    (anchors, split, streaming through the parallel engine, decode), then
    its longest streamed chunk through the exact engine; the two engines'
    pair sets must agree. Captures the full-size launches of sites 4, 5,
    7 and 8 and checks them against their plain versions."""
    import random

    from cpecan_tpu_torch.align import batch, pairwise
    from cpecan_tpu_torch.align.anchors import get_anchors
    from cpecan_tpu_torch.config import PairwiseAlignmentParameters
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.msa.aligner import (
        filter_pairwise_alignment_to_make_pairs_ordered)
    from cpecan_tpu_torch.ops import fb_parallel, fb_streaming
    from cpecan_tpu_torch.ops import fb_wavefront as wf
    from cpecan_tpu_torch.ops import pairs as pairs_mod
    from cpecan_tpu_torch.utils import metrics
    from cpecan_tpu_torch.utils.symbols import (
        genomic_like_sequence, tracked_evolve)

    rng = random.Random(3)
    x = genomic_like_sequence(LONG_PAIR, rng)
    y, truth = tracked_evolve(x, rng, sub_rate=0.08)
    sm, p = state_machine5(), PairwiseAlignmentParameters()
    hmm = PairHMM.from_state_machine(sm).cuda()
    metrics.reset()
    torch.cuda.synchronize()
    wf.reset_launch_counts()
    with _capture(("par_fwd", "par_bwd")) as kept:
        t0 = time.perf_counter()
        pairs = pairwise.get_aligned_pairs(sm, x, y, p, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(wf.LAUNCHES)
    snap = metrics.snapshot()
    st, ctr = snap["stages"], snap["counters"]
    host = sum(st.get(k, {}).get("seconds", 0.0)
               for k in ("host_anchoring", "host_prep"))
    if fb_streaming.LAST_ENGINE != "parallel":
        raise AssertionError(f"streaming engine {fb_streaming.LAST_ENGINE!r}")
    for k in ("par_fwd", "par_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by the 500 kb path")
    ordered = filter_pairwise_alignment_to_make_pairs_ordered(
        pairs_mod.sort_pairs(pairs), x, y, 0.9)
    pred = {(int(a), int(b)) for a, b in zip(ordered["x"], ordered["y"])}
    tp = len(pred & set(truth))
    sens, spec = tp / max(len(truth), 1), tp / max(len(pred), 1)
    if not sens > 0.5:
        raise AssertionError(f"500 kb sensitivity {sens}")
    log(f"long pair {len(x)} x {len(y)} (long_500kb) on {card}: "
        f"get_aligned_pairs {wall:.2f} s wall, host (anchoring + prep) "
        f"{host:.2f} s, fb_stream {st.get('fb_stream', {}).get('seconds', 0):.2f} s; "
        f"{ctr.get('streamed_chunks', 0)} streamed chunks, "
        f"{ctr.get('stream_windows', 0)} windows, {ctr.get('dp_cells', 0)} "
        f"DP cells; launches "
        f"{ {k: v for k, v in launches.items() if v} }; {len(pairs)} pairs; "
        f"sensitivity {sens:.4f}, specificity {spec:.4f}")
    sites["par_fwd"]["launches"] = launches["par_fwd"]
    sites["par_bwd"]["launches"] = launches["par_bwd"]
    for site, entry in kept.items():
        e, ms, plain_ms, bound = _check_site(
            site, entry, 5, hmm.nz, "the 500 kb path's largest slice", card)
        sites[site].update(err=max(sites[site]["err"], e), ms=ms,
                           plain_ms=plain_ms, bound=bound)
    del kept

    # the longest streamed chunk through both engines
    t, band, W = _streamed_tasks([(x, y, get_anchors(x, y, p), False, False)], p)[0]
    L = band.diagonal_number
    args = (hmm, t.sub_x, t.sub_y, band, "posterior_match", W,
            fb_streaming.window_rows(p), fb_parallel.burnin_rows(p))
    torch.cuda.synchronize()
    wf.reset_launch_counts()
    with _capture(("seg_fwd", "seg_bwd")) as kept:
        t0 = time.perf_counter()
        ex_out = _stream(*args, "exact", threshold=p.threshold)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(wf.LAUNCHES)
    for k in ("seg_fwd", "seg_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by the exact engine")
        sites[k]["launches"] = launches[k]
    par_out = _stream(*args, "parallel", threshold=p.threshold)
    log(f"  longest streamed chunk: {len(t.sub_x)} x {len(t.sub_y)}, "
        f"L={L}, W={W}: exact engine {dt:.3f} s on {card} "
        f"({1e6 * dt / L:.2f} us per diagonal, {ex_out['windows']} windows "
        f"of {fb_streaming.window_rows(p)}), launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    to_pairs = lambda o: batch._stream_entries_to_pairs(
        o["post_entries"]["post_match"], o["xoff"], L, 0, 0)
    _same_pair_sets(to_pairs(par_out), to_pairs(ex_out),
                    "parallel vs exact engine on that chunk")
    for site, entry in kept.items():
        e, ms, plain_ms, bound = _check_site(
            site, entry, 5, hmm.nz, "the exact engine on that chunk", card)
        sites[site].update(err=max(sites[site]["err"], e), ms=ms,
                           plain_ms=plain_ms, bound=bound)
    torch.cuda.empty_cache()
    return {"wall_s": wall, "host_s": host, "exact_s": dt, "L": L}


def _realign_jobs(seqs, cigars, p):
    """The batch jobs realign builds from cigar records: anchors from the
    cigars' match runs, filtered to exact base matches, ragged ends."""
    from cpecan_tpu_torch.cli import realign

    jobs = []
    for c in cigars:
        x, y = seqs[c.contig1], seqs[c.contig2]
        anchors = realign.filter_anchors_to_matches(
            realign.cigar_io.alignment_to_anchor_pairs(
                c, p.constraintDiagonalTrim, p.diagonalExpansion), x, y)
        jobs.append((x, y, anchors, True, True))
    return jobs


@contextlib.contextmanager
def _forced_streaming():
    """Every chunk streams (a 1-byte budget)."""
    from cpecan_tpu_torch.ops import fb_streaming

    saved = fb_streaming._STREAM_BUDGET
    fb_streaming._STREAM_BUDGET = 1
    try:
        yield
    finally:
        fb_streaming._STREAM_BUDGET = saved


def _write_fasta(path, seqs):
    with open(path, "w") as fh:
        for k, v in seqs.items():
            fh.write(f">{k}\n{v}\n")


def phase_long_realign(card, tmp):
    """The realign CLI on long records (planted-truth cigars, so the band
    follows the alignment; split at 3000 x 3000 so each record stays one
    chunk that streams): default decode on all, --mea on the first. Then
    the first record's chunk through the exact engine against the two-pass
    kernels, and card against CPU on short records whose every chunk is
    made to stream."""
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.cli import realign
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_parallel, fb_streaming
    from cpecan_tpu_torch.ops import fb_wavefront as wf
    from cpecan_tpu_torch.utils import metrics

    seqs, cigars = _planted_records(LONG_RECORDS, 11, "long")
    fasta = f"{tmp}/long.fa"
    _write_fasta(fasta, seqs)
    bases = {c.contig1: c.end1 - c.start1 for c in cigars}
    for extra, recs in (([], cigars), (["--mea"], cigars[:1])):
        metrics.reset()
        torch.cuda.synchronize()
        wf.reset_launch_counts()
        t0 = time.perf_counter()
        out = _realign(fasta, recs, "cuda", LONG_SPLIT + extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in wf.LAUNCHES.items() if v}
        if fb_streaming.LAST_ENGINE != "parallel" or not (
                launches.get("par_fwd") and launches.get("par_bwd")):
            raise AssertionError(f"long records did not stream through the "
                                 f"parallel engine: {launches}")
        _check_cigars(out, recs)
        snap = metrics.snapshot()
        stages = ", ".join(f"{k} {v['seconds']:.2f} s"
                           for k, v in sorted(snap["stages"].items()))
        n_bases = sum(bases[c.contig1] for c in recs)
        log(f"long records realign {' '.join(extra) or '(default)'}: "
            f"{len(recs)} records of {', '.join(str(bases[c.contig1]) for c in recs)} "
            f"bases in {dt:.2f} s on {card}: {len(recs) / dt:.3f} records/s, "
            f"{n_bases / dt:.4g} bases/s; streamed chunks "
            f"{snap['counters'].get('streamed_chunks', 0)}, windows "
            f"{snap['counters'].get('stream_windows', 0)}; stages {stages}; "
            f"launches {launches}")

    p = realign.alignment_parameters(
        realign.make_parser().parse_args([fasta] + LONG_SPLIT))
    sm = state_machine5()
    hmm = PairHMM.from_state_machine(sm).cuda()
    t, band, W = _streamed_tasks(_realign_jobs(seqs, cigars[:1], p), p)[0]
    L = band.diagonal_number
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = _stream(hmm, t.sub_x, t.sub_y, band, "posterior_match", W,
                 fb_streaming.window_rows(p), fb_parallel.burnin_rows(p),
                 "exact")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    two = _two_pass(hmm, t.sub_x, t.sub_y, band, "posterior_match", W)
    _compare_streams(ex, two, L, W,
                     f"record 0's chunk (L={L}, W={W}, F "
                     f"{(L + 1) * 5 * W * 4 / 1e6:.0f} MB two-pass): exact "
                     f"engine ({dt:.3f} s, {1e6 * dt / L:.2f} us per "
                     f"diagonal) vs two-pass kernels")
    del two
    torch.cuda.empty_cache()

    fseqs, fcigars = _planted_records(FORCED_RECORDS, 13, "forced")
    jobs = _realign_jobs(fseqs, fcigars, p)
    with _forced_streaming():
        card_pairs = batch.batch_posteriors(sm, jobs, p, device="cuda")
        engines = [fb_streaming.LAST_ENGINE]
        cpu_pairs = batch.batch_posteriors(sm, jobs, p, device="cpu")
        engines.append(fb_streaming.LAST_ENGINE)
    if engines != ["parallel", "exact"]:
        raise AssertionError(f"forced streaming ran engines {engines}")
    for i, (a, b) in enumerate(zip(card_pairs, cpu_pairs)):
        _same_pair_sets(a, b, f"forced streaming record {i} "
                              f"({FORCED_RECORDS[i]} bases): card parallel vs "
                              f"CPU exact")


def phase_long_em(card, tmp, short_seqs, short_cigars, sites):
    """EM on a corpus with long records: one 5-state iteration of the EM
    CLI on the card (long chunks stream through the segmented exp
    kernel); the exact engine's counts and likelihood on one long chunk
    against the two-pass kernels'; card against CPU (2 iterations) on
    short records whose every chunk is made to stream."""
    from cpecan_tpu_torch.em import em as em_mod
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_parallel, fb_streaming
    from cpecan_tpu_torch.ops import fb_wavefront as wf
    from cpecan_tpu_torch.utils import metrics

    lseqs, lcigars = _planted_records(LONG_EM_RECORDS, 17, "em")
    seqs = {**short_seqs, **lseqs}
    cigars = lcigars + short_cigars[:COMPARE_RECORDS]
    fasta, cig = f"{tmp}/em_long.fa", f"{tmp}/em_long.cigar"
    _write_fasta(fasta, seqs)
    _write_cigars(cig, cigars)
    metrics.reset()
    torch.cuda.synchronize()
    wf.reset_launch_counts()
    with _capture(("seg_exp",)) as kept:
        t0 = time.perf_counter()
        model = _em(fasta, cig, f"{tmp}/em_long.hmm", "cuda",
                    ["--modelType", "fiveState", "--iterations", "1"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: v for k, v in wf.LAUNCHES.items() if v}
    for k in ("seg_fwd", "seg_exp"):
        if not launches.get(k):
            raise AssertionError(f"{k} was not launched by the EM path: {launches}")
    if not (np.isfinite(model.likelihood)
            and np.all(np.isfinite(model.running_likelihoods))):
        raise AssertionError(f"EM likelihood {model.likelihood} is not finite")
    snap = metrics.snapshot()
    stages = ", ".join(f"{k} {v['seconds']:.2f} s"
                       for k, v in sorted(snap["stages"].items()))
    log(f"long records em: {len(lcigars)} records of {LONG_EM_RECORDS} bases "
        f"and {COMPARE_RECORDS} of 1 kb, 1 iteration in {dt:.2f} s on {card}; "
        f"streamed chunks {snap['counters'].get('streamed_chunks', 0)}; "
        f"stages {stages}; likelihood {model.likelihood}; launches {launches}")
    sites["seg_exp"]["launches"] = launches["seg_exp"]
    sm = state_machine5()
    hmm = PairHMM.from_state_machine(sm).cuda()
    e, ms, plain_ms, bound = _check_site(
        "seg_exp", kept["seg_exp"], 5, hmm.nz, "the EM path's long chunk", card)
    sites["seg_exp"].update(err=max(sites["seg_exp"]["err"], e), ms=ms,
                            plain_ms=plain_ms, bound=bound)
    del kept

    p = em_mod.EmOptions().pairwise_params()
    _, streamed = em_mod.bucket_tasks(
        em_mod.tasks_from_cigars(lcigars[:1], seqs, p), p)
    t, band, W = max(streamed, key=lambda e: e[1].diagonal_number)
    L = band.diagonal_number
    ex = _stream(hmm, t.sub_x, t.sub_y, band, "expectation", W,
                 fb_streaming.window_rows(p), fb_parallel.burnin_rows(p),
                 "exact")
    two = _two_pass(hmm, t.sub_x, t.sub_y, band, "expectation", W)
    _compare_streams(ex, two, L, W, f"EM chunk (L={L}, W={W}): exact engine "
                                    f"vs two-pass kernels", SEG_COUNT_RTOL)
    la, lb = _likelihood(ex, L), _likelihood(two, L)
    if abs(la - lb) > EM_LIKE_RTOL * abs(lb):
        raise AssertionError(f"EM chunk likelihood {la} (exact) vs {lb}")
    log(f"  its likelihood contribution {la} vs {lb} (two-pass): "
        f"{abs(la - lb) / abs(lb):.3g} relative")
    torch.cuda.empty_cache()

    fseqs, fcigars = _planted_records(FORCED_RECORDS, 19, "emforced")
    ffasta, fcig = f"{tmp}/em_forced.fa", f"{tmp}/em_forced.cigar"
    _write_fasta(ffasta, fseqs)
    _write_cigars(fcig, fcigars)
    with _forced_streaming():
        models = [_em(ffasta, fcig, f"{tmp}/em_forced_{d}.hmm", d,
                      ["--iterations", "2"]) for d in ("cuda", "cpu")]
    worst = _close_hmms(*models, "em forced streaming card vs CPU")
    np.testing.assert_allclose(models[0].running_likelihoods,
                               models[1].running_likelihoods, rtol=EM_LIKE_RTOL)
    log(f"card vs CPU em, every chunk streamed: {len(fcigars)} records of "
        f"{FORCED_RECORDS} bases, 2 iterations; max relative difference "
        f"transitions {worst[0]:.3g}, emissions {worst[1]:.3g}, likelihood "
        f"{worst[2]:.3g}")


# bands wider than the shared-memory variants take (wide variants): a
# full band of two evolved 1 kb pairs padded out to these widths (the
# second off the 16-byte grid; the kernels' work per diagonal is set by
# W, while the plain versions' time grows with R); and a record whose cigar leaves an anchor-free 4.5 kb gap
# between two 1 kb flanks, realigned (and trained on) with the split at
# 5000 x 5000, so the gap stays in one chunk
WIDE_WIDTHS = (4352, 8200)
GAP_FLANK, GAP_MIDDLE = 1000, 4500
GAP_SPLIT = ["--splitMatrixBiggerThanThis", "5000"]


def _timed(fn):
    """(output, ms) of one call, CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _wide_batch(card, sites):
    """The batch path's three kernels at W > MAX_KERNEL_WIDTH (the wide
    variants) against their plain versions on the same card tensors, with
    times; the first width's numbers go to the JSON summary."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    S = hmm.state_number
    for width in WIDE_WIDTHS:
        bt = _band_batch(np.random.default_rng(5), 2, 2 * SEQ_LEN + 200,
                         "posterior_all", state_machine5, full=True,
                         evolve=True, seq_len=SEQ_LEN, width=width)
        W = bt["W"]
        if W <= wf.MAX_KERNEL_WIDTH:
            raise AssertionError(f"wide batch has W={W}")
        pre = wf.precompute(hmm, *bt["args"], width=W)
        L = bt["args"][4].long() + bt["args"][5].long()
        ein = _exp_inputs(wf, hmm, pre)
        fin = (ein[0], pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"],
               pre["b0"], pre["F0"], hmm.nz)
        bin_ = (*ein[:5], *ein[7:14], pre["pm"], pre["end_row"], hmm.nz,
                "posterior_all")
        B, R, _ = pre["ex"].shape
        wf.reset_launch_counts()
        res = {}
        for k, args in (("fwd", fin), ("bwd", bin_), ("exp", ein)):
            got = getattr(wf, k)(*args)
            ms = _median_ms(lambda: getattr(wf, k)(*args), 3)
            want, plain_ms = _timed(lambda: getattr(wf, f"{k}_reference")(*args))
            if k == "fwd":
                err = max(_max_err({"mf": got[2]}, {"mf": want[2]}, L).values())
                torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-6)
            elif k == "bwd":
                keys = ("post_match", "post_gap_x", "post_gap_y")
                err = max(_max_err(
                    {**dict(zip(keys, got[0])), "mb": got[1], "total_raw": got[2]},
                    {**dict(zip(keys, want[0])), "mb": want[1], "total_raw": want[2]},
                    L).values())
            else:
                err = _exp_errs(got, want, L)[0]
            res[k] = (err, ms, plain_ms, _bound(B, R, W, S, hmm.nz, k))
            log(f"wide {k}: B={B} R={R} W={W}; kernel {ms:.3f} ms "
                f"({1e3 * ms / R:.2f} us per diagonal), plain {plain_ms:.1f} ms, "
                f"bound {res[k][3][0]:.4f} ms ({res[k][3][1]}), max abs err "
                f"{err:.3g} ({card})")
        if any(wf.LAUNCHES[f"wide_{k}"] <= 0 for k in ("fwd", "bwd", "exp")):
            raise AssertionError(f"wide variants not launched: {wf.LAUNCHES}")
        for k, (err, ms, plain_ms, bound) in res.items():
            v = sites[f"wide_{k}"]
            v["err"] = max(v["err"], err)
            if width == WIDE_WIDTHS[0]:
                v.update(ms=ms, plain_ms=plain_ms, bound=bound)
        del bt, pre, ein, fin, bin_
        torch.cuda.empty_cache()


def _gap_record(seed):
    """A record pair around an anchor-free gap: x is random, y keeps x's
    1 kb flanks and carries an evolved copy of its 4.5 kb middle; the
    cigar matches the flanks base for base and leaves the middle as one
    deletion and one insertion. Returns (sequences, [cigar])."""
    from cpecan_tpu_torch.cli.realign import cigar_io

    rng = np.random.default_rng(seed)
    x = _ACGT[rng.integers(0, 4, 2 * GAP_FLANK + GAP_MIDDLE)].tobytes().decode()
    mid = _evolve(x[GAP_FLANK:GAP_FLANK + GAP_MIDDLE], rng)
    y = x[:GAP_FLANK] + mid + x[GAP_FLANK + GAP_MIDDLE:]
    ops = [(cigar_io.MATCH, GAP_FLANK), (cigar_io.INDEL_X, GAP_MIDDLE),
           (cigar_io.INDEL_Y, len(mid)), (cigar_io.MATCH, GAP_FLANK)]
    cig = cigar_io.PairwiseAlignment("gapx", 0, len(x), True, "gapy", 0, len(y),
                                     True, 0.0, ops)
    return {"gapx": x, "gapy": y}, [cig]


def phase_wide(card, tmp, sites):
    """Bands wider than MAX_KERNEL_WIDTH: the batch path's kernels (wide
    variants) against their plain versions; then the gap record through
    the realign CLI (the parallel engine's windows, counts reset before and
    read after) and its pairs against the plain versions' on the same card
    tensors; then one EM iteration on it (the exact engine's exp windows).
    Each site's widest window launch is checked against its plain version
    (carries, exp's F halo)."""
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.cli import realign
    from cpecan_tpu_torch.models.state_machine import state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    _wide_batch(card, sites)
    seqs, cigars = _gap_record(21)
    fasta, cig = f"{tmp}/gap.fa", f"{tmp}/gap.cigar"
    _write_fasta(fasta, seqs)
    _write_cigars(cig, cigars)
    width = lambda args: args[1].shape[-1]
    torch.cuda.synchronize()
    wf.reset_launch_counts()
    with _capture(("par_fwd", "par_bwd"), width) as kept:
        t0 = time.perf_counter()
        out = _realign(fasta, cigars, "cuda", GAP_SPLIT)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: v for k, v in wf.LAUNCHES.items() if v}
    for k in ("wide_fwd", "wide_bwd"):
        if not launches.get(k):
            raise AssertionError(f"{k} not launched by the gap record: {launches}")
        sites[k]["launches"] = launches[k]
    _check_cigars(out, cigars)
    if set(kept) != {"par_fwd", "par_bwd"}:
        raise AssertionError(f"the gap record did not stream: {launches}")
    log(f"gap record realign ({len(seqs['gapx'])} x {len(seqs['gapy'])}, "
        f"an anchor-free {GAP_MIDDLE} bp gap, {' '.join(GAP_SPLIT)}): {dt:.2f} s "
        f"on {card}; launches {launches}")
    for site, entry in kept.items():
        e, *_ = _check_site(site, entry, 5, wf.KERNEL_NZ[5],
                            "the gap record's widest window", card, reps=3)
        k = f"wide_{SITES[site][0]}"
        sites[k]["err"] = max(sites[k]["err"], e)

    p = realign.alignment_parameters(
        realign.make_parser().parse_args([fasta] + GAP_SPLIT))
    jobs = _realign_jobs(seqs, cigars, p)
    sm = state_machine5()
    card_pairs = batch.batch_posteriors(sm, jobs, p, device="cuda")
    with _plain_versions():
        plain_pairs = batch.batch_posteriors(sm, jobs, p, device="cuda")
    n, flips, worst = _same_pairs(card_pairs[0], plain_pairs[0], p.threshold)
    if worst > 100:
        raise AssertionError(f"gap record: posteriors differ by {worst} / 1e7")
    log(f"  gap record pairs, kernels vs plain versions on the card: {n} "
        f"pairs agree ({flips} threshold flips within 1e-5), max prob diff "
        f"{worst} / 1e7")

    torch.cuda.synchronize()
    wf.reset_launch_counts()
    with _capture(("seg_exp",), width) as kept:
        t0 = time.perf_counter()
        model = _em(fasta, cig, f"{tmp}/gap.hmm", "cuda",
                    ["--iterations", "1"] + GAP_SPLIT)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: v for k, v in wf.LAUNCHES.items() if v}
    if not launches.get("wide_exp") or "seg_exp" not in kept:
        raise AssertionError(f"EM on the gap record launched no wide, streamed "
                             f"exp: {launches}")
    sites["wide_exp"]["launches"] = launches["wide_exp"]
    if not np.isfinite(model.likelihood):
        raise AssertionError(f"gap record EM likelihood {model.likelihood}")
    log(f"gap record em, 1 iteration: {dt:.2f} s on {card}; likelihood "
        f"{model.likelihood}; launches {launches}")
    e, *_ = _check_site("seg_exp", kept["seg_exp"], 5, wf.KERNEL_NZ[5],
                        "the gap record's widest exp window", card, reps=3)
    sites["wide_exp"]["err"] = max(sites["wide_exp"]["err"], e)
    torch.cuda.empty_cache()


def _no_jax_package():
    bad = sorted(m for m in sys.modules if m in ("jax", "cpecan_tpu")
                 or m.startswith(("jax.", "cpecan_tpu.")))
    if bad:
        raise AssertionError(f"modules of jax or the JAX package loaded: {bad}")


def main() -> int:
    card, smi = phase_device()
    ptxas = phase_build()
    summary = phase_kernels(card)
    phase_bwd_sweep(card, ptxas)
    phase_exp_sweep(card, ptxas)

    seqs, cigars = _records(RECORDS)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = f"{tmp}/records.fa"
        with open(fasta, "w") as fh:
            for k, v in seqs.items():
                fh.write(f">{k}\n{v}\n")
        launches, out = _run_realign(fasta, cigars, [], card)
        _, mea_out = _run_realign(fasta, cigars[:MEA_RECORDS], ["--mea"], card)
        some = cigars[:COMPARE_RECORDS]
        near_ties = _compare_card_cpu(fasta, seqs, some)
        _compare_cli(fasta, some, out[:COMPARE_RECORDS], [])
        _compare_cli(fasta, some, mea_out[:COMPARE_RECORDS], ["--mea"],
                     near_ties)

        phase_em_kernel(seqs, cigars, card, summary)
        cig = f"{tmp}/records.cigar"
        _write_cigars(cig, cigars)
        em_launches, _ = _run_em(fasta, cig, f"{tmp}/em5.hmm", RECORDS, [
            "--modelType", "fiveState", "--iterations", str(EM_ITERATIONS)],
            card)
        _run_em(fasta, cig, f"{tmp}/em3.hmm", RECORDS, [
            "--modelType", "threeState", "--iterations", "1"], card)
        phase_em_profile(fasta, cig, tmp, card)
        phase_em_card_cpu(tmp, fasta, some)

        sites = {k: {"err": 0.0} for k in LONG_SITES + WIDE_SITES}
        phase_long_kernels(card, sites)
        phase_long_pair(card, sites)
        phase_long_realign(card, tmp)
        phase_long_em(card, tmp, seqs, cigars, sites)
        phase_wide(card, tmp, sites)
    _no_jax_package()

    # launches: fwd and bwd from the realign main path, exp from the EM
    # main path (fwd launched there too: em_launches); the long-pair sites
    # from the 500 kb path (parallel), the exact engine on its longest
    # chunk (segmented fwd, bwd) and the EM path with long records
    # (segmented exp); the wide variants from the gap record's realign
    # (fwd, bwd) and EM (exp) runs
    runs = {"fwd": launches, "bwd": launches, "exp": em_launches}
    for k in ("fwd", "bwd", "exp"):
        sites[k] = {"launches": runs[k][k], **summary[k]}
    kernels = []
    for k, (_, replaces, name) in SITES.items():
        v = sites[k]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "cpecan_tpu_torch/csrc/wavefront.cu",
            "replaces": replaces, "launches": v["launches"],
            "max_abs_err": v["err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound"][0], "bound_by": v["bound"][1],
            "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
