"""Smoke run of the PyTorch port (cpecan_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the CUDA kernels from cpecan_tpu_torch/csrc with nvcc
     (four parts at once);
  3. kernels: on four batches (headline, dense anchors, 3-state ragged,
     full band W >= 1024) run the prep's kernels (wavefront_rows, the
     stream prep's row part, and wavefront_prep, its slot part), the
     forward and backward kernels and their plain PyTorch versions on the
     same card tensors, check the tolerances (the prep's bit for bit) and
     time the kernels per call (the plain versions' one call at the
     headline batch; the prep's plain versions on every batch; the prep's
     kernels timed on the device alone, behind a spin), and, in a fresh
     process, count one precompute's and one precompute_window's CUDA
     launches with torch.profiler (at most 2 each); on the headline and
     the 3-state
     batch the same for the expectation kernel, and on a full band of
     2.5 kb pairs with its emission bins in device scratch (W > 2048);
     then the forward and the backward kernel across band widths 32-4096
     (B=64, R=257), and the expectation kernel across the same and two
     more: against its plain version, its launch plan (ring depth, shared
     memory), time, us per diagonal, share of the bound and ptxas
     registers/spills, with its direct-load variant beside the ring where
     it has one;
  4. realign main path: cpecan_tpu_torch.cli.realign.main on 1024
     generated 1 kb record pairs (default decode) and 128 of them with
     --mea, with every kernel's launch count reset before and read after
     (fwd, bwd and the prep's two kernels must have run);
  5. card against CPU: realign.main with --device cpu (the kernels' plain
     versions) on the first 8 records, default and --mea, must give the
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
  7. EM card against CPU: 2 iterations on the first 8 records, and
     realign --outputExpectations on them, on the card and with
     --device cpu: the HMMs must agree;
  8. long-pair kernels: on a 600 bp evolved pair in windows of 128 rows,
     the exact streaming engine (posterior, expectation and forward
     modes: the kernels with carries, k0 phase and F halo) and the
     burn-in-parallel engine, each through the kernels and again through
     their plain versions on the same card tensors (every window batch's
     prep, both kernels, bit for bit); the exact engine's scale streams
     and posteriors against the two-pass kernels';
  9. long pair: the long_500kb configuration (bench.py:616-622) through
     pairwise.get_aligned_pairs (the parallel engine), with wall and host
     seconds, windows, launches and sensitivity/specificity against the
     planted truth; its longest streamed chunk through the exact engine
     (seconds, us per diagonal), whose pair set must match the parallel
     engine's; each kernel site's largest launch on these paths again
     through the kernel and its plain version (times and bounds), and
     the prep of the largest window batch of each engine;
 10. long records: the realign CLI on 100-200 kb records with planted-
     truth cigars (default decode, and --mea on one), the exact engine
     against the two-pass kernels on one 100 kb chunk, and card against
     CPU with every chunk of two 3 kb records made to stream;
 11. EM with long records: one 5-state iteration over 2 x 100 kb records
     and 8 short ones (segmented exp kernel), the exact engine's counts
     and likelihood on one long chunk against the two-pass kernels', and
     card against CPU (2 iterations) with every chunk made to stream;
 12. wide bands (W > 4096, the kernels' wide variants): first F2 and F4,
     every kernel (shared-memory, cluster and global-scratch) against its
     plain version on backward totals of 0, inf and NaN and on rows whose
     raw values hold a NaN (scale 1), and the prep's two kernels on a
     model with NaN and inf emissions, a NaN start and an inf end
     probability (NaN off the band, bit for bit as the plain versions,
     batch and windows); the batch path's three kernels on a
     full band of 1 kb pairs padded out to W=4352 and of 500 bp pairs
     padded to an off-grid 8200 against their plain versions (fwd bit for
     bit), with times, each on the cluster kernel and again on the
     global-scratch kernel (in turns), at a cluster of 4, and fwd at each
     of its slots per thread, and CPECAN_TPU_DEBUG=1 on a NaN transition
     there; a record with an anchor-free 4.5 kb gap through the realign
     CLI (parallel engine) and one EM iteration (exact engine) with
     --splitMatrixBiggerThanThis 5000, launch counts reset before and
     read after each, the launch plan of every wide launch (each must
     run a cluster), the widest window launch of each site against its
     plain version and against the global-scratch kernel (times in
     turns), and the record's pairs against the plain versions' on the
     same card tensors;
 13. MSA and align: make_alignment (2 spanning trees, the native
     progressive merge) on BASELINE config #5's 100 evolved 1 kb
     fragments (bench.py:570-575's generator), with its stage split and
     fwd/bwd launch counts reset before and read after, then once more
     under torch.profiler for its device busy share; the same call on
     the first 5 fragments on the card and on the CPU (equal columns and
     kept pairs, near-ties counted); the align CLI on 8 x 32 evolved 1 kb
     sequences (256 pairs), pairs/s, and the first 2 x 2 pairs again with
     --device cpu (identical cigars);
 14. data parallel, on phase 4's records: (a) the EM expectation step at
     the EM defaults on a DataMesh of two shards on the one card against
     no mesh (counts, likelihood), launch counts reset before and read
     after the mesh run, and batch_posteriors at realign's parameters
     with and without that mesh (identical pair sets); (b) the em CLI as
     one process, as two gloo processes on the card, and as one process
     with --dataParallel (5-state, 2 iterations, ~10 chunks): the models
     must agree, with each run's wall time; (c) one EM iteration under
     utils.metrics.trace, whose trace must name wavefront_exp and
     wavefront_fwd; (d) CPECAN_TPU_DEBUG=1 on the headline batch: the
     same outputs as unchecked, and a NaN transition raises "fb debug";
 15. bench: python -m cpecan_tpu_torch.bench (bench.py's nine configs on
     the port) as a user runs it, each in a process of its own with a
     timeout: --all --smoke (every config's output check must pass), then
     --config headline at full size; either exiting non-zero fails the
     smoke.

Each phase's wall time is printed on a line of its own ("phase wall:").
The last two lines of standard output are the kernels' JSON summary and
{"ok": true, "device": {...}}. Imports no jax and nothing of cpecan_tpu
(checked at the end on sys.modules), and reaches the system only through
cpecan_tpu_torch. Test data is made with numpy from fixed seeds.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import random
import re
import signal
import socket
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
MEA_RECORDS = 128
COMPARE_RECORDS = 8
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
    fwd, bwd and exp <S,slots,ring|direct,batch|window>,
    fwd_wide<S,batch|window>, back_wide<S,bwd|exp,batch|window>,
    back_cluster<S,slots,bwd|exp,batch|window>."""
    vals = [v for _, v in re.findall(r"L([ib])(\d+)E", args)]
    if kernel == "wavefront_prep":  # <16-byte stores or per-slot ones>
        return f"{kernel}<{'vector' if vals[0] == '1' else 'scalar'}>"
    vals[-1] = "window" if vals[-1] == "1" else "batch"
    if kernel in ("wavefront_fwd", "wavefront_bwd", "wavefront_exp"):
        vals[2] = "ring" if vals[2] == "1" else "direct"
    if kernel == "wavefront_back_wide":
        vals[1] = "exp" if vals[1] == "1" else "bwd"
    if kernel == "wavefront_back_cluster":  # <S, slots, bwd|exp, ...>
        vals[2] = "exp" if vals[2] == "1" else "bwd"
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
    from cpecan_tpu_torch.ops import band as port_band
    from cpecan_tpu_torch.ops.fb_batch import width_bucket
    from cpecan_tpu_torch.utils.symbols import encode

    seqs, bands = [], []
    for _ in range(B):
        x = _ACGT[rng.integers(0, 4, seq_len)].tobytes().decode()
        y = _evolve(x, rng)[:P - seq_len] if evolve else x
        if full:
            band = port_band.full_band(len(x), len(y))
        else:
            m = min(len(x), len(y))
            band = port_band.construct_band([(i, i) for i in range(
                anchor_every // 2, m - anchor_every // 2, anchor_every)],
                len(x), len(y), expansion)
        seqs.append((x, y))
        bands.append(band)
    W = width_bucket(max(b.frame_width() for b in bands))
    if width is not None:
        if width < W:
            raise ValueError(f"bands need W={W}, above width={width}")
        W = width
    sx = np.zeros((B, P), np.int32)
    sy = np.zeros((B, P), np.int32)
    offs = np.zeros((B, P + 1), np.int32)
    wids = np.zeros((B, P + 1), np.int32)
    for i, ((x, y), band) in enumerate(zip(seqs, bands)):
        offs[i], wids[i], _ = port_band.pad_band(band, P, W)
        sx[i, :len(x)] = encode(x)
        sy[i, :len(y)] = encode(y)
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
def _plain_versions(times=None):
    """Route the kernel wrappers (fwd, bwd, exp and the prep's rows and
    streams), for every caller, to their plain versions (which take the
    same arguments but the launch-count site).
    With a dict ``times``, each call's CUDA-event ms is appended to
    times[kernel]."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    saved = wf.fwd, wf.bwd, wf.exp, wf.streams, wf.prep_rows, wf.prep_rows_window

    def plain(ref, kind):
        def call(*a, site=None, **kw):
            if times is None:
                return ref(*a, **kw)
            out, ms = _timed(lambda: ref(*a, **kw))
            times.setdefault(kind, []).append(ms)
            return out
        return call

    (wf.fwd, wf.bwd, wf.exp, wf.streams, wf.prep_rows,
     wf.prep_rows_window) = (
        plain(wf.fwd_reference, "fwd"), plain(wf.bwd_reference, "bwd"),
        plain(wf.exp_reference, "exp"), plain(wf.streams_reference, "prep"),
        plain(wf.rows_reference, "rows"),
        plain(wf.rows_window_reference, "rows"))
    try:
        yield
    finally:
        (wf.fwd, wf.bwd, wf.exp, wf.streams, wf.prep_rows,
         wf.prep_rows_window) = saved


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


def _check_exp(wf, hmm, args, W, name, card, reps=10):
    """wavefront_exp against exp_reference on the card (same inputs), and
    its mb/total_raw against wavefront_bwd's; the CUDA-event median of
    ``reps`` kernel calls and the time of the one plain call."""
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
    want, plain_ms = _timed(lambda: wf.exp_reference(*ein))
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
    ms = {"exp": _median_ms(lambda: wf.exp(*ein), reps), "exp_plain": plain_ms}
    B, R, Wd = pre["ex"].shape
    log(f"exp kernel {name}: B={B} P={R - 1} W={Wd} S={hmm.state_number}; "
        f"max abs err " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float)
                                    else f"{k} {v}" for k, v in errs.items()))
    log(f"  {card}: exp {ms['exp']:.3f} ms (plain {ms['exp_plain']:.1f} ms)")
    err = max(v for k, v in errs.items()
              if isinstance(v, float) and not k.endswith("_rel"))
    return ms, err, (B, R, Wd, hmm.state_number, hmm.nz)


PREP_KEYS = ("ex", "ey", "em", "efx", "efy", "efm", "pm", "wx", "wy")


@contextlib.contextmanager
def _capture_prep(keep_all=False, windows=False):
    """Keep the arguments of the prep's two kernel calls, the row part
    (prep_rows or prep_rows_window) and the streams call after it, while
    the block runs (every call goes through): all of them, or the largest
    by slots; with ``windows``, only precompute_window's. Yields a list of
    (rows call, streams arguments), a rows call being (form, args,
    kwargs) with form "batch" or "window"."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    saved = wf.streams, wf.prep_rows, wf.prep_rows_window
    kept, last = [], []

    def rows_call(form, fn):
        def call(*args, **kwargs):
            last[:] = [(form, args, kwargs)]
            return fn(*args, **kwargs)
        return call

    def call(*args):
        out = saved[0](*args)
        rows = last.pop()
        if windows and rows[0] != "window":
            return out
        if keep_all or not kept or out["ex"].numel() > kept[0][1]:
            entry = ((rows, args), out["ex"].numel())
            kept[:] = kept + [entry] if keep_all else [entry]
        return out

    wf.streams = call
    wf.prep_rows = rows_call("batch", saved[1])
    wf.prep_rows_window = rows_call("window", saved[2])
    try:
        yield kept
    finally:
        wf.streams, wf.prep_rows, wf.prep_rows_window = saved
        kept[:] = [entry for entry, _ in kept]


def _bytes_bound(byts, ops):
    t_bytes, t_ops = byts / PEAK_BYTES, ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _prep_bound(args):
    """(bound_ms, bound_by) of one streams call: its inputs read once (the
    padded symbols, the row tensors as the kernel reads them: 16 + 1 bytes
    a row, the three tables) and its 9 outputs written once (6 f32 and 3
    int8 per slot), over HBM's rate; its fp32 operations (the 6 masking
    multiplies per slot) over the fp32 peak."""
    sx_pad, sy_pad, (B, R) = args[1], args[2], args[5].shape[:2]
    slots = B * R * args[7]
    return _bytes_bound(sx_pad.numel() + sy_pad.numel() + 17 * B * R + 4 * 35
                        + (6 * 4 + 3) * slots, 6 * slots)


def _rows_bound(call):
    """(bound_ms, bound_by) of one row-kernel call, counted as _prep_bound
    counts: its inputs read once and its outputs written once over HBM's
    rate, its fp32 operations over the fp32 peak. Batch form: the symbols,
    band, lengths and flags at their element sizes and the model's
    buffers; out the row tensor (16 bytes a row), bits and 8 selects (9),
    xoff/jlo/jhi (24), the padded symbols, L, m0log, F0 and end_row (S x
    W each), the 35 tables; operations S x W divides and multiplies and
    the 35 + 3S exp and log. Window form: the frame rows the windows read
    (their R rows and 3 neighbours, 4 arrays of 8 bytes, at most the
    frame), starts, base, emit; out rows, bits, selects and tables."""
    form, args, kw = call
    hmm = args[0]
    S = hmm.state_number
    model = 4 * (35 + 4 * S)
    if form == "batch":
        sx, sy, offsets, widths, lx, ly, rl, rr, W = args[1:]
        B, R = offsets.shape
        ins = sum(x.numel() * x.element_size()
                  for x in (sx, sy, offsets, widths, lx, ly, rl, rr))
        outs = (R * B * (16 + 9 + 24) + sx.numel() + sy.numel()
                + 4 * B * (W + 1) + 8 * B + 4 * B + 2 * 4 * B * S * W + 4 * 35)
        return _bytes_bound(ins + model + outs, 2 * B * S * W + 35 + 3 * S * B)
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    a = inspect.signature(wf.rows_window_reference).bind(*args, **kw).arguments
    n, R = a["starts"].shape[0], a["rows"]
    rows_read = min(n * (R + 3), a["frame"]["xoff"].shape[0])
    ins = 32 * rows_read + 8 * n * (1 + (a.get("base") is not None)
                                    + 2 * (a.get("emit") is not None))
    return _bytes_bound(ins + 4 * 35 + n * R * (16 + 9) + 4 * 35, 35)


def _same_streams(got, want, what, keys=PREP_KEYS):
    """The kernel's outputs equal the plain version's bit for bit, NaN
    where the plain version has NaN. Returns the max abs error (0)."""
    err = 0.0
    for k in keys:
        g, w_ = got[k], want[k]
        if g.dtype != w_.dtype or g.shape != w_.shape:
            raise AssertionError(f"{what} {k}: {g.dtype} {tuple(g.shape)}, plain "
                                 f"{w_.dtype} {tuple(w_.shape)}")
        if g.is_floating_point():
            if not torch.equal(g.isnan(), w_.isnan()):
                raise AssertionError(f"{what} {k}: NaN elsewhere than the plain "
                                     f"version's")
            g, w_ = g.nan_to_num(), w_.nan_to_num()
        if not torch.equal(g, w_):
            n = int((g != w_).sum())
            raise AssertionError(f"{what} {k}: {n} elements differ from the "
                                 f"plain version's")
        err = max(err, float((g.float() - w_.float()).abs().max()) if g.numel() else 0.0)
    return err


def _check_rows(call, what, card, reps=10):
    """wavefront_rows (prep_rows or prep_rows_window) against its plain
    version on the same card tensors, bit for bit on every output; with
    reps, the CUDA-event median of ``reps`` kernel calls, the plain
    version's one call and the bound. Returns {"err", "ms", "plain_ms",
    "bound"} (times None without reps)."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    form, args, kw = call
    kernel, plain = ((wf.prep_rows, wf.rows_reference) if form == "batch"
                     else (wf.prep_rows_window, wf.rows_window_reference))
    got = kernel(*args, **kw)
    want, plain_ms = _timed(lambda: plain(*args, **kw))
    err = _same_streams(got, want, f"rows at {what}", keys=tuple(want))
    del got, want
    out = {"err": err, "ms": None, "plain_ms": None, "bound": _rows_bound(call)}
    if reps:
        out["ms"] = _device_ms(lambda: kernel(*args, **kw), reps)
        call_ms = _median_ms(lambda: kernel(*args, **kw), reps)
        out["plain_ms"] = plain_ms
        bms, by = out["bound"]
        B, R = (args[3].shape if form == "batch" else (args[3].shape[0], args[4]))
        log(f"  rows ({form}) at {what}: B={B} R={R}; kernel {out['ms']:.4f} ms "
            f"(the wrapper's call with its host time {call_ms:.4f}), plain "
            f"{plain_ms:.2f} ms, bound {bms:.5f} ms ({by}), "
            f"{100 * bms / out['ms']:.1f}% of the bound; bit-equal ({card})")
    return out


def _check_prep(entry, what, card, reps=10, sites=None):
    """wavefront_prep (the streams wrapper) against streams_reference, and
    wavefront_rows against its plain version (``_check_rows``), on the
    same card tensors, bit for bit; with reps, the CUDA-event median of
    ``reps`` kernel calls, the plain version's one call and the bound of
    each. Returns {"err", "ms", "plain_ms", "bound", "rows"} (times None
    without reps), "rows" the row kernel's; with ``sites``, both errors
    are folded into sites["prep"] and sites["rows"]."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    rows_call, args = entry
    got = wf.streams(*args)
    want, plain_ms = _timed(lambda: wf.streams_reference(*args))
    err = _same_streams(got, want, f"prep at {what}")
    del got, want
    B, R = args[5].shape[:2]
    W = args[7]
    out = {"err": err, "ms": None, "plain_ms": None, "bound": _prep_bound(args)}
    if reps:
        out["ms"] = _device_ms(lambda: wf.streams(*args), reps)
        call_ms = _median_ms(lambda: wf.streams(*args), reps)
        out["plain_ms"] = plain_ms
        bms, by = out["bound"]
        log(f"  prep at {what}: B={B} R={R} W={W}; kernel {out['ms']:.3f} ms "
            f"(the wrapper's call with its host time {call_ms:.3f}), plain "
            f"{plain_ms:.2f} ms, bound {bms:.4f} ms ({by}), "
            f"{100 * bms / out['ms']:.1f}% of the bound; bit-equal ({card})")
    out["rows"] = _check_rows(rows_call, what, card, reps)
    if sites is not None:
        sites["prep"]["err"] = max(sites["prep"]["err"], out["err"])
        sites["rows"]["err"] = max(sites["rows"]["err"], out["rows"]["err"])
    return out


def _cuda_launches(fn, sessions=3):
    """The CUDA work one call of fn launches, by torch.profiler: the most
    device events one of ``sessions`` profiled calls recorded, and the
    names recorded in any. The profiler never invents an event but can
    miss one: in one process it recorded a prep's two launches in its
    first sessions and then, after a few, one or none of them, and a
    session's first launches can go unrecorded, so each session first
    runs torch.cuda._sleep's spin kernel twice (not counted), and this
    runs in a fresh process (``_prep_launch_child``). The most is a lower
    bound of the count; the names show which kernels ran."""
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: (getattr(e, "self_device_time_total", 0)
                        or getattr(e, "self_cuda_time_total", 0))
    most, names = 0, set()
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if dev_us(e) > 0 and "spin_kernel" not in e.key}
        most = max(most, sum(kernels.values()))
        names |= set(kernels)
    return most, sorted(names)


PREP_LAUNCH_FLAG = "--prep-launches"


def _prep_launch_child():
    """The child of ``phase_prep_launches``: one precompute at the
    headline batch and one precompute_window over the windows of its
    first pair (256 rows each, emitted ranges set), each run once and
    then counted by ``_cuda_launches``; prints one JSON line."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb as _fb
    from cpecan_tpu_torch.ops import fb_streaming
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    bt = _band_batch(np.random.default_rng(0), 256, 2048, "posterior_match",
                     state_machine5, anchor_every=50)
    args, W = bt["args"], bt["W"]
    lx, ly = int(args[4][0]), int(args[5][0])
    L, K = lx + ly, 256
    frame = [a[0].cpu().numpy() for a in _fb._frame_from_band(args[2][:1],
                                                              args[3][:1])]
    sx, sy, fr = fb_streaming._device_pair(
        args[0][0, :lx].cpu().numpy(), args[1][0, :ly].cpu().numpy(), frame,
        K + W + 1, "cuda")
    starts = torch.arange(1, L + 1, K, device="cuda")
    emit = torch.stack([starts + 8, starts + K - 8], 1)
    calls = {
        "precompute": lambda: wf.precompute(hmm, *args, width=W),
        "precompute_window": lambda: wf.precompute_window(
            hmm, sx, sy, fr, ly, L, starts, K, W, K + W + 1, emit=emit)}
    out = {}
    for name, call in calls.items():
        call()
        out[name] = _cuda_launches(call)
    print(json.dumps(out))
    return 0


def phase_prep_launches(card):
    """One precompute and one precompute_window make at most 2 CUDA
    launches each, wavefront_rows and wavefront_prep, as torch.profiler
    counts them in a fresh process (``_prep_launch_child``)."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           PREP_LAUNCH_FLAG], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"prep launch count: rc {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, (n, kernels) in counts.items():
        seen = [k for k in ("wavefront_rows", "wavefront_prep")
                if any(k in kern for kern in kernels)]
        if n > 2 or len(seen) < 2:
            raise AssertionError(f"one {name}: up to {n} CUDA launches, "
                                 f"kernels {kernels}; expected at most 2, "
                                 f"wavefront_rows and wavefront_prep")
        log(f"one {name}: {n} CUDA launches by torch.profiler ({card}): "
            + ", ".join(k[:60] for k in kernels))


# device cycles of the spin ahead of a timed prep call (~2.5 ms at the
# H100's 1.98 GHz): longer than the host takes to issue the call
SPIN_CYCLES = 5_000_000


def _device_ms(fn, reps):
    """CUDA-event median of ``reps`` calls of fn, each issued while the
    device spins (torch.cuda._sleep), so the events time the device's
    work and not the host's time to issue it (``_median_ms`` times both:
    for a call whose kernels take less than their wrapper's host time it
    measures the host)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(card):
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    summary = {"fwd": {"err": 0.0}, "bwd": {"err": 0.0}, "exp": {"err": 0.0},
               "prep": {"err": 0.0}, "rows": {"err": 0.0}}
    wf.reset_launch_counts()
    for name, bt in _batches().items():
        hmm = PairHMM.from_state_machine(bt["sm"]).cuda()
        args, mode, W = bt["args"], bt["mode"], bt["W"]
        B, P1 = args[2].shape
        got = wf.fb_pass_batch_wavefront(hmm, *args, mode=mode, width=W)
        plain_times = {}
        with _plain_versions(plain_times):
            want = wf.fb_pass_batch_wavefront(hmm, *args, mode=mode, width=W)
        errs = _max_err(got, want, args[4].long() + args[5].long())
        summary["fwd"]["err"] = max(summary["fwd"]["err"],
                                    *(errs[k] for k in FWD_KEYS))
        summary["bwd"]["err"] = max(summary["bwd"]["err"],
                                    *(v for k, v in errs.items()
                                      if k not in FWD_KEYS))

        with _capture_prep() as kept:
            pre = wf.precompute(hmm, *args, width=W)
        with _plain_versions():
            want_pre = wf.precompute(hmm, *args, width=W)
        _same_streams(pre, want_pre, f"precompute at {name}")
        for k in set(pre) - set(PREP_KEYS):
            if not torch.equal(pre[k], want_pre[k]):
                raise AssertionError(f"precompute at {name}: {k} differs")
        del want_pre
        chk = _check_prep(kept[0], name, card, sites=summary)
        if name.startswith("a_"):
            for k, c in (("prep", chk), ("rows", chk["rows"])):
                summary[k].update(ms=c["ms"], plain_ms=c["plain_ms"],
                                  bound=c["bound"])
        del kept
        t = hmm.t_prob_host
        fin = (t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"],
               pre["b0"], pre["F0"], hmm.nz)
        F, bv, _ = wf.fwd(*fin)
        bin_ = (t, pre["efx"], pre["efy"], pre["efm"], pre["em"], F, bv,
                pre["abw"], pre["c1"], pre["c0"], pre["bm1"], pre["bm0"],
                pre["pm"], pre["end_row"], hmm.nz, mode)
        ms = {"fwd": _median_ms(lambda: wf.fwd(*fin), 10),
              "bwd": _median_ms(lambda: wf.bwd(*bin_), 10)}
        plain = ""
        if name.startswith("a_"):
            # the plain versions take seconds a call: their one call each
            # above, which made the outputs every batch is checked against
            ms["fwd_plain"], = plain_times["fwd"]
            ms["bwd_plain"], = plain_times["bwd"]
            plain_s = (ms["fwd_plain"] + ms["bwd_plain"]) / 1e3
            plain = (f"; plain fwd {ms['fwd_plain']:.1f} ms, bwd "
                     f"{ms['bwd_plain']:.1f} ms, {bt['cells'] / plain_s:.4g} cells/s")
        direct = _bwd_direct(bin_, {}, hmm.state_number, W, 10, wf.bwd(*bin_))
        kern_s = (ms["fwd"] + ms["bwd"]) / 1e3
        log(f"kernels {name}: B={B} P={P1 - 1} W={W} {mode}, "
            f"{bt['cells']} in-band cells; max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        log(f"  {card}: fwd {ms['fwd']:.3f} ms, bwd {ms['bwd']:.3f} ms; "
            f"fwd+bwd {bt['cells'] / kern_s:.4g} cells/s{plain}; kernel "
            f"launches so far in this phase {wf.LAUNCHES}")
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
            ems, err, shape = _check_exp(wf, hmm, args, W, name, card)
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
    bt = _band_batch(np.random.default_rng(1), 2, 5120, "posterior_match",
                     state_machine5, full=True, evolve=True, seq_len=2500)
    if bt["W"] <= wf.EXP_SHARED_WIDTH:
        raise AssertionError(f"wide batch has W={bt['W']}")
    _, err, _ = _check_exp(wf, hmm, bt["args"], bt["W"],
                           "f_wide_full_band_B2_2500", card, reps=3)
    summary["exp"]["err"] = max(summary["exp"]["err"], err)
    torch.cuda.empty_cache()
    for k, v in summary.items():
        bms, by = v["bound"]
        log(f"bound {k} at the headline batch: {bms:.3f} ms ({by}); kernel "
            f"{v['ms']:.3f} ms, {100 * bms / v['ms']:.1f}% of the bound")
    return summary


# bwd's width sweep: B pairs of SWEEP_P bases (R = SWEEP_P + 1 diagonals)
SWEEP_B, SWEEP_P = 64, 256
SWEEP_WIDTHS = (32, 128, 544, 1024, 1664, 2048, 4096)


def _on_grid(args):
    """Whether the streams wavefront_bwd's ring copies (efx, efy, efm,
    em, F, bv, pm in the wrapper's argument order) start on 16-byte
    boundaries, as the ring needs."""
    return all(args[i].data_ptr() % 16 == 0 for i in (1, 2, 3, 4, 5, 6, 12))


def _off_grid(x):
    """A contiguous copy of ``x`` (int8 or float32) that starts one element
    past a 16-byte boundary: a kernel with a ring then runs its
    direct-load variant."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def phase_fwd_sweep(card, ptxas):
    """wavefront_fwd across band widths on the bwd sweep's batch shape
    (B=SWEEP_B identical 512 bp pairs, anchors every 50 bp, the bands
    padded out to W; dense anchors at W=32), 5-state: the kernel against
    fwd_reference on the same card tensors (F, bv and mf within the
    tolerances, and whether each is bit-equal), and per width its launch
    plan (threads, slots, ring depth, shared memory), its time and us per
    diagonal, its share of the bound and the ptxas line of the
    instantiation that ran. Where the plan has a ring, the direct-load
    variant (ex off the 16-byte grid) is checked and timed beside it.
    Returns {(W, variant): ms}."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    t0 = time.perf_counter()
    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    S, t = hmm.state_number, hmm.t_prob_host
    rng = np.random.default_rng(13)
    out = {}
    for W in SWEEP_WIDTHS:
        bt = _band_batch(rng, SWEEP_B, SWEEP_P, "forward", state_machine5,
                         anchor_every=1 if W == 32 else 50,
                         seq_len=SWEEP_P // 2, width=W)
        pre = wf.precompute(hmm, *bt["args"], width=W)
        fin = [t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"],
               pre["b0"], pre["F0"], hmm.nz]
        want = wf.fwd_reference(*fin)
        grid = all(fin[i].data_ptr() % 16 == 0 for i in (1, 2, 3))
        ring = wf.fwd_plan(S, W)["depth"] > 0 and grid
        variants = [("ring" if ring else "direct", fin)]
        if ring:
            variants.append(("direct", [t, _off_grid(pre["ex"])] + fin[2:]))
        B, R, _ = pre["ex"].shape
        bms, by = _bound(B, R, W, S, hmm.nz, "fwd")
        log(f"fwd sweep W={W}: B={B} R={R}; bound {bms:.4f} ms ({by})")
        for name, args in variants:
            plan = wf.fwd_plan(S, W, aligned=name == "ring")
            got = wf.fwd(*args)
            errs, same = {}, []
            for k, g, w_ in zip(("F", "bv", "mf"), got, want):
                rtol, atol = TOLERANCES.get(k, (1e-4, 1e-6))
                torch.testing.assert_close(g, w_, rtol=rtol, atol=atol,
                                           msg=f"fwd sweep W={W} {name} {k}")
                errs[k] = float((g - w_).abs().max())
                same.append(f"{k} {'bit-equal' if torch.equal(g, w_) else 'not bit-equal'}")
            ms = _median_ms(lambda: wf.fwd(*args), 5)
            out[(W, name)] = ms
            inst = f"wavefront_fwd<{S},{plan['slots']},{name},batch>"
            log(f"  {name}: {plan['threads']} threads x {plan['slots']} slots, "
                f"ring depth {plan['depth']}, shared memory {plan['smem']} B "
                f"per block; {ms:.3f} ms ({1e3 * ms / R:.3f} us per diagonal, "
                f"{100 * bms / ms:.1f}% of the bound), max abs err "
                f"{max(errs.values()):.3g} ({', '.join(same)}; {card}); "
                f"ptxas {inst}: "
                f"{ptxas.get(inst, 'not reported (library already built)')}")
        del bt, pre, fin, want, variants
        torch.cuda.empty_cache()
    log(f"fwd sweep: {time.perf_counter() - t0:.1f} s")
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
    for k in ("fwd", "bwd", "prep", "rows"):
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
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.em import em as em_mod
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    opts = em_mod.EmOptions()
    p = opts.pairwise_params()
    chunk = em_mod.split_alignments(cigars, opts.maxAlignmentLengthPerJob)[0][0]
    buckets, _ = batch.plan(em_mod.tasks_from_cigars(chunk, seqs, p), p)
    (P, W), items = max(buckets.items(), key=lambda kv: len(kv[1]))
    args = [torch.from_numpy(a).cuda() for a in batch.launch_arrays(items, P)]
    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    _, err, _ = _check_exp(wf, hmm, args, W, f"em_batch_{len(items)}_tasks",
                           card)
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
    for k in ("fwd", "exp", "prep", "rows"):
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
FORCED_RECORDS = (1_000, 1_100)  # streamed by a patched budget, card vs CPU
CHECK_PAIR, CHECK_WINDOW, CHECK_BURNIN = 600, 128, 64
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
    # the stream prep's slot and row parts at every site (XLA on the TPU)
    "prep": ("prep", "cpecan_tpu/ops/fb_wavefront.py:865", "wavefront_prep"),
    "rows": ("rows", "cpecan_tpu/ops/fb_wavefront.py:865", "wavefront_rows"),
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
    within the tolerances (TOLERANCES; counts EXP_RTOL; the backward
    carries rtol 1e-4 against a row max of 1; fwd's F, bv, mf and carries
    bit for bit), CUDA-event medians of both, and the bound. Returns
    (max_abs_err, ms, plain_ms, (bound_ms, by))."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    kind = SITES[site][0]
    args, kw = entry
    kern = getattr(wf, kind)
    plain = getattr(wf, f"{kind}_reference")
    got = _flat(kern(*args, site=site, **kw))
    want, plain_ms = _timed(lambda: _flat(plain(*args, **kw)))
    err = 0.0
    for (name, g), (_, w_) in zip(got, want):
        g, w_ = g.float().cpu(), w_.float().cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{site} output {name} is not finite")
        if kind == "fwd" and not torch.equal(g, w_):
            # wavefront_fwd and the wide fwd kernels round as fwd_reference
            raise AssertionError(f"{site} {name}: not bit-equal to fwd_reference")
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
    """Kernels with carries against their plain versions on an evolved
    pair of CHECK_PAIR bases (windows of CHECK_WINDOW rows): the exact
    engine in every mode and the parallel engine, each run through the
    kernels and again through their plain versions on the same card
    tensors; the exact engine's scale streams and posteriors against the
    two-pass kernels'. Per site: the error and one window launch's time."""
    from cpecan_tpu_torch.align.anchors import get_anchors
    from cpecan_tpu_torch.config import PairwiseAlignmentParameters
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_parallel
    from cpecan_tpu_torch.ops import fb_wavefront as wf
    from cpecan_tpu_torch.ops.band import construct_band
    from cpecan_tpu_torch.ops.fb_batch import width_bucket
    from cpecan_tpu_torch.utils.symbols import encode

    rng = np.random.default_rng(7)
    x = _ACGT[rng.integers(0, 4, CHECK_PAIR)].tobytes().decode()
    y = _evolve(x, rng)
    p = PairwiseAlignmentParameters()
    band = construct_band([(int(a[0]), int(a[1])) for a in get_anchors(x, y, p)],
                          len(x), len(y), p.diagonalExpansion)
    W = width_bucket(band.frame_width())
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
        with _capture(LONG_SITES) as kept, _capture_prep(keep_all=True) as preps:
            got = run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in wf.LAUNCHES.items() if v}
        if (launches.get("prep", 0) != len(preps) or not preps
                or launches.get("rows", 0) != len(preps)):
            raise AssertionError(f"{engine} {mode}: {len(preps)} prep calls, "
                                 f"launches {launches}")
        for i, entry in enumerate(preps):
            _check_prep(entry, f"window batch {i} of {engine} {mode}", card,
                        reps=10 if i == 0 else 0, sites=sites)
        log(f"  prep and rows: {len(preps)} window batches of {engine} {mode} "
            f"bit-equal to the plain versions ({card})")
        del preps
        with _plain_versions():
            want = run()
        err = _compare_streams(got, want, L, W,
                               f"{engine} {mode} kernels vs plain ({launches})")
        for site, entry in kept.items():
            e, ms, _, _ = _check_site(site, entry, sm.state_number, hmm.nz,
                                      f"one window of the {CHECK_PAIR} bp pair", card,
                                      reps=10)
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

    _, streamed = batch.plan(batch.chunk_tasks(jobs, p), p)
    return sorted(streamed, key=lambda e: -e[1].diagonal_number)


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
    with _capture(("par_fwd", "par_bwd")) as kept, \
            _capture_prep(windows=True) as prep:
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
    if launches["prep"] <= 0 or launches["rows"] != launches["prep"]:
        raise AssertionError("prep and rows were not launched by the 500 kb "
                             f"path as often as each other: {launches}")
    _check_prep(prep[0], "the 500 kb path's largest window batch (site 7's "
                "streams)", card, sites=sites)
    del prep
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
    with _capture(("seg_fwd", "seg_bwd")) as kept, _capture_prep() as prep:
        t0 = time.perf_counter()
        ex_out = _stream(*args, "exact", threshold=p.threshold)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(wf.LAUNCHES)
    for k in ("seg_fwd", "seg_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by the exact engine")
        sites[k]["launches"] = launches[k]
    _check_prep(prep[0], "one window of the exact engine on that chunk", card,
                sites=sites)
    del prep
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
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.io import cigar as cigar_io

    jobs = []
    for c in cigars:
        x, y = seqs[c.contig1], seqs[c.contig2]
        anchors = batch.filter_anchors_to_matches(
            cigar_io.alignment_to_anchor_pairs(
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
    from cpecan_tpu_torch.align import batch
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
    _, streamed = batch.plan(
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
# full band of two evolved pairs padded out to each width, (W, the pairs'
# length): 1 kb pairs at 4352, 500 bp ones at 8200 (off the 16-byte grid;
# the kernels' work per diagonal is set by W, while the plain versions'
# time grows with R); and a record whose cigar leaves an anchor-free 4.5
# kb gap between two 1 kb flanks, realigned (and trained on) with the
# split at 5000 x 5000, so the gap stays in one chunk
WIDE_BATCHES = ((4352, SEQ_LEN), (8200, SEQ_LEN // 2))
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


@contextlib.contextmanager
def _cluster_limit(cluster):
    """The wide kernels' cluster size for the block (0: the global-scratch
    kernels at every width)."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    before = wf.set_cluster_limit(cluster)
    try:
        yield
    finally:
        wf.set_cluster_limit(before)


def _wide_plan(kind, S, W):
    """The launch plan of a wide launch of ``kind`` at (S, W)."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    return (wf.fwd_wide_plan(S, W) if kind == "fwd"
            else wf.back_wide_plan(S, W, kind == "exp"))


def _plan_text(plan, W):
    return (f"cluster {plan['cluster']} x {plan['threads']} threads of "
            f"{plan['slots']} slots, slices of {plan['slice']} slots, "
            f"{plan['smem']} B shared memory per CTA"
            if plan["cluster"] else f"cluster 0 (global-scratch kernel) at W={W}")


@contextlib.contextmanager
def _wide_plans():
    """Every fwd, bwd and exp wrapper call at W > MAX_KERNEL_WIDTH while
    the block runs: (site, B, R, W, its launch plan), in call order."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    saved = wf.fwd, wf.bwd, wf.exp
    seen = []

    def wrap(fn, kind):
        def call(*args, site=kind, **kw):
            B, R, W = args[1].shape
            if W > wf.MAX_KERNEL_WIDTH:
                if kind == "fwd":  # F0, or a window's carry in
                    S = (args[7] if args[7] is not None else kw["carry"][0]).shape[1]
                else:  # F
                    S = args[5 if kind == "bwd" else 7].shape[2]
                seen.append((site, B, R, W, _wide_plan(kind, S, W)))
            return fn(*args, site=site, **kw)
        return call

    wf.fwd, wf.bwd, wf.exp = (wrap(saved[0], "fwd"), wrap(saved[1], "bwd"),
                              wrap(saved[2], "exp"))
    try:
        yield seen
    finally:
        wf.fwd, wf.bwd, wf.exp = saved


def _log_wide_plans(seen, what):
    """Logs each wide launch's plan; fails where one ran no cluster."""
    for site, B, R, W, plan in seen:
        log(f"  {what}: {site} B={B} R={R} W={W}: {_plan_text(plan, W)}")
        if not plan["cluster"]:
            raise AssertionError(f"{what}: {site} at W={W} ran no cluster")


def _special_back_inputs(rng, hmm, B, R, W, kernel, nan_row=None):
    """bwd's or exp's arguments (card tensors) at random, as
    tests/test_torch_nan.py makes them: row 3 with F zero and no bridge
    (total 0), one F value inf on row 7 (total inf) and one NaN on row 11
    (total NaN); or, with ``nan_row`` (F4), one NaN in pair 0's efx at
    slot 5 of that norm row (raw B NaN there and on every row below) and
    each pair's at-end row at R - 1."""
    S = hmm.state_number

    def unif(*shape, lo=0.0):
        return torch.from_numpy(rng.uniform(lo, 1.0, shape).astype(np.float32)).cuda()

    def bits(*shape):
        return torch.from_numpy((rng.random(shape) < 0.5).astype(np.int8)).cuda()

    row = np.where(rng.random((B, R)) < 0.7, 16, 0)
    row[np.arange(B), rng.integers(R // 2, R, B)] |= 8
    pm = torch.from_numpy((rng.integers(0, 8, (B, R, W)) | row[..., None])
                          .astype(np.int8)).cuda()
    efx, efy, efm, em = (unif(B, R, W, lo=0.1) for _ in range(4))
    F, bv, sel = unif(B, R, S, W), unif(B, R, W), [bits(B, R) for _ in range(5)]
    end_row = unif(B, S, W)
    if nan_row is None:
        F[:, 3] = 0.0
        pm[:, 3] &= ~16
        F[:, 7, 1, 5] = float("inf")
        F[:, 11, 0, 9] = float("nan")
    else:
        pm &= ~8
        pm[:, R - 1] |= 8
        efx[0, nan_row, 5] = float("nan")
    t = hmm.t_prob_host
    if kernel == "bwd":
        return (t, efx, efy, efm, em, F, bv, *sel, pm, end_row, hmm.nz,
                "posterior_all")
    ex, ey = unif(B, R, W, lo=0.1), unif(B, R, W, lo=0.1)
    fsel = [bits(B, R) for _ in range(3)]
    adj = [0.5 + unif(B, R) for _ in range(2)]
    sym = [torch.from_numpy(rng.integers(0, 6, (B, R, W)).astype(np.int8)).cuda()
           for _ in range(2)]
    return (t, efx, efy, efm, em, ex, ey, F, bv, *sel, *fsel, pm, end_row,
            *adj, *sym, hmm.nz)


def _nan_fwd_inputs(rng, hmm, B, R, W, nan_row):
    """fwd's arguments (card tensors) at random, as
    tests/test_torch_wavefront.py's random_fwd_inputs makes them, with one
    NaN in pair 0's ex at slot 5 of the norm row ``nan_row`` (F4: raw F
    NaN there and on every row after)."""
    S = hmm.state_number
    unif = lambda *shape, lo=0.0: torch.from_numpy(
        rng.uniform(lo, 1.0, shape).astype(np.float32)).cuda()
    bits = [torch.from_numpy((rng.random((B, R)) < 0.5).astype(np.int8)).cuda()
            for _ in range(3)]
    ex, ey, em = (unif(B, R, W, lo=0.1) for _ in range(3))
    ex[0, nan_row, 5] = float("nan")
    return (hmm.t_prob_host, ex, ey, em, *bits, unif(B, S, W), hmm.nz)


# F4's NaN rows (norm rows of the batch path at R = 17): fwd's and the
# backward kernels'
NAN_ROW = {"fwd": 7, "bwd": 11, "exp": 11}
# where each kernel's outputs hold its row scales (mf or mb)
_SCALE_OUT = {"fwd": "out.2", "bwd": "out.1", "exp": "out.2"}


def _nan_totals(card):
    """F2 and F4: bwd and exp (shared-memory variants at W=128), the
    cluster kernels and the global-scratch kernels (W=4224) against their
    plain versions on rows whose per-diagonal total is 0, inf and NaN,
    and all three kernels, fwd too, on rows whose raw values hold a NaN
    (scale 1, mf / mb 0): NaN and inf exactly where the plain versions
    have them, mf / mb bit for bit where the plain version's is 0 (fwd's
    outputs everywhere), the rest within the usual tolerances."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    for kernel in ("fwd", "bwd", "exp"):
        for W, cluster in ((128, None), (4224, 8), (4224, 0)):
            cases = {"F4 NaN rows": (
                _nan_fwd_inputs(np.random.default_rng(W), hmm, 2, 17, W,
                                NAN_ROW[kernel]) if kernel == "fwd" else
                _special_back_inputs(np.random.default_rng(W + 1), hmm, 2, 17,
                                     W, kernel, NAN_ROW[kernel]))}
            if kernel != "fwd":
                cases["F2 totals"] = _special_back_inputs(
                    np.random.default_rng(W), hmm, 2, 17, W, kernel)
            for case, args in cases.items():
                with (_cluster_limit(cluster) if cluster is not None
                      else contextlib.nullcontext()):
                    if cluster is not None and \
                            _wide_plan(kernel, 5, W)["cluster"] != cluster:
                        raise AssertionError(f"{case} {kernel}: plan is not "
                                             f"cluster {cluster}")
                    got_out = getattr(wf, kernel)(*args)
                    got = _flat(got_out)
                want_out = getattr(wf, f"{kernel}_reference")(*args)
                want = _flat(want_out)
                torch.cuda.synchronize()
                what = f"{case} {kernel} W={W} cluster={cluster}"
                if kernel == "fwd" and not all(
                        torch.equal(g.isnan(), w_.isnan())
                        and torch.equal(g.nan_to_num(), w_.nan_to_num())
                        for (_, g), (_, w_) in zip(got, want)):
                    raise AssertionError(f"{what}: not bit-equal to fwd_reference")
                for (name, g), (_, w_) in zip(got, want):
                    g, w_ = g.cpu(), w_.cpu()
                    if not (torch.equal(g.isnan(), w_.isnan())
                            and torch.equal(g.isinf(), w_.isinf())):
                        raise AssertionError(f"{what} {name}: NaN/inf elsewhere "
                                             f"than the plain version's")
                    key = _OUT_KEYS[kernel].get(name)
                    tol = ((EXP_RTOL, 1e-7) if key == "counts" else (0.0, 1e-5)
                           if key == "exp_rows" else TOLERANCES.get(key, (1e-4, 1e-6)))
                    torch.testing.assert_close(g, w_, rtol=tol[0], atol=tol[1],
                                               equal_nan=True, msg=f"{what} {name}")
                sg = dict(got)[_SCALE_OUT[kernel]].cpu()
                sw = dict(want)[_SCALE_OUT[kernel]].cpu()
                zero = sw == 0
                if not torch.equal(sg[zero], sw[zero]):
                    raise AssertionError(f"{what}: mf / mb not 0 where the "
                                         f"plain version's is")
                if case == "F2 totals":
                    tot = dict(got)["out.2" if kernel == "bwd" else "out.3"].cpu()
                    if not (tot[:, 3].eq(0).all() and tot[:, 7].isposinf().all()
                            and tot[:, 11].isnan().all()):
                        raise AssertionError(f"{what}: total_raw rows 3, 7, 11 "
                                             f"are {tot[:, [3, 7, 11]].tolist()}")
                else:
                    r = NAN_ROW[kernel]
                    if sg[0, r] != 0 or sg[1, r] == 0:
                        raise AssertionError(f"{what}: row {r}'s scales "
                                             f"{sg[:, r].tolist()}")
                variant = ("shared-memory variant" if cluster is None else
                           _plan_text(_wide_plan(kernel, 5, W), W) if cluster
                           else "global-scratch kernel")
                log(f"{case}, {kernel} at W={W} ({variant}): "
                    + ("total_raw 0, inf and NaN on the rows the plain version "
                       "has them" if case == "F2 totals" else
                       f"scale 1 (mf / mb 0) on row {NAN_ROW[kernel]} and the "
                       f"rows the NaN reaches")
                    + f", NaN/inf patterns of every output equal ({card})")


def _nan_prep(card, sites):
    """wavefront_prep and wavefront_rows on a model whose emission tables
    hold NaN and inf (gap x of A, gap y of G, match (C, T) and (G, A)),
    whose start probabilities hold a NaN and whose end ones an inf: bit
    for bit as the plain versions, NaN where they have NaN, on 16 pairs of
    the headline's shape and on windows of the first of them
    (precompute_window with emitted row ranges); each stream must hold NaN
    off the band, F0 NaN and its scale 1 (m0log 0), end_row NaN off the
    band."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb as _fb
    from cpecan_tpu_torch.ops import fb_streaming
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    hmm = PairHMM.from_state_machine(state_machine5())
    bufs = {k: v.numpy().copy() for k, v in hmm.named_buffers()}
    bufs["em_gap_x"][0] = np.nan
    bufs["em_gap_y"][2] = np.inf
    bufs["em_match"][1, 3] = np.nan
    bufs["em_match"][2, 0] = np.inf
    bufs["start"][1] = np.nan
    bufs["end"][0] = np.inf
    hmm = PairHMM(bufs).cuda()
    bt = _band_batch(np.random.default_rng(4), 16, 2048, "posterior_match",
                     state_machine5, anchor_every=50)
    args, W = bt["args"], bt["W"]
    with _capture_prep() as kept:
        pre = wf.precompute(hmm, *args, width=W)
    _check_prep(kept[0], "a NaN/inf emission model", card, reps=0, sites=sites)
    js = torch.arange(W, device="cuda")
    off = ~((js >= pre["jlo"][..., None]) & (js <= pre["jhi"][..., None]))
    for k in PREP_KEYS[:6]:
        if not pre[k][off].isnan().any():
            raise AssertionError(f"NaN/inf model: no NaN in {k} off the band")
    if not (pre["F0"].isnan().any() and (pre["m0log"] == 0).all()
            and pre["end_row"].isnan().any()):
        raise AssertionError("NaN/inf model: F0, m0log or end_row do not carry "
                             "the NaN start and the inf end")
    lx, ly = int(args[4][0]), int(args[5][0])
    L, K = lx + ly, 256
    frame = [a[0].cpu().numpy() for a in _fb._frame_from_band(args[2][:1],
                                                              args[3][:1])]
    sx, sy, fr = fb_streaming._device_pair(
        args[0][0, :lx].cpu().numpy(), args[1][0, :ly].cpu().numpy(), frame,
        K + W + 1, "cuda")
    starts = torch.arange(1, L + 1, K, device="cuda")
    with _capture_prep() as kept:
        wf.precompute_window(hmm, sx, sy, fr, ly, L, starts, K, W, K + W + 1,
                             emit=torch.stack([starts + 8, starts + K - 8], 1))
    _check_prep(kept[0], "windows of a NaN/inf emission model", card, reps=0,
                sites=sites)
    log(f"NaN/inf emission, start and end tables: prep and rows bit-equal to "
        f"the plain versions on 16 pairs at W={W} and {len(starts)} windows of "
        f"{K} rows, NaN off the band in every stream ({card})")


def _nan_debug_on_card(bt, hmm, card):
    """F2: CPECAN_TPU_DEBUG=1 on a NaN transition (t[1, 0, 0]) through
    fb_batch on a wide batch (the cluster kernel) raises the message the
    CPU raises."""
    from cpecan_tpu_torch.models.state_machine import PairHMM
    from cpecan_tpu_torch.ops import fb_batch

    bad = {k: getattr(hmm, k).cpu().numpy().copy() for k, _ in hmm.named_buffers()}
    bad["t"][1, 0, 0] = np.nan
    bad = PairHMM(bad).cuda()
    os.environ["CPECAN_TPU_DEBUG"] = "1"
    try:
        fb_batch.fb_pass_batch(bad, *bt["args"], mode="posterior_match",
                               width=bt["W"])
    except RuntimeError as e:
        if "fb debug: non-finite per-diagonal total" not in str(e):
            raise
        log(f"F2 debug on a NaN transition at W={bt['W']}: raised {e} ({card})")
    else:
        raise AssertionError("a NaN transition passed the debug checks")
    finally:
        os.environ.pop("CPECAN_TPU_DEBUG", None)


def _bit_equal(got, want):
    """Whether two (nested) wrapper outputs are equal bit for bit, as fwd's
    kernels and fwd_reference are (they round alike)."""
    return all(torch.equal(g, w_) for (_, g), (_, w_) in zip(_flat(got), _flat(want)))


def _wide_batch(card, sites):
    """The batch path's three kernels at W > MAX_KERNEL_WIDTH (the wide
    variants: the cluster kernels) against their plain versions on the
    same card tensors (fwd bit for bit), with times; each against the
    global-scratch kernel on the same inputs (fwd bit for bit), times in
    turns, and at a cluster of 4. The first width's numbers go to the JSON
    summary."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    hmm = PairHMM.from_state_machine(state_machine5()).cuda()
    S = hmm.state_number
    for width, seq_len in WIDE_BATCHES:
        bt = _band_batch(np.random.default_rng(5), 2, 2 * seq_len + 200,
                         "posterior_all", state_machine5, full=True,
                         evolve=True, seq_len=seq_len, width=width)
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

        def errs(k, got, want):
            if k == "fwd":
                if not _bit_equal(got, want):
                    raise AssertionError(f"wide fwd at W={W}: not bit-equal to "
                                         f"fwd_reference")
                return 0.0
            if k == "bwd":
                keys = ("post_match", "post_gap_x", "post_gap_y")
                return max(_max_err(
                    {**dict(zip(keys, got[0])), "mb": got[1], "total_raw": got[2]},
                    {**dict(zip(keys, want[0])), "mb": want[1], "total_raw": want[2]},
                    L).values())
            return _exp_errs(got, want, L)[0]

        for k, args in (("fwd", fin), ("bwd", bin_), ("exp", ein)):
            run = lambda: getattr(wf, k)(*args)
            got = run()
            ms = _median_ms(run, 3)
            want, plain_ms = _timed(lambda: getattr(wf, f"{k}_reference")(*args))
            err = errs(k, got, want)
            res[k] = (err, ms, plain_ms, _bound(B, R, W, S, hmm.nz, k))
            plan = _wide_plan(k, S, W)
            if not plan["cluster"]:
                raise AssertionError(f"wide {k} at W={W}: no cluster "
                                     f"({_plan_text(plan, W)})")
            # the global-scratch kernel on the same inputs, against the
            # same plain outputs (fwd: and the cluster's, bit for bit), in
            # turns
            with _cluster_limit(0):
                g_out = run()
                g_err = errs(k, g_out, want)
                g_ms = _median_ms(run, 3)
            if k == "fwd" and not _bit_equal(got, g_out):
                raise AssertionError(f"wide fwd at W={W}: cluster and "
                                     f"global-scratch kernels differ")
            ms2 = _median_ms(run, 3)
            with _cluster_limit(0):
                g_ms2 = _median_ms(run, 3)
            variant = (f"; {_plan_text(plan, W)}; global-scratch kernel "
                       f"{g_ms:.3f} / {g_ms2:.3f} ms against cluster {ms:.3f} / "
                       f"{ms2:.3f} (in turns, {g_ms / ms:.2f}x), its max abs err "
                       f"{g_err:.3g}")
            # a smaller cluster, where the band fits one of 4, against the
            # same plain outputs
            with _cluster_limit(4):
                alt = _wide_plan(k, S, W)
                if alt["cluster"]:
                    errs(k, run(), want)
                    variant += f"; {_plan_text(alt, W)} checked"
            log(f"wide {k}: B={B} R={R} W={W}; kernel {ms:.3f} ms "
                f"({1e3 * ms / R:.2f} us per diagonal), plain {plain_ms:.1f} ms, "
                f"bound {res[k][3][0]:.4f} ms ({res[k][3][1]}), max abs err "
                f"{err:.3g}{' (bit-equal)' if k == 'fwd' else ''} ({card}){variant}")
        if any(wf.LAUNCHES[f"wide_{k}"] <= 0 for k in ("fwd", "bwd", "exp")):
            raise AssertionError(f"wide variants not launched: {wf.LAUNCHES}")
        first = width == WIDE_BATCHES[0][0]
        if first:
            _nan_debug_on_card(bt, hmm, card)
        for k, (err, ms, plain_ms, bound) in res.items():
            v = sites[f"wide_{k}"]
            v["err"] = max(v["err"], err)
            if first:
                v.update(ms=ms, plain_ms=plain_ms, bound=bound)
        del bt, pre, ein, fin, bin_
        torch.cuda.empty_cache()


def _global_variant(site, entry, ms, card):
    """The global-scratch kernel on a captured wide launch's inputs: its
    outputs against the cluster kernel's (the kernel tests' tolerances;
    fwd's bit for bit) and its time beside the cluster's (``ms``), in
    turns."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    kind = SITES[site][0]
    args, kw = entry
    run = lambda: getattr(wf, kind)(*args, site=site, **kw)
    cl_out = run()
    cl = _flat(cl_out)
    with _cluster_limit(0):
        gl_out = run()
        gl = _flat(gl_out)
        g_ms = _median_ms(run, 3)
    ms2 = _median_ms(run, 3)
    torch.cuda.synchronize()
    for (name, c), (_, g) in zip(cl, gl):
        key = _OUT_KEYS[kind].get(name)
        tol = ((EXP_RTOL, 1e-6) if key == "counts" else (0.0, 1e-5)
               if key == "exp_rows" else TOLERANCES.get(key, (1e-4, 1e-6)))
        torch.testing.assert_close(c, g, rtol=tol[0], atol=tol[1],
                                   msg=f"{site} cluster vs global {name}")
    B, R, W = args[1].shape
    if kind == "fwd" and not _bit_equal(cl_out, gl_out):
        raise AssertionError(f"{site}: cluster and global-scratch kernels differ")
    log(f"    the global-scratch kernel on the same inputs (B={B} R={R} W={W}): "
        f"{g_ms:.3f} ms ({1e3 * g_ms / R:.2f} us per diagonal) against the "
        f"cluster's {ms:.3f} / {ms2:.3f} ms (in turns, {g_ms / ms:.2f}x; {card})")


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

    _nan_totals(card)
    _nan_prep(card, sites)
    _wide_batch(card, sites)
    seqs, cigars = _gap_record(21)
    fasta, cig = f"{tmp}/gap.fa", f"{tmp}/gap.cigar"
    _write_fasta(fasta, seqs)
    _write_cigars(cig, cigars)
    width = lambda args: args[1].shape[-1]
    torch.cuda.synchronize()
    wf.reset_launch_counts()
    with _capture(("par_fwd", "par_bwd"), width) as kept, _wide_plans() as seen:
        t0 = time.perf_counter()
        out = _realign(fasta, cigars, "cuda", GAP_SPLIT)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: v for k, v in wf.LAUNCHES.items() if v}
    for k in ("wide_fwd", "wide_bwd"):
        if not launches.get(k):
            raise AssertionError(f"{k} not launched by the gap record: {launches}")
        sites[k]["launches"] = launches[k]
    for k in ("fwd", "bwd"):
        if launches.get(f"cluster_{k}") != launches[f"wide_{k}"]:
            raise AssertionError(f"wide {k} launches without a cluster: {launches}")
    _log_wide_plans(seen, "gap record realign")
    _check_cigars(out, cigars)
    if set(kept) != {"par_fwd", "par_bwd"}:
        raise AssertionError(f"the gap record did not stream: {launches}")
    log(f"gap record realign ({len(seqs['gapx'])} x {len(seqs['gapy'])}, "
        f"an anchor-free {GAP_MIDDLE} bp gap, {' '.join(GAP_SPLIT)}): {dt:.2f} s "
        f"on {card}; launches {launches}")
    for site, entry in kept.items():
        e, ms, *_ = _check_site(site, entry, 5, wf.KERNEL_NZ[5],
                                "the gap record's widest window", card, reps=3)
        k = f"wide_{SITES[site][0]}"
        sites[k]["err"] = max(sites[k]["err"], e)
        _global_variant(site, entry, ms, card)

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
    with _capture(("seg_fwd", "seg_exp"), width) as kept, _wide_plans() as seen:
        t0 = time.perf_counter()
        model = _em(fasta, cig, f"{tmp}/gap.hmm", "cuda",
                    ["--iterations", "1"] + GAP_SPLIT)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: v for k, v in wf.LAUNCHES.items() if v}
    if not launches.get("wide_exp") or set(kept) != {"seg_fwd", "seg_exp"}:
        raise AssertionError(f"EM on the gap record launched no wide, streamed "
                             f"fwd and exp: {launches}")
    for k in ("fwd", "exp"):
        if launches.get(f"cluster_{k}") != launches[f"wide_{k}"]:
            raise AssertionError(f"wide {k} launches without a cluster: {launches}")
    _log_wide_plans(seen, "gap record em")
    sites["wide_exp"]["launches"] = launches["wide_exp"]
    if not np.isfinite(model.likelihood):
        raise AssertionError(f"gap record EM likelihood {model.likelihood}")
    log(f"gap record em, 1 iteration: {dt:.2f} s on {card}; likelihood "
        f"{model.likelihood}; launches {launches}")
    for site in ("seg_fwd", "seg_exp"):
        kind = SITES[site][0]
        e, ms, *_ = _check_site(site, kept[site], 5, wf.KERNEL_NZ[5],
                                f"the gap record's widest {kind} window", card,
                                reps=3)
        sites[f"wide_{kind}"]["err"] = max(sites[f"wide_{kind}"]["err"], e)
        _global_variant(site, kept[site], ms, card)
    torch.cuda.empty_cache()


# ------------------------------------------------------------ MSA and align


MSA_SEQS, MSA_LEN, MSA_COMPARE = 100, 1000, 5
ALIGN_TARGETS, ALIGN_QUERIES = 8, 32
ALIGN_COMPARE = (2, 2)  # targets x queries run again on the CPU
# kept MSA pairs are AMAP-reweighted, prob - gapGamma * (indel_x +
# indel_y), each indel term 1e7 minus its row's (column's) posteriors: a
# kept pair moves by its own error (<= 100) plus 0.5 x those of up to 9
# pairs in its row and 9 in its column
KEPT_TOL = 1000


def _msa_frags(n):
    """BASELINE config #5's inputs as bench.py:570-575 makes them: one
    random root and n evolved copies, each with its own end ids (so every
    pair aligns with ragged ends)."""
    from cpecan_tpu_torch.msa.aligner import SeqFrag
    from cpecan_tpu_torch.utils import symbols

    rng = random.Random(5)
    root = symbols.get_random_sequence(MSA_LEN, rng).upper()
    return [SeqFrag(symbols.evolve_sequence(root, rng).upper(), i, i + 1)
            for i in range(n)]


def _msa(frags, device):
    """make_alignment at bench.py's MSA settings (bench.py:581-584)."""
    from cpecan_tpu_torch.config import PairwiseAlignmentParameters
    from cpecan_tpu_torch.models.state_machine import state_machine5
    from cpecan_tpu_torch.msa import aligner

    return aligner.make_alignment(
        state_machine5(), frags, spanning_trees=2,
        max_pairs_to_consider=10_000_000, use_progressive_merging=True,
        match_gamma=0.0, p=PairwiseAlignmentParameters(), seed=0,
        device=device)


def _check_msa(ma, frags):
    """Every position in exactly one column, no column with two positions
    of one sequence, every kept pair inside one column, n-1 seed pairs and
    at most n more."""
    cols = ma.column_list()
    if sum(len(c) for c in cols) != sum(f.length for f in frags):
        raise AssertionError("the columns do not partition the positions")
    if any(len({s for s, _ in c}) != len(c) for c in cols):
        raise AssertionError("a column holds two positions of one sequence")
    ap, store = ma.aligned_pairs, ma.columns
    if len(ap) == 0 or any(
            store.find_pos(int(q["seq1"]), int(q["pos1"]))
            != store.find_pos(int(q["seq2"]), int(q["pos2"])) for q in ap):
        raise AssertionError("a kept pair spans two columns")
    n = len(frags)
    if not n - 1 <= len(ma.chosen_pairwise_alignments) <= 2 * n - 1:
        raise AssertionError(
            f"{len(ma.chosen_pairwise_alignments)} pairwise alignments")
    return cols


def _stages(snap):
    return ", ".join(f"{k} {v['seconds']:.2f} s ({v['calls']} calls)"
                     for k, v in sorted(snap["stages"].items()))


def _msa_card_cpu(frags):
    """make_alignment on the card and on the CPU (the kernels' plain
    versions). The chosen pairwise alignments must be equal, and their
    posteriors, recomputed on both, must agree as phase 5's do (pair sets
    equal but for threshold flips, within 100/1e7). Columns and kept pairs
    must be equal; kept pairs are AMAP-reweighted, so each may move by its
    own posterior's error plus gapGamma times those of its row and column
    (KEPT_TOL). A column may differ only as a near-tie, where the merge
    met weights within that noise: then the kept pairs' summed posteriors
    must agree within 1e-5 relative. Returns the near-tie count."""
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.align.anchors import get_anchors
    from cpecan_tpu_torch.config import PairwiseAlignmentParameters
    from cpecan_tpu_torch.models.state_machine import state_machine5

    card, cpu = _msa(frags, "cuda"), _msa(frags, "cpu")
    _check_msa(cpu, frags)
    if ([c[1:] for c in card.chosen_pairwise_alignments]
            != [c[1:] for c in cpu.chosen_pairwise_alignments]):
        raise AssertionError("card and CPU chose other pairwise alignments")
    p = PairwiseAlignmentParameters()
    jobs = [(frags[i].seq, frags[j].seq,
             get_anchors(frags[i].seq, frags[j].seq, p),
             frags[i].left_end_id != frags[j].left_end_id,
             frags[i].right_end_id != frags[j].right_end_id)
            for _, i, j in card.chosen_pairwise_alignments]
    got = [batch.get_aligned_pairs_batch(state_machine5(), jobs, p,
                                         device=dev)
           for dev in ("cuda", "cpu")]
    raw = [_same_pairs(x, y, p.threshold) for x, y in zip(*got)]
    worst = max(w for _, _, w in raw)
    flips = sum(f for _, f, _ in raw)
    if worst > 100:
        raise AssertionError(f"MSA posteriors differ by {worst} > 100")
    a, b = card.column_list(), cpu.column_list()
    near_ties = len(a) - len(set(map(tuple, a)) & set(map(tuple, b)))
    ka, kb = card.aligned_pairs, cpu.aligned_pairs
    kept = "n/a (near-ties)"
    if near_ties:
        sa, sb = int(ka["prob"].sum()), int(kb["prob"].sum())
        if abs(sa - sb) > 1e-5 * max(sb, 1):
            raise AssertionError(f"kept posteriors {sa} (card) vs {sb} (CPU)")
    else:
        for k in ("seq1", "pos1", "seq2", "pos2"):
            if not np.array_equal(ka[k], kb[k]):
                raise AssertionError("card and CPU kept other pairs")
        kept = int(np.abs(ka["prob"] - kb["prob"]).max())
        if kept > KEPT_TOL and not flips:
            raise AssertionError(f"kept pairs differ by {kept} > {KEPT_TOL}")
    log(f"card vs CPU MSA: {len(frags)} x {MSA_LEN} bp, "
        f"{len(card.chosen_pairwise_alignments)} pairwise alignments, "
        f"{sum(n for n, _, _ in raw)} posterior pairs agree ({flips} "
        f"threshold flips within 1e-5), max prob diff {worst} / 1e7; "
        f"{len(b)} columns (CPU), identical but {near_ties} (near-ties); "
        f"{len(kb)} kept pairs, max reweighted prob diff {kept} / 1e7")
    return near_ties


def _msa_profile(frags, card):
    """The MSA run again with torch.profiler tracing the device only: its
    device busy time (kernels and copies, one stream) against its wall."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _msa(frags, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    if not busy > 0:
        raise AssertionError("the profiler recorded no device time")
    log(f"msa profile (device tracing only, {card}): {wall:.3f} s wall, "
        f"device busy {1e3 * busy:.2f} ms ({100 * (1 - busy / wall):.2f}% "
        f"idle); longest: "
        + ", ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.2f} ms x{e.count}"
                    for e in rows[:4]))


def _align_cli(target_fa, query_fa, device):
    from cpecan_tpu_torch.cli import align

    stdout = io.StringIO()
    rc = align.main([target_fa, query_fa, "--device", device], stdout=stdout)
    if rc != 0:
        raise RuntimeError(f"align exited with {rc}")
    return stdout.getvalue()


def phase_msa_align(card, tmp):
    """Phase 13: MSA (make_alignment, the native progressive merge) at
    BASELINE config #5's stated scale, card against CPU on its first
    fragments, and the align CLI on 256 pairs, card against CPU on 8."""
    from cpecan_tpu_torch.align import native
    from cpecan_tpu_torch.cli.realign import cigar_io, metrics
    from cpecan_tpu_torch.ops import fb_batch
    from cpecan_tpu_torch.ops import fb_wavefront as wf
    from cpecan_tpu_torch.utils import symbols

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host library (progressive merge) "
                             "is unavailable")
    frags = _msa_frags(MSA_SEQS)
    metrics.reset()
    torch.cuda.synchronize()
    wf.reset_launch_counts()
    t0 = time.perf_counter()
    ma = _msa(frags, "cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(wf.LAUNCHES)
    if fb_batch.LAST_ENGINE != "cuda":
        raise AssertionError(f"engine {fb_batch.LAST_ENGINE!r}, not cuda")
    for k in ("fwd", "bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the MSA path")
    cols = _check_msa(ma, frags)
    snap = metrics.snapshot()
    staged = sum(v["seconds"] for v in snap["stages"].values())
    log(f"msa {MSA_SEQS} x {MSA_LEN} bp (make_alignment, 2 spanning trees, "
        f"native progressive merge) on {card}: {dt:.2f} s; "
        f"{len(ma.chosen_pairwise_alignments)} pairwise alignments, "
        f"{len(cols)} columns, {len(ma.aligned_pairs)} aligned pairs kept, "
        f"{snap['counters'].get('dp_cells', 0)} DP cells; stages "
        f"{_stages(snap)}; outside the stages (reweighting, "
        f"distance matrix, pair choice) {dt - staged:.2f} s; launches "
        f"fwd {launches['fwd']}, bwd {launches['bwd']}")
    _msa_profile(frags, card)
    near_ties = _msa_card_cpu(frags[:MSA_COMPARE])

    rng = random.Random(13)
    root = symbols.get_random_sequence(MSA_LEN, rng).upper()
    targets = {f"t{i}": symbols.evolve_sequence(root, rng).upper()
               for i in range(ALIGN_TARGETS)}
    queries = {f"q{i}": symbols.evolve_sequence(root, rng).upper()
               for i in range(ALIGN_QUERIES)}
    nt, nq = ALIGN_COMPARE
    files = {}
    for name, t, q in (("all", targets, queries),
                       ("some", dict(list(targets.items())[:nt]),
                        dict(list(queries.items())[:nq]))):
        files[name] = (f"{tmp}/align_{name}_t.fa", f"{tmp}/align_{name}_q.fa")
        _write_fasta(files[name][0], t)
        _write_fasta(files[name][1], q)
    metrics.reset()
    torch.cuda.synchronize()
    wf.reset_launch_counts()
    t0 = time.perf_counter()
    out = _align_cli(*files["all"], "cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(wf.LAUNCHES)
    for k in ("fwd", "bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by align")
    got = list(cigar_io.cigar_read(io.StringIO(out)))
    n_pairs = ALIGN_TARGETS * ALIGN_QUERIES
    if len(got) != n_pairs:
        raise AssertionError(f"{len(got)} cigars for {n_pairs} pairs")
    for c in got:
        c.check()
    log(f"align CLI {ALIGN_TARGETS} x {ALIGN_QUERIES} evolved {MSA_LEN} bp "
        f"on {card}: {n_pairs} pairs in {dt:.2f} s, {n_pairs / dt:.1f} "
        f"pairs/s; stages {_stages(metrics.snapshot())}; launches fwd "
        f"{launches['fwd']}, bwd {launches['bwd']}")
    cpu = list(cigar_io.cigar_read(io.StringIO(
        _align_cli(*files["some"], "cpu"))))
    card_some = [c for c in got if c.contig1 in list(targets)[:nt]
                 and c.contig2 in list(queries)[:nq]]
    if len(cpu) != nt * nq or cpu != card_some:
        raise AssertionError("align: CPU cigars differ from the card's")
    log(f"card vs CPU align: {len(cpu)} pairs, cigars identical")
    log(f"phase 13 (MSA and align): {time.perf_counter() - t_phase:.1f} s; "
        f"MSA near-ties {near_ties}")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ data parallel

# realign's batch_posteriors with and without a mesh on this many records
DP_POSTERIOR_RECORDS = 64
# the em CLI runs: ~10 chunks of the 1024 records, so both ranks get work
DP_EM_ARGS = ["--modelType", "fiveState", "--iterations", "2",
              "--maxAlignmentLengthPerJob", "100000"]
DP_TIMEOUT_S = 300  # per em CLI process
DP_COLLECTIVE_TIMEOUT_S = "60"  # rendezvous and all-gather
# two processes against one (tests/test_multihost.py:146-150)
DP_RTOL, DP_ATOL = 1e-6, 1e-9


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _em_processes(argvs):
    """Run ``python -m cpecan_tpu_torch.cli.em`` once per argv, all at
    once, each with a timeout; every process is stopped before this
    returns. Returns the wall seconds until the last one ended."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cpecan_tpu_torch.cli.em", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env=env) for argv in argvs]
    try:
        errs = [pr.communicate(timeout=DP_TIMEOUT_S)[1] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    dt = time.perf_counter() - t0
    for pr, err in zip(procs, errs):
        if pr.returncode != 0:
            raise RuntimeError(f"em process exited with {pr.returncode}: "
                               f"{err[-3000:]}")
    return dt


def _dp_expectation(seqs, cigars, mesh, card):
    """(a): the EM expectation step over all records at the EM defaults,
    without and with the two-shard mesh; then batch_posteriors at
    realign's parameters."""
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.cli import realign
    from cpecan_tpu_torch.em import em as em_mod
    from cpecan_tpu_torch.models.hmm import Hmm, StateMachineType
    from cpecan_tpu_torch.models.state_machine import state_machine5
    from cpecan_tpu_torch.ops import fb_batch
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    p = em_mod.EmOptions().pairwise_params()
    tasks = em_mod.tasks_from_cigars(cigars, seqs, p)
    counts, launches, secs = {}, {}, {"none": [], "mesh": []}
    # in turns (none, mesh, mesh, none); launch counts reset just before
    # and read just after each run
    for name, m in (("none", None), ("mesh", mesh), ("mesh", mesh),
                    ("none", None)):
        hmm = Hmm(StateMachineType.fiveState)
        torch.cuda.synchronize()
        wf.reset_launch_counts()
        t0 = time.perf_counter()
        em_mod.expectation_step(state_machine5(), tasks, p, hmm, mesh=m,
                                device="cuda")
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
        launches[name] = dict(wf.LAUNCHES)
        if m is not None and fb_batch.LAST_ENGINE != "cuda_sharded":
            raise AssertionError(
                f"engine {fb_batch.LAST_ENGINE!r}, not cuda_sharded")
        counts[name] = hmm
    for k in ("fwd", "exp"):
        if not launches["mesh"][k] >= launches["none"][k] > 0:
            raise AssertionError(f"{k}: {launches['mesh'][k]} launches on the "
                                 f"mesh, {launches['none'][k]} without")
    worst = _close_hmms(counts["mesh"], counts["none"],
                        "expectation step mesh vs none")
    log(f"data parallel (a) expectation step, {len(tasks)} tasks, 2 shards "
        f"on {card}: s per run in turns, no mesh "
        f"{', '.join(f'{t:.3f}' for t in secs['none'])}, mesh "
        f"{', '.join(f'{t:.3f}' for t in secs['mesh'])}; launches exp "
        f"{launches['mesh']['exp']} / fwd {launches['mesh']['fwd']} (no mesh "
        f"{launches['none']['exp']} / {launches['none']['fwd']}); max "
        f"relative difference transitions {worst[0]:.3g}, emissions "
        f"{worst[1]:.3g}, likelihood {worst[2]:.3g}")

    pr = realign.alignment_parameters(realign.make_parser().parse_args(["x"]))
    jobs = _realign_jobs(seqs, cigars[:DP_POSTERIOR_RECORDS], pr)
    outs = []
    for m in (None, mesh):
        wf.reset_launch_counts()
        outs.append(batch.batch_posteriors(state_machine5(), jobs, pr,
                                           device="cuda", mesh=m))
        launches = dict(wf.LAUNCHES)
        if launches["fwd"] <= 0 or launches["bwd"] <= 0:
            raise AssertionError(f"batch_posteriors launched {launches}")
    n_pairs, not_equal, worst = 0, 0, 0
    for a, b in zip(*outs):
        if (a.shape != b.shape or not np.array_equal(a["x"], b["x"])
                or not np.array_equal(a["y"], b["y"])):
            raise AssertionError("the mesh changed a job's pair set")
        n_pairs += len(a)
        if not np.array_equal(a, b):
            not_equal += 1
            worst = max(worst, int(np.abs(a["prob"].astype(np.int64)
                                          - b["prob"]).max()))
    if worst > 100:
        raise AssertionError(f"posteriors differ by {worst}/1e7 on the mesh")
    log(f"data parallel (a) batch_posteriors, {len(jobs)} records, 2 shards: "
        f"{n_pairs} pairs, pair sets identical; "
        + ("bit-equal on every record" if not not_equal else
           f"NOT bit-equal on {not_equal} records (max {worst}/1e7)"))


def _dp_em_cli(tmp, fasta, cig):
    """(b): the em CLI as one process, as two gloo processes on the card,
    and as one process with --dataParallel. Returns the wall seconds."""
    from cpecan_tpu_torch.models.hmm import Hmm

    def argv(out, extra=()):
        return ["--sequences", fasta, "--alignments", cig, "--outputModel",
                out, "--device", "cuda", "--diagonalExpansion", "10",
                "--splitMatrixBiggerThanThis", "3000", "--trainEmissions",
                "--randomStart", "--trials", "1", "--seed", "0",
                *DP_EM_ARGS, *extra]

    one, dp = f"{tmp}/dp_one.hmm", f"{tmp}/dp_mesh.hmm"
    ranks = [f"{tmp}/dp_rank{i}.hmm" for i in range(2)]
    walls = {"one": _em_processes([argv(one)])}
    port = _free_port()
    walls["two"] = _em_processes([argv(ranks[i], [
        "--coordinator", f"127.0.0.1:{port}", "--numProcesses", "2",
        "--processId", str(i), "--collectiveTimeout",
        DP_COLLECTIVE_TIMEOUT_S]) for i in range(2)])
    walls["dataParallel"] = _em_processes([argv(dp, ["--dataParallel"])])
    if os.path.exists(ranks[1]):
        raise AssertionError("rank 1 wrote a model file")
    ref, got = Hmm.load(one), Hmm.load(ranks[0])
    np.testing.assert_allclose(got.transitions, ref.transitions, rtol=DP_RTOL,
                               atol=DP_ATOL)
    np.testing.assert_allclose(got.emissions, ref.emissions, rtol=DP_RTOL,
                               atol=DP_ATOL)
    rel = abs(got.likelihood - ref.likelihood) / abs(ref.likelihood)
    if rel > DP_RTOL:
        raise AssertionError(f"2 processes: likelihood {got.likelihood} vs "
                             f"{ref.likelihood}")
    with open(one) as a, open(dp) as b:
        if a.read() != b.read():
            raise AssertionError("--dataParallel changed the model file")
    worst = max(float(np.max(np.abs(got.transitions - ref.transitions))),
                float(np.max(np.abs(got.emissions - ref.emissions))))
    log(f"data parallel (b) em CLI, {' '.join(DP_EM_ARGS)}: wall 1 process "
        f"{walls['one']:.2f} s, 2 gloo processes on the one card "
        f"{walls['two']:.2f} s, 1 process --dataParallel "
        f"{walls['dataParallel']:.2f} s (process start included); 2 processes "
        f"vs 1: max abs difference {worst:.3g}, likelihood {rel:.3g} "
        f"relative ({len(ref.running_likelihoods)} iterations, likelihoods "
        f"{ref.running_likelihoods}); --dataParallel file identical")
    return walls


def _dp_trace(tmp, fasta, seqs, cigars):
    """(c): one EM iteration under utils.metrics.trace."""
    from cpecan_tpu_torch.utils import metrics

    cig = f"{tmp}/trace.cigar"
    _write_cigars(cig, cigars[:DP_POSTERIOR_RECORDS])
    log_dir = f"{tmp}/trace"
    t0 = time.perf_counter()
    with metrics.trace(log_dir):
        _em(fasta, cig, f"{tmp}/traced.hmm", "cuda", ["--iterations", "1"])
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    paths = [f"{log_dir}/{f}" for f in os.listdir(log_dir)
             if f.endswith(".pt.trace.json")]
    if len(paths) != 1:
        raise AssertionError(f"trace files: {os.listdir(log_dir)}")
    with open(paths[0]) as fh:
        text = fh.read()
    for name in ("wavefront_exp", "wavefront_fwd"):
        if name not in text:
            raise AssertionError(f"the trace does not name {name}")
    log(f"data parallel (c) metrics.trace: 1 EM iteration on "
        f"{DP_POSTERIOR_RECORDS} records in {dt:.2f} s traced; "
        f"{os.path.basename(paths[0])} {len(text)} bytes names "
        f"wavefront_exp and wavefront_fwd")


def _dp_debug(card):
    """(d): CPECAN_TPU_DEBUG=1 on the headline batch through
    fb_pass_batch, then a NaN transition."""
    from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
    from cpecan_tpu_torch.ops import fb_batch

    bt = _band_batch(np.random.default_rng(0), 256, 2048, "posterior_match",
                     state_machine5, anchor_every=50)
    hmm = PairHMM.from_state_machine(bt["sm"]).cuda()
    bad = {k: getattr(hmm, k).cpu().numpy().copy()
           for k, _ in hmm.named_buffers()}
    bad["t"][1, 0, 0] = np.nan
    bad = PairHMM(bad).cuda()
    def call(model, mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fb_batch.fb_pass_batch(model, *bt["args"], mode=mode,
                                     width=bt["W"])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    os.environ.pop("CPECAN_TPU_DEBUG", None)
    try:
        for mode in ("posterior_match", "expectation"):
            ms, first = {"0": [], "1": []}, None
            for flag in ("0", "1", "1", "0", "0", "1"):  # in turns
                os.environ["CPECAN_TPU_DEBUG"] = flag
                t, out = call(hmm, mode)
                ms[flag].append(t)
                first = first or out
                for k, v in out.items():
                    if not torch.equal(v, first[k]):
                        raise AssertionError(f"debug mode changed {mode} {k}")
            log(f"data parallel (d) CPECAN_TPU_DEBUG=1, headline batch "
                f"{mode} on {card}: outputs identical; median of 3 calls "
                f"{statistics.median(ms['1']):.2f} ms checked, "
                f"{statistics.median(ms['0']):.2f} ms unchecked (host "
                f"clock, synchronised)")
        os.environ["CPECAN_TPU_DEBUG"] = "0"
        _, out = call(bad, "posterior_match")
        finite = ", ".join(
            f"{k} {100 * torch.isfinite(v).float().mean().item():.1f}%"
            for k, v in out.items())
        os.environ["CPECAN_TPU_DEBUG"] = "1"
        try:
            call(bad, "posterior_match")
        except RuntimeError as e:
            if "fb debug: non-finite per-diagonal total" not in str(e):
                raise
            log(f"data parallel (d) NaN transition t[1, 0, 0]: raised {e}; "
                f"finite share of the unchecked outputs: {finite}")
        else:
            raise AssertionError("a NaN transition passed the debug checks")
    finally:
        os.environ.pop("CPECAN_TPU_DEBUG", None)


def phase_data_parallel(card, tmp, fasta, cig, seqs, cigars):
    """Phase 14: the data-parallel slice on one card."""
    from cpecan_tpu_torch.parallel.mesh import DataMesh

    t_phase = time.perf_counter()
    mesh = DataMesh(["cuda:0", "cuda:0"])
    _dp_expectation(seqs, cigars, mesh, card)
    walls = _dp_em_cli(tmp, fasta, cig)
    _dp_trace(tmp, fasta, seqs, cigars)
    _dp_debug(card)
    log(f"phase 14 (data parallel): {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return walls


# python -m cpecan_tpu_torch.bench: every config at --smoke sizes, then
# the headline at full size with the first run's progress lines as its
# --resume-log, each in a process of its own
BENCH_RUNS = (["--all", "--smoke"], ["--config", "headline"])
BENCH_TIMEOUT_S = 600  # per bench process
_REFUSED = "--resume-log: headline is run again: "


def _bench(args):
    """``python -m cpecan_tpu_torch.bench *args`` in its own process group,
    with a timeout; the group is stopped before this returns. Returns
    (its JSON report, its stderr, wall seconds); a non-zero exit raises."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cpecan_tpu_torch.bench", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env=dict(os.environ, PYTHONPATH=root), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"bench {' '.join(args)} exited with "
                           f"{proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
    return json.loads(out.splitlines()[-1]), err, wall


def _check_resume_refusal(report, err, commit):
    """The full-size headline was run, not taken from the smoke run's
    log: its refusal names smoke as a field that differs (commit, when
    this checkout's commit is unknown or dirty and vouches for nothing)."""
    (headline,) = report["configs"]
    if headline.get("resumed"):
        raise AssertionError("bench reused the smoke run's headline line")
    refusals = [ln[len(_REFUSED):] for ln in err.splitlines()
                if ln.startswith(_REFUSED)]
    if len(refusals) != 1:
        raise AssertionError(f"bench printed {len(refusals)} refusals of the "
                             f"headline's smoke line:\n{err[-3000:]}")
    fields = [part.split(":")[0] for part in refusals[0].split("; ")]
    vouches = commit != "unknown" and not commit.endswith("+dirty")
    if ("smoke" if vouches else "commit") not in fields:
        raise AssertionError(f"headline refused for {refusals[0]!r}")
    log(f"bench --resume-log: headline run again: {refusals[0]}")


def phase_bench(card, tmp):
    """Phase 15: the port's benchmark harness end to end, as a user runs
    it: every config of bench.py at --smoke sizes (each output check must
    pass), then the headline at full size, which must not reuse the smoke
    run's line; each report names this checkout's commit as the bench's
    own commit lookup gives it in this process."""
    from cpecan_tpu_torch import bench

    commit = bench.resolve_commit()
    resume_log = f"{tmp}/bench_smoke.log"
    for i, args in enumerate(BENCH_RUNS):
        if i:
            args = [*args, "--resume-log", resume_log]
        report, err, wall = _bench(args)
        if i == 0:
            with open(resume_log, "w") as fh:
                fh.write(err)
        else:
            _check_resume_refusal(report, err, commit[0])
        if report["backend"] != card:
            raise AssertionError(f"bench ran on {report['backend']}, not {card}")
        if (report["commit"], report["commit_source"]) != commit:
            raise AssertionError(f"bench reported the commit "
                                 f"{report['commit']!r} ({report['commit_source']}),"
                                 f" this process finds {commit}")
        for c in report["configs"]:
            if c["check"] != "ok":
                raise AssertionError(f"bench config {c['name']}: {c['check']}")
            if c["stamp"]["device"] != card or c["stamp"]["commit"] != commit[0]:
                raise AssertionError(f"bench config {c['name']}: stamp "
                                     f"{c['stamp']}")
            log(f"bench {' '.join(args)}: {c['name']} {c['metric']} = "
                f"{c['value']} {c['unit']} (vs C {c['vs_baseline']}), check "
                f"{c['check']}")
        log(f"bench {' '.join(args)}: {len(report['configs'])} configs in "
            f"{wall:.1f} s; C baseline {report['c_baseline_cells_per_sec']:.4g} "
            f"cells/s (runs {report['c_baseline_runs']}); power limit "
            f"{report['power_limit']}; commit {report['commit']} "
            f"({report['commit_source']})")


def _no_jax_package():
    bad = sorted(m for m in sys.modules if m in ("jax", "cpecan_tpu")
                 or m.startswith(("jax.", "cpecan_tpu.")))
    if bad:
        raise AssertionError(f"modules of jax or the JAX package loaded: {bad}")


@contextlib.contextmanager
def _wall(phase):
    """Logs the wall time of the block, a phase of the run, on its own line."""
    t0 = time.perf_counter()
    yield
    log(f"phase wall: {phase}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t0 = time.perf_counter()
    with _wall("1 device"):
        card, smi = phase_device()
    with _wall("2 build"):
        ptxas = phase_build()
    with _wall("3 kernels"):
        summary = phase_kernels(card)
        phase_prep_launches(card)
    with _wall("3 fwd sweep"):
        phase_fwd_sweep(card, ptxas)
    with _wall("3 bwd sweep"):
        phase_bwd_sweep(card, ptxas)
    with _wall("3 exp sweep"):
        phase_exp_sweep(card, ptxas)

    seqs, cigars = _records(RECORDS)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = f"{tmp}/records.fa"
        with open(fasta, "w") as fh:
            for k, v in seqs.items():
                fh.write(f">{k}\n{v}\n")
        with _wall("4 realign"):
            launches, out = _run_realign(fasta, cigars, [], card)
            _, mea_out = _run_realign(fasta, cigars[:MEA_RECORDS], ["--mea"], card)
        with _wall("5 realign card vs CPU"):
            some = cigars[:COMPARE_RECORDS]
            near_ties = _compare_card_cpu(fasta, seqs, some)
            _compare_cli(fasta, some, out[:COMPARE_RECORDS], [])
            _compare_cli(fasta, some, mea_out[:COMPARE_RECORDS], ["--mea"],
                         near_ties)

        with _wall("6 em"):
            phase_em_kernel(seqs, cigars, card, summary)
            cig = f"{tmp}/records.cigar"
            _write_cigars(cig, cigars)
            em_launches, _ = _run_em(fasta, cig, f"{tmp}/em5.hmm", RECORDS, [
                "--modelType", "fiveState", "--iterations", str(EM_ITERATIONS)],
                card)
            _run_em(fasta, cig, f"{tmp}/em3.hmm", RECORDS, [
                "--modelType", "threeState", "--iterations", "1"], card)
            phase_em_profile(fasta, cig, tmp, card)
        with _wall("7 em card vs CPU"):
            phase_em_card_cpu(tmp, fasta, some)

        sites = {k: {"err": 0.0} for k in LONG_SITES + WIDE_SITES}
        sites["prep"], sites["rows"] = summary["prep"], summary["rows"]
        for phase, run in (
                ("8 long kernels", lambda: phase_long_kernels(card, sites)),
                ("9 long pair", lambda: phase_long_pair(card, sites)),
                ("10 long records", lambda: phase_long_realign(card, tmp)),
                ("11 long em", lambda: phase_long_em(card, tmp, seqs, cigars, sites)),
                ("12 wide bands", lambda: phase_wide(card, tmp, sites)),
                ("13 msa and align", lambda: phase_msa_align(card, tmp)),
                ("14 data parallel", lambda: phase_data_parallel(
                    card, tmp, fasta, cig, seqs, cigars)),
                ("15 bench", lambda: phase_bench(card, tmp))):
            with _wall(phase):
                run()
    _no_jax_package()
    log(f"phase wall: all: {time.perf_counter() - t0:.1f} s")

    # launches: fwd and bwd from the realign main path, exp from the EM
    # main path (fwd launched there too: em_launches); the long-pair sites
    # from the 500 kb path (parallel), the exact engine on its longest
    # chunk (segmented fwd, bwd) and the EM path with long records
    # (segmented exp); the wide variants from the gap record's realign
    # (fwd, bwd) and EM (exp) runs
    runs = {"fwd": launches, "bwd": launches, "exp": em_launches}
    for k in ("fwd", "bwd", "exp"):
        sites[k] = {"launches": runs[k][k], **summary[k]}
    # the prep's two kernels: launches from the realign main path, times
    # at the headline batch, the error of every prep check (phases 3, 8, 9
    # and 12)
    sites["prep"]["launches"] = launches["prep"]
    sites["rows"]["launches"] = launches["rows"]
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
    sys.exit(_prep_launch_child() if sys.argv[1:] == [PREP_LAUNCH_FLAG]
             else main())
