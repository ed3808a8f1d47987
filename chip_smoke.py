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
     2.5 kb pairs for its wide variant (W > 2048);
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
     --device cpu: the HMMs must agree.

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


def phase_build():
    from cpecan_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    path, diagnostics = _kernels.build()
    _kernels.load()
    log(f"build: {path.name} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if diagnostics else " (already built)"))
    for line in diagnostics.splitlines():
        m = re.search(r"entry function .*(wavefront_\w{3})ILi(\d)E(?:Li(\d+)E)?",
                      line)
        if m:
            log(f"  ptxas: {m[1]}<{','.join(g for g in m.groups()[1:] if g)}>")
        elif "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())


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
                seq_len=SEQ_LEN):
    """One launch's inputs, shaped as batch_posteriors builds them."""
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
    """Route the launcher's kernel wrappers to their plain versions."""
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    saved = wf.fwd, wf.bwd, wf.exp
    wf.fwd, wf.bwd, wf.exp = wf.fwd_reference, wf.bwd_reference, wf.exp_reference
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


def _bound(B, R, W, S, nz, kernel):
    """(bound_ms, bound_by) of one call: the larger of the bytes it must
    move (each input read once, each output written once) over HBM's rate
    and its fp32 operations over the fp32 peak. exp reads only pm's
    row-constant bits (one byte per row), bwd its per-slot bits.
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
        fin = (t, pre["ex"], pre["ey"], pre["em"], pre["a"], pre["b1"],
               pre["b0"], pre["F0"], hmm.nz)
        F, bv, _ = wf.fwd(*fin)
        bin_ = (t, pre["efx"], pre["efy"], pre["efm"], pre["em"], F, bv,
                pre["abw"], pre["c1"], pre["c0"], pre["bm1"], pre["bm0"],
                pre["pm"], pre["end_row"], hmm.nz, mode)
        ms = {"fwd": _median_ms(lambda: wf.fwd(*fin), 10),
              "bwd": _median_ms(lambda: wf.bwd(*bin_), 10),
              "fwd_plain": _median_ms(lambda: wf.fwd_reference(*fin), 3),
              "bwd_plain": _median_ms(lambda: wf.bwd_reference(*bin_), 3)}
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
    # exp's wide variant (512 threads, emission bins in device scratch):
    # a full band of evolved 2.5 kb pairs, as an unanchored multi-kb gap
    # of an EM chunk gives it
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


def _run_realign(fasta, cigars, extra, card):
    """The main path on the card, with every kernel's launch count reset
    just before and read just after. Returns (launches, output cigars)."""
    from cpecan_tpu_torch.cli.realign import cigar_io, metrics
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
    jobs = []
    for c in cigars:
        x, y = seqs[c.contig1], seqs[c.contig2]
        anchors = realign.filter_anchors_to_matches(
            realign.cigar_io.alignment_to_anchor_pairs(
                c, p.constraintDiagonalTrim, p.diagonalExpansion), x, y)
        jobs.append((x, y, anchors, True, True))
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
    buckets = em_mod.bucket_tasks(em_mod.tasks_from_cigars(chunk, seqs, p), p)
    (P, W), items = max(buckets.items(), key=lambda kv: len(kv[1]))
    args = [torch.from_numpy(a).cuda() for a in em_mod.bucket_arrays(items, P)]
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


def _no_jax_package():
    bad = sorted(m for m in sys.modules if m in ("jax", "cpecan_tpu")
                 or m.startswith(("jax.", "cpecan_tpu.")))
    if bad:
        raise AssertionError(f"modules of jax or the JAX package loaded: {bad}")


def main() -> int:
    card, smi = phase_device()
    phase_build()
    summary = phase_kernels(card)

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
    _no_jax_package()

    # launches: fwd and bwd from the realign main path, exp from the EM
    # main path (fwd launched there too: em_launches)
    source = "cpecan_tpu_torch/csrc/wavefront.cu"
    replaces = {"fwd": 235, "bwd": 404, "exp": 592}
    runs = {"fwd": launches, "bwd": launches, "exp": em_launches}
    kernels = [
        {"name": f"wavefront_{k}", "route": "cuda", "source": source,
         "replaces": f"cpecan_tpu/ops/fb_wavefront.py:{replaces[k]}",
         "launches": runs[k][k], "max_abs_err": summary[k]["err"],
         "ms": summary[k]["ms"], "plain_ms": summary[k]["plain_ms"],
         "bound_ms": summary[k]["bound"][0],
         "bound_by": summary[k]["bound"][1], "library_ms": None}
        for k in ("fwd", "bwd", "exp")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
