"""Smoke run of the PyTorch port (cpecan_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the CUDA kernels from cpecan_tpu_torch/csrc with nvcc;
  3. kernels: on four batches (headline, dense anchors, 3-state ragged,
     full band W >= 1024) run the kernels and their plain PyTorch
     versions on the same card tensors, check the tolerances, and time
     both per call;
  4. main path: cpecan_tpu_torch.cli.realign.main on 1024 generated 1 kb
     record pairs (default decode) and 256 of them with --mea, with every
     kernel's launch count reset before and read after;
  5. card against CPU: realign.main with --device cpu (the kernels' plain
     versions) on the first 32 records, default and --mea, must give the
     card run's cigars; batch_posteriors at the main path's parameters on
     those records, on the card and on the CPU, must give the same pairs.

The last two lines of standard output are the kernels' JSON summary and
{"ok": true, "device": {...}}. Imports no jax and reaches the system only
through cpecan_tpu_torch. Test data is made with numpy from fixed seeds.
"""

from __future__ import annotations

import contextlib
import io
import json
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
        if "registers" in line or "spill" in line:
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
                expansion=20, full=False, evolve=False, ragged=False):
    """One launch's inputs, shaped as batch_posteriors builds them."""
    from cpecan_tpu_torch.align import batch as port_batch
    from cpecan_tpu_torch.align.pairwise import _width_bucket

    seqs, bands = [], []
    for _ in range(B):
        x = _ACGT[rng.integers(0, 4, SEQ_LEN)].tobytes().decode()
        y = _evolve(x, rng)[:P - SEQ_LEN] if evolve else x
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

    saved = wf.fwd, wf.bwd
    wf.fwd, wf.bwd = wf.fwd_reference, wf.bwd_reference
    try:
        yield
    finally:
        wf.fwd, wf.bwd = saved


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


def phase_kernels(card):
    from cpecan_tpu_torch.models.state_machine import PairHMM
    from cpecan_tpu_torch.ops import fb_wavefront as wf

    summary = {"fwd": {"err": 0.0}, "bwd": {"err": 0.0}}
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
        del got, want, pre, F, bv
        torch.cuda.empty_cache()
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
    for k, v in launches.items():
        if v <= 0:
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

    source = "cpecan_tpu_torch/csrc/wavefront.cu"
    kernels = [
        {"name": "wavefront_fwd", "route": "cuda", "source": source,
         "replaces": "cpecan_tpu/ops/fb_wavefront.py:235",
         "launches": launches["fwd"], "max_abs_err": summary["fwd"]["err"],
         "ms": summary["fwd"]["ms"], "plain_ms": summary["fwd"]["plain_ms"]},
        {"name": "wavefront_bwd", "route": "cuda", "source": source,
         "replaces": "cpecan_tpu/ops/fb_wavefront.py:404",
         "launches": launches["bwd"], "max_abs_err": summary["bwd"]["err"],
         "ms": summary["bwd"]["ms"], "plain_ms": summary["bwd"]["plain_ms"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
