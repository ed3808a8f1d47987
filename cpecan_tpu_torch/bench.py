"""Benchmark harness of the PyTorch port: bench.py's nine configs (the
configurations of BASELINE.md) on cpecan_tpu_torch.

Counterpart of the repository root's bench.py, which measures the JAX
package. The workload builders below are copies of bench.py's on the same
seeds, so both measure the same inputs; every config keeps bench.py's
``metric`` name, ``unit`` and fields, so the two reports line up.

    python -m cpecan_tpu_torch.bench                   # headline, one JSON line
    python -m cpecan_tpu_torch.bench --all             # every config
    python -m cpecan_tpu_torch.bench --config NAME     # one config
    python -m cpecan_tpu_torch.bench --all --smoke --device cpu

``--all`` prints one JSON report and, for a full run on the card whose
checks pass and whose commit is known, writes it to BENCH_TORCH_ALL.json
(never bench.py's BENCH_ALL.json, the TPU's record); ``--smoke`` runs tiny
sizes whose numbers mean nothing; ``--resume-log`` reuses the per-config
JSON lines of an earlier run's log that were measured the same way.

The report names the code it measured: ``commit`` is ROOT's git HEAD (with
``+dirty`` when a tracked file differs from it), else ``--commit REV``,
else $CPECAN_BENCH_COMMIT, else "unknown"; ``commit_source`` says which
(git, flag, env or none). A checkout unpacked from ``git archive`` has no
repository, so its caller names the commit.

Where the port differs from bench.py:

* ``--device`` (default cuda) picks the device. A run that asks for cuda
  and finds no card raises; ``--device cpu`` runs the kernels' plain
  PyTorch versions, its report says cpu and it is never written to disk.
* The C comparator is ``csrc/host/bench_cells.c``, a verbatim copy of
  native/bench_cells.c, built with ``gcc -O3`` into build/cpecan_tpu_torch/
  at first use and run C_RUNS times; its median is the baseline and the
  report lists every run. A failed build or run raises: there is no
  assumed rate.
* Every config reports ``rep_seconds``, each timed rep, beside its median
  ``value``. Each rep ends with torch.cuda.synchronize(); the headline
  times its 10 reps one by one (bench.py times them as one pipelined
  window and divides).
* Every config carries ``"check": "ok"``, or the run prints it with
  ``"check": "failed: ..."`` and exits non-zero. headline: the kernels'
  outputs on CHECK_PAIRS pairs against their plain versions on the same
  tensors (tests/test_wavefront.py's tolerances); realign_1kb: posterior
  parity card vs CPU <= PARITY_MAX_ABS; read_pairs_1kb: card vs CPU pair
  sets on CHECK_PAIRS pairs; em: one expectation step's counts on
  EM_CHECK_PAIRS pairs card vs CPU within EM_COUNT_RTOL; msa: columns card
  vs CPU on MSA_CHECK_FRAGS fragments. The other configs hold only the
  asserts bench.py makes.
* ``posterior_parity_max_abs`` compares the device with the CPU's plain
  versions (bench.py compares its engine with its scan oracle, which the
  port does not have).
* The headline's dense companion launches at the port's width bucket (32,
  where bench.py's lane-packing ladder gives 24) and has no
  ``dense_band_pack_factor``: lane packing is TPU-only and not ported.
* em_scaling shards the expectation step over a DataMesh of 8 shards of
  the one device against no mesh (bench.py: an 8-device virtual CPU mesh):
  it measures dispatch and reduction overhead, not hardware scaling.
* ``--update-readme`` is not ported: the README's bench table is the TPU's.
* Every per-config line and every config of the report carries a
  ``stamp``: the commit, ``smoke``, the device (the card's name or cpu)
  and the config's size overrides (``kwargs``, {} at full size).
  ``--resume-log`` reuses a line only when its stamp equals the one this
  run gives the config, and nothing while this run's commit is unknown or
  dirty; every refused line is named on stderr and its config run again.
  bench.py reuses any line with a config's name and trusts the caller.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.state_machine import PairHMM, state_machine5
from cpecan_tpu_torch.ops import fb_batch, fb_wavefront
from cpecan_tpu_torch.ops.band import construct_band, pad_band
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils import symbols as sym
from cpecan_tpu_torch.utils.logmath import PAIR_ALIGNMENT_PROB_1

_PKG = Path(__file__).resolve().parent
ROOT = _PKG.parent
C_SOURCE = _PKG / "csrc" / "host" / "bench_cells.c"
BUILD_DIR = ROOT / "build" / "cpecan_tpu_torch"
REPORT = ROOT / "BENCH_TORCH_ALL.json"

SEQ_LEN = 1000
BATCH = 256
EXPANSION = 20  # default diagonalExpansion
C_RUNS = 5  # the x-factor moved +-7% with machine load on one run

# output checks
CHECK_PAIRS = 8
EM_CHECK_PAIRS = 4
MSA_CHECK_FRAGS = 5
# (rtol, atol) of tests/test_wavefront.py, as chip_smoke.py holds the
# kernels to their plain versions
TOLERANCES = {"mf": (1e-4, 2e-5), "mb": (1e-4, 2e-5),
              "total_raw": (1e-4, 2e-5), "post_match": (1e-3, 2e-5)}
PARITY_MAX_ABS = 1e-5  # raw posteriors card vs CPU: 100 / 1e7
THRESHOLD_FLIP = 1e-5  # pairs this close to the threshold may flip
EM_COUNT_RTOL = 1e-4


class CheckFailed(AssertionError):
    """An output check of a config failed."""


@dataclasses.dataclass
class Bench:
    """What every config runs with: the device and the C cell rate."""
    device: torch.device
    baseline: float

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# ------------------------------------------------------ C comparator


def build_c_comparator() -> Path:
    """The C micro-benchmark's executable, built with gcc -O3 on first use
    (the file name carries a hash of the source)."""
    digest = hashlib.sha256(C_SOURCE.read_bytes()).hexdigest()[:16]
    exe = BUILD_DIR / f"bench_cells_{digest}"
    if not exe.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        res = subprocess.run(["gcc", "-O3", "-o", str(tmp), str(C_SOURCE),
                              "-lm"], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"gcc could not build {C_SOURCE}:\n{res.stderr}")
        os.replace(tmp, exe)  # atomic: concurrent builds race harmlessly
    return exe


def measure_c_baseline(runs: int = C_RUNS) -> tuple:
    """(median, every run) of the single-core C cell-update rate, cells/s
    (the reference's per-cell fwd+bwd arithmetic, native/bench_cells.c)."""
    exe = build_c_comparator()
    rates = []
    for _ in range(runs):
        out = subprocess.run([str(exe)], check=True, capture_output=True,
                             text=True, timeout=300).stdout.split()
        if len(out) != 2 or out[0] != "cells_per_sec":
            raise RuntimeError(f"{exe.name} printed {out!r}")
        rates.append(float(out[1]))
    return statistics.median(rates), rates


# ------------------------------------------------------------ helpers


def _random_pair(rng: np.random.Generator, n: int):
    """An evolved read pair: ~20% substitutions + short indels, the
    reference's test-data model (bench.py:68-76)."""
    pyrng = random.Random(int(rng.integers(0, 2**31)))
    x = sym.get_random_sequence(n, pyrng).upper()
    y = sym.evolve_sequence(x, pyrng).upper()
    return x, y


def _time_reps(b: Bench, fn, reps: int, warmup: int = 1) -> tuple:
    """(median, every rep) of fn's wall time after warmup runs; each rep
    ends when the device is done."""
    for _ in range(warmup):
        fn()
    b.sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        b.sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def _metered_cells(fn) -> int:
    """dp_cells counted by the library's metrics during one run of fn
    (estimated single-core C time = in-band cells / C cell rate)."""
    metrics.reset()
    fn()
    c = metrics.snapshot()["counters"]
    return int(c.get("dp_cells", 0) + c.get("stream_cells_useful", 0))


def _checked(result: dict, check) -> dict:
    """result with the fields check() returns and "check": "ok", or with
    "check": "failed: ..." when it raises CheckFailed."""
    try:
        extra = check() or {}
    except CheckFailed as e:
        return {**result, "check": f"failed: {e}"}
    return {**result, **extra, "check": "ok"}


def _match_cigar(name_x: str, x: str, name_y: str, y: str):
    """One match run over the shorter sequence, the rest an indel
    (bench.py:235-242, :417-424)."""
    from cpecan_tpu_torch.io import cigar as cigar_io

    m = min(len(x), len(y))
    ops = [(cigar_io.MATCH, m)]
    if len(x) > m:
        ops.append((cigar_io.INDEL_X, len(x) - m))
    if len(y) > m:
        ops.append((cigar_io.INDEL_Y, len(y) - m))
    return cigar_io.PairwiseAlignment(
        name_x, 0, len(x), True, name_y, 0, len(y), True, 0.0, ops)


def _pair_diff(got, want, threshold: float) -> tuple:
    """(largest fixed-point prob difference over pairs on both sides, pairs
    on one side only, of which threshold flips) between two pair arrays.
    A pair on one side only counts as prob 0 on the other, unless it lies
    within THRESHOLD_FLIP of the threshold (a flip)."""
    a = {(int(x), int(y)): int(q)
         for q, x, y in zip(got["prob"], got["x"], got["y"])}
    w = {(int(x), int(y)): int(q)
         for q, x, y in zip(want["prob"], want["x"], want["y"])}
    worst, lone, flips = 0, 0, 0
    for key in a.keys() | w.keys():
        if key in a and key in w:
            worst = max(worst, abs(a[key] - w[key]))
            continue
        q = a.get(key, w.get(key))
        lone += 1
        if abs(q / PAIR_ALIGNMENT_PROB_1 - threshold) < THRESHOLD_FLIP:
            flips += 1
        else:
            worst = max(worst, q)
    return worst, lone, flips


# ----------------------------------------------------------- headline


def build_batch(rng, batch: int = BATCH, anchor_every: int = 50,
                seq_len: int = SEQ_LEN):
    """Banded ~1 kb pairs (x and y the same random sequence) with anchors
    every ``anchor_every`` bp on the identity diagonal and the default
    expansion: every 50 bp is the headline batch (bench.py:108-134), every
    base the dense-anchor companion (bench.py:174-198). W is the port's
    width bucket of the first band's frame."""
    sxs, offs, wids = [], [], []
    P = fb_batch.diagonal_bucket(2 * seq_len)  # 2048 at 1 kb
    W = None
    cells = 0
    half = anchor_every // 2
    for _ in range(batch):
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=seq_len))
        anchors = [(i, i) for i in range(half, seq_len - half, anchor_every)]
        band = construct_band(anchors, seq_len, seq_len, EXPANSION)
        if W is None:
            W = fb_batch.width_bucket(band.frame_width())
        o, w, _ = pad_band(band, P, W)
        cells += int(band.widths.sum())
        sx = np.zeros(P, np.int32)
        sx[:seq_len] = sym.encode(seq)
        sxs.append(sx)
        offs.append(o)
        wids.append(w)
    lens = np.full(batch, seq_len, np.int32)
    return (np.stack(sxs), np.stack(sxs), np.stack(offs), np.stack(wids),
            lens, lens.copy(), W, cells)


def _plain_pass(hmm, args, W: int) -> dict:
    """fb_pass_batch's posterior_match pass through the kernels' plain
    PyTorch versions, on the tensors' own device."""
    wf = fb_wavefront
    pre = wf.precompute(hmm, *args, width=W)
    t = hmm.t_prob_host
    F, bv, mf = wf.fwd_reference(t, pre["ex"], pre["ey"], pre["em"],
                                 pre["a"], pre["b1"], pre["b0"], pre["F0"],
                                 hmm.nz)
    mf[:, 0] += pre["m0log"]
    posts, mb, tot = wf.bwd_reference(
        t, pre["efx"], pre["efy"], pre["efm"], pre["em"], F, bv, pre["abw"],
        pre["c1"], pre["c0"], pre["bm1"], pre["bm0"], pre["pm"],
        pre["end_row"], hmm.nz, "posterior_match")
    return {"mf": mf, "mb": mb, "total_raw": tot, "post_match": posts[0]}


def _check_kernels(hmm, args, W: int) -> dict:
    """fb_pass_batch on the first CHECK_PAIRS pairs against _plain_pass on
    the same tensors, at TOLERANCES (total_raw on diagonals 1..L)."""
    args = [a[:CHECK_PAIRS] for a in args]
    got = fb_batch.fb_pass_batch(hmm, *args, mode="posterior_match", width=W)
    want = _plain_pass(hmm, args, W)
    L = (args[4].long() + args[5].long()).cpu()
    errs = {}
    for k, (rtol, atol) in TOLERANCES.items():
        g, w = got[k].float().cpu(), want[k].float().cpu()
        if k == "total_raw":
            rows = torch.arange(g.shape[1])[None, :]
            keep = (rows >= 1) & (rows <= L[:, None])
            g, w = g[keep], w[keep]
        if not torch.isfinite(g).all():
            raise CheckFailed(f"{k} is not finite")
        try:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
        except AssertionError as e:
            raise CheckFailed(f"{k} against the plain version: {e}") from None
        errs[k] = float((g - w).abs().max())
    return {"check_max_abs_err": errs}


def bench_headline(b: Bench, batch: int = BATCH,
                   seq_len: int = SEQ_LEN) -> dict:
    """DP cells/s/chip on the fused banded FB posterior pass (B=256, 1 kb
    anchored pairs), and the dense-anchor (cigar-band) regime of
    realign/EM beside it."""
    hmm = PairHMM.from_state_machine(state_machine5()).to(b.device)
    rl = np.zeros(batch, bool)

    def timed(rng, anchor_every):
        sx, sy, offsets, widths, lx, ly, W, cells = build_batch(
            rng, batch, anchor_every, seq_len)
        args = [torch.from_numpy(a).to(b.device)
                for a in (sx, sy, offsets, widths, lx, ly, rl, rl.copy())]
        dt, times = _time_reps(b, lambda: fb_batch.fb_pass_batch(
            hmm, *args, mode="posterior_match", width=W), reps=10)
        return args, W, cells / dt, times

    args, W, rate, times = timed(np.random.default_rng(0), 50)
    _, Wd, rate_d, times_d = timed(np.random.default_rng(1), 1)
    return _checked({
        "metric": "pairhmm_dp_cells_per_sec_per_chip",
        "value": round(rate),
        "unit": "cells/s",
        "vs_baseline": round(rate / b.baseline, 2),
        "dense_band_cells_per_sec": round(rate_d),
        "dense_band_vs_baseline": round(rate_d / b.baseline, 2),
        "dense_band_width": Wd,
        "rep_seconds": times,
        "dense_band_rep_seconds": times_d,
    }, lambda: _check_kernels(hmm, args, W))


# ------------------------------------- config 1: realign 1 kb latency


def _posterior_parity(b: Bench, x: str, y: str) -> float:
    """Max |posterior| gap between the device and the CPU's plain versions
    on one banded pair (fixed-point units of 1e7, returned as a
    probability); threshold flips are left out."""
    from cpecan_tpu_torch.align import pairwise

    sm = state_machine5()
    p = PairwiseAlignmentParameters()
    anchors = [(i, i) for i in range(25, min(len(x), len(y)) - 25, 50)]
    got, want = (pairwise.get_aligned_pairs_using_anchors(
        sm, x, y, anchors, p, device=dev) for dev in (b.device, "cpu"))
    return round(_pair_diff(got, want, p.threshold)[0] / PAIR_ALIGNMENT_PROB_1, 6)


def bench_realign_1kb(b: Bench) -> dict:
    """End-to-end latency of the realign CLI on one ~1 kb record
    (BASELINE config #1): parse, anchor from the input cigar, band,
    banded FB posteriors, reweight, poset-consistency filter, cigar out;
    and posterior parity between the device and the CPU on the pair."""
    from cpecan_tpu_torch.cli import realign as realign_cli
    from cpecan_tpu_torch.io import cigar as cigar_io

    rng = np.random.default_rng(1)
    x, y = _random_pair(rng, SEQ_LEN)
    text = cigar_io.cigar_format(_match_cigar("seqX", x, "seqY", y)) + "\n"

    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "seqs.fa")
        with open(fasta, "w") as fh:
            fh.write(f">seqX\n{x}\n>seqY\n{y}\n")

        def run():
            rc = realign_cli.main([fasta, "--device", str(b.device)],
                                  stdin=io.StringIO(text), stdout=io.StringIO())
            if rc != 0:
                raise RuntimeError(f"realign exited with {rc}")

        dt, times = _time_reps(b, run, reps=5, warmup=2)
        cells = _metered_cells(run)

    parity = _posterior_parity(b, x, y)

    def check():
        if not parity <= PARITY_MAX_ABS:
            raise CheckFailed(f"posterior parity {parity} > {PARITY_MAX_ABS}")

    return _checked({
        "metric": "realign_1kb_latency",
        "value": round(dt, 4),
        "unit": "s",
        "vs_baseline": round(cells / b.baseline / dt, 2),
        "posterior_parity_max_abs": parity,
        "rep_seconds": times,
    }, check)


# --------------------------------- config 2: 1024 x 1 kb full-band pairs


def bench_read_pairs_1kb(b: Bench, n_pairs: int = 1024,
                         seq_len: int = SEQ_LEN) -> dict:
    """Batched FB + posterior pair decoding of 1024 random ~1 kb evolved
    pairs, full band, one device (BASELINE config #2), through the
    end-to-end batch API; the first CHECK_PAIRS pairs' pair sets against
    the CPU's."""
    from cpecan_tpu_torch.align import batch as batch_mod
    from cpecan_tpu_torch.ops.band import full_band

    rng = np.random.default_rng(2)
    sm = state_machine5()
    p = PairwiseAlignmentParameters()
    jobs, cells = [], 0
    for _ in range(n_pairs):
        x, y = _random_pair(rng, seq_len)
        jobs.append((x, y, None, False, False))
        cells += int(full_band(len(x), len(y)).widths.sum())

    result = [None]

    def run():
        result[0] = batch_mod.batch_posteriors(
            sm, jobs, p, mode="posterior_match", device=b.device)

    dt, times = _time_reps(b, run, reps=3, warmup=1)

    def check():
        cpu = batch_mod.batch_posteriors(sm, jobs[:CHECK_PAIRS], p,
                                         mode="posterior_match", device="cpu")
        worst, lone, flips = 0, 0, 0
        for got, want in zip(result[0], cpu):
            w, n, f = _pair_diff(got, want, p.threshold)
            worst, lone, flips = max(worst, w), lone + n, flips + f
        if lone > flips:
            raise CheckFailed(f"{lone - flips} pairs on one side only, "
                              "card vs CPU")
        return {"check_threshold_flips": flips,
                "check_max_prob_diff": worst / PAIR_ALIGNMENT_PROB_1}

    return _checked({
        "metric": "read_pairs_1kb_per_sec",
        "value": round(n_pairs / dt, 2),
        "unit": "pairs/s",
        "vs_baseline": round(cells / dt / b.baseline, 2),
        "dp_cells_per_sec": round(cells / dt),
        "vs_baseline_cells": round(cells / dt / b.baseline, 2),
        "rep_seconds": times,
    }, check)


# ------------------------------------ config 3: anchored 10-50 kb pairs


def _planted_pair(n: int, genomic: bool):
    """(x, y, truth): a planted-truth evolved pair (bench.py:353-361)."""
    pyrng = random.Random(3)
    if genomic:
        x = sym.genomic_like_sequence(n, pyrng)
        y, truth = sym.tracked_evolve(x, pyrng, sub_rate=0.08)
    else:
        x = "".join(pyrng.choice("ACGT") for _ in range(n))
        y, truth = sym.tracked_evolve(x, pyrng)
    return x, y, truth


def bench_anchored_50kb(b: Bench, n: int = 50_000, reps: int = 3,
                        genomic: bool = False) -> dict:
    """Anchored banded alignment of one 50 kb pair end to end (BASELINE
    config #3): native k-mer seeding/chaining, recursion, large-gap
    splitting, bucketed device batches (long chunks streamed), pair
    extraction; sensitivity/specificity against the planted truth."""
    from cpecan_tpu_torch.align import pairwise
    from cpecan_tpu_torch.msa.aligner import (
        filter_pairwise_alignment_to_make_pairs_ordered)
    from cpecan_tpu_torch.ops import pairs as pairs_mod

    x, y, truth = _planted_pair(n, genomic)
    sm = state_machine5()
    p = PairwiseAlignmentParameters()
    cells = [0]
    result = [None]

    def run():
        metrics.reset()
        pairs = pairwise.get_aligned_pairs(sm, x, y, p, device=b.device)
        c = metrics.snapshot()["counters"]
        cells[0] = c.get("dp_cells", 0) + c.get("stream_cells_useful", 0)
        result[0] = pairs
        if len(pairs) == 0:
            raise RuntimeError("get_aligned_pairs returned no pairs")

    dt, times = _time_reps(b, run, reps=reps, warmup=1)
    snap = metrics.snapshot()["stages"]
    host_s = (snap.get("host_anchoring", {}).get("seconds", 0.0)
              + snap.get("host_prep", {}).get("seconds", 0.0))

    ordered = filter_pairwise_alignment_to_make_pairs_ordered(
        pairs_mod.sort_pairs(result[0]), x, y, 0.9)
    truth_set = set(truth)
    pred = {(int(px), int(py)) for px, py in zip(ordered["x"], ordered["y"])}
    tp = len(pred & truth_set)
    return {
        "metric": "anchored_50kb_e2e",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(cells[0] / dt / b.baseline, 2),
        "dp_cells_per_sec": round(cells[0] / dt),
        "vs_baseline_cells": round(cells[0] / dt / b.baseline, 2),
        "host_prep_seconds": round(host_s, 3),
        "host_prep_fraction": round(host_s / max(dt, 1e-9), 4),
        "sensitivity": round(tp / max(len(truth_set), 1), 4),
        "specificity": round(tp / max(len(pred), 1), 4),
        "rep_seconds": times,
        "check": "ok",
    }


# ------------------------------------------- config 4: EM iterations/s


def em_corpus(n_pairs: int, seq_len: int = SEQ_LEN):
    """(sequences, cigars): n_pairs evolved 1 kb pairs, each with one
    match-run cigar (bench.py:410-425)."""
    rng = np.random.default_rng(4)
    sequences, cigars = {}, []
    for i in range(n_pairs):
        x, y = _random_pair(rng, seq_len)
        sequences[f"x{i}"] = x
        sequences[f"y{i}"] = y
        cigars.append(_match_cigar(f"x{i}", x, f"y{i}", y))
    return sequences, cigars


def bench_em(b: Bench, n_pairs: int = 64, seq_len: int = SEQ_LEN) -> dict:
    """Baum-Welch EM iterations/s over a 64 x 1 kb corpus (BASELINE
    config #4): bucketed expectation batches on the device + host M-step,
    the cPecanEm iteration loop; the model moves on every rep, as in
    bench.py. One expectation step's counts on the first EM_CHECK_PAIRS
    pairs against the CPU's."""
    from cpecan_tpu_torch.em import em as em_mod
    from cpecan_tpu_torch.models.hmm import Hmm
    from cpecan_tpu_torch.models.state_machine import state_machine_from_hmm

    sequences, cigars = em_corpus(n_pairs, seq_len)
    options = em_mod.EmOptions(iterations=1, trials=1)
    p = options.pairwise_params()
    tasks = em_mod.tasks_from_cigars(cigars, sequences, p)
    model = em_mod.make_initial_model(options, random.Random(0))

    def expectations(model, tasks, device):
        ex = Hmm(model.type, pseudo_expectation=1e-12)
        em_mod.expectation_step(state_machine_from_hmm(model), tasks, p, ex,
                                device=device)
        return ex

    state = [model]

    def run():
        state[0] = em_mod.maximisation_step(
            expectations(state[0], tasks, b.device), state[0], options)

    dt, times = _time_reps(b, run, reps=3, warmup=1)
    cells = _metered_cells(run)

    def check():
        some = em_mod.tasks_from_cigars(cigars[:EM_CHECK_PAIRS], sequences, p)
        got, want = (expectations(model, some, dev)
                     for dev in (b.device, "cpu"))
        rel = {}
        for k in ("transitions", "emissions"):
            g, w = getattr(got, k), getattr(want, k)
            try:
                np.testing.assert_allclose(g, w, rtol=EM_COUNT_RTOL)
            except AssertionError as e:
                raise CheckFailed(f"expected {k} card vs CPU: {e}") from None
            rel[k] = float(np.max(np.abs(g - w) / np.abs(w)))
        return {"check_max_rel_err": rel}

    return _checked({
        "metric": "em_iterations_per_sec_64x1kb",
        "value": round(1.0 / dt, 3),
        "unit": "iters/s",
        "vs_baseline": round(cells / b.baseline / dt, 2),
        "dp_cells_per_iteration": cells,
        "rep_seconds": times,
    }, check)


# -------------------------------- config 4b: EM data-parallel scaling


def em_scaling_point(n_shards: int, n_pairs: int, seq_len: int,
                     device: str) -> dict:
    """One point of em_scaling (run in a process of its own, as bench.py's
    _EM_SCALING_RUN): EM iterations on the corpus of bench.py:474-486,
    the expectation step sharded over a DataMesh of n_shards copies of
    ``device`` (none for 1); one warm-up iteration, then 3 timed."""
    from cpecan_tpu_torch.em import em as em_mod
    from cpecan_tpu_torch.models.hmm import Hmm
    from cpecan_tpu_torch.models.state_machine import state_machine_from_hmm
    from cpecan_tpu_torch.parallel.mesh import DataMesh

    b = Bench(torch.device(device), 0.0)
    rng = random.Random(4)
    sequences, cigars = {}, []
    for i in range(n_pairs):
        x = sym.get_random_sequence(seq_len, rng).upper()
        y = sym.evolve_sequence(x, rng).upper()
        sequences[f"x{i}"] = x
        sequences[f"y{i}"] = y
        cigars.append(_match_cigar(f"x{i}", x, f"y{i}", y))
    options = em_mod.EmOptions(iterations=1, trials=1)
    p = options.pairwise_params()
    tasks = em_mod.tasks_from_cigars(cigars, sequences, p)
    mesh = DataMesh([b.device] * n_shards) if n_shards > 1 else None
    state = [em_mod.make_initial_model(options, random.Random(0))]

    def run():
        model = state[0]
        ex = Hmm(model.type, pseudo_expectation=1e-12)
        em_mod.expectation_step(state_machine_from_hmm(model), tasks, p, ex,
                                mesh=mesh, device=b.device)
        state[0] = em_mod.maximisation_step(ex, model, options)

    dt, times = _time_reps(b, run, reps=3, warmup=1)
    return {"iters_per_sec": 1.0 / dt, "rep_seconds": times}


def bench_em_scaling(b: Bench, n_pairs: int = 64, seq_len: int = 1000) -> dict:
    """Data-parallel EM dispatch overhead (BASELINE config #4 scaling
    axis): the sharded expectation step over 8 shards of the one device
    against none, each in a process of its own. All shards share one
    device, so the ratio is the sharding overhead (0 would mean free
    sharding), not hardware scaling."""
    points = {}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [q for q in [env.get("PYTHONPATH")] if q])
    for n in (1, 8):
        code = ("import json\nfrom cpecan_tpu_torch import bench\n"
                "print('EMSCALE ' + json.dumps(bench.em_scaling_point("
                f"{n}, {n_pairs}, {seq_len}, {str(b.device)!r})))\n")
        res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=1200, env=env, cwd=ROOT)
        if res.returncode != 0:
            points[str(n)] = {"error": res.stderr[-500:]}
            continue
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("EMSCALE ")]
        points[str(n)] = json.loads(line[-1][len("EMSCALE "):])
    overhead = None
    if all("iters_per_sec" in points[k] for k in ("1", "8")):
        t1 = 1.0 / points["1"]["iters_per_sec"]
        t8 = 1.0 / points["8"]["iters_per_sec"]
        overhead = round(t8 / t1 - 1.0, 3)
    name = (torch.cuda.get_device_name(b.device) if b.device.type == "cuda"
            else "the CPU")
    result = {
        "metric": "em_scaling_virtual8_sharding_overhead",
        "value": overhead,
        "unit": "extra_time_fraction_per_iter",
        "vs_baseline": None,
        "points": points,
        "note": (f"8 shards of one device ({name}), a DataMesh, against no "
                 "mesh: measures the sharded expectation step's dispatch "
                 "and count-reduction overhead, not hardware scaling"),
    }
    if overhead is None:
        raise RuntimeError(f"em_scaling: a point failed: {points}")
    return {**result, "check": "ok"}


# ------------------------------------------------- config 5: MSA


def msa_frags(n_seqs: int, seq_len: int):
    """One random root and n_seqs evolved copies, each with its own end ids
    (bench.py:570-575)."""
    from cpecan_tpu_torch.msa import aligner

    pyrng = random.Random(5)
    root = sym.get_random_sequence(seq_len, pyrng).upper()
    return [aligner.SeqFrag(sym.evolve_sequence(root, pyrng).upper(), i, i + 1)
            for i in range(n_seqs)]


def _make_alignment(frags, device):
    from cpecan_tpu_torch.msa import aligner

    ma = aligner.make_alignment(state_machine5(), frags, spanning_trees=2,
                                max_pairs_to_consider=10_000_000,
                                use_progressive_merging=True, match_gamma=0.0,
                                p=PairwiseAlignmentParameters(), seed=0,
                                device=device)
    if not ma.column_list():
        raise RuntimeError("make_alignment returned no columns")
    return ma


def _check_msa(frags, device) -> dict:
    """make_alignment on the device and on the CPU: equal columns, but for
    near-ties (columns the merge built from weights within the posteriors'
    noise), where the kept pairs' summed posteriors must agree within
    1e-5 relative (chip_smoke.py phase 13's rule)."""
    card, cpu = _make_alignment(frags, device), _make_alignment(frags, "cpu")
    a, w = card.column_list(), cpu.column_list()
    near_ties = len(a) - len(set(map(tuple, a)) & set(map(tuple, w)))
    if near_ties:
        sa = int(card.aligned_pairs["prob"].sum())
        sw = int(cpu.aligned_pairs["prob"].sum())
        if abs(sa - sw) > 1e-5 * max(sw, 1):
            raise CheckFailed(f"{near_ties} columns differ card vs CPU and "
                              f"the kept posteriors too ({sa} vs {sw})")
    return {"check_columns": len(w), "check_near_ties": near_ties}


def bench_msa(b: Bench, n_seqs: int = 20, seq_len: int = 500, reps: int = 3,
              check: bool = True) -> dict:
    """Progressive multiple alignment of evolved sequences (BASELINE
    config #5): spanning-tree pair selection, batched pairwise posteriors
    on the device, host column merging; the host-merge vs device-posterior
    split from the metrics stages. With ``check``, the first
    MSA_CHECK_FRAGS fragments' columns against the CPU's."""
    frags = msa_frags(n_seqs, seq_len)
    dt, times = _time_reps(b, lambda: _make_alignment(frags, b.device),
                           reps=reps, warmup=1)
    cells = _metered_cells(lambda: _make_alignment(frags, b.device))
    snap = metrics.snapshot()["stages"]
    fb_s = snap.get("fb_pass", {}).get("seconds", 0.0)
    merge_s = snap.get("msa_merge", {}).get("seconds", 0.0)
    return _checked({
        "metric": f"msa_{n_seqs}x{seq_len}_e2e",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(cells / b.baseline / dt, 2),
        "pair_posterior_cells_per_sec": round(cells / dt),
        "device_posterior_seconds": round(fb_s, 3),
        "host_merge_seconds": round(merge_s, 3),
        "rep_seconds": times,
    }, lambda: _check_msa(frags[:MSA_CHECK_FRAGS], b.device) if check else None)


def bench_msa_100x1kb(b: Bench, n_seqs: int = 100, seq_len: int = 1000) -> dict:
    """BASELINE config #5 at its stated scale: progressive multiple
    alignment of 100 x 1 kb sequences end to end (reference comparator:
    makeAlignment, impl/multipleAligner.c:887-939)."""
    return bench_msa(b, n_seqs=n_seqs, seq_len=seq_len, reps=1, check=False)


# --------------------------- reference-scale long pair (ENCODE analog)


def bench_long_500kb(b: Bench, n: int = 500_000) -> dict:
    """Reference-scale integration run: one ~0.5 Mb genomic-like evolved
    pair through the full anchored pipeline (the regime of the reference's
    long test, tests/pairwiseAlignerLongTest.c:40-121)."""
    return {**bench_anchored_50kb(b, n=n, reps=1, genomic=True),
            "metric": "long_500kb_e2e"}


CONFIGS = {
    "headline": bench_headline,
    "realign_1kb": bench_realign_1kb,
    "read_pairs_1kb": bench_read_pairs_1kb,
    "anchored_50kb": bench_anchored_50kb,
    "long_500kb": bench_long_500kb,
    "em": bench_em,
    "em_scaling": bench_em_scaling,
    "msa": bench_msa,
    "msa_100x1kb": bench_msa_100x1kb,
}

# --smoke sizes: bench.py:749-763's, cut further where the kernels'
# plain versions on the CPU took over 20 s (a sequence of 1 kb costs
# them ~1.2 ms per diagonal for a forward and a backward pass)
SMOKE_KWARGS = {
    "headline": {"batch": 8, "seq_len": 100},
    "read_pairs_1kb": {"n_pairs": 8, "seq_len": 200},
    "anchored_50kb": {"n": 400},
    "long_500kb": {"n": 500},
    "em": {"n_pairs": 4, "seq_len": 100},
    "em_scaling": {"n_pairs": 4, "seq_len": 30},
    "msa": {"n_seqs": 6, "seq_len": 100},
    "msa_100x1kb": {"n_seqs": 8, "seq_len": 120},
}


# ---------------------------------------------------------------- main


def resolve_device(name: str) -> torch.device:
    """The device of ``--device``; cuda without a card raises."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is available "
                               "(the bench does not fall back to the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return device


def device_report(device: torch.device) -> dict:
    """backend (the card's name, or cpu), its power limit as nvidia-smi
    prints it, and the device count."""
    if device.type == "cpu":
        return {"backend": "cpu", "power_limit": None, "device_count": 1}
    limits = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return {"backend": torch.cuda.get_device_name(device),
            "power_limit": limits[device.index].strip(),
            "device_count": torch.cuda.device_count()}


def run_config(b: Bench, name: str, kwargs: dict) -> dict:
    """One config's result; an error is recorded with its traceback (the
    run goes on to the next config and exits non-zero)."""
    try:
        return {"name": name, **CONFIGS[name](b, **kwargs)}
    except Exception:
        return {"name": name, "check": "error",
                "error": traceback.format_exc()[-4000:]}


COMMIT_ENV = "CPECAN_BENCH_COMMIT"
UNKNOWN_COMMIT = "unknown"
# why an --all run on the card writes nothing when its commit is unknown
NO_COMMIT = ("the commit is unknown: a checkout from git archive has no "
             "repository, so its caller names the commit with --commit REV "
             f"or ${COMMIT_ENV}")


def _git(*args) -> str:
    """git's stdout in ROOT, stripped; "" when git is missing or fails."""
    try:
        res = subprocess.run(["git", *args], capture_output=True, text=True,
                             cwd=ROOT, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return res.stdout.strip() if res.returncode == 0 else ""


def resolve_commit(flag: str | None = None) -> tuple:
    """(commit, source) of the code this run measures: ROOT's git HEAD,
    with "+dirty" when a tracked file differs from it ("git"); else
    ``--commit``'s value ("flag"); else $CPECAN_BENCH_COMMIT ("env"); else
    ("unknown", "none"). ROOT counts as a repository only when it is the
    top of one, so a package that lies inside another project's
    repository does not report that project's commit."""
    top_head = _git("rev-parse", "--show-toplevel", "HEAD").splitlines()
    if (len(top_head) == 2
            and Path(top_head[0]).resolve() == Path(ROOT).resolve()):
        dirty = _git("status", "--porcelain", "--untracked-files=no")
        return top_head[1] + ("+dirty" if dirty else ""), "git"
    if flag:
        return flag, "flag"
    if os.environ.get(COMMIT_ENV):
        return os.environ[COMMIT_ENV], "env"
    return UNKNOWN_COMMIT, "none"


def _stamp_refusal(line_stamp, run_stamp: dict) -> str | None:
    """Why a resume line with ``line_stamp`` may not stand for a config
    this run stamps ``run_stamp`` ("field: ..."), or None."""
    commit = run_stamp["commit"]
    if commit == UNKNOWN_COMMIT or commit.endswith("+dirty"):
        return (f"commit: this run's commit is {commit!r}, which vouches "
                "for no earlier line")
    if not isinstance(line_stamp, dict):
        return "stamp: the line has none"
    fields = [k for k in run_stamp if line_stamp.get(k) != run_stamp[k]]
    fields += [k for k in line_stamp if k not in run_stamp]
    if not fields:
        return None
    return "; ".join(f"{k}: the line's {line_stamp.get(k)!r}, this run's "
                     f"{run_stamp.get(k)!r}" for k in fields)


def _read_resume_log(path: str, stamps: dict) -> dict:
    """{config: its JSON line} from an earlier run's log, for the configs
    of ``stamps`` ({config: the stamp this run gives it}) whose line is
    stamped the same. A refused line gets one line on stderr with the
    config and the stamp field that differs; its config is run again."""
    resumed, refused = {}, {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not (line.startswith("{") and '"name"' in line):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            name = rec.get("name")
            if name not in stamps or "metric" not in rec:
                continue
            why = _stamp_refusal(rec.get("stamp"), stamps[name])
            if why is None:
                resumed[name] = rec
            else:
                refused[name] = why
    for name, why in refused.items():
        if name not in resumed:
            print(f"--resume-log: {name} is run again: {why}", file=sys.stderr,
                  flush=True)
    return resumed


def report_refusal(configs: list, *, smoke: bool, one_config: bool,
                   device: torch.device, commit: str) -> str | None:
    """Why an --all report must not be written to REPORT, or None. It is
    written only for a full run (no --smoke, no --config) on the card
    whose every check passed and whose commit is known."""
    failed = [c["name"] for c in configs if c.get("check") != "ok"]
    if failed:
        return f"the check of {', '.join(failed)} did not pass"
    if smoke:
        return "--smoke sizes mean nothing"
    if one_config:
        return "--config runs one config"
    if device.type != "cuda":
        return f"the run was on the {device.type}, not the card"
    if commit == UNKNOWN_COMMIT:
        return NO_COMMIT
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cpecan_tpu_torch.bench",
        description="bench.py's configs on the PyTorch port")
    ap.add_argument("--all", action="store_true",
                    help="run every config; one JSON report, also written "
                         f"to {REPORT.name} by a full run on the card")
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    help="run a single named config")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny problem sizes (a fast check of the harness "
                         "itself; numbers are meaningless, nothing is "
                         "written)")
    ap.add_argument("--resume-log", metavar="PATH",
                    help="reuse per-config JSON progress lines from an "
                         "earlier run's log whose stamp (commit, smoke, "
                         "device, size overrides) equals this run's: those "
                         "configs are not run again")
    ap.add_argument("--commit", metavar="REV",
                    help="the commit of this checkout, for a checkout with "
                         "no git repository (one from git archive); the "
                         "repository's HEAD wins when there is one, "
                         f"${COMMIT_ENV} is read when neither is there")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "PyTorch versions; the report is never written)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    baseline, rates = measure_c_baseline()
    b = Bench(device, baseline)
    smoke = SMOKE_KWARGS if args.smoke else {}

    if not (args.all or args.config):
        result = run_config(b, "headline", smoke.get("headline", {}))
        result.pop("name")
        print(json.dumps(result))
        return 0 if result["check"] == "ok" else 1

    commit, commit_source = resolve_commit(args.commit)
    where = device_report(device)
    names = [args.config] if args.config else list(CONFIGS)
    stamps = {name: {"commit": commit, "smoke": args.smoke,
                     "device": where["backend"], "kwargs": smoke.get(name, {})}
              for name in names}
    resumed = (_read_resume_log(args.resume_log, stamps) if args.resume_log
               else {})
    configs = []
    for name in names:
        if name in resumed:
            result = {**resumed[name], "resumed": True}
        else:
            result = {**run_config(b, name, stamps[name]["kwargs"]),
                      "stamp": stamps[name]}
        configs.append(result)
        print(json.dumps(result), file=sys.stderr, flush=True)  # progress

    report = {
        **where,
        "c_baseline_cells_per_sec": baseline,
        "c_baseline_runs": rates,
        "date": time.strftime("%Y-%m-%d"),
        "commit": commit,
        "commit_source": commit_source,
        "configs": configs,
    }
    print(json.dumps(report))
    refusal = report_refusal(configs, smoke=args.smoke,
                             one_config=bool(args.config), device=device,
                             commit=commit)
    if refusal is None:
        with open(REPORT, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    elif args.all:
        print(f"{REPORT.name} not written: {refusal}", file=sys.stderr)
    ok = all(c.get("check") == "ok" for c in configs)
    return 0 if ok and refusal != NO_COMMIT else 1


if __name__ == "__main__":
    sys.exit(main())
