"""Streaming banded forward-backward for long single pairs.

Counterpart of cpecan_tpu/ops/fb_streaming.py: which chunks stream, the
window and frame helpers, and ``fb_pass_streaming``, the entry point
that picks an engine and keeps the JAX package's return contract. The
two engines:

  * exact (ops/fb_segmented.py): the checkpoint/recompute scheme (the
    reference's traceback windowing, impl/pairwiseAligner.c:756-877,
    with the true backward state carried across windows), every window
    a launch of the wavefront kernels with carry-in and carry-out; on
    CPU tensors their plain versions. It serves every mode and gives
    the two-pass engine's numbers.
  * parallel (ops/fb_parallel.py): burn-in windows side by side as the
    pairs of one batched launch; posterior modes only, approximate the
    way the reference's traceback seeding is.

Engine choice mirrors the JAX package's auto route: on CUDA tensors the
parallel engine for posterior modes and the exact engine otherwise; on
CPU tensors the exact engine (the JAX package's CPU choice is its scan
engine, which gives the same numbers as its exact engine by design). The
JAX package's scan engine itself is not ported. The JAX package's two
overrides are read here too: CPECAN_TPU_STREAM_BUDGET (bytes, see
``stream_budget_bytes``) and CPECAN_TPU_STREAM_ENGINE (see
``fb_pass_streaming``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cpecan_tpu_torch.ops.fb import _SENTINEL

# Chunks whose two-pass resident tensors (F + B + the emission/mask
# streams, ~3 copies of (P+1, S, W) fp32) would exceed this many bytes
# stream (cpecan_tpu/ops/fb_streaming.py at its default budget), unless
# CPECAN_TPU_STREAM_BUDGET says otherwise.
_STREAM_BUDGET = 1 << 30

ENGINES = ("exact", "parallel")
# CPECAN_TPU_STREAM_ENGINE's values (the JAX package's engine names)
ENV_ENGINES = ("auto", "parallel", "wavefront", "scan")

# Engine of the most recent fb_pass_streaming call.
LAST_ENGINE: str | None = None


def stream_budget_bytes() -> int:
    """CPECAN_TPU_STREAM_BUDGET, or the module's _STREAM_BUDGET (read at
    call time)."""
    return int(os.environ.get("CPECAN_TPU_STREAM_BUDGET", _STREAM_BUDGET))


def should_stream(diagonal_number: int, width: int,
                  state_number: int = 5) -> bool:
    resident = 3 * (diagonal_number + 1) * state_number * max(width, 128) * 4
    return resident > stream_budget_bytes()


def _env_engine(mode: str, on_card: bool) -> str:
    """The engine CPECAN_TPU_STREAM_ENGINE picks (cpecan_tpu/ops/
    fb_streaming.py:248-270): "auto" (the default) by device, as the
    module docstring says; "parallel" the burn-in engine where it serves
    ``mode``, else the exact engine, as the JAX package falls through;
    "wavefront" the exact engine; "scan" the exact engine too (the JAX
    package's scan engine is not ported, and computes the same
    recurrence). Any other value raises ValueError."""
    from cpecan_tpu_torch.ops import fb_parallel

    name = os.environ.get("CPECAN_TPU_STREAM_ENGINE", "auto")
    if name not in ENV_ENGINES:
        raise ValueError(f"CPECAN_TPU_STREAM_ENGINE must be one of "
                         f"{ENV_ENGINES}, got {name!r}")
    if name == "parallel" or (name == "auto" and on_card):
        return "parallel" if fb_parallel.supported(mode) else "exact"
    return "exact"


def window_rows(p) -> int:
    """Window/checkpoint stride from the config (a multiple of 8)."""
    k = max(int(p.minDiagsBetweenTraceBack), int(p.traceBackDiagonals) + 2, 64)
    return -(-k // 8) * 8


def _host_frame(offsets: np.ndarray, widths: np.ndarray):
    """x-frame arrays (numpy) from unpadded band tensors."""
    ks = np.arange(len(offsets), dtype=np.int64)
    xlo = (ks + offsets.astype(np.int64)) // 2
    xhi = xlo + widths - 1
    xoff = np.maximum.accumulate(xlo)
    delta = np.diff(xoff, prepend=xoff[:1])
    jlo = xlo - xoff
    jhi = xhi - xoff
    return (xoff.astype(np.int32), delta.astype(np.int32),
            jlo.astype(np.int32), jhi.astype(np.int32))


def _pad_frame(xoff, delta, jlo, jhi, rows_total):
    """Pad frame arrays to rows_total (+2 slack for d_{k+1}/d_{k+2} reads).
    Padding rows carry an empty band (jhi < jlo), so windows through them
    add nothing."""
    n = rows_total + 2
    pad = n - len(xoff)
    xoff = np.concatenate([xoff, np.full(pad, xoff[-1], np.int32)])
    delta = np.concatenate([delta, np.zeros(pad, np.int32)])
    jlo = np.concatenate([jlo, np.zeros(pad, np.int32)])
    jhi = np.concatenate([jhi, np.full(pad, -1, np.int32)])
    return xoff, delta, jlo, jhi


def _device_pair(seq_x_codes, seq_y_codes, frame, pad_off: int, device):
    """One long pair on the device for ``precompute_window``: sentinel-
    padded symbols (1, pad_off + n + pad_off) int8 (y reversed) and the
    padded x-frame as 1-D int64 tensors."""
    pad = np.full(pad_off, _SENTINEL, np.int8)
    sx = np.concatenate([pad, np.asarray(seq_x_codes, np.int8), pad])
    sy = np.concatenate([pad, np.asarray(seq_y_codes, np.int8)[::-1], pad])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (to(sx)[None], to(sy)[None],
            {k: to(v.astype(np.int64))
             for k, v in zip(("xoff", "delta", "jlo", "jhi"), frame)})


def fb_pass_streaming(hmm, seq_x_codes, seq_y_codes, offsets: np.ndarray,
                      widths: np.ndarray, lx: int, ly: int,
                      ragged_left: bool, ragged_right: bool, mode: str,
                      width: int, window: int, burnin: int,
                      threshold: float = 0.0, engine: str | None = None):
    """Streaming banded FB for ONE long pair on the PairHMM's device.

    seq_*_codes: int symbol arrays of the true lengths (no padding).
    offsets/widths: UNPADDED band arrays (length lx+ly+1).
    window: diagonals per checkpoint window (``window_rows(p)``).
    burnin: the parallel engine's halo rows (``fb_parallel.burnin_rows(p)``).
    engine: "exact", "parallel" or None (CPECAN_TPU_STREAM_ENGINE, see
      ``_env_engine``).

    Returns a dict:
      "windows": the number of windows; "xoff": the padded frame offsets
        for (k, j) -> (x, y);
      exact engine: "log_fwd", the raw end-dot log at L (add sum(mf) for
        the log-likelihood); "mf", "mb", "total_raw": (L+1,) float64 rows
        (mb[0] and total_raw[0] are 0 / -inf placeholders: consumers read
        rows 1..L);
      posterior modes: "post_entries": {key: (vals, ks, js)} numpy arrays
        of the in-band posteriors >= max(threshold, 1e-9);
      expectation: "trans" (S, S), "emis" (S, 4, 4) float64 counts.
    """
    from cpecan_tpu_torch.ops import fb_parallel, fb_segmented

    global LAST_ENGINE
    if engine is None:
        engine = _env_engine(mode, hmm.t.device.type == "cuda")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    LAST_ENGINE = engine
    if engine == "parallel":
        return fb_parallel.fb_pass_parallel(
            hmm, seq_x_codes, seq_y_codes, offsets, widths, lx, ly,
            ragged_left, ragged_right, mode, width, burnin=burnin,
            threshold=threshold)
    return fb_segmented.fb_pass_segmented(
        hmm, seq_x_codes, seq_y_codes, offsets, widths, lx, ly,
        ragged_left, ragged_right, mode, width, window, threshold=threshold)
