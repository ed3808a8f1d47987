"""Device-side sparse compaction of thresholded posterior blocks.

Counterpart of cpecan_tpu/ops/compact.py with the same contract. The JAX
package ranks hits per row in a first stage of a few slots because
``jnp.nonzero`` lowers to a sort on a TPU, and escalates to its exact
path when a row overflows; here ``torch.nonzero`` is exact, so
compact_rows needs no escalation and reports row_max only to keep the
contract.
"""

from __future__ import annotations

import torch


def compact_rows_exact(win, thr, cap: int):
    """Compact entries >= thr of a (R, W) block into a flat entry list.

    Returns (idx, vals, count): idx (cap,) int64, row * W + j of each
    entry in row-major order, -1 padded; vals (cap,) matching values;
    count, the number of >= thr entries (0-d tensor; entries past cap
    are dropped)."""
    flat = win.reshape(-1)
    hit = flat >= thr
    pos = torch.nonzero(hit).reshape(-1)[:cap]
    idx = torch.full((cap,), -1, dtype=torch.int64, device=win.device)
    vals = torch.zeros(cap, dtype=win.dtype, device=win.device)
    idx[:pos.numel()] = pos
    vals[:pos.numel()] = flat[pos]
    return idx, vals, hit.sum()


def compact_rows(win, thr, cap: int):
    """compact_rows_exact plus row_max, the largest per-row hit count."""
    idx, vals, count = compact_rows_exact(win, thr, cap)
    return idx, vals, count, (win >= thr).sum(dim=-1).max()
