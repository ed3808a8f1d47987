"""Batched forward-backward with engine dispatch by device.

Counterpart of cpecan_tpu/ops/fb_batch.py (without the mesh and
shard_map, which belong to the data-parallel slice). The tensors' device
picks the engine, and nothing else does:

 * ``"cuda"``: the hand-written wavefront kernels (CUDA tensors);
 * ``"torch"``: the kernels' plain PyTorch versions (CPU tensors).

The engine of the most recent call is recorded in LAST_ENGINE.
"""

from __future__ import annotations

from cpecan_tpu_torch.ops import fb_wavefront

# Most recent engine choice, for tests and telemetry.
LAST_ENGINE: str | None = None


def fb_pass_batch(hmm, sx, sy, offsets, widths, lx, ly, ragged_left,
                  ragged_right, mode: str = "posterior_match",
                  width: int = 0) -> dict:
    """Batch-of-pairs FB pass; every tensor carries a leading batch axis
    and lives on the PairHMM's device. Returns the keys of
    ``fb_wavefront.fb_pass_batch_wavefront``."""
    global LAST_ENGINE
    dev = offsets.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"no engine for device type {dev!r}")
    LAST_ENGINE = "cuda" if dev == "cuda" else "torch"
    return fb_wavefront.fb_pass_batch_wavefront(
        hmm, sx, sy, offsets, widths, lx, ly, ragged_left, ragged_right,
        mode=mode, width=width)
