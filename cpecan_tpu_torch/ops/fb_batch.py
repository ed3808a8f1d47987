"""Batched forward-backward with engine dispatch by device.

Counterpart of cpecan_tpu/ops/fb_batch.py. The tensors' device picks the
engine, and nothing else does:

 * ``"cuda"``: the hand-written wavefront kernels (CUDA tensors);
 * ``"torch"``: the kernels' plain PyTorch versions (CPU tensors).

Data parallelism: pass ``mesh`` (a ``parallel.mesh.DataMesh``) and the
batch runs in ``mesh.size`` contiguous shards, one per mesh device (the
``P("data")`` split of the JAX package's shard_map). Each shard's inputs
go straight to its device, the PairHMM is replicated once per distinct
device, every shard's launches are enqueued before any result is read,
and the per-pair outputs come back concatenated in shard order on the
mesh's first device; in expectation mode the (S, S) / (S, 4, 4) counts
are summed over the shards (the psum of ``_sharded_call``). The engine
is then ``"cuda_sharded"`` or ``"torch_sharded"``.

The engine of the most recent call is recorded in LAST_ENGINE.

Launch shapes are decided here, and nowhere else: every launch pads its
pairs' diagonals to ``diagonal_bucket``, its band width to
``width_bucket`` and its batch to ``batch_size``, so that few distinct
shapes reach the kernels.

Debug invariants: with ``CPECAN_TPU_DEBUG=1`` every call checks its
outputs as cpecan_tpu/ops/fb.py's checkify mode does (the reference's
total-probability asserts, impl/pairwiseAligner.c:830-838) and raises
``RuntimeError("fb debug: ...")``; unset, nothing runs and nothing
syncs.
"""

from __future__ import annotations

import copy
import os

import torch

from cpecan_tpu_torch.ops import fb_wavefront
from cpecan_tpu_torch.parallel.mesh import pad_to_multiple

# Most recent engine choice, for tests and telemetry.
LAST_ENGINE: str | None = None

# Band-width buckets: warp multiples up to 128, then multiples of 128.
# Padding slots are masked out of every stream, so the bucket changes
# which pairs share a launch and nothing in the results.
WIDTH_LADDER = (32, 64, 128)


def _next_power_of_two(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def diagonal_bucket(n: int) -> int:
    """A launch's padded diagonal count: the next power of two, at least 8."""
    return _next_power_of_two(n, 8)


def width_bucket(w: int) -> int:
    """A launch's padded band width: the first rung of WIDTH_LADDER that
    holds ``w``, else the next multiple of 128."""
    for b in WIDTH_LADDER:
        if w <= b:
            return b
    return ((w + 127) // 128) * 128


def batch_size(n: int, n_dev: int = 1) -> int:
    """A launch's padded batch: the next power of two, then the next
    multiple of the mesh's device count ``n_dev``."""
    return pad_to_multiple(_next_power_of_two(n, 1), n_dev)


def debug_checks_enabled() -> bool:
    """CPECAN_TPU_DEBUG=1 turns on the output invariants."""
    return os.environ.get("CPECAN_TPU_DEBUG", "0") != "0"


def check_invariants(out: dict, lx, ly) -> None:
    """The four device-side invariants of cpecan_tpu/ops/fb.py:522-566 on a
    batch's outputs, per pair over its diagonals k in 1..L (L = lx + ly):
    the per-diagonal total in the global frame (total_raw + cumsum(mf) +
    reverse-cumsum(mb)) is finite and within 1 nat of the pair's
    maximum, mf + mb is finite, and no match posterior exceeds 1 + 1e-3.
    One host sync for all four; raises RuntimeError("fb debug: ...")."""
    if "mb" not in out:  # forward mode has no backward totals
        return
    mf = out["mf"].double()
    mb = out["mb"].double()
    dev = mf.device
    R = mf.shape[1]
    L = (lx.long() + ly.long()).to(dev)[:, None]
    ks = torch.arange(R, device=dev)[None, :]
    mask = (ks >= 1) & (ks <= L)
    cf = torch.cumsum(mf, dim=1)
    cb = torch.flip(torch.cumsum(torch.flip(
        torch.where(ks <= L, mb, 0.0), dims=[1]), dim=1), dims=[1])
    g = out["total_raw"].double() + cf + cb
    ref = torch.where(mask, g, -torch.inf).amax(dim=1, keepdim=True)
    drift = torch.where(mask, ref - g, 0.0)
    ok = [torch.isfinite(torch.where(mask, g, 0.0)).all(),
          drift.amax() < 1.0,
          torch.isfinite(torch.where(mask, mf + mb, 0.0)).all()]
    if "post_match" in out:
        ok.append(out["post_match"].amax() <= 1.0 + 1e-3)
    ok = torch.stack(ok).tolist()
    messages = ("fb debug: non-finite per-diagonal total",
                "fb debug: per-diagonal totals drift > 1 nat "
                "(forward/backward inconsistency)",
                "fb debug: non-finite diagonal scale",
                "fb debug: match posterior > 1")
    for good, message in zip(ok, messages):
        if not good:
            raise RuntimeError(message)


def _engine(device_type: str) -> str:
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"no engine for device type {device_type!r}")
    return "cuda" if device_type == "cuda" else "torch"


def _sharded_call(hmm, mesh, batch_args, mode: str, width: int) -> dict:
    """One engine call per mesh device on its contiguous shard of the
    batch; outputs gathered on the mesh's first device."""
    B = batch_args[0].shape[0]
    n = mesh.size
    if B % n:
        raise ValueError(f"batch of {B} pairs does not split over a mesh "
                         f"of {n} devices")
    step = B // n
    replicas = {}
    for dev in mesh.devices:
        if dev not in replicas:
            replicas[dev] = (hmm if hmm.t.device == dev
                             else copy.deepcopy(hmm).to(dev))
    # enqueue every shard's launches before any result is read back
    outs = []
    for i, dev in enumerate(mesh.devices):
        shard = [a[i * step:(i + 1) * step].to(dev) for a in batch_args]
        outs.append(fb_wavefront.fb_pass_batch_wavefront(
            replicas[dev], *shard, mode=mode, width=width))
    home = mesh.devices[0]
    return {k: (torch.stack([o[k].to(home) for o in outs]).sum(dim=0)
                if k in ("trans", "emis")
                else torch.cat([o[k].to(home) for o in outs], dim=0))
            for k in outs[0]}


def fb_pass_batch(hmm, sx, sy, offsets, widths, lx, ly, ragged_left,
                  ragged_right, mode: str = "posterior_match",
                  width: int = 0, mesh=None) -> dict:
    """Batch-of-pairs FB pass; every tensor carries a leading batch axis.
    Returns the keys of ``fb_wavefront.fb_pass_batch_wavefront``.

    Without a mesh (or with a mesh of one device) the tensors and the
    PairHMM live on one device. With a mesh of several devices the batch
    axis must divide by ``mesh.size``; the tensors may live anywhere (the
    host is best: each shard is copied straight to its device) and the
    outputs land on ``mesh.devices[0]``."""
    global LAST_ENGINE
    batch_args = (sx, sy, offsets, widths, lx, ly, ragged_left, ragged_right)
    if mesh is not None and mesh.size > 1:
        LAST_ENGINE = _engine(mesh.devices[0].type) + "_sharded"
        out = _sharded_call(hmm, mesh, batch_args, mode, width)
    else:
        if mesh is not None:
            batch_args = tuple(a.to(mesh.devices[0]) for a in batch_args)
        LAST_ENGINE = _engine(batch_args[2].device.type)
        out = fb_wavefront.fb_pass_batch_wavefront(
            hmm, *batch_args, mode=mode, width=width)
    if debug_checks_enabled():
        check_invariants(out, lx, ly)
    return out
