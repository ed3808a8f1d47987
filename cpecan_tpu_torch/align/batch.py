"""Cross-pair batched posterior alignment.

Counterpart of cpecan_tpu/align/batch.py. Every chunk produced by
large-gap splitting (align/split.py) across all jobs becomes one row of a
(padded diagonals, padded width) bucket; each bucket runs through
fb_batch.fb_pass_batch once on ``device`` (the CUDA kernels on a GPU),
the posterior blocks are thresholded and compacted on the device, and
only the entries above threshold come back to the host, where they
scatter to their jobs with the chunk coordinate shifts.

Chunks long enough to need the checkpointed streaming engine raise
NotImplementedError: that engine belongs to the long-pair slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.state_machine import StateMachine
from cpecan_tpu_torch.ops import pairs as pairs_mod
from cpecan_tpu_torch.ops.band import construct_band, full_band, pad_band
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils.symbols import encode
from cpecan_tpu_torch.align.pairwise import (
    _bucket, _iterate_chunks, _width_bucket)
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import compact as compact_mod
from cpecan_tpu_torch.ops import fb_batch


@dataclasses.dataclass
class _Task:
    job: int
    x1: int
    y1: int
    sub_x: str
    sub_y: str
    anchors: list
    ragged_left: bool
    ragged_right: bool


# Chunks whose two-pass resident tensors (~3 copies of (P+1, S, W) fp32)
# would exceed this many bytes go to the streaming engine
# (cpecan_tpu/ops/fb_streaming.py should_stream, at its default budget).
_STREAM_BUDGET = 1 << 30


def should_stream(diagonal_number: int, width: int,
                  state_number: int = 5) -> bool:
    resident = 3 * (diagonal_number + 1) * state_number * max(width, 128) * 4
    return resident > _STREAM_BUDGET


def _count_above(post, thr) -> int:
    """Per-launch entry count (sizes the compaction's capacity)."""
    return int(torch.sum(post >= thr))


def _compact_above(post, thr, cap):
    """Compact a launch's (B, P+1, W) posterior block to its >= thr
    entries on the device. Returns (idx, vals, count, row_max) with idx
    flat over (B*(P+1), W)."""
    B, P1, W = post.shape
    return compact_mod.compact_rows(post.reshape(B * P1, W), thr, cap)


def _sparse_to_pairs_batch(idx, vals, offs, P1, W, items, res_one):
    """Vectorized host decode of one launch's compacted entries into
    per-job pair arrays (addPosteriorProb semantics)."""
    from cpecan_tpu_torch.utils.logmath import PAIR_ALIGNMENT_PROB_1

    sel = idx >= 0
    idx = idx[sel].astype(np.int64)
    vals = vals[sel]
    rows = idx // W
    js = idx % W
    b = rows // P1
    ks = rows % P1
    # per-item frame offsets: vectorized cummax over the offsets matrix
    xoff = pairs_mod.frame_offsets_batch(offs)
    xs = xoff[b, ks] + js
    ys = ks - xs
    prob = np.floor(np.minimum(vals.astype(np.float64), 1.0)
                    * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
    order = np.argsort(b, kind="stable")
    b, ks, xs, ys, prob = b[order], ks[order], xs[order], ys[order], prob[order]
    bounds = np.searchsorted(b, np.arange(len(items) + 1))
    for i, (t, band) in enumerate(items):
        lo, hi = bounds[i], bounds[i + 1]
        keep = ks[lo:hi] <= band.diagonal_number
        res_one[t.job].append(pairs_mod.make_pairs(
            prob[lo:hi][keep], xs[lo:hi][keep] - 1 + t.x1,
            ys[lo:hi][keep] - 1 + t.y1))


# Dense posterior outputs (B x (P+1) x W floats per mode output) live on
# the device until sparsified; launches are split and flushed so the
# bytes queued stay bounded.
_DENSE_BUDGET = 1 << 30


def _batch_bucket_size(n: int) -> int:
    """Pad batch sizes to powers of two (few distinct launch shapes)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _expand_jobs(jobs, p):
    tasks = []
    for ji, (seq_x, seq_y, anchor_pairs, rl0, rr0) in enumerate(jobs):
        if anchor_pairs is None:
            # full-band job (the reference's unbanded small-matrix path):
            # whole rectangle, no splitting
            tasks.append(_Task(ji, 0, 0, seq_x, seq_y, None, rl0, rr0))
            continue
        for (x1, y1, x2, y2), local, rl, rr in _iterate_chunks(
                seq_x, seq_y, anchor_pairs, p, rl0, rr0):
            if x2 - x1 == 0 and y2 - y1 == 0:
                continue
            tasks.append(_Task(ji, x1, y1, seq_x[x1:x2], seq_y[y1:y2],
                               local, rl, rr))
    return tasks


def _band_of(t: _Task, p: PairwiseAlignmentParameters):
    if t.anchors is None:
        return full_band(len(t.sub_x), len(t.sub_y))
    arr = np.asarray(t.anchors if isinstance(t.anchors, np.ndarray)
                     else list(t.anchors), dtype=np.int64)
    if arr.ndim == 1:
        arr = arr.reshape(0, 3)
    if p.dynamicAnchorExpansion:
        return construct_band(arr, len(t.sub_x), len(t.sub_y), expansion=None)
    return construct_band(arr[:, :2], len(t.sub_x), len(t.sub_y),
                          p.diagonalExpansion)


def batch_posteriors(sm: StateMachine, jobs, p: PairwiseAlignmentParameters,
                     mode: str = "posterior_match", device="cuda"):
    """Run all jobs' band chunks through shape-bucketed device batches.

    jobs: iterable of (seq_x, seq_y, anchor_pairs, ragged_left,
    ragged_right); anchor_pairs=None runs the job full-band (whole
    rectangle, no splitting). Returns, per job, the thresholded posterior
    pair array(s): one array in posterior_match mode, a (match, gap_x,
    gap_y) triple in posterior_all mode.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    n_out = 3 if mode == "posterior_all" else 1
    keys = ("post_match", "post_gap_x", "post_gap_y")[:n_out]
    results = [[[] for _ in jobs] for _ in range(n_out)]

    with metrics.stage("host_prep"):
        tasks = _expand_jobs(jobs, p)
    hmm = PairHMM.from_state_machine(sm).to(device)
    buckets: dict = {}
    for t in tasks:
        with metrics.stage("host_prep"):
            band = _band_of(t, p)
            W = _width_bucket(band.frame_width())
        if should_stream(band.diagonal_number, W):
            raise NotImplementedError(
                f"a chunk of {band.diagonal_number} diagonals at width {W} "
                "needs the checkpointed streaming engine, which the port "
                "does not have yet (the long-pair slice)")
        P = _bucket(band.diagonal_number)
        buckets.setdefault((P, W), []).append((t, band))

    pending = []  # (items, offs (B, P+1), out) per launch
    pending_bytes = 0

    def flush():
        """Count -> compact -> decode for everything queued: only the
        >= threshold entries come back to the host."""
        nonlocal pending, pending_bytes
        for items, offs, out in pending:
            P1, Wp = out[keys[0]].shape[1:]
            for oi, k in enumerate(keys):
                count = _count_above(out[k], p.threshold)
                cap = _batch_bucket_size(max(count, 64))
                idx, vals = _compact_above(out[k], p.threshold, cap)[:2]
                _sparse_to_pairs_batch(idx.cpu().numpy(), vals.cpu().numpy(),
                                       offs, P1, Wp, items, results[oi])
        pending = []
        pending_bytes = 0

    with metrics.stage("fb_pass"):
        launches = []
        for (P, W), items in sorted(buckets.items()):
            bmax = max(1, int(_DENSE_BUDGET // ((P + 1) * W * 4 * n_out)))
            bmax = 1 << (bmax.bit_length() - 1)  # power of two: B == bmax
            launches.extend(((P, W), items[s:s + bmax])
                            for s in range(0, len(items), bmax))
        for (P, W), items in launches:
            B = _batch_bucket_size(len(items))
            sx = np.zeros((B, P), np.int32)
            sy = np.zeros((B, P), np.int32)
            offsets = np.zeros((B, P + 1), np.int32)
            offsets[:, 1::2] = 1  # parity-consistent pad rows
            widths = np.ones((B, P + 1), np.int32)
            lx = np.zeros(B, np.int32)
            ly = np.zeros(B, np.int32)
            rl = np.zeros(B, bool)
            rr = np.zeros(B, bool)
            for i, (t, band) in enumerate(items):
                o, w, _L = pad_band(band, P)
                offsets[i] = o
                widths[i] = w
                sx[i, : len(t.sub_x)] = encode(t.sub_x)
                sy[i, : len(t.sub_y)] = encode(t.sub_y)
                lx[i] = len(t.sub_x)
                ly[i] = len(t.sub_y)
                rl[i] = t.ragged_left
                rr[i] = t.ragged_right

            metrics.add("dp_cells", int(widths[: len(items)].sum()))
            on_dev = [torch.from_numpy(a).to(device) for a in
                      (sx, sy, offsets, widths, lx, ly, rl, rr)]
            out = fb_batch.fb_pass_batch(hmm, *on_dev, mode=mode, width=W)
            pending.append((items, offsets.astype(np.int64), out))
            pending_bytes += B * (P + 1) * W * 4 * n_out
            if pending_bytes >= _DENSE_BUDGET:
                flush()
        flush()

    merged = [[pairs_mod.concat_pairs(job_lists) for job_lists in res]
              for res in results]
    if mode == "posterior_match":
        return merged[0]
    return list(zip(*merged))


def get_aligned_pairs_batch(sm: StateMachine, jobs,
                            p: PairwiseAlignmentParameters, device="cuda"):
    """Batched get_aligned_pairs_using_anchors over many jobs."""
    return batch_posteriors(sm, jobs, p, mode="posterior_match",
                            device=device)


def get_aligned_pairs_with_indels_batch(sm: StateMachine, jobs,
                                        p: PairwiseAlignmentParameters,
                                        device="cuda"):
    """Batched get_aligned_pairs_with_indels_using_anchors: per job a
    (match, gap_x, gap_y) pair-array triple."""
    return batch_posteriors(sm, jobs, p, mode="posterior_all", device=device)
