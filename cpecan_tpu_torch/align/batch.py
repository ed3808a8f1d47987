"""Cross-pair batched posterior alignment.

Counterpart of cpecan_tpu/align/batch.py. Every chunk produced by
large-gap splitting (align/split.py) across all jobs becomes one row of a
(padded diagonals, padded width) bucket; each bucket runs through
fb_batch.fb_pass_batch once on ``device`` (the CUDA kernels on a GPU),
the posterior blocks are thresholded and compacted on the device, and
only the entries above threshold come back to the host, where they
scatter to their jobs with the chunk coordinate shifts.

Chunks too long for the two-pass engine (``fb_streaming.should_stream``)
run one at a time through the streaming engines (ops/fb_streaming.py):
on the card the burn-in-parallel engine, on the CPU the exact one.

With a ``parallel.mesh.DataMesh`` the mesh's devices take the place of
``device``: each launch's batch is padded to a multiple of the mesh size
with zero-length pairs and split over the devices
(``fb_batch.fb_pass_batch``); streamed chunks run on the mesh's first
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.models.state_machine import StateMachine
from cpecan_tpu_torch.ops import pairs as pairs_mod
from cpecan_tpu_torch.ops.band import full_band, pad_band
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils.symbols import encode
from cpecan_tpu_torch.align.pairwise import (
    _bucket, _iterate_chunks, _width_bucket, anchored_bands)
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import compact as compact_mod
from cpecan_tpu_torch.ops import fb_batch, fb_parallel, fb_streaming
from cpecan_tpu_torch.ops.fb_streaming import should_stream
from cpecan_tpu_torch.parallel.mesh import pad_to_multiple


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


def _stream_entries_to_pairs(entries, xoff, L, ox, oy):
    """Streaming-engine posterior entries -> pair array with the chunk
    coordinate shift (the fixed-point semantics of _sparse_to_pairs_batch)."""
    from cpecan_tpu_torch.utils.logmath import PAIR_ALIGNMENT_PROB_1

    vals, ks, js = entries
    keep = ks <= L
    vals, ks, js = vals[keep], ks[keep], js[keep]
    xs = xoff[ks] + js
    ys = ks - xs
    prob = np.minimum(vals.astype(np.float64), 1.0)
    return pairs_mod.make_pairs(
        np.floor(prob * PAIR_ALIGNMENT_PROB_1).astype(np.int64),
        xs - 1 + ox, ys - 1 + oy)


def _run_streaming_task(hmm, t, band, p, mode, keys):
    """One long chunk through the streaming engine on the PairHMM's
    device, in fixed memory for any chunk length."""
    W = _width_bucket(band.frame_width())
    out = fb_streaming.fb_pass_streaming(
        hmm, encode(t.sub_x), encode(t.sub_y), band.offsets, band.widths,
        len(t.sub_x), len(t.sub_y), t.ragged_left, t.ragged_right, mode, W,
        fb_streaming.window_rows(p), fb_parallel.burnin_rows(p),
        threshold=p.threshold)
    metrics.add("dp_cells", int(band.widths.sum()))
    metrics.add("streamed_chunks", 1)
    metrics.add("stream_windows", out["windows"])
    return [_stream_entries_to_pairs(out["post_entries"][k], out["xoff"],
                                     band.diagonal_number, t.x1, t.y1)
            for k in keys]


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


def _bands_of(tasks, p: PairwiseAlignmentParameters):
    """Each task's band and frame width: the anchored tasks' in one
    construct_bands call, full_band for the rest."""
    anchored = [t for t in tasks if t.anchors is not None]
    built, frames = anchored_bands(
        [t.anchors for t in anchored], [len(t.sub_x) for t in anchored],
        [len(t.sub_y) for t in anchored], p)
    built, frames = iter(built), iter(frames.tolist())
    bands, band_frames = [], []
    for t in tasks:
        if t.anchors is None:
            band = full_band(len(t.sub_x), len(t.sub_y))
            frame = band.frame_width()
        else:
            band, frame = next(built), next(frames)
        bands.append(band)
        band_frames.append(frame)
    return bands, band_frames


def batch_posteriors(sm: StateMachine, jobs, p: PairwiseAlignmentParameters,
                     mode: str = "posterior_match", device="cuda", mesh=None):
    """Run all jobs' band chunks through shape-bucketed device batches.

    jobs: iterable of (seq_x, seq_y, anchor_pairs, ragged_left,
    ragged_right); anchor_pairs=None runs the job full-band (whole
    rectangle, no splitting). Returns, per job, the thresholded posterior
    pair array(s): one array in posterior_match mode, a (match, gap_x,
    gap_y) triple in posterior_all mode. With a mesh, each launch's batch
    is padded to a multiple of the device count and sharded over it.
    """
    device = torch.device(device) if mesh is None else mesh.devices[0]
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    n_dev = 1 if mesh is None else mesh.size
    n_out = 3 if mode == "posterior_all" else 1
    keys = ("post_match", "post_gap_x", "post_gap_y")[:n_out]
    results = [[[] for _ in jobs] for _ in range(n_out)]

    with metrics.stage("host_prep"):
        tasks = _expand_jobs(jobs, p)
        bands, frames = _bands_of(tasks, p)
        widths = [_width_bucket(f) for f in frames]
    with metrics.stage("fb_pass"):  # the model's copy to the device
        hmm = PairHMM.from_state_machine(sm).to(device)
    buckets: dict = {}
    for t, band, W in zip(tasks, bands, widths):
        if should_stream(band.diagonal_number, W):
            with metrics.stage("fb_stream"):
                for oi, pairs in enumerate(_run_streaming_task(
                        hmm, t, band, p, mode, keys)):
                    results[oi][t.job].append(pairs)
            continue
        P = _bucket(band.diagonal_number)
        buckets.setdefault((P, W), []).append((t, band))

    pending = []  # (items, offs (B, P+1), out) per launch
    pending_bytes = 0

    def flush():
        """Count -> compact -> decode for everything queued: only the
        >= threshold entries come back to the host."""
        nonlocal pending, pending_bytes
        if pending and device.type == "cuda":
            # every queued launch precedes the first count in stream
            # order: wait for them here, apart from the host's work
            with metrics.stage("device_wait"):
                torch.cuda.current_stream(device).synchronize()
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
            bmax = max(bmax, n_dev)
            launches.extend(((P, W), items[s:s + bmax])
                            for s in range(0, len(items), bmax))
        for (P, W), items in launches:
            B = pad_to_multiple(_batch_bucket_size(len(items)), n_dev)
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
            args = [torch.from_numpy(a) for a in
                    (sx, sy, offsets, widths, lx, ly, rl, rr)]
            if mesh is None:  # with a mesh, each shard goes to its device
                args = [a.to(device) for a in args]
            out = fb_batch.fb_pass_batch(hmm, *args, mode=mode, width=W,
                                         mesh=mesh)
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
                            p: PairwiseAlignmentParameters, device="cuda",
                            mesh=None):
    """Batched get_aligned_pairs_using_anchors over many jobs."""
    return batch_posteriors(sm, jobs, p, mode="posterior_match",
                            device=device, mesh=mesh)


def get_aligned_pairs_with_indels_batch(sm: StateMachine, jobs,
                                        p: PairwiseAlignmentParameters,
                                        device="cuda", mesh=None):
    """Batched get_aligned_pairs_with_indels_using_anchors: per job a
    (match, gap_x, gap_y) pair-array triple."""
    return batch_posteriors(sm, jobs, p, mode="posterior_all", device=device,
                            mesh=mesh)
