"""The batch layer: every step from jobs to kernel launches.

Counterpart of cpecan_tpu/align/batch.py and of the expectation step of
cpecan_tpu/em/em.py. Every caller of the forward-backward pass goes
through here:

  alignment_tasks   a job of cigars -> its jobs in one pass (subsequences,
                    one walk of the ops, anchors in one native call),
                    then chunk_tasks
  chunk_tasks       jobs -> Tasks: large-gap splitting (align/split.py),
                    skipped where no gap is large, empty chunks dropped
  plan              Tasks -> bands, grouped by launch shape (P, W); the
                    chunks too long for the two-pass engine
                    (``fb_streaming.should_stream``) are set apart
  launch_arrays     one launch's inputs, padded to its shape, and
  launch            their fb_batch.fb_pass_batch call
  stream_task       one long chunk through the streaming engines
                    (ops/fb_streaming.py): on the card the burn-in-parallel
                    engine for posteriors, else the exact one
  batch_posteriors  posterior modes (realign, align, MSA, the pairwise
                    posterior APIs): each bucket's launches run on
                    ``device``, the posterior blocks are thresholded and
                    compacted on the device, and only the entries above
                    threshold come back to the host, where they scatter
                    to their jobs with the chunk coordinate shifts
  expectation_step  expectation mode (EM, realign --outputExpectations,
                    the pairwise expectation API): each bucket is one
                    launch, its counts summed into an Hmm in float64

ops/fb_batch.py decides the launch shapes (``diagonal_bucket``,
``width_bucket``, ``batch_size``).

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

from cpecan_tpu_torch.align import native
from cpecan_tpu_torch.align.split import (
    _as_array, get_split_points, split_anchors)
from cpecan_tpu_torch.config import PairwiseAlignmentParameters
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.models.hmm import Hmm
from cpecan_tpu_torch.models.state_machine import PairHMM, StateMachine
from cpecan_tpu_torch.ops import compact as compact_mod
from cpecan_tpu_torch.ops import fb_batch, fb_parallel, fb_streaming
from cpecan_tpu_torch.ops import pairs as pairs_mod
from cpecan_tpu_torch.ops.band import construct_bands, full_band
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils.logmath import PAIR_ALIGNMENT_PROB_1
from cpecan_tpu_torch.utils.symbols import encode, reverse_complement


@dataclasses.dataclass
class Task:
    """One banded forward-backward sub-problem: the chunk of job ``job``
    that starts at (x1, y1) of its sequences. ``anchors`` None runs it
    full-band."""
    job: int
    x1: int
    y1: int
    sub_x: str
    sub_y: str
    anchors: object
    ragged_left: bool
    ragged_right: bool


# ------------------------------------------------------------------ jobs

def get_sub_sequence(seq: str, start: int, end: int, strand: bool) -> str:
    """Forward-strand subsequence; minus strand reads [end, start) and
    reverse-complements (reference getSubSequence :232-240)."""
    if strand:
        return seq[start:end]
    return reverse_complement(seq[end:start])


def filter_anchors_to_matches(anchors, seq_x: str, seq_y: str):
    """Keep anchors whose bases match exactly (never N) — reference matchFn
    :277-281.  Vectorized: one bytes-level gather per sequence instead of
    a per-anchor Python loop (realign feeds one anchor per matched base)."""
    anchors = np.asarray(anchors, dtype=np.int64)
    if anchors.ndim == 1 or len(anchors) == 0:
        return anchors.reshape(0, 3)
    bx = np.frombuffer(seq_x.upper().encode("latin-1"), np.uint8)
    by = np.frombuffer(seq_y.upper().encode("latin-1"), np.uint8)
    cx = bx[anchors[:, 0]]
    keep = (cx == by[anchors[:, 1]]) & (cx != ord("N"))
    return anchors[keep]


def chunk_tasks(jobs, p: PairwiseAlignmentParameters,
                unsplit=None) -> list:
    """Jobs (seq_x, seq_y, anchor_pairs, ragged_left, ragged_right) ->
    the Tasks of their non-empty chunks, in job order: each anchored job
    split by large gaps (reference
    getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps
    :1273-1326: ragged flags propagate to the outermost chunks only). A
    job with anchor_pairs None is one full-band task (the reference's
    unbanded small-matrix path: the whole rectangle, no splitting). A job
    the split leaves whole is one task of its anchors as they are
    (counter ``unsplit_jobs``); ``unsplit``, where given, holds each
    job's answer, else get_split_points gives it."""
    tasks = []
    n_unsplit = 0
    for ji, (seq_x, seq_y, anchor_pairs, rl0, rr0) in enumerate(jobs):
        if anchor_pairs is None:
            tasks.append(Task(ji, 0, 0, seq_x, seq_y, None, rl0, rr0))
            continue
        lx, ly = len(seq_x), len(seq_y)
        anchors = _as_array(anchor_pairs)
        whole = [(0, 0, lx, ly)]
        points = (whole if unsplit is not None and unsplit[ji] else
                  get_split_points(anchors, lx, ly,
                                   p.splitMatrixBiggerThanThis, rl0, rr0))
        if points == whole:
            n_unsplit += 1
            if lx or ly:
                tasks.append(Task(ji, 0, 0, seq_x, seq_y, anchors, rl0, rr0))
            continue
        for i, ((x1, y1, x2, y2), local) in enumerate(
                split_anchors(anchors, points)):
            if x2 - x1 == 0 and y2 - y1 == 0:
                continue
            tasks.append(Task(ji, x1, y1, seq_x[x1:x2], seq_y[y1:y2], local,
                              rl0 or i > 0, rr0 or i < len(points) - 1))
    metrics.add("unsplit_jobs", n_unsplit)
    return tasks


# Every latin-1 byte's complement: case kept, N for all but ACGTacgt.
_COMPLEMENT = bytes(
    {ord(a): ord(b) for a, b in zip("ACGTacgt", "TGCAtgca")}.get(c, ord("N"))
    for c in range(256))


def fast_reverse_complement(seq: str) -> str:
    """symbols.reverse_complement through one bytes.translate table; a
    string outside latin-1 takes symbols.reverse_complement."""
    try:
        raw = seq.encode("latin-1")
    except UnicodeEncodeError:
        return reverse_complement(seq)
    return raw[::-1].translate(_COMPLEMENT).decode("ascii")


def _sub_sequence(seq: str, start: int, end: int, strand: bool) -> str:
    """get_sub_sequence with fast_reverse_complement."""
    if strand:
        return seq[start:end]
    return fast_reverse_complement(seq[end:start])


def _record_anchors(pa, sub_x: str, sub_y: str,
                    p: PairwiseAlignmentParameters) -> np.ndarray:
    """One alignment's matched anchors, as realign prepares a record."""
    fwd = cigar_io.PairwiseAlignment(
        pa.contig1, 0, len(sub_x), True, pa.contig2, 0, len(sub_y), True,
        pa.score, pa.operations)
    anchors = cigar_io.alignment_to_anchor_pairs(
        fwd, p.constraintDiagonalTrim, p.diagonalExpansion)
    return filter_anchors_to_matches(anchors, sub_x, sub_y)


def alignment_anchors(alignments, subs,
                      p: PairwiseAlignmentParameters) -> tuple:
    """Each alignment's anchors, as _record_anchors gives them, from one
    walk of the job's cigar ops and one native call: ([(N, 3) int64 views
    of one array], each one's largest gap area as get_split_points
    measures it, or None where not computed). Without the host library,
    for sequences outside ASCII, a negative constraintDiagonalTrim and
    alignments whose ops do not end at their spans, they go record by
    record, which raises for the last as alignment_to_anchor_pairs
    does."""
    trim = p.constraintDiagonalTrim
    op_starts = np.zeros(len(alignments) + 1, np.int64)
    np.cumsum([len(pa.operations) for pa in alignments], out=op_starts[1:])
    n_ops = int(op_starts[-1])
    # the one walk of the ops: their codes, then their lengths
    codes = "".join([c for pa in alignments for c, _ in pa.operations])
    sx = "".join([x for x, _ in subs])
    sy = "".join([y for _, y in subs])
    built = None
    if (native.available() and trim >= 0 and len(codes) == n_ops
            and codes.isascii() and sx.isascii() and sy.isascii()):
        x_starts = np.zeros(len(subs) + 1, np.int64)
        np.cumsum([len(x) for x, _ in subs], out=x_starts[1:])
        y_starts = np.zeros(len(subs) + 1, np.int64)
        np.cumsum([len(y) for _, y in subs], out=y_starts[1:])
        args = (op_starts, np.frombuffer(codes.encode(), np.uint8),
                np.fromiter([m for pa in alignments for _, m in pa.operations],
                            np.int64, n_ops),
                np.frombuffer(sx.upper().encode(), np.uint8), x_starts,
                np.frombuffer(sy.upper().encode(), np.uint8), y_starts,
                trim, p.diagonalExpansion)
        built = native.alignment_anchors(*args)
    if built is None:
        return [_record_anchors(pa, x, y, p)
                for pa, (x, y) in zip(alignments, subs)], None
    anchors, counts, max_gaps = built
    bounds = np.concatenate([[0], np.cumsum(counts)]).tolist()
    return [anchors[s:e] for s, e in zip(bounds, bounds[1:])], max_gaps


def alignment_tasks(alignments, sequences: dict,
                    p: PairwiseAlignmentParameters) -> list:
    """A job of alignments (io/cigar.PairwiseAlignment over
    ``sequences``) -> the Tasks of their expectation passes, in one pass
    over the job (cPecanRealign's expectation path,
    cPecanRealign.c:516-534): each alignment's subsequences, minus
    strands reverse-complemented; its anchors from its cigar's match
    runs, kept where the bases match exactly and are not N; ragged 1, 1;
    then chunk_tasks, with the native call's gap areas as its no-split
    test. Equal to get_sub_sequence, alignment_to_anchor_pairs on
    forward coordinates and filter_anchors_to_matches per alignment,
    then chunk_tasks."""
    subs = [(_sub_sequence(sequences[pa.contig1], pa.start1, pa.end1,
                           pa.strand1),
             _sub_sequence(sequences[pa.contig2], pa.start2, pa.end2,
                           pa.strand2))
            for pa in alignments]
    anchors, max_gaps = alignment_anchors(alignments, subs, p)
    unsplit = (None if max_gaps is None else
               (max_gaps <= p.splitMatrixBiggerThanThis).tolist())
    return chunk_tasks([(x, y, a, True, True)
                        for (x, y), a in zip(subs, anchors)], p, unsplit)


# ----------------------------------------------------------------- bands

def build_bands(tasks, p: PairwiseAlignmentParameters) -> list:
    """Each task's (band, frame width): the anchored tasks' in one
    ``construct_bands`` call at p's expansion (each anchor's own, its
    third column, under dynamicAnchorExpansion, else diagonalExpansion),
    full_band for the rest."""
    anchored = [t for t in tasks if t.anchors is not None]
    built, frames = construct_bands(
        [t.anchors for t in anchored], [len(t.sub_x) for t in anchored],
        [len(t.sub_y) for t in anchored],
        None if p.dynamicAnchorExpansion else p.diagonalExpansion)
    built, frames = iter(built), iter(frames.tolist())
    out = []
    for t in tasks:
        if t.anchors is None:
            band = full_band(len(t.sub_x), len(t.sub_y))
            out.append((band, band.frame_width()))
        else:
            out.append((next(built), next(frames)))
    return out


def plan(tasks, p: PairwiseAlignmentParameters) -> tuple:
    """Tasks with their bands, grouped by launch shape: ({(P, W): [(task,
    band), ...]}, streamed), the buckets in the order of their first
    task, where streamed lists the (task, band, W) of the tasks too long
    for the two-pass engine."""
    buckets: dict = {}
    streamed = []
    for t, (band, frame) in zip(tasks, build_bands(tasks, p)):
        W = fb_batch.width_bucket(frame)
        if fb_streaming.should_stream(band.diagonal_number, W):
            streamed.append((t, band, W))
        else:
            P = fb_batch.diagonal_bucket(band.diagonal_number)
            buckets.setdefault((P, W), []).append((t, band))
    return buckets, streamed


# -------------------------------------------------------------- launches

def launch_arrays(items: list, P: int, n_dev: int = 1) -> tuple:
    """One launch's inputs (sx, sy, offsets, widths, lx, ly, ragged_left,
    ragged_right) as numpy arrays, padded with zero-length pairs to
    ``fb_batch.batch_size(len(items), n_dev)``. Each item's band rows are
    ``pad_band(band, P)``'s."""
    B_pad = fb_batch.batch_size(len(items), n_dev)
    n = len(items)
    lxs = [len(t.sub_x) for t, _ in items]
    lys = [len(t.sub_y) for t, _ in items]
    sx = np.zeros((B_pad, P), np.int32)
    sy = np.zeros((B_pad, P), np.int32)
    offsets = np.zeros((B_pad, P + 1), np.int32)
    widths = np.ones((B_pad, P + 1), np.int32)
    # pad rows: parity-consistent offsets, zero lengths (no contribution)
    offsets[:, 1::2] = 1
    lx = np.zeros(B_pad, np.int32)
    ly = np.zeros(B_pad, np.int32)
    rl = np.zeros(B_pad, bool)
    rr = np.zeros(B_pad, bool)
    lx[:n] = lxs
    ly[:n] = lys
    rl[:n] = [t.ragged_left for t, _ in items]
    rr[:n] = [t.ragged_right for t, _ in items]
    # past an item's last diagonal L, as pad_band pads: that diagonal's
    # offset plus (k - L) % 2, width 1
    alt = np.arange(1, P + 2, dtype=np.int32) % 2
    codes_x = encode("".join(t.sub_x for t, _ in items))
    codes_y = encode("".join(t.sub_y for t, _ in items))
    x0 = y0 = 0
    for i, ((_, band), nx, ny) in enumerate(zip(items, lxs, lys)):
        L = nx + ny
        assert L <= P
        offsets[i, : L + 1] = band.offsets
        np.add(alt[: P - L], band.offsets[L], out=offsets[i, L + 1:])
        widths[i, : L + 1] = band.widths
        sx[i, :nx] = codes_x[x0: x0 + nx]
        sy[i, :ny] = codes_y[y0: y0 + ny]
        x0 += nx
        y0 += ny
    return sx, sy, offsets, widths, lx, ly, rl, rr


def launch(hmm, arrays, mode: str, W: int, device, mesh=None) -> dict:
    """fb_batch.fb_pass_batch on launch_arrays' output, the arrays copied
    to ``device``; with a mesh, each shard goes from the host to its
    device."""
    args = [torch.from_numpy(a) for a in arrays]
    if mesh is None:
        args = [a.to(device) for a in args]
    return fb_batch.fb_pass_batch(hmm, *args, mode=mode, width=W, mesh=mesh)


def stream_task(hmm, t: Task, band, W: int, p: PairwiseAlignmentParameters,
                mode: str) -> dict:
    """One long chunk through the streaming engine on the PairHMM's
    device, in fixed memory for any chunk length; returns
    ``fb_streaming.fb_pass_streaming``'s outputs."""
    out = fb_streaming.fb_pass_streaming(
        hmm, encode(t.sub_x), encode(t.sub_y), band.offsets, band.widths,
        len(t.sub_x), len(t.sub_y), t.ragged_left, t.ragged_right, mode, W,
        fb_streaming.window_rows(p), fb_parallel.burnin_rows(p),
        threshold=p.threshold)
    metrics.add("dp_cells", int(band.widths.sum()))
    metrics.add("streamed_chunks", 1)
    metrics.add("stream_windows", out["windows"])
    return out


# ------------------------------------------------------------ posteriors

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


def _stream_entries_to_pairs(entries, xoff, L, ox, oy):
    """Streaming-engine posterior entries -> pair array with the chunk
    coordinate shift (the fixed-point semantics of _sparse_to_pairs_batch)."""
    vals, ks, js = entries
    keep = ks <= L
    vals, ks, js = vals[keep], ks[keep], js[keep]
    xs = xoff[ks] + js
    ys = ks - xs
    prob = np.minimum(vals.astype(np.float64), 1.0)
    return pairs_mod.make_pairs(
        np.floor(prob * PAIR_ALIGNMENT_PROB_1).astype(np.int64),
        xs - 1 + ox, ys - 1 + oy)


# Dense posterior outputs (B x (P+1) x W floats per mode output) live on
# the device until sparsified; launches are split and flushed so the
# bytes queued stay bounded.
_DENSE_BUDGET = 1 << 30


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
        buckets, streamed = plan(chunk_tasks(jobs, p), p)
    with metrics.stage("fb_pass"):  # the model's copy to the device
        hmm = PairHMM.from_state_machine(sm).to(device)
    for t, band, W in streamed:
        with metrics.stage("fb_stream"):
            out = stream_task(hmm, t, band, W, p, mode)
            for oi, k in enumerate(keys):
                results[oi][t.job].append(_stream_entries_to_pairs(
                    out["post_entries"][k], out["xoff"],
                    band.diagonal_number, t.x1, t.y1))

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
                cap = fb_batch.batch_size(max(count, 64))
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
            arrays = launch_arrays(items, P, n_dev)
            offsets, widths = arrays[2], arrays[3]
            metrics.add("dp_cells", int(widths[: len(items)].sum()))
            out = launch(hmm, arrays, mode, W, device, mesh)
            pending.append((items, offsets.astype(np.int64), out))
            pending_bytes += offsets.shape[0] * (P + 1) * W * 4 * n_out
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


# ---------------------------------------------------------- expectations

def _add_counts(hmm: Hmm, out: dict, lengths) -> None:
    """Add one pass's expected counts to hmm: trans, emis and, per pair
    of L = lengths[i] > 0 diagonals, the likelihood, its per-diagonal
    totals recombined in float64 (total_raw + cumsum(mf) + reverse
    cumsum(mb) over diagonals 1..L). The per-pair rows of ``out`` carry
    a leading batch axis, or none for one streamed pair."""
    hmm.transitions += np.asarray(out["trans"], np.float64)
    hmm.emissions += np.asarray(out["emis"], np.float64)
    mf, mb, totals = (np.atleast_2d(np.asarray(out[k], np.float64))
                      for k in ("mf", "mb", "total_raw"))
    for i, L in enumerate(lengths):
        if L == 0:
            continue
        cf = np.cumsum(mf[i, : L + 1])
        cb = np.cumsum(mb[i, : L + 1][::-1])[::-1]
        hmm.likelihood += float(
            np.sum(totals[i, 1 : L + 1] + cf[1:] + cb[1:]))


def expectation_step(sm: StateMachine, tasks: list,
                     p: PairwiseAlignmentParameters, hmm: Hmm,
                     mesh=None, device="cuda") -> None:
    """Accumulate expected counts for all tasks into hmm. Tasks are bucketed
    by padded shape (P, W) and each bucket, padded to a power of two with
    zero-length pairs, runs as one batch of expectation passes on
    ``device``; tasks too long for that run one at a time through the
    exact streaming engine. With a mesh its devices take the place of
    ``device``: each bucket is padded to a multiple of the device count
    and sharded over the mesh, and streamed tasks run on its first
    device. EM's and realign's parameters never set
    dynamicAnchorExpansion, so their bands take p.diagonalExpansion, as
    the JAX package's expectation step's do."""
    device = torch.device(device) if mesh is None else mesh.devices[0]
    n_dev = 1 if mesh is None else mesh.size
    model = PairHMM.from_state_machine(sm).to(device)
    with metrics.stage("host_prep"):
        buckets, streamed = plan(tasks, p)
    for t, band, W in streamed:
        with metrics.stage("fb_stream"):
            out = stream_task(model, t, band, W, p, "expectation")
        with metrics.stage("em_counts"):
            _add_counts(hmm, out, [band.diagonal_number])
    for (P, W), items in buckets.items():
        metrics.add("dp_cells", sum(int(band.widths.sum()) for _, band in items))
        with metrics.stage("host_prep"):
            arrays = launch_arrays(items, P, n_dev)
        lengths = (arrays[4] + arrays[5]).tolist()
        # the launches and the copies back (which wait for the device)
        with metrics.stage("fb_pass"):
            out = launch(model, arrays, "expectation", W, device, mesh)
            if device.type == "cuda":
                # the copies below wait for the launches anyway: wait here,
                # apart from the copies' own time
                with metrics.stage("device_wait"):
                    torch.cuda.current_stream(device).synchronize()
            out = {k: v.cpu().numpy().astype(np.float64)
                   for k, v in out.items()}
        with metrics.stage("em_counts"):
            _add_counts(hmm, out, lengths)
