"""Plain banded forward-backward of long chunks: the reference of the
long-pair cells.

The recursion, the rescaling and the posteriors are fb.py's, written
from the same equations: one anti-diagonal at a time, in probability
space, every diagonal rescaled to sum 1; the posterior of a cell is
F(c)B(c)/P, with P worked out on each diagonal as the sum of F.B over
its cells plus the match steps that jump over it. What differs is the
storage. fb.py lays a batch out as (chunks x diagonals x widest band)
tensors and builds every diagonal's sources, targets and emissions at
once, which at 10^6 diagonals and a band that widens to a few hundred
cells does not fit. Here:

- the per-diagonal inputs are built a block of STEPS diagonals at a
  time, from each diagonal's band origin and width;
- the scaled forward and backward values are kept a block at a time at
  the widest band of that block (the band stored ragged, by block);
- the posteriors are worked out block by block from the two, and only
  the cells at or above ``threshold`` leave the device.

The forward and the backward sweep do not depend on each other: on the
card each runs on a stream of its own, in blocks captured once as CUDA
graphs, and they overlap. Chunks are the dicts of fb.py (``sx``, ``sy``,
``offsets``, ``widths``, ``rl``, ``rr``); ``dtype`` sets the precision
of every tensor (float64 for the reference; a lower one gives the
control).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference.fb import M, STEPS, X, Y, _prob_model


class _Chunks:
    """A batch of chunks: each diagonal's band origin and width, and the
    symbols, on the device, with two empty diagonals on either side."""

    def __init__(self, chunks, pm: dict, dtype, device):
        B = len(chunks)
        self.B, self.S = B, pm["S"]
        self.L = np.array([len(c["offsets"]) - 1 for c in chunks])
        self.K = int(self.L.max()) + 1
        self.Wm = int(max(np.max(c["widths"]) for c in chunks))
        lxm = max(len(c["sx"]) for c in chunks)
        lym = max(len(c["sy"]) for c in chunks)
        xlo = np.zeros((B, self.K + 4), np.int64)
        w = np.zeros((B, self.K + 4), np.int64)
        SX = np.full((B, lxm + 1), 4, np.int64)
        SY = np.full((B, lym + 1), 4, np.int64)
        for b, c in enumerate(chunks):
            n = self.L[b] + 1
            xlo[b, 2:n + 2] = (np.arange(n) + np.asarray(c["offsets"],
                                                         np.int64)) // 2
            w[b, 2:n + 2] = np.asarray(c["widths"], np.int64)
            SX[b, 1:len(c["sx"]) + 1] = c["sx"]
            SY[b, 1:len(c["sy"]) + 1] = c["sy"]
        to = lambda a: torch.tensor(a, device=device)
        self.xlo, self.w, self.SX, self.SY = to(xlo), to(w), to(SX), to(SY)
        self.lxm, self.lym = lxm, lym
        self.Lt = to(self.L)
        self.lx = to(np.array([len(c["sx"]) for c in chunks]))
        self.start = torch.stack([pm["ragged_start"] if c["rl"] else pm["start"]
                                  for c in chunks])
        self.end = torch.stack([pm["ragged_end"] if c["rr"] else pm["end"]
                                for c in chunks])
        self.pm, self.dtype, self.device = pm, dtype, device
        self.j = torch.arange(self.Wm, device=device)
        self.zero = torch.zeros((), dtype=dtype, device=device)

    def rows(self, lo: int, hi: int) -> dict:
        """Diagonals lo..hi-1 (lo >= -2, hi <= K + 2): x of each slot,
        validity, and the emission of entering each cell by class,
        (B, n, Wm[, 3])."""
        pm, B, j = self.pm, self.B, self.j
        xlo, w = self.xlo[:, lo + 2:hi + 2], self.w[:, lo + 2:hi + 2]
        ks = torch.arange(lo, hi, device=self.device)
        Xc = xlo[:, :, None] + j
        Yc = ks[None, :, None] - Xc
        valid = j < w[:, :, None]
        symx = torch.gather(self.SX, 1, Xc.clamp(0, self.lxm).reshape(B, -1)
                            ).reshape(Xc.shape)
        symy = torch.gather(self.SY, 1, Yc.clamp(0, self.lym).reshape(B, -1)
                            ).reshape(Xc.shape)
        okx = valid & (Xc >= 1)
        oky = valid & (Yc >= 1)
        E = torch.stack([
            torch.where(okx, pm["em_gap_x"][symx], self.zero),
            torch.where(okx & oky, pm["em_match"][symx, symy], self.zero),
            torch.where(oky, pm["em_gap_y"][symy], self.zero)], dim=-1)
        return {"xlo": xlo, "w": w, "Xc": Xc, "Yc": Yc, "valid": valid,
                "E": E, "ks": ks}

    def sources(self, R: dict, n: int):
        """Forward inputs of the n diagonals at R's rows 2..n+1: indices
        into the view (row k-2, row k-1) of the ring, (B, n, 3 Wm), and
        the emissions (B, n, Wm, 3)."""
        Wm = self.Wm
        cur, m1, m2 = slice(2, 2 + n), slice(1, 1 + n), slice(0, n)
        Xc, valid = R["Xc"][:, cur], R["valid"][:, cur]
        okx, oky = valid & (Xc >= 1), valid & (R["Yc"][:, cur] >= 1)
        jx = Xc - 1 - R["xlo"][:, m1, None]
        jy = Xc - R["xlo"][:, m1, None]
        jm = Xc - 1 - R["xlo"][:, m2, None]
        w1, w2 = R["w"][:, m1, None], R["w"][:, m2, None]
        vx = okx & (jx >= 0) & (jx < w1)
        vy = oky & (jy >= 0) & (jy < w1)
        vm = okx & oky & (jm >= 0) & (jm < w2)
        idx = torch.stack([torch.where(vx, Wm + 1 + jx, Wm),
                           torch.where(vm, jm, Wm),
                           torch.where(vy, Wm + 1 + jy, Wm)], dim=-1)
        return idx.reshape(self.B, n, 3 * Wm), R["E"][:, cur]

    def _target(self, R: dict, at: slice, row: slice, dx: int, cls: int):
        """Slot on ``row`` of the target (x + dx, ..) of each cell of
        ``at``, whether it is in the band, and its emission by ``cls``."""
        t = R["Xc"][:, at] + dx - R["xlo"][:, row, None]
        ok = R["valid"][:, at] & (t >= 0) & (t < R["w"][:, row, None])
        e = torch.gather(R["E"][:, row, :, cls], 2, t.clamp(0, self.Wm - 1))
        return t, ok, torch.where(ok, e, self.zero)

    def targets(self, R: dict, n: int):
        """Backward inputs of the n diagonals at R's rows 2..n+1: indices
        into the view (row k+1, row k+2), (B, n, 3 Wm), the targets'
        emissions (B, n, Wm, 3) and the end flags (B, n)."""
        Wm = self.Wm
        cur, p1, p2 = slice(2, 2 + n), slice(3, 3 + n), slice(4, 4 + n)
        tx, ux, ex = self._target(R, cur, p1, 1, X)
        ty, uy, ey = self._target(R, cur, p1, 0, Y)
        tm, um, em = self._target(R, cur, p2, 1, M)
        idx = torch.stack([torch.where(ux, tx, Wm),
                           torch.where(um, Wm + 1 + tm, Wm),
                           torch.where(uy, ty, Wm)], dim=-1)
        end = (R["ks"][cur][None, :] == self.Lt[:, None]).to(self.dtype)
        return (idx.reshape(self.B, n, 3 * Wm),
                torch.stack([ex, em, ey], dim=-1), end)


def _runner(body, device):
    """body, captured once as a CUDA graph on the card (replayed on the
    caller's stream), else itself."""
    if torch.device(device).type != "cuda":
        return body
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph.replay


class _Sweep:
    """One direction's ring of STEPS + 2 rows, its staged inputs and the
    graph that runs a block. Forward: ring[i + 2] is the block's i-th
    diagonal, ring[0:2] the two below. Backward: ring[i] is the block's
    i-th diagonal, ring[STEPS:STEPS + 2] the two above."""

    def __init__(self, g: _Chunks, forward: bool):
        B, S, Wm, C = g.B, g.S, g.Wm, STEPS
        dt, dev = g.dtype, g.device
        one = torch.ones((), dtype=dt, device=dev)
        T = g.pm["T3"] if forward else g.pm["T3b"]
        self.ring = torch.zeros(B, C + 2, Wm + 1, S, dtype=dt, device=dev)
        self.idx = torch.full((B, C, Wm * 3), Wm, dtype=torch.long, device=dev)
        self.e = torch.zeros(B, C, Wm, 3, 1, dtype=dt, device=dev)
        self.scale = torch.ones(B, C, dtype=dt, device=dev)
        # the match step reads two diagonals back: one rescale further
        self.back = torch.ones(B, 1, 3, 1, dtype=dt, device=dev)
        self.endflag = torch.zeros(B, C, dtype=dt, device=dev)
        self.endrow = torch.zeros(B, Wm, S, dtype=dt, device=dev)
        ring, idx, e, s_s, back = self.ring, self.idx, self.e, self.scale, self.back

        def step(i, lo):
            view = ring[:, lo:lo + 2].reshape(B, 2 * (Wm + 1), S)
            src = torch.gather(view, 1, idx[:, i, :, None].expand(B, Wm * 3, S))
            src = src.reshape(B, Wm, 3, S) * (e[:, i] * back)
            return torch.matmul(src.reshape(B, Wm, 3 * S), T)

        def finish(i, new, row):
            s = new.sum(dim=(1, 2))
            s = torch.where(s > 0, s, one)
            ring[:, row, :Wm] = new / s[:, None, None]
            s_s[:, i] = s
            back[:, 0, M, 0] = 1 / s

        def fwd_body():
            for i in range(C):
                finish(i, step(i, i), i + 2)

        def bwd_body():
            for i in range(C - 1, -1, -1):
                new = step(i, i + 1)
                finish(i, new + self.endrow * self.endflag[:, i, None, None], i)

        self.run = _runner(fwd_body if forward else bwd_body, dev)
        ring.zero_()
        back.fill_(1)


def _sweeps(g: _Chunks, blocks):
    """Scaled forward and backward values of every diagonal, kept a block
    at a time: ({block: (B, n, Wb, S)}, {block: ...}, forward scales
    (B, K), backward scales (B, K)). Row 0 is the forward's start; the
    backward starts at row K - 1 and stops at row 1 (no posterior of
    row 0 is kept)."""
    B, K, C, dev = g.B, g.K, STEPS, g.device
    on_card = torch.device(dev).type == "cuda"
    streams = ((torch.cuda.Stream(), torch.cuda.Stream()) if on_card
               else (None, None))
    ctx = lambda s: (torch.cuda.stream(s) if s is not None
                     else contextlib.nullcontext())
    fw = _Sweep(g, True)
    bw = _Sweep(g, False)
    sF = torch.ones(B, K, dtype=g.dtype, device=dev)
    sB = torch.ones(B, K, dtype=g.dtype, device=dev)
    bi = torch.arange(B, device=dev)
    F0 = torch.zeros(B, 1, 1, g.S, dtype=g.dtype, device=dev)
    for s in streams:
        if s is not None:
            s.wait_stream(torch.cuda.current_stream())
    with ctx(streams[0]):
        s0 = g.start.sum(-1)
        fw.ring[:, 1, 0] = g.start / s0[:, None]
        F0[:, 0, 0] = fw.ring[:, 1, 0]
        sF[:, 0] = s0
        fw.back[:, 0, M, 0] = 1 / s0
    with ctx(streams[1]):
        bw.endrow[bi, g.lx - g.xlo[bi, g.Lt + 2]] = g.end
    Fs, Bs = {}, {}
    widths = g.w[:, 2:K + 2].amax(0).cpu().numpy()
    for i in range(len(blocks)):
        with ctx(streams[0]):
            k0, k1 = blocks[i]
            n = k1 - k0
            idx, e = g.sources(g.rows(k0 - 2, k1), n)
            fw.idx[:, :n] = idx
            fw.idx[:, n:] = g.Wm
            fw.e[:, :n] = e[..., None]
            fw.e[:, n:] = 0
            fw.run()
            Fs[i] = fw.ring[:, 2:2 + n, :int(widths[k0:k1].max())].clone()
            sF[:, k0:k1] = fw.scale[:, :n]
            fw.ring[:, 0:2] = fw.ring[:, C:C + 2].clone()
        with ctx(streams[1]):
            b = len(blocks) - 1 - i
            k0, k1 = blocks[b]
            n, off = k1 - k0, C - (k1 - k0)
            idx, e, end = g.targets(g.rows(k0 - 2, k1 + 2), n)
            bw.idx[:, off:] = idx
            bw.idx[:, :off] = g.Wm
            bw.e[:, off:] = e[..., None]
            bw.e[:, :off] = 0
            bw.endflag[:, off:] = end
            bw.endflag[:, :off] = 0
            bw.run()
            Bs[b] = bw.ring[:, off:C, :int(widths[k0:k1].max())].clone()
            sB[:, k0:k1] = bw.scale[:, off:]
            bw.ring[:, C:C + 2] = bw.ring[:, off:off + 2].clone()
            # the empty steps below a short block rescaled by 1: the next
            # block's match steps read the block's lowest diagonal
            bw.back[:, 0, M, 0] = 1 / bw.scale[:, off]
    for s in streams:
        if s is not None:
            torch.cuda.current_stream().wait_stream(s)
    Fs[-1] = F0
    return Fs, Bs, sF, sB


def _widen(a, Wm: int):
    return torch.nn.functional.pad(a, (0, 0, 0, Wm - a.shape[2]))


def _groups(chunks, cell_budget: int) -> list:
    """Chunk indices, longest first, in batches whose chunks times the
    most band cells of any of them stays under cell_budget."""
    order = sorted(range(len(chunks)), key=lambda i: -len(chunks[i]["offsets"]))
    groups, most = [], 0
    for i in order:
        cells = int(np.sum(chunks[i]["widths"]))
        if groups and (len(groups[-1]) + 1) * max(most, cells) <= cell_budget:
            groups[-1].append(i)
            most = max(most, cells)
        else:
            groups.append([i])
            most = cells
    return groups


def posteriors(chunks, model, dtype=torch.float64, device="cpu",
               threshold: float = 0.0, cell_budget: int = 1 << 26):
    """Match posteriors of the band cells with x, y >= 1 and a posterior
    of at least ``threshold``, per chunk: a list of (x, y, post) numpy
    arrays in chunk coordinates (cell (x, y) aligns sx[x-1] with
    sy[y-1]). Chunks run in batches of at most cell_budget band cells
    (each chunk counted as the batch's largest)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pm = _prob_model(model, dtype, device)
    out = [None] * len(chunks)
    for idx in _groups(chunks, cell_budget):
        for i, res in zip(idx, _group_posteriors([chunks[i] for i in idx], pm,
                                                 threshold)):
            out[i] = res
    return out


def _group_posteriors(chunks, pm, threshold: float):
    g = _Chunks(chunks, pm, pm["T3"].dtype, pm["T3"].device)
    B, K, Wm, C = g.B, g.K, g.Wm, STEPS
    blocks = [(k0, min(k0 + C, K)) for k0 in range(1, K, C)]
    Fs, Bs, sF, sB = _sweeps(g, blocks)
    Tm = pm["Tc"][M]
    kept = []  # per block: (chunk, x, y, post) of the cells kept
    for b, (k0, k1) in enumerate(blocks):
        n = k1 - k0
        R = g.rows(k0 - 2, k1 + 2)
        Fk = _widen(Fs[b], Wm)
        prev = Fs[b - 1] if b > 0 else Fs[-1]
        Fm1 = torch.cat([_widen(prev[:, -1:], Wm), Fk[:, :-1]], dim=1)
        Bk = _widen(Bs[b], Wm)
        above = (_widen(Bs[b + 1][:, :1], Wm) if b + 1 < len(blocks)
                 else torch.zeros_like(Bk[:, :1]))
        Bp1 = torch.cat([Bk[:, 1:], above], dim=1)
        dot = (Fk * Bk).sum(dim=(2, 3))
        # the match steps from diagonal k-1 over k to k+1
        tm, um, em = g._target(R, slice(1, 1 + n), slice(3, 3 + n), 1, M)
        tgt = torch.gather(Bp1, 2, tm.clamp(0, Wm - 1)[..., None].expand(
            B, n, Wm, g.S)) * em[..., None]
        bridge = (Fm1 * torch.matmul(tgt, Tm.T)).sum(dim=(2, 3))
        tot = dot + bridge / (sF[:, k0:k1] * sB[:, k0:k1])
        tot = torch.where(tot > 0, tot, torch.ones_like(tot))
        post = Fk[..., 0] * Bk[..., 0] / tot[:, :, None]
        Xc, Yc = R["Xc"][:, 2:2 + n], R["Yc"][:, 2:2 + n]
        keep = R["valid"][:, 2:2 + n] & (Xc >= 1) & (Yc >= 1) & (post >= threshold)
        kept.append((keep.nonzero(as_tuple=True)[0], Xc[keep], Yc[keep],
                     post[keep]))
    b, xs, ys, ps = (torch.cat(a).cpu() for a in zip(*kept))
    ps = ps.double()
    return [(xs[b == i].numpy(), ys[b == i].numpy(), ps[b == i].numpy())
            for i in range(B)]
