"""Plain banded pair-HMM forward-backward: the benchmark's reference DP.

Written for the benchmark from the model's equations, not from the
program: one anti-diagonal at a time, in probability space, with every
diagonal rescaled to sum 1, as a handful of torch operations on a batch
of chunks. ``dtype`` sets the precision of every tensor (float64 for the
reference; a lower precision gives the control).

A chunk is a dict: ``sx``/``sy`` symbol arrays (0..3 bases, 4 N), the
band as ``offsets``/``widths`` per diagonal k = x + y (cells x - y =
offsets[k] + 2j, j < widths[k]), and the ragged flags ``rl``/``rr``. A
model is a dict of log-space numpy arrays: ``t_x``, ``t_m``, ``t_y``
(S, S), ``em_match`` (5, 5), ``em_gap_x``/``em_gap_y`` (5,), ``start``,
``ragged_start``, ``end``, ``ragged_end`` (S,).

Cell (x, y) is entered from (x-1, y) consuming x (class X, gap-x
emission of sx[x-1]), from (x-1, y-1) consuming both (class M, match
emission) and from (x, y-1) consuming y (class Y). F(0, 0) is the start
vector and B(lx, ly) the end vector. The posterior of cell c is
F(c)B(c)/P, with P worked out on each diagonal as the sum of F.B over
its cells plus the match steps that jump over it.
"""

from __future__ import annotations

import numpy as np
import torch

X, M, Y = 0, 1, 2  # move classes, in the order of every (..., 3) axis
STEPS = 128  # diagonals per block of the loops (one CUDA graph on the card)


def _prob_model(model: dict, dtype, device) -> dict:
    t = lambda a: torch.tensor(np.exp(np.asarray(a, np.float64)), dtype=dtype,
                               device=device)
    S = np.asarray(model["t_m"]).shape[0]
    tc = [np.exp(np.asarray(model[k], np.float64)) for k in ("t_x", "t_m", "t_y")]
    return {
        "S": S,
        # forward: rows (class, from), columns to; backward: rows (class, to)
        "T3": torch.tensor(np.concatenate(tc, 0), dtype=dtype, device=device),
        "T3b": torch.tensor(np.concatenate([a.T for a in tc], 0), dtype=dtype,
                            device=device),
        "Tc": [torch.tensor(a, dtype=dtype, device=device) for a in tc],
        "em_match": t(model["em_match"]), "em_gap_x": t(model["em_gap_x"]),
        "em_gap_y": t(model["em_gap_y"]), "start": t(model["start"]),
        "ragged_start": t(model["ragged_start"]), "end": t(model["end"]),
        "ragged_end": t(model["ragged_end"]),
    }


def _groups(chunks, cell_budget: int):
    """Chunk indices in groups of similar length whose padded (chunks x
    diagonals x width) stays under cell_budget."""
    order = sorted(range(len(chunks)), key=lambda i: -len(chunks[i]["offsets"]))
    groups, cur, K, Wm = [], [], 0, 0
    for i in order:
        k, w = len(chunks[i]["offsets"]), int(np.max(chunks[i]["widths"]))
        nK, nW = max(K, k), max(Wm, w)
        if cur and (len(cur) + 1) * nK * nW > cell_budget:
            groups.append(cur)
            cur, nK, nW = [], k, w
        cur.append(i)
        K, Wm = nK, nW
    if cur:
        groups.append(cur)
    return groups


class _Group:
    """One batch of chunks laid out for the diagonal loops."""

    def __init__(self, chunks, pm: dict, dtype, device):
        B = len(chunks)
        S = pm["S"]
        L = np.array([len(c["offsets"]) - 1 for c in chunks])
        K = int(L.max()) + 1
        Wm = int(max(np.max(c["widths"]) for c in chunks))
        lxm = max(len(c["sx"]) for c in chunks)
        lym = max(len(c["sy"]) for c in chunks)
        xlo = np.zeros((B, K), np.int64)
        w = np.zeros((B, K), np.int64)
        SX = np.full((B, lxm + 1), 4, np.int64)
        SY = np.full((B, lym + 1), 4, np.int64)
        for b, c in enumerate(chunks):
            n = L[b] + 1
            ks = np.arange(n)
            xlo[b, :n] = (ks + np.asarray(c["offsets"], np.int64)) // 2
            w[b, :n] = np.asarray(c["widths"], np.int64)
            SX[b, 1:len(c["sx"]) + 1] = c["sx"]
            SY[b, 1:len(c["sy"]) + 1] = c["sy"]
        dev = device
        self.B, self.S, self.K, self.Wm = B, S, K, Wm
        self.L = torch.tensor(L, device=dev)
        xlo_t = torch.tensor(xlo, device=dev)
        w_t = torch.tensor(w, device=dev)
        j = torch.arange(Wm, device=dev)
        ks = torch.arange(K, device=dev)
        Xc = xlo_t[:, :, None] + j  # (B, K, Wm) x of each slot
        Yc = ks[None, :, None] - Xc
        valid = j[None, None, :] < w_t[:, :, None]
        self.valid = valid
        self.Xc, self.Yc = Xc, Yc
        SXt = torch.tensor(SX, device=dev)
        SYt = torch.tensor(SY, device=dev)
        xi = Xc.clamp(0, lxm).reshape(B, -1)
        yi = Yc.clamp(0, lym).reshape(B, -1)
        symx = torch.gather(SXt, 1, xi).reshape(B, K, Wm)
        symy = torch.gather(SYt, 1, yi).reshape(B, K, Wm)
        self.symx, self.symy = symx, symy
        okx = valid & (Xc >= 1)
        oky = valid & (Yc >= 1)
        zero = torch.zeros((), dtype=dtype, device=dev)
        E = torch.stack([
            torch.where(okx, pm["em_gap_x"][symx], zero),
            torch.where(okx & oky, pm["em_match"][symx, symy], zero),
            torch.where(oky, pm["em_gap_y"][symy], zero)], dim=-1)
        self.E = E  # (B, K, Wm, 3): emission of entering each cell by class

        def shifted(a, d, fill):
            out = torch.full_like(a, fill)
            out[:, d:] = a[:, :K - d] if d > 0 else a
            return out

        def up(a, d, fill):
            out = torch.full_like(a, fill)
            out[:, :K - d] = a[:, d:]
            return out

        pad = Wm  # index of the zero slot of the first row of a view
        # forward sources, in the view (diag k-2 row, diag k-1 row)
        xlo1, w1 = shifted(xlo_t, 1, 0), shifted(w_t, 1, 0)
        xlo2, w2 = shifted(xlo_t, 2, 0), shifted(w_t, 2, 0)
        jx = Xc - 1 - xlo1[:, :, None]
        jy = Xc - xlo1[:, :, None]
        jm = Xc - 1 - xlo2[:, :, None]
        vx = okx & (jx >= 0) & (jx < w1[:, :, None])
        vy = oky & (jy >= 0) & (jy < w1[:, :, None])
        vm = okx & oky & (jm >= 0) & (jm < w2[:, :, None])
        self.IDX = torch.stack([
            torch.where(vx, Wm + 1 + jx, pad),
            torch.where(vm, jm, pad),
            torch.where(vy, Wm + 1 + jy, pad)], dim=-1)
        self.fvalid = torch.stack([vx, vm, vy], dim=-1)
        # backward targets, in the view (diag k+1 row, diag k+2 row)
        xlo1u, w1u = up(xlo_t, 1, 0), up(w_t, 1, 0)
        xlo2u, w2u = up(xlo_t, 2, 0), up(w_t, 2, 0)
        tx = Xc + 1 - xlo1u[:, :, None]
        ty = Xc - xlo1u[:, :, None]
        tm = Xc + 1 - xlo2u[:, :, None]
        ux = valid & (tx >= 0) & (tx < w1u[:, :, None])
        uy = valid & (ty >= 0) & (ty < w1u[:, :, None])
        um = valid & (tm >= 0) & (tm < w2u[:, :, None])
        self.IDXB = torch.stack([
            torch.where(ux, tx, pad),
            torch.where(um, Wm + 1 + tm, pad),
            torch.where(uy, ty, pad)], dim=-1)
        # the emission of each target, by class
        Epad = torch.cat([E, torch.zeros_like(E[:, :2])], dim=1)  # K+2 rows
        Epad = torch.cat([Epad, torch.zeros_like(Epad[:, :, :1])], dim=2)
        bi = torch.arange(B, device=dev)[:, None, None]
        kk = ks[None, :, None]
        EB = torch.stack([
            Epad[bi, kk + 1, torch.where(ux, tx, Wm), X],
            Epad[bi, kk + 2, torch.where(um, tm, Wm), M],
            Epad[bi, kk + 1, torch.where(uy, ty, Wm), Y]], dim=-1)
        self.EB = torch.where(torch.stack([ux, um, uy], -1), EB, zero)
        # start and end rows
        start = torch.stack([pm["ragged_start"] if c["rl"] else pm["start"]
                             for c in chunks])
        end = torch.stack([pm["ragged_end"] if c["rr"] else pm["end"]
                           for c in chunks])
        self.start, self.end = start, end
        lx = torch.tensor([len(c["sx"]) for c in chunks], device=dev)
        self.end_slot = lx - xlo_t[torch.arange(B, device=dev), self.L]
        self.dtype, self.device = dtype, dev

    def _runner(self, body):
        """body, run once per block of STEPS diagonals. On the card it is
        captured once as a CUDA graph and replayed: the same operations
        without the host's launch cost per diagonal."""
        if torch.device(self.device).type != "cuda":
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

    def forward(self, pm):
        """Scaled forward values of every cell, (B, K, Wm, S), and each
        diagonal's scale, (B, K). Diagonals run in blocks of STEPS through
        a ring of rows: ring[i + 2] is diagonal k0 + i."""
        B, S, K, Wm, C = self.B, self.S, self.K, self.Wm, STEPS
        dt, dev = self.dtype, self.device
        one = torch.ones((), dtype=dt, device=dev)
        T3 = pm["T3"]
        IDX = self.IDX.reshape(B, K, Wm * 3)
        ring = torch.zeros(B, C + 2, Wm + 1, S, dtype=dt, device=dev)
        idx_s = torch.full((B, C, Wm * 3), Wm, dtype=torch.long, device=dev)
        e_s = torch.zeros(B, C, Wm, 3, 1, dtype=dt, device=dev)
        s_s = torch.ones(B, C, dtype=dt, device=dev)
        # the match step reads diagonal k-2, one rescale further back
        back = torch.ones(B, 1, 3, 1, dtype=dt, device=dev)

        def body():
            for i in range(C):
                view = ring[:, i:i + 2].reshape(B, 2 * (Wm + 1), S)
                g = torch.gather(view, 1,
                                 idx_s[:, i, :, None].expand(B, Wm * 3, S))
                g = g.reshape(B, Wm, 3, S) * (e_s[:, i] * back)
                new = torch.matmul(g.reshape(B, Wm, 3 * S), T3)
                s = new.sum(dim=(1, 2))
                s = torch.where(s > 0, s, one)
                ring[:, i + 2, :Wm] = new / s[:, None, None]
                s_s[:, i] = s
                back[:, 0, M, 0] = 1 / s

        run = self._runner(body)
        F = torch.zeros(B, K, Wm, S, dtype=dt, device=dev)
        sF = torch.ones(B, K, dtype=dt, device=dev)
        s0 = self.start.sum(-1)
        ring.zero_()
        ring[:, 1, 0] = self.start / s0[:, None]
        F[:, 0] = ring[:, 1, :Wm]
        sF[:, 0] = s0
        back.fill_(1)
        back[:, 0, M, 0] = 1 / s0
        for k0 in range(1, K, C):
            n = min(C, K - k0)
            idx_s[:, :n] = IDX[:, k0:k0 + n]
            idx_s[:, n:] = Wm
            e_s[:, :n] = self.E[:, k0:k0 + n, :, :, None]
            e_s[:, n:] = 0
            run()
            F[:, k0:k0 + n] = ring[:, 2:2 + n, :Wm]
            sF[:, k0:k0 + n] = s_s[:, :n]
            ring[:, 0:2] = ring[:, C:C + 2].clone()
        return F, sF

    def backward(self, pm):
        """Scaled backward values, (B, K, Wm, S), and scales, (B, K).
        Diagonals run from the last down, in blocks of STEPS through a
        ring: ring[i] is diagonal k1 - STEPS + i, ring[STEPS] and
        ring[STEPS + 1] the two above the block."""
        B, S, K, Wm, C = self.B, self.S, self.K, self.Wm, STEPS
        dt, dev = self.dtype, self.device
        one = torch.ones((), dtype=dt, device=dev)
        T3b = pm["T3b"]
        IDXB = self.IDXB.reshape(B, K, Wm * 3)
        endrow = torch.zeros(B, Wm, S, dtype=dt, device=dev)
        endrow[torch.arange(B, device=dev), self.end_slot] = self.end
        endflag = (torch.arange(K, device=dev)[None, :] == self.L[:, None]).to(dt)
        ring = torch.zeros(B, C + 2, Wm + 1, S, dtype=dt, device=dev)
        idx_s = torch.full((B, C, Wm * 3), Wm, dtype=torch.long, device=dev)
        e_s = torch.zeros(B, C, Wm, 3, 1, dtype=dt, device=dev)
        end_s = torch.zeros(B, C, dtype=dt, device=dev)
        s_s = torch.ones(B, C, dtype=dt, device=dev)
        back = torch.ones(B, 1, 3, 1, dtype=dt, device=dev)

        def body():
            for i in range(C - 1, -1, -1):
                view = ring[:, i + 1:i + 3].reshape(B, 2 * (Wm + 1), S)
                g = torch.gather(view, 1,
                                 idx_s[:, i, :, None].expand(B, Wm * 3, S))
                g = g.reshape(B, Wm, 3, S) * (e_s[:, i] * back)
                new = torch.matmul(g.reshape(B, Wm, 3 * S), T3b)
                new = new + endrow * end_s[:, i, None, None]
                r = new.sum(dim=(1, 2))
                r = torch.where(r > 0, r, one)
                ring[:, i, :Wm] = new / r[:, None, None]
                s_s[:, i] = r
                back[:, 0, M, 0] = 1 / r

        run = self._runner(body)
        Bm = torch.zeros(B, K, Wm, S, dtype=dt, device=dev)
        sB = torch.ones(B, K, dtype=dt, device=dev)
        ring.zero_()
        back.fill_(1)
        k1 = K
        while k1 > 0:
            lo = max(0, k1 - C)
            off = C - (k1 - lo)
            idx_s[:, off:] = IDXB[:, lo:k1]
            idx_s[:, :off] = Wm
            e_s[:, off:] = self.EB[:, lo:k1, :, :, None]
            e_s[:, :off] = 0
            end_s[:, off:] = endflag[:, lo:k1]
            end_s[:, :off] = 0
            run()
            Bm[:, lo:k1] = ring[:, off:C, :Wm]
            sB[:, lo:k1] = s_s[:, off:]
            ring[:, C:C + 2] = ring[:, off:off + 2].clone()
            k1 = lo
        return Bm, sB

    def _sources(self, F, k0, k1):
        """F at the X, M and Y sources of the cells of diagonals k0..k1-1:
        (B, n, Wm, 3, S)."""
        B, S, Wm = self.B, self.S, self.Wm
        Fp = torch.cat([torch.zeros_like(F[:, :2]), F], dim=1)  # row k+2 = diag k
        Fp = torch.cat([Fp, torch.zeros_like(Fp[:, :, :1])], dim=2)
        n = k1 - k0
        idx = self.IDX[:, k0:k1]  # view (diag k-2 row, diag k-1 row)
        row = torch.where(idx >= Wm + 1, 1, 0)
        slot = torch.where(idx >= Wm + 1, idx - (Wm + 1), idx)
        kk = torch.arange(k0, k1, device=F.device)[None, :, None, None]
        bi = torch.arange(B, device=F.device)[:, None, None, None]
        return Fp[bi, kk + row, slot]  # (B, n, Wm, 3, S)

    def _targets(self, Bm, k0, k1):
        """B at the X, M and Y targets of the cells of diagonals k0..k1-1,
        times the target's emission: (B, n, Wm, 3, S)."""
        B, Wm = self.B, self.Wm
        Bp = torch.cat([Bm, torch.zeros_like(Bm[:, :2])], dim=1)
        Bp = torch.cat([Bp, torch.zeros_like(Bp[:, :, :1])], dim=2)
        idx = self.IDXB[:, k0:k1]  # view (diag k+1 row, diag k+2 row)
        row = torch.where(idx >= Wm + 1, 2, 1)
        slot = torch.where(idx >= Wm + 1, idx - (Wm + 1), idx)
        kk = torch.arange(k0, k1, device=Bm.device)[None, :, None, None]
        bi = torch.arange(B, device=Bm.device)[:, None, None, None]
        return Bp[bi, kk + row, slot] * self.EB[:, k0:k1, :, :, None]

    def totals(self, pm, F, sF, Bm, sB, block: int):
        """Per diagonal, P in the diagonal's scaled units: (B, K)."""
        B, K = self.B, self.K
        tot = torch.zeros(B, K, dtype=self.dtype, device=self.device)
        Tm = pm["Tc"][M]
        for k0 in range(0, K, block):
            k1 = min(K, k0 + block)
            dot = (F[:, k0:k1] * Bm[:, k0:k1]).sum(dim=(2, 3))
            # match steps from diagonal k-1 to k+1
            ka, kb = max(k0 - 1, 0), k1 - 1
            bridge = torch.zeros(B, k1 - k0, dtype=self.dtype, device=self.device)
            if kb > ka:
                tgt = self._targets(Bm, ka, kb)[:, :, :, M]  # (B, n, Wm, S)
                q = torch.matmul(tgt, Tm.T)  # sum over to: (B, n, Wm, S from)
                br = (F[:, ka:kb] * q).sum(dim=(2, 3))
                off = ka + 1 - k0
                bridge[:, off:off + (kb - ka)] = br
            tot[:, k0:k1] = dot + bridge / (sF[:, k0:k1] * sB[:, k0:k1])
        # diagonals past a chunk's end hold nothing: 1 keeps 0/0 out
        return torch.where(tot > 0, tot, torch.ones_like(tot))


def _log_p(g: _Group, F, sF):
    """log P from the forward alone: the end vector at (lx, ly), float64."""
    bi = torch.arange(g.B, device=g.device)
    FL = F[bi, g.L, g.end_slot]  # (B, S)
    cum = torch.log(sF.double())
    mask = torch.arange(g.K, device=g.device)[None, :] <= g.L[:, None]
    return (torch.log((FL * g.end).sum(-1).double())
            + (cum * mask).sum(-1))


def posteriors(chunks, model, dtype=torch.float64, device="cpu",
               cell_budget: int = 1 << 24, block: int = 2048):
    """Match posteriors of every band cell with x, y >= 1, per chunk:
    a list of (x, y, post) numpy arrays in chunk coordinates (cell (x, y)
    aligns sx[x-1] with sy[y-1])."""
    pm = _prob_model(model, dtype, device)
    out = [None] * len(chunks)
    for idx in _groups(chunks, cell_budget):
        g = _Group([chunks[i] for i in idx], pm, dtype, device)
        F, sF = g.forward(pm)
        Bm, sB = g.backward(pm)
        tot = g.totals(pm, F, sF, Bm, sB, block)
        post = F[..., 0] * Bm[..., 0] / tot[:, :, None]
        keep = g.valid & (g.Xc >= 1) & (g.Yc >= 1)
        for b, i in enumerate(idx):
            kb = keep[b]
            out[i] = (g.Xc[b][kb].cpu().numpy(), g.Yc[b][kb].cpu().numpy(),
                      post[b][kb].double().cpu().numpy())
    return out


def expectations(chunks, model, dtype=torch.float64, device="cpu",
                 cell_budget: int = 1 << 24, block: int = 1024):
    """Expected transition counts (S, S), emission counts (S, 4, 4) summed
    over the chunks, and the likelihood: the sum over chunks of
    (lx + ly) log P, as the per-diagonal sum of log P that cPecan
    accumulates. Counts are float64 numpy."""
    pm = _prob_model(model, dtype, device)
    S = pm["S"]
    trans = torch.zeros(S, S, dtype=torch.float64, device=device)
    emis = torch.zeros(S, 16, dtype=torch.float64, device=device)
    like = 0.0
    for idx in _groups(chunks, cell_budget):
        g = _Group([chunks[i] for i in idx], pm, dtype, device)
        F, sF = g.forward(pm)
        Bm, sB = g.backward(pm)
        tot = g.totals(pm, F, sF, Bm, sB, block)
        like += float((g.L.double() * _log_p(g, F, sF)).sum())
        sprev = torch.cat([torch.ones_like(sF[:, :1]), sF[:, :-1]], dim=1)
        for k0 in range(1, g.K, block):
            k1 = min(g.K, k0 + block)
            src = g._sources(F, k0, k1) * g.fvalid[:, k0:k1, :, :, None]
            denom = tot[:, k0:k1] * sF[:, k0:k1]
            d = torch.stack([denom, denom * sprev[:, k0:k1], denom], dim=-1)
            # E_c(cell) B(cell, to) / (tot D_c): (B, n, Wm, 3, S)
            right = (g.E[:, k0:k1, :, :, None] * Bm[:, k0:k1, :, None, :]
                     / d[:, :, None, :, None])
            for c in (X, M, Y):
                a = src[:, :, :, c].reshape(-1, S)
                bb = right[:, :, :, c].reshape(-1, S)
                trans += (torch.matmul(a.T, bb) * pm["Tc"][c]).double()
            # per cell and target state: sum over classes and sources
            q = sum(torch.matmul(src[:, :, :, c], pm["Tc"][c]) * right[:, :, :, c]
                    for c in (X, M, Y))  # (B, n, Wm, S)
            sx, sy = g.symx[:, k0:k1], g.symy[:, k0:k1]
            ok = ((sx < 4) & (sy < 4) & (g.Xc[:, k0:k1] >= 1)
                  & (g.Yc[:, k0:k1] >= 1) & g.valid[:, k0:k1])
            sidx = (sx * 4 + sy)[ok]
            emis.index_add_(1, sidx, q[ok].T.double())
    return (trans.cpu().numpy(), emis.reshape(S, 4, 4).cpu().numpy(), like)
