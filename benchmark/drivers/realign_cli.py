"""Drives ``cpecan_tpu_torch.cli.realign.main`` as a user pipes a cigar
stream into it: the configuration's arguments, the fasta written once,
and a stdin that hands out the pool's cigar lines in turn until the
window's time is up. The CLI reads stdin lazily (a group of
``--batchPairs`` ahead, on its prefetch), so the window ends when the
CLI has written every record it read.

The timed path's output is every cigar line the CLI wrote; ``check``
compares a sample of them, drawn from the seed and with the longest
record in it, with the reference.
"""

from __future__ import annotations

import io
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.lib.common import model_of, sync
from benchmark.reference import cigar as ref_cigar
from benchmark.reference import fb as ref_fb
from benchmark.reference import records as ref_records
from benchmark.reference import state_machine as ref_sm


class _Lines:
    """A stdin of the pool's lines, cycled, that ends once ``seconds``
    have passed since its first line was read; notes when each line was
    read."""

    def __init__(self, lines, seconds: float):
        self.lines, self.seconds = lines, seconds
        self.read_at = []
        self.deadline = None

    def __iter__(self):
        return self

    def __next__(self):
        now = time.perf_counter()
        if self.deadline is None:
            self.deadline = now + self.seconds
        elif now >= self.deadline:
            raise StopIteration
        self.read_at.append(now)
        return self.lines[(len(self.read_at) - 1) % len(self.lines)]


class _Sink:
    """A stdout that keeps what was written and when."""

    def __init__(self):
        self.text, self.at = [], []

    def write(self, s):
        self.text.append(s)
        self.at.append(time.perf_counter())
        return len(s)

    def flush(self):
        pass


class Driver:
    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.settings = cell.config["settings"]
        self.failed = 0

    def setup(self):
        from cpecan_tpu_torch.cli import realign

        gen = self.cell.generator()
        self.seqs, self.records = gen.generate(self.cell.traffic, self.seed)
        self.lines = [gen.cigar_line(r) + "\n" for r in self.records]
        self.qbases = np.array([gen.query_bases(r) for r in self.records])
        self.workdir = tempfile.mkdtemp(prefix="bench-realign-",
                                        dir=os.environ.get("TMPDIR"))
        fasta = os.path.join(self.workdir, "seqs.fa")
        with open(fasta, "w") as fh:
            for name, seq in self.seqs.items():
                fh.write(f">{name}\n{seq}\n")
        self.argv = ([fasta] + list(self.cell.config.get("argv", []))
                     + ["--device", self.device])
        # warm-up: one batch through the same entry point
        warm = "".join(self.lines[:int(self.settings["batchPairs"])])
        realign.main(self.argv, stdin=io.StringIO(warm), stdout=io.StringIO())
        sync(self.device)

    def window(self, seconds: float):
        from cpecan_tpu_torch.cli import realign

        self.src, self.sink = _Lines(self.lines, seconds), _Sink()
        with torch.profiler.record_function("realign_cli"):
            realign.main(self.argv, stdin=self.src, stdout=self.sink)
        sync(self.device)
        self.end = time.perf_counter()
        self.start = self.src.read_at[0]
        n = len(self.sink.text)
        self.attempted = len(self.src.read_at)
        self.failed = self.attempted - n
        idx = np.arange(n) % len(self.records)
        lat = np.array(self.sink.at) - np.array(self.src.read_at[:n])
        return {"window_s": self.end - self.start,
                "query_bases": int(self.qbases[idx].sum()),
                "latencies_s": lat, "records": n,
                "record_index": idx}

    def release(self):
        shutil.rmtree(self.workdir, ignore_errors=True)

    def useful_cells(self, record_index) -> int:
        """Band cells of the chunks of the records the window wrote."""
        counts = {}
        for i in np.unique(record_index):
            pa = self._input(i)
            _, _, chunks = ref_records.record_chunks(pa, self.seqs, self.settings)
            counts[i] = sum(int(np.sum(c["widths"])) for c in chunks)
        return int(sum(counts[i] for i in record_index))

    # ---------------------------------------------------------------- check

    def _input(self, i):
        return next(ref_cigar.cigar_read(io.StringIO(self.lines[i])))

    def sample(self):
        """Indices (in window order) of the written records to compare:
        the longest and a seeded draw of the others."""
        n = len(self.sink.text)
        k = min(n, int(self.cell.workload["check"]["records"]))
        if k == 0:
            return []
        q = self.qbases[np.arange(n) % len(self.records)]
        longest = int(np.argmax(q))
        rest = np.setdiff1d(np.arange(n), [longest])
        rng = np.random.default_rng([self.seed, 1])
        pick = rng.choice(rest, size=k - 1, replace=False) if k > 1 else []
        return [longest] + sorted(int(i) for i in pick)

    def reference_weights(self, pool_ids, dtype=torch.float64):
        """Per pool record: the reference's pairs (xs, ys) and their
        reweighted weights, from its posteriors computed in dtype."""
        sm = ref_sm.state_machine5()
        per, chunks = {}, []
        for i in pool_ids:
            sub_x, sub_y, cs = ref_records.record_chunks(
                self._input(i), self.seqs, self.settings)
            per[i] = (sub_x, sub_y, len(chunks), len(chunks) + len(cs))
            chunks.extend(cs)
        posts = ref_fb.posteriors(
            chunks, model_of(sm), dtype=dtype, device=self.device,
            cell_budget=int(self.cell.workload["check"].get("cell_budget",
                                                             1 << 24)))
        out = {}
        for i, (sub_x, sub_y, a, b) in per.items():
            xs, ys, ps = ref_records.pairs_from_posteriors(
                chunks[a:b], posts[a:b], self.settings["threshold"])
            w = ref_records.reweight(xs, ys, ps, len(sub_x), len(sub_y),
                                     self.settings["gapGamma"])
            out[i] = (xs, ys, w / ref_records.PROB_ONE)
        return out

    def decode(self, xs, ys, weights, floor=None):
        """The default decode of a record's weighted pairs: the heaviest
        chain among those of weight ``floor`` (matchGamma) or more."""
        keep = weights >= (self.settings["matchGamma"] if floor is None
                           else floor)
        total, chain = ref_records.heaviest_chain(xs[keep], ys[keep],
                                                  weights[keep])
        return xs[keep][chain], ys[keep][chain]

    def program_outputs(self, picks):
        """(header fields, x, y) of each picked written record."""
        out = {}
        for j in picks:
            pa = next(ref_cigar.cigar_read(io.StringIO(self.sink.text[j])))
            x, y = ref_records.cigar_pairs(pa)
            head = (pa.contig1, pa.start1, pa.end1, pa.strand1,
                    pa.contig2, pa.start2, pa.end2, pa.strand2)
            out[j] = (head, x, y)
        return out

    def check(self, outputs=None) -> list:
        """[(name, value, limit)]: records read but not written, headers
        that differ from the input record, and the chain gap: over the
        sample, the summed distance of the reference weight of each
        record's written pairs from what the reference's own decode
        allows, over the summed weight of the reference's decodes. (Each
        record's relative gap is kept in ``self.record_gaps``.)"""
        limits = self.cell.workload["check"]["limits"]
        picks = self.sample()
        n_pool = len(self.records)
        outputs = outputs or self.program_outputs(picks)
        ref = self.reference_weights(sorted({j % n_pool for j in picks}))
        bad_head, lost, total, self.record_gaps = 0, 0.0, 0.0, []
        for j in picks:
            i = j % n_pool
            head, x, y = outputs[j]
            pa = self._input(i)
            if head != (pa.contig1, pa.start1, pa.end1, pa.strand1,
                        pa.contig2, pa.start2, pa.end2, pa.strand2):
                bad_head += 1
            xs, ys, w = ref[i]
            table = dict(zip(zip(xs.tolist(), ys.tolist()), w.tolist()))
            # cPecan's decode adds a tie-break jitter in [0, JITTER) to
            # each weight: a correct decode totals between the heaviest
            # chain of weights >= matchGamma, less the jitter it may
            # trade away, and the heaviest of weights >= matchGamma -
            # JITTER
            gamma = self.settings["matchGamma"]
            bx, by = self.decode(xs, ys, w)
            best = sum(table[p] for p in zip(bx.tolist(), by.tolist()))
            low = best - ref_records.JITTER * len(bx)
            hx, hy = self.decode(xs, ys, w, gamma - ref_records.JITTER)
            high = sum(table[p] for p in zip(hx.tolist(), hy.tolist()))
            got = sum(table.get(p, 0.0) for p in zip(x.tolist(), y.tolist()))
            miss = max(0.0, low - got, got - high)
            lost += miss
            total += best
            self.record_gaps.append(miss / max(best, 1.0))
        gap = lost / max(total, 1.0)
        return [("records_missing", float(self.failed), 0.0),
                ("headers_differ", float(bad_head), 0.0),
                ("chain_gap", gap if np.isfinite(gap) else float("inf"),
                 float(limits["chain_gap"]))]

    def control_outputs(self, picks, dtype):
        """The reference in the program's place, computed in dtype: the
        outputs ``check`` compares, for the same picks."""
        n_pool = len(self.records)
        low = self.reference_weights(sorted({j % n_pool for j in picks}), dtype)
        out = {}
        for j in picks:
            pa = self._input(j % n_pool)
            xs, ys, w = low[j % n_pool]
            bx, by = self.decode(xs, ys, w)
            out[j] = ((pa.contig1, pa.start1, pa.end1, pa.strand1,
                       pa.contig2, pa.start2, pa.end2, pa.strand2), bx, by)
        return out

    def control_check(self, dtype) -> list:
        """``check`` with the reference, computed in dtype, in the
        program's place."""
        return self.check(outputs=self.control_outputs(self.sample(), dtype))
