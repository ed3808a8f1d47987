"""Drives ``cpecan_tpu_torch.cli.align.main`` as cPecanAlign is deployed
on orthologous pairs: one invocation per pair, a target fasta and a
query fasta of one sequence each, every flag at its default, the
cigars on stdout. Set-up writes the pool's fastas once and runs one
pair through the same entry point; the window runs the pool's pairs in
turn and ends at the first pair boundary after its time is up.

The timed path's output is each invocation's stdout; ``check`` compares
two of them, the pair that ran longest and one drawn from the seed,
with the reference (reference/align_records.py).
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
from benchmark.reference import align_records as ref_align
from benchmark.reference import cigar as ref_cigar
from benchmark.reference import records as ref_records
from benchmark.reference import state_machine as ref_sm


class Driver:
    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.settings = cell.config["settings"]
        self.failed = 0
        self._chunks = {}

    def setup(self):
        from cpecan_tpu_torch.cli import align

        gen = self.cell.generator()
        self.seqs, self.records = gen.generate(self.cell.traffic, self.seed)
        self.qbases = np.array([gen.query_bases(r) for r in self.records])
        self.workdir = tempfile.mkdtemp(prefix="bench-align-",
                                        dir=os.environ.get("TMPDIR"))
        self.argvs = []
        for i, r in enumerate(self.records):
            files = []
            for side, name in (("target", r["contig1"]), ("query", r["contig2"])):
                path = os.path.join(self.workdir, f"{side}{i}.fa")
                with open(path, "w") as fh:
                    fh.write(f">{name}\n{self.seqs[name]}\n")
                files.append(path)
            self.argvs.append(files + list(self.cell.config.get("argv", []))
                              + ["--device", self.device])
        # warm-up: one pair through the same entry point
        align.main(self.argvs[0], stdout=io.StringIO())
        sync(self.device)

    def window(self, seconds: float):
        from cpecan_tpu_torch.cli import align

        self.outputs, lat, idx = [], [], []
        start = time.perf_counter()
        deadline = start + seconds
        while not idx or time.perf_counter() < deadline:
            i = len(idx) % len(self.records)
            sink = io.StringIO()
            t0 = time.perf_counter()
            with torch.profiler.record_function("align_cli"):
                align.main(self.argvs[i], stdout=sink)
            lat.append(time.perf_counter() - t0)
            self.outputs.append(sink.getvalue())
            idx.append(i)
        sync(self.device)
        self.end = time.perf_counter()
        self.record_index = np.array(idx)
        self.latencies = np.array(lat)
        self.attempted = len(idx)
        self.failed = sum(1 for o in self.outputs if "cigar:" not in o)
        return {"window_s": self.end - start,
                "query_bases": int(self.qbases[self.record_index].sum()),
                "latencies_s": self.latencies, "records": len(idx),
                "record_index": self.record_index}

    def release(self):
        shutil.rmtree(self.workdir, ignore_errors=True)

    def _pair(self, i):
        r = self.records[i]
        return self.seqs[r["contig1"]], self.seqs[r["contig2"]]

    def chunks(self, i):
        """The reference's chunks of pool pair i (anchors, split, bands)."""
        if i not in self._chunks:
            self._chunks[i] = ref_align.pair_chunks(*self._pair(i),
                                                    self.settings)
        return self._chunks[i]

    def useful_cells(self, record_index) -> int:
        """Band cells of the chunks of the pairs the window aligned."""
        counts = {int(i): ref_align.band_cells(self.chunks(int(i)))
                  for i in np.unique(record_index)}
        return int(sum(counts[int(i)] for i in record_index))

    # ---------------------------------------------------------------- check

    def sample(self):
        """Indices (in window order) of the invocations to compare: the
        one that ran longest and a seeded draw of the others."""
        n = len(self.outputs)
        k = min(n, int(self.cell.workload["check"]["records"]))
        if k == 0:
            return []
        longest = int(np.argmax(self.latencies))
        rest = np.setdiff1d(np.arange(n), [longest])
        rng = np.random.default_rng([self.seed, 1])
        pick = rng.choice(rest, size=k - 1, replace=False) if k > 1 else []
        return [longest] + sorted(int(i) for i in pick)

    def reference_weights(self, pool_ids, dtype=torch.float64):
        """Per pool pair: the reference's pairs (xs, ys) and their
        reweighted weights, from its posteriors computed in dtype."""
        model = model_of(ref_sm.state_machine5())
        got = ref_align.weighted_pairs(
            [self._pair(i) for i in pool_ids], model, self.settings,
            dtype=dtype, device=self.device,
            chunks=[self.chunks(i) for i in pool_ids],
            cell_budget=int(self.cell.workload["check"]["cell_budget"]))
        return dict(zip(pool_ids, got))

    def _header(self, i):
        r = self.records[i]
        return (r["contig1"], 0, len(self.seqs[r["contig1"]]), True,
                r["contig2"], 0, len(self.seqs[r["contig2"]]), True)

    def program_outputs(self, picks):
        """(header fields, x, y) of each picked invocation's cigar, or
        None where it wrote none."""
        out = {}
        for j in picks:
            got = list(ref_cigar.cigar_read(io.StringIO(self.outputs[j])))
            if len(got) != 1:
                out[j] = None
                continue
            pa = got[0]
            x, y = ref_records.cigar_pairs(pa)
            out[j] = ((pa.contig1, pa.start1, pa.end1, pa.strand1,
                       pa.contig2, pa.start2, pa.end2, pa.strand2), x, y)
        return out

    def check(self, outputs=None) -> list:
        """[(name, value, limit)]: invocations that wrote no cigar, picked
        cigars whose header is not the pair's, and the chain gap: over
        the picks, the summed distance of the reference weight of each
        written chain from what the reference's own decode allows, over
        the summed weight of the reference's decodes (each pick's own in
        ``self.record_gaps``)."""
        limits = self.cell.workload["check"]["limits"]
        picks = self.sample()
        outputs = outputs or self.program_outputs(picks)
        pool = sorted({int(self.record_index[j]) for j in picks})
        ref = self.reference_weights(pool)
        gamma = self.settings["matchGamma"]
        bad_head, lost, total, self.record_gaps = 0, 0.0, 0.0, []
        for j in picks:
            i = int(self.record_index[j])
            xs, ys, w = ref[i]
            table = dict(zip(zip(xs.tolist(), ys.tolist()), w.tolist()))
            # cPecan's decode adds a tie-break jitter in [0, JITTER) to
            # each weight: a correct decode totals between the heaviest
            # chain of weights >= matchGamma, less the jitter it may
            # trade away, and the heaviest of weights >= matchGamma -
            # JITTER
            bx, by = ref_align.decode(xs, ys, w, gamma)
            best = sum(table[p] for p in zip(bx.tolist(), by.tolist()))
            low = best - ref_records.JITTER * len(bx)
            hx, hy = ref_align.decode(xs, ys, w, gamma - ref_records.JITTER)
            high = sum(table[p] for p in zip(hx.tolist(), hy.tolist()))
            if outputs[j] is None:
                got = 0.0
                bad_head += 1
            else:
                head, x, y = outputs[j]
                bad_head += head != self._header(i)
                got = sum(table.get(p, 0.0) for p in zip(x.tolist(), y.tolist()))
            miss = max(0.0, low - got, got - high)
            lost += miss
            total += best
            self.record_gaps.append(miss / max(best, 1.0))
        gap = lost / max(total, 1.0)
        return [("records_missing", float(self.failed),
                 float(limits["records_missing"])),
                ("headers_differ", float(bad_head),
                 float(limits["headers_differ"])),
                ("chain_gap", gap if np.isfinite(gap) else float("inf"),
                 float(limits["chain_gap"]))]

    def control_outputs(self, picks, dtype):
        """The reference in the program's place, computed in dtype: the
        outputs ``check`` compares, for the same picks."""
        pool = sorted({int(self.record_index[j]) for j in picks})
        low = self.reference_weights(pool, dtype)
        out = {}
        for j in picks:
            i = int(self.record_index[j])
            bx, by = ref_align.decode(*low[i], self.settings["matchGamma"])
            out[j] = (self._header(i), bx, by)
        return out

    def control_check(self, dtype) -> list:
        """``check`` with the reference, computed in dtype, in the
        program's place."""
        return self.check(outputs=self.control_outputs(self.sample(), dtype))
