"""Drives the iteration loop of ``cpecan_tpu_torch.em.em.
expectation_maximisation`` over an in-memory corpus: one call per
iteration, each continuing from the model file the last one wrote
(``inputModel``), as cPecanEm's loop carries its model from one
iteration to the next. Each call splits and samples the corpus, turns
every cigar into expectation tasks, runs the expectation step, the
maximisation step and writes the model.

Set-up runs the first ``check.steps`` iterations through the same call
(the first also warms every shape); the window runs the ones after
them. A wrapper around ``maximisation_step`` keeps a copy of the summed
expected counts and likelihood that each iteration hands to it, before
it normalises them: ``check`` compares those, and the model each
iteration wrote, for the set-up's iterations and the window's first,
with the reference, which follows as many iterations from its own
start.
"""

from __future__ import annotations

import dataclasses
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
from benchmark.reference import hmm as ref_hmm
from benchmark.reference import records as ref_records
from benchmark.reference import state_machine as ref_sm


def _worst_gap(got, want) -> float:
    """Widest |got - want| of any entry, against the larger of the
    entry's |want| and the median |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = np.median(np.abs(want))
    gap = np.abs(got - want) / np.maximum(np.abs(want), floor)
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else float("inf")


class Driver:
    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.settings = cell.config["settings"]
        self.failed = 0
        self.steps = []  # (transitions, emissions, likelihood, model) per call

    def setup(self):
        from cpecan_tpu_torch.em import em as em_mod
        from cpecan_tpu_torch.io import cigar as cigar_io

        gen = self.cell.generator()
        self.seqs, self.records = gen.generate(self.cell.traffic, self.seed)
        self.lines = [gen.cigar_line(r) + "\n" for r in self.records]
        self.qbases = int(sum(gen.query_bases(r) for r in self.records))
        self.cigars = list(cigar_io.cigar_read(io.StringIO("".join(self.lines))))
        self.workdir = tempfile.mkdtemp(prefix="bench-em-",
                                        dir=os.environ.get("TMPDIR"))
        self.model_path = os.path.join(self.workdir, "hmm.txt")
        s = self.settings
        self.options = em_mod.EmOptions(
            iterations=1, diagonalExpansion=s["diagonalExpansion"],
            splitMatrixBiggerThanThis=s["splitMatrixBiggerThanThis"],
            maxAlignmentLengthPerJob=s["maxAlignmentLengthPerJob"],
            maxAlignmentLengthToSample=s["maxAlignmentLengthToSample"])
        self._original = em_mod.maximisation_step
        em_mod.maximisation_step = self._recording
        self.check_steps = int(self.cell.workload["check"]["steps"])
        for _ in range(self.check_steps):
            self._iteration()

    def _recording(self, expectations, old_model, options):
        kept = (expectations.transitions.copy(), expectations.emissions.copy(),
                float(expectations.likelihood))
        new = self._original(expectations, old_model, options)
        self.steps.append(kept + ((new.transitions.copy(),
                                   new.emissions.copy()),))
        return new

    def _iteration(self):
        from cpecan_tpu_torch.em import em as em_mod

        first = not os.path.exists(self.model_path)
        opts = dataclasses.replace(
            self.options, inputModel=None if first else self.model_path)
        with torch.profiler.record_function("em_iteration"):
            em_mod.expectation_maximisation(self.seqs, self.cigars,
                                            self.model_path, opts,
                                            device=self.device)
        sync(self.device)

    def window(self, seconds: float):
        self.start = time.perf_counter()
        n = 0
        while True:
            self._iteration()
            n += 1
            self.end = time.perf_counter()
            if self.end - self.start >= seconds:
                break
        self.attempted = n
        return {"window_s": self.end - self.start, "iterations": n,
                "query_bases": self.qbases * n}

    def release(self):
        from cpecan_tpu_torch.em import em as em_mod

        em_mod.maximisation_step = self._original
        shutil.rmtree(self.workdir, ignore_errors=True)

    def _tasks(self):
        cigars = list(ref_cigar.cigar_read(io.StringIO("".join(self.lines))))
        return ref_records.tasks_of_corpus(cigars, self.seqs, self.settings)

    def useful_cells(self, iterations: int) -> int:
        return iterations * sum(int(np.sum(t["widths"])) for t in self._tasks())

    def reference_steps(self, dtype=torch.float64):
        """The first check.steps + 1 iterations (the set-up's and the
        window's first) worked out by the reference from its own starting
        model: [(transitions, emissions, likelihood, (model transitions,
        model emissions))]."""
        tasks = self._tasks()
        kind = ref_hmm.StateMachineType[self.settings["modelType"]]
        model = ref_hmm.Hmm(kind)
        model.equalise()
        out = []
        budget = int(self.cell.workload["check"].get("cell_budget", 1 << 24))
        for _ in range(self.check_steps + 1):
            sm = ref_sm.state_machine_from_hmm(model)
            trans, emis, like = ref_fb.expectations(
                tasks, model_of(sm), dtype=dtype, device=self.device,
                cell_budget=budget)
            counts = ref_hmm.Hmm(kind, pseudo_expectation=1e-12)
            counts.transitions += trans
            counts.emissions += emis
            counts.likelihood = like
            kept = (counts.transitions.copy(), counts.emissions.copy(), like)
            counts.normalise()
            counts.emissions = model.emissions.copy()  # trainEmissions off
            out.append(kept + ((counts.transitions.copy(),
                                counts.emissions.copy()),))
            model = counts
        return out

    def check(self, steps=None) -> list:
        """[(name, value, limit)] over the checked iterations: the widest
        gap of an expected count (transitions and emissions), of the
        likelihood, and of the model's transitions after the step."""
        limits = self.cell.workload["check"]["limits"]
        got = steps if steps is not None else self.steps[:self.check_steps + 1]
        want = self.reference_steps()
        if len(got) < len(want):
            return [("steps_missing", float(len(want) - len(got)), 0.0)]
        count = like = model = 0.0
        for g, w in zip(got, want):
            count = max(count, _worst_gap(g[0], w[0]), _worst_gap(g[1], w[1]))
            lg = abs(g[2] - w[2]) / abs(w[2])
            like = max(like, lg if np.isfinite(lg) else float("inf"))
            model = max(model, _worst_gap(g[3][0], w[3][0]))
        return [("count_gap", count, float(limits["count_gap"])),
                ("likelihood_gap", like, float(limits["likelihood_gap"])),
                ("model_gap", model, float(limits["model_gap"]))]

    def control_check(self, dtype) -> list:
        """``check`` with the reference, computed in dtype, in the
        program's place."""
        return self.check(steps=self.reference_steps(dtype))
