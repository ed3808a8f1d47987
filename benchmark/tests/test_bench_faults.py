"""The check catches a broken timed path: each cell's run, on the CPU at
a small size with the chip look skipped, with one fault planted in the
program underneath, comes out not correct. One test per fault that the
cell can have:

- an answer altered where it is produced;
- half of the batch left out (for EM, the counts of the other half
  doubled: the mean taken over the rest);
- a step that returns its state unchanged (EM; the realign CLI keeps no
  state from one record to the next);
- a state that goes wrong only in the window (EM: from the third call
  on, the model file is not read and training starts over);
- the exchange between chips left out does not apply: every cell runs
  on one chip.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark.lib import harness  # noqa: E402
from test_bench_harness import small_cell  # noqa: E402


def _run(tmp_path, name, every_record=False):
    cell = small_cell(tmp_path, name)
    if every_record:
        cell.workload["check"]["records"] = 10_000
    return harness.run_cell(cell, 2**31 + 9, 0.5, False, device="cpu")


def _realign_shift(monkeypatch):
    """Every decoded pair moved one base along x."""
    from cpecan_tpu_torch.cli import realign

    original = realign.filter_pairwise_alignment_to_make_pairs_ordered

    def shifted(aligned, seq_x, seq_y, gamma):
        out = original(aligned, seq_x, seq_y, gamma).copy()
        out["x"] += 1
        return out[out["x"] < len(seq_x)]

    monkeypatch.setattr(realign, "filter_pairwise_alignment_to_make_pairs_ordered",
                        shifted)


def _realign_half(monkeypatch):
    """Every other record of a batch is left out of the device batch."""
    from cpecan_tpu_torch.align import batch
    from cpecan_tpu_torch.ops import pairs

    original = batch.get_aligned_pairs_batch

    def half(sm, jobs, p, device="cuda", mesh=None):
        got = original(sm, jobs[::2], p, device=device, mesh=mesh)
        return [got[i // 2] if i % 2 == 0 else pairs.empty_pairs()
                for i in range(len(jobs))]

    monkeypatch.setattr(batch, "get_aligned_pairs_batch", half)


def _em_unchanged(monkeypatch):
    from cpecan_tpu_torch.em import em

    monkeypatch.setattr(em, "maximisation_step",
                        lambda expectations, old, options: old)


def _em_restarts_in_the_window(monkeypatch):
    """From the window's first iteration on, each call starts again from
    the initial model instead of the one the call before wrote."""
    import dataclasses

    from cpecan_tpu_torch.em import em

    original = em.expectation_maximisation
    calls = []

    def restart(seqs, cigars, path, options, **kwargs):
        calls.append(1)
        if len(calls) > 2:
            options = dataclasses.replace(options, inputModel=None)
        return original(seqs, cigars, path, options, **kwargs)

    monkeypatch.setattr(em, "expectation_maximisation", restart)


def _em_half(monkeypatch):
    from cpecan_tpu_torch.em import em

    original = em.expectation_step

    def half(sm, tasks, p, hmm, mesh=None, device="cuda"):
        from cpecan_tpu_torch.models.hmm import Hmm

        part = Hmm(hmm.type)
        original(sm, tasks[::2], p, part, mesh=mesh, device=device)
        hmm.transitions += 2 * part.transitions
        hmm.emissions += 2 * part.emissions
        hmm.likelihood += 2 * part.likelihood

    monkeypatch.setattr(em, "expectation_step", half)


def _em_altered(monkeypatch):
    """One expected count altered in the pass that produces it."""
    from cpecan_tpu_torch.ops import fb_batch

    original = fb_batch.fb_pass_batch

    def altered(*args, **kwargs):
        out = original(*args, **kwargs)
        if "trans" in out:
            out["trans"] = out["trans"].clone()
            out["trans"][0, 1] *= 1.01
        return out

    monkeypatch.setattr(fb_batch, "fb_pass_batch", altered)


@pytest.mark.parametrize("plant", [_realign_shift, _realign_half])
def test_realign_faults_are_caught(tmp_path, monkeypatch, plant):
    plant(monkeypatch)
    result = _run(tmp_path, "realign-reads", every_record=True)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("plant", [_em_unchanged, _em_restarts_in_the_window,
                                   _em_half, _em_altered])
def test_em_faults_are_caught(tmp_path, monkeypatch, plant):
    plant(monkeypatch)
    result = _run(tmp_path, "em-reads")
    assert result["correct"] is False, result["checks"]


def test_sound_runs_pass(tmp_path):
    for name in ("realign-reads", "em-reads"):
        result = _run(tmp_path / name, name, every_record=True)
        assert result["correct"] is True, (name, result["checks"])
        json.dumps(result)
        assert np.isfinite([c["value"] for c in result["checks"].values()]).all()
