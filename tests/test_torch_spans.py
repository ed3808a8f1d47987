"""The port's critical-path stages on the CPU.

utils/metrics: the ``staged_main_s`` counter holds the main thread's
seconds inside at least one stage (nested stages once, other threads'
not at all). The realign CLI opens ``cigar_in`` per group read,
``prefetch_wait`` per prepared group, and ``decode`` and ``cigar_out``
per record written; the EM loop opens ``em_split``, ``em_counts`` and
``em_mstep``; ``device_wait`` opens only on CUDA devices. The EM CLI
prints the report lines under CPECAN_TPU_METRICS=1.
"""

import io
import random
import sys
import threading
import time

import pytest
import torch

from cpecan_tpu_torch.cli import em as em_cli
from cpecan_tpu_torch.cli import realign
from cpecan_tpu_torch.em import em as em_mod
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.utils import metrics
from cpecan_tpu_torch.utils.pipeline import prefetch_map
from cpecan_tpu_torch.utils.symbols import evolve_sequence, get_random_sequence

torch.set_num_threads(1)

REALIGN_STAGES = ("cigar_in", "prefetch_wait", "decode", "cigar_out")


def _corpus(n_pairs, length, seed):
    """Evolved pairs, each with an all-match-first input cigar."""
    rng = random.Random(seed)
    sequences, cigars = {}, []
    for i in range(n_pairs):
        x = get_random_sequence(length, rng).upper()
        y = evolve_sequence(x, rng).upper() or "ACGT"
        sequences[f"x{i}"], sequences[f"y{i}"] = x, y
        m = min(len(x), len(y))
        ops = [(cigar_io.MATCH, m)]
        if len(x) > m:
            ops.append((cigar_io.INDEL_X, len(x) - m))
        if len(y) > m:
            ops.append((cigar_io.INDEL_Y, len(y) - m))
        cigars.append(cigar_io.PairwiseAlignment(
            f"x{i}", 0, len(x), True, f"y{i}", 0, len(y), True, 0.0, ops))
    return sequences, cigars


def _files(tmp_path, sequences, cigars):
    fasta = tmp_path / "seqs.fa"
    with open(fasta, "w") as fh:
        for name, seq in sequences.items():
            fh.write(f">{name}\n{seq}\n")
    cigar_file = tmp_path / "aln.cigar"
    with open(cigar_file, "w") as fh:
        for pa in cigars:
            cigar_io.cigar_write(fh, pa)
    return str(fasta), str(cigar_file)


# -------------------------------------------------------------- registry

def test_nested_stages_count_once_in_staged_main_s():
    metrics.reset()
    with metrics.stage("outer"):
        time.sleep(0.02)
        with metrics.stage("inner"):
            time.sleep(0.02)
    snap = metrics.snapshot()
    outer = snap["stages"]["outer"]["seconds"]
    assert snap["stages"]["inner"]["seconds"] < outer
    assert snap["counters"]["staged_main_s"] == pytest.approx(outer)
    assert snap["stages"]["outer"]["calls"] == 1


def test_a_stage_on_another_thread_adds_nothing():
    metrics.reset()

    def work():
        with metrics.stage("worker"):
            time.sleep(0.01)

    t = threading.Thread(target=work)
    t.start()
    t.join()
    snap = metrics.snapshot()
    assert snap["stages"]["worker"]["calls"] == 1
    assert "staged_main_s" not in snap["counters"]
    with metrics.stage("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    snap = metrics.snapshot()
    assert snap["counters"]["staged_main_s"] == pytest.approx(
        snap["stages"]["main"]["seconds"])


def test_report_lines_show_staged_main_s():
    metrics.reset()
    with metrics.stage("outer"):
        pass
    lines = metrics.report_lines()
    assert any(line.startswith("staged_main_s: ") for line in lines)
    assert lines[-1].startswith("kernel_launches: ")


def test_prefetch_map_times_each_wait_as_its_stage():
    metrics.reset()
    out = list(prefetch_map(lambda x: x + 1, range(5), depth=2))
    assert out == [1, 2, 3, 4, 5]
    assert metrics.snapshot()["stages"]["prefetch_wait"]["calls"] == 5


def test_stages_on_many_threads_lose_no_update():
    """Eight threads open stages while the main thread holds one: every
    call is counted and staged_main_s is the main thread's stage alone."""
    metrics.reset()
    interval = sys.getswitchinterval()

    def work():
        for _ in range(200):
            with metrics.stage("worker"):
                with metrics.stage("nested"):
                    pass

    sys.setswitchinterval(1e-6)
    try:
        with metrics.stage("main"):
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = metrics.snapshot()
    assert snap["stages"]["worker"]["calls"] == 1600
    assert snap["stages"]["nested"]["calls"] == 1600
    assert snap["counters"]["staged_main_s"] == snap["stages"]["main"]["seconds"]


# ------------------------------------------------------------ realign CLI

@pytest.mark.parametrize("batch_pairs", [1, 3])
def test_realign_names_its_critical_path(tmp_path, batch_pairs):
    n = 5
    sequences, cigars = _corpus(n, 60, seed=batch_pairs)
    fasta, cigar_file = _files(tmp_path, sequences, cigars)
    with open(cigar_file) as fh:
        text = fh.read()
    metrics.reset()
    out = io.StringIO()
    t0 = time.perf_counter()
    realign.main([fasta, "--device", "cpu", "--batchPairs", str(batch_pairs)],
                 stdin=io.StringIO(text), stdout=out)
    wall = time.perf_counter() - t0
    snap = metrics.snapshot()
    stages = snap["stages"]
    written = len(out.getvalue().splitlines())
    groups = -(-n // batch_pairs)
    assert written == n
    for name in REALIGN_STAGES:
        assert name in stages, name
    assert "device_wait" not in stages  # CUDA only
    assert stages["decode"]["calls"] == written
    assert stages["cigar_out"]["calls"] == written
    assert stages["prefetch_wait"]["calls"] == groups
    # each group read, and the read that finds the input's end
    assert stages["cigar_in"]["calls"] == groups + 1
    assert stages["host_prep"]["calls"] == groups  # not once a chunk
    top = REALIGN_STAGES + ("host_prep", "fb_pass")
    staged = snap["counters"]["staged_main_s"]
    assert max(stages[k]["seconds"] for k in top) <= staged <= wall
    assert staged >= sum(stages[k]["seconds"] for k in top) * (1 - 1e-9)


# ----------------------------------------------------------------- EM loop

def test_an_em_iteration_names_its_loop(tmp_path):
    sequences, cigars = _corpus(3, 40, seed=4)
    options = em_mod.EmOptions(iterations=1, trials=1, diagonalExpansion=4,
                               splitMatrixBiggerThanThis=100 ** 2)
    metrics.reset()
    em_mod.expectation_maximisation(sequences, cigars,
                                    str(tmp_path / "m.hmm"), options,
                                    device="cpu")
    stages = metrics.snapshot()["stages"]
    assert stages["em_split"]["calls"] == 1
    assert stages["em_mstep"]["calls"] == 1
    assert stages["em_counts"]["calls"] >= 1
    assert stages["em_tasks"]["calls"] >= 1
    assert "device_wait" not in stages


def test_em_cli_prints_its_metrics_lines(tmp_path, monkeypatch, capsys):
    sequences, cigars = _corpus(2, 30, seed=8)
    fasta, cigar_file = _files(tmp_path, sequences, cigars)
    monkeypatch.setenv("CPECAN_TPU_METRICS", "1")
    metrics.reset()
    assert em_cli.main(["--sequences", fasta, "--alignments", cigar_file,
                        "--outputModel", str(tmp_path / "m.hmm"),
                        "--iterations", "1", "--trials", "1",
                        "--diagonalExpansion", "4",
                        "--splitMatrixBiggerThanThis", "100",
                        "--device", "cpu"]) == 0
    err = capsys.readouterr().err.splitlines()
    lines = [line for line in err if line.startswith("metrics: ")]
    for name in ("em_split", "em_tasks", "em_counts", "em_mstep", "fb_pass"):
        assert any(line.startswith(f"metrics: {name}: ")
                   for line in lines), name
    assert any(line.startswith("metrics: staged_main_s: ") for line in lines)
    assert lines[-1].startswith("metrics: kernel_launches: ")
