"""The port's data-parallel slice on the CPU: a DataMesh inside one
process and a gloo process group across processes, against the port's
unsharded runs and against the JAX package's mesh and multi-process
runs (conftest's 8-device virtual CPU mesh).

Tolerances: sharded counts are fp32 sums grouped by shard, so they are
held to the unsharded ones at tests/test_em.py's data-parallel
tolerances (rtol 1e-4, likelihood 1e-5 relative); per pair the plain
versions do not depend on the batch a pair sits in, so sharded pair sets
and per-pair outputs must equal the unsharded ones exactly. Two
processes must give one process's model within rtol 1e-6 / atol 1e-9
(tests/test_multihost.py:146-150): each chunk's counts are the same bits
in both, only their float64 sum is grouped otherwise.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpecan_tpu.config import PairwiseAlignmentParameters
from cpecan_tpu.models.hmm import Hmm, StateMachineType
from cpecan_tpu.models.state_machine import state_machine5
from cpecan_tpu_torch.align import batch as port_batch
from cpecan_tpu_torch.align.anchors import get_anchors
from cpecan_tpu_torch.em import em as port_em
from cpecan_tpu_torch.io import cigar as cigar_io
from cpecan_tpu_torch.models.hmm import Hmm as PortHmm
from cpecan_tpu_torch.models.hmm import StateMachineType as PortType
from cpecan_tpu_torch.models.state_machine import PairHMM
from cpecan_tpu_torch.ops import fb_batch
from cpecan_tpu_torch.parallel import mesh as port_mesh
from cpecan_tpu_torch.parallel.mesh import DataMesh
from cpecan_tpu_torch.utils.symbols import (evolve_sequence,
                                            get_random_sequence)
from test_multihost import _em_argv, _free_port, _make_corpus

# The modules of the JAX package that import jax are imported inside the
# tests that compare with it, so that the cuda test runs where jax is
# absent.

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = DataMesh(["cpu"] * 8)
_P = PairwiseAlignmentParameters(constraintDiagonalTrim=0, diagonalExpansion=4,
                                 splitMatrixBiggerThanThis=100 * 100)


def make_corpus(n_pairs, length, seed):
    """tests/test_em.py's make_corpus, built with the port's copies of the
    host modules (the same sequences and cigars)."""
    rng = random.Random(seed)
    sequences, cigars = {}, []
    for i in range(n_pairs):
        x = "".join(rng.choice("ACGT") for _ in range(length))
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


def align_jobs(n_jobs, seed):
    """tests/test_batch_align.py's _jobs, built with the port's copies."""
    from cpecan_tpu_torch.config import PairwiseAlignmentParameters as TP

    rng = random.Random(seed)
    p = TP()
    jobs = []
    for i in range(n_jobs):
        n = rng.randint(40, 300)
        sx = get_random_sequence(n, rng)
        sy = evolve_sequence(sx, rng)
        jobs.append((sx, sy, get_anchors(sx, sy, p), i % 2 == 0, i % 3 == 0))
    return jobs, p


def test_fixtures_are_the_jax_tests_own():
    import dataclasses

    import test_batch_align
    import test_em
    from cpecan_tpu.io import cigar as jax_cigar_io

    seqs, cigars = make_corpus(5, 30, seed=6)
    ref_seqs, ref_cigars = test_em.make_corpus(5, 30, seed=6)
    assert seqs == ref_seqs
    assert [cigar_io.cigar_format(c) for c in cigars] \
        == [jax_cigar_io.cigar_format(c) for c in ref_cigars]
    ours, p = align_jobs(4, 7)
    theirs, q = test_batch_align._jobs(n_jobs=4, seed=7)
    assert dataclasses.asdict(p) == dataclasses.asdict(q)
    for a, b in zip(ours, theirs):
        assert a[:2] == b[:2] and a[3:] == b[3:]
        np.testing.assert_array_equal(np.asarray(a[2]), np.asarray(b[2]))


def _assert_counts_close(new, ref):
    np.testing.assert_allclose(new.transitions, ref.transitions, rtol=1e-4)
    np.testing.assert_allclose(new.emissions, ref.emissions, rtol=1e-4)
    assert new.likelihood == pytest.approx(ref.likelihood, rel=1e-5)


# ------------------------------------------------------ without a group


def test_process_helpers_are_identities_without_a_group():
    assert port_mesh.process_index() == 0
    assert port_mesh.process_count() == 1
    items = [("c", 1), ("c", 2), ("c", 3)]
    assert port_mesh.process_shard(items) == items
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3), np.asarray([2.5])]
    out = port_mesh.all_sum_across_processes(arrays)
    for a, b in zip(out, arrays):
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    port_mesh.initialize_distributed(None, 1, 0)  # one process: a no-op
    port_mesh.initialize_distributed("127.0.0.1:1", None, None)
    assert not torch.distributed.is_initialized()
    port_mesh.shutdown_distributed()
    assert [port_mesh.pad_to_multiple(n, 8) for n in (1, 8, 9, 16)] \
        == [8, 8, 16, 16]


def test_initialize_distributed_rejects_what_cannot_rendezvous():
    with pytest.raises(ValueError, match="coordinator"):
        port_mesh.initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="process id"):
        port_mesh.initialize_distributed("127.0.0.1:1", 2, 2)


def test_data_mesh_devices(monkeypatch):
    assert port_mesh.data_mesh(device="cpu") == (torch.device("cpu"),)
    mesh = port_mesh.data_mesh(3, device="cpu")
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert isinstance(mesh, tuple)
    with pytest.raises(ValueError, match="one type"):
        DataMesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        DataMesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.data_mesh(device="cuda")


def test_data_mesh_never_shrinks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert port_mesh.data_mesh(device="cuda").devices == (
        torch.device("cuda", 0), torch.device("cuda", 1))
    assert port_mesh.data_mesh(1, device="cuda").size == 1
    with pytest.raises(ValueError, match="2 are available"):
        port_mesh.data_mesh(4, device="cuda")


# ------------------------------------------------------ fb_pass_batch


def _bucket(n_pad=8):
    """One EM bucket of the test_em corpus, padded to n_pad pairs, as host
    tensors."""
    sequences, cigars = make_corpus(5, 30, seed=6)
    tasks = port_em.tasks_from_cigars(cigars, sequences, _P)
    buckets, _ = port_batch.plan(tasks, _P)
    (P, W), items = max(buckets.items(), key=lambda kv: len(kv[1]))
    args = port_batch.launch_arrays(items, P, n_pad)
    return [torch.from_numpy(a) for a in args], W, len(items)


@pytest.mark.parametrize("mode", ["posterior_match", "posterior_all",
                                  "expectation", "forward"])
def test_sharded_batch_matches_unsharded(mode):
    args, W, _ = _bucket()
    hmm = PairHMM.from_state_machine(state_machine5())
    ref = fb_batch.fb_pass_batch(hmm, *args, mode=mode, width=W)
    assert fb_batch.LAST_ENGINE == "torch"
    for mesh in (DataMesh(["cpu"] * 2), CPU8):
        got = fb_batch.fb_pass_batch(hmm, *args, mode=mode, width=W,
                                     mesh=mesh)
        assert fb_batch.LAST_ENGINE == "torch_sharded"
        assert got.keys() == ref.keys()
        for k in ref:
            if k in ("trans", "emis"):
                np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
            else:
                assert torch.equal(got[k], ref[k]), k
    one = fb_batch.fb_pass_batch(hmm, *args, mode=mode, width=W,
                                 mesh=DataMesh(["cpu"]))
    assert fb_batch.LAST_ENGINE == "torch"
    assert all(torch.equal(one[k], ref[k]) for k in ref)


def test_sharded_batch_must_split_evenly():
    args, W, _ = _bucket(n_pad=8)
    hmm = PairHMM.from_state_machine(state_machine5())
    with pytest.raises(ValueError, match="does not split"):
        fb_batch.fb_pass_batch(hmm, *args, mode="expectation", width=W,
                               mesh=DataMesh(["cpu"] * 3))


def test_pad_rows_add_exact_zeros():
    """A batch of zero-length pad pairs alone, sharded or not, counts
    exactly nothing, so padding B to a multiple of the mesh size changes
    no count."""
    args, W, n = _bucket(n_pad=8)
    pads = [a[n:] for a in args]
    assert int(pads[4].sum() + pads[5].sum()) == 0 and pads[0].shape[0] >= 2
    hmm = PairHMM.from_state_machine(state_machine5())
    for mesh in (None, DataMesh(["cpu"] * 2)):
        out = fb_batch.fb_pass_batch(hmm, *[p[:2] for p in pads],
                                     mode="expectation", width=W, mesh=mesh)
        assert not out["trans"].any() and not out["emis"].any()


# ------------------------------------------------------ expectation_step


def test_expectation_step_mesh_matches_serial_and_jax():
    """tests/test_em.py:117-152's corpus through the port's expectation
    step on an 8-way CPU mesh, against the port's serial result and the
    JAX package's 8-device mesh run."""
    from cpecan_tpu.em import em as jax_em
    from cpecan_tpu.parallel.mesh import data_mesh as jax_data_mesh

    sequences, cigars = make_corpus(5, 30, seed=6)
    tasks = port_em.tasks_from_cigars(cigars, sequences, _P)
    assert tasks
    serial = PortHmm(PortType.fiveState)
    port_em.expectation_step(state_machine5(), tasks, _P, serial,
                             device="cpu")
    sharded = PortHmm(PortType.fiveState)
    port_em.expectation_step(state_machine5(), tasks, _P, sharded, mesh=CPU8)
    assert fb_batch.LAST_ENGINE == "torch_sharded"
    _assert_counts_close(sharded, serial)

    mesh = jax_data_mesh()
    assert mesh.devices.size == 8
    ref = Hmm(StateMachineType.fiveState)
    jax_em.expectation_step(state_machine5(), jax_em.tasks_from_cigars(
        cigars, sequences, _P), _P, ref, mesh=mesh)
    _assert_counts_close(sharded, ref)


def test_bucket_arrays_pad_to_the_mesh():
    sequences, cigars = make_corpus(5, 30, seed=6)
    buckets, _ = port_batch.plan(
        port_em.tasks_from_cigars(cigars, sequences, _P), _P)
    (P, _W), items = next(iter(buckets.items()))
    for n_dev, want in ((1, 1), (3, 3), (8, 8)):
        sub = items[:1]
        assert port_batch.launch_arrays(sub, P, n_dev)[0].shape[0] == want
    B = port_batch.launch_arrays(items, P)[0].shape[0]
    assert port_batch.launch_arrays(items, P, 3)[0].shape[0] \
        == port_mesh.pad_to_multiple(B, 3)


# ------------------------------------------------------ batch posteriors


@pytest.mark.parametrize("with_indels", [False, True])
def test_batch_mesh_matches_unsharded_and_jax(with_indels, monkeypatch):
    """tests/test_batch_align.py:47-61's jobs on an 8-way CPU mesh: the
    same pairs as the unsharded port, and the same pair sets as the JAX
    package's sharded wavefront run (interpret mode)."""
    from cpecan_tpu.align import batch as jax_batch
    from cpecan_tpu.parallel.mesh import data_mesh as jax_data_mesh

    jobs, p = align_jobs(4, 7)
    fn = ("get_aligned_pairs_with_indels_batch" if with_indels
          else "get_aligned_pairs_batch")
    sm = state_machine5()
    serial = getattr(port_batch, fn)(sm, jobs, p, device="cpu")
    # on the CPU every shard walks its diagonals in Python: 2 keep it short
    mesh = DataMesh(["cpu"] * 2) if with_indels else CPU8
    sharded = getattr(port_batch, fn)(sm, jobs, p, mesh=mesh)
    assert fb_batch.LAST_ENGINE == "torch_sharded"
    if with_indels:
        serial = [a for triple in serial for a in triple]
        sharded = [a for triple in sharded for a in triple]
    for a, b in zip(sharded, serial):
        np.testing.assert_array_equal(a, b)
    if with_indels:
        return  # the JAX package shards only the match posteriors in tests
    monkeypatch.setenv("CPECAN_TPU_ENGINE", "wavefront")
    ref = jax_batch.get_aligned_pairs_batch(sm, jobs, p,
                                            mesh=jax_data_mesh())
    for a, b in zip(sharded, ref):
        a = np.sort(a, order=["x", "y"])
        b = np.sort(b, order=["x", "y"])
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
        np.testing.assert_allclose(a["prob"], b["prob"], rtol=2e-3, atol=30)


# ------------------------------------------------------ processes

_WORKER = """
import sys
from cpecan_tpu_torch.cli import em
rc = em.main(sys.argv[1:])
bad = [m for m in sys.modules if m in ("jax", "cpecan_tpu")
       or m.startswith(("jax.", "jaxlib", "cpecan_tpu."))]
assert not bad, bad
sys.exit(rc)
"""


def _worker_env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _rendezvous_failed(err: str) -> bool:
    """A port race at the rendezvous (timing, not correctness)."""
    err = err.lower()
    return any(s in err for s in ("eaddrinuse", "address already in use",
                                  "distnetworkerror", "diststoreerror",
                                  "timed out", "connection closed"))


def _run_ranks(argvs, timeout=120):
    """Start one em CLI process per argv, each with a timeout; returns
    [(returncode, stderr)]."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO, env=_worker_env())
        for argv in argvs]
    results = []
    try:
        for pr in procs:
            _out, err = pr.communicate(timeout=timeout)
            results.append((pr.returncode, err))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    return results


def _rank_argv(fasta, cig, out_model, port, pid, xml):
    return _em_argv(fasta, cig, out_model, extra=[
        "--outputXMLModelFile", xml, "--device", "cpu",
        "--coordinator", f"127.0.0.1:{port}", "--numProcesses", "2",
        "--processId", str(pid), "--collectiveTimeout", "60"])


def test_two_process_em_cli_matches_one_process_and_jax(tmp_path):
    """tests/test_multihost.py's corpus and argv (every cigar its own
    chunk, so both ranks get work): the port's em CLI as 2 gloo processes
    gives its 1-process model; that model agrees with the JAX package's
    1-process CLI; only rank 0 writes files; the ranks import no jax."""
    from cpecan_tpu.cli import em as jax_cli
    from cpecan_tpu_torch.cli import em as port_cli

    fasta, cig = _make_corpus(tmp_path)
    one, one_xml = str(tmp_path / "one.hmm"), str(tmp_path / "one.xml")
    assert port_cli.main(_em_argv(fasta, cig, one, extra=[
        "--outputXMLModelFile", one_xml, "--device", "cpu"])) == 0
    jax_model = str(tmp_path / "jax.hmm")
    assert jax_cli.main(_em_argv(fasta, cig, jax_model)) == 0
    _assert_counts_close(Hmm.load(one), Hmm.load(jax_model))

    outs = [str(tmp_path / f"rank{i}.hmm") for i in range(2)]
    xmls = [str(tmp_path / f"rank{i}.xml") for i in range(2)]
    for attempt in range(2):
        port = _free_port()
        results = _run_ranks([_rank_argv(fasta, cig, outs[i], port, i,
                                         xmls[i]) for i in range(2)])
        if all(rc == 0 for rc, _ in results):
            break
        errs = "".join(err[-3000:] for _, err in results)
        assert attempt == 0 and _rendezvous_failed(errs), errs
    ref, got = Hmm.load(one), Hmm.load(outs[0])
    np.testing.assert_allclose(got.transitions, ref.transitions,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.emissions, ref.emissions,
                               rtol=1e-6, atol=1e-9)
    assert got.likelihood == pytest.approx(ref.likelihood, rel=1e-6)
    np.testing.assert_allclose(got.running_likelihoods,
                               ref.running_likelihoods, rtol=1e-6)
    assert os.path.exists(xmls[0])
    assert not os.path.exists(outs[1]) and not os.path.exists(xmls[1])
    assert not [f for f in os.listdir(tmp_path) if "_trial" in f]


def test_a_failing_rank_does_not_hang_the_other(tmp_path):
    """Rank 1 joins the group and then fails (a missing cigar file): rank
    0 leaves at its next collective with an error, long before the
    timeout; rank 1 writes nothing."""
    fasta, cig = _make_corpus(tmp_path, n_pairs=2)
    outs = [str(tmp_path / f"rank{i}.hmm") for i in range(2)]
    port = _free_port()
    argvs = [_rank_argv(fasta, cig, outs[0], port, 0, str(tmp_path / "0.xml")),
             _rank_argv(fasta, str(tmp_path / "missing.cigar"), outs[1], port,
                        1, str(tmp_path / "1.xml"))]
    results = _run_ranks(argvs, timeout=90)
    assert results[1][0] != 0 and "missing.cigar" in results[1][1]
    assert results[0][0] != 0, results[0][1][-2000:]
    assert not os.path.exists(outs[1])


def test_a_lone_rank_fails_at_the_rendezvous(tmp_path):
    """One of two processes started alone gives up after
    --collectiveTimeout instead of waiting for ever."""
    fasta, cig = _make_corpus(tmp_path, n_pairs=2)
    argv = _em_argv(fasta, cig, str(tmp_path / "m.hmm"), extra=[
        "--device", "cpu", "--coordinator", f"127.0.0.1:{_free_port()}",
        "--numProcesses", "2", "--processId", "0", "--collectiveTimeout",
        "3"])
    [(rc, err)] = _run_ranks([argv], timeout=60)
    assert rc != 0 and _rendezvous_failed(err), err[-2000:]


_ALL_SUM = """
import json
import sys
import numpy as np
from cpecan_tpu_torch.parallel import mesh
rank, port = int(sys.argv[1]), sys.argv[2]
mesh.initialize_distributed(f"127.0.0.1:{port}", 3, rank, timeout_s=60)
try:
    assert (mesh.process_index(), mesh.process_count()) == (rank, 3)
    shard = mesh.process_shard(list(range(8)))
    a = np.float32([0.1, 1e8, -1e8]) * (rank + 1) + rank / 3
    out = mesh.all_sum_across_processes([a, np.asarray([[rank + 0.5]])])
    print(json.dumps({"shard": shard, "shapes": [x.shape for x in out],
                      "sums": [x.tobytes().hex() for x in out]}))
finally:
    mesh.shutdown_distributed()
"""


def test_all_sum_across_three_processes():
    """Three gloo processes: each gets items[rank::3], and the sum in rank
    order, bit-identical on every rank."""
    for attempt in range(2):
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-c", _ALL_SUM, str(r), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=_worker_env()) for r in range(3)]
        outs = [pr.communicate(timeout=90) for pr in procs]
        if all(pr.returncode == 0 for pr in procs):
            break
        errs = "".join(e[-2000:] for _, e in outs)
        assert attempt == 0 and _rendezvous_failed(errs), errs
    got = [json.loads(o) for o, _ in outs]
    assert [g["shard"] for g in got] == [[0, 3, 6], [1, 4, 7], [2, 5]]
    assert all(g["shapes"] == [[3], [1, 1]] for g in got)
    assert len({tuple(g["sums"]) for g in got}) == 1
    arrays = [np.float32([0.1, 1e8, -1e8]) * (r + 1) + r / 3
              for r in range(3)]
    want = np.stack([a.astype(np.float64) for a in arrays]).sum(axis=0)
    assert got[0]["sums"] == [want.tobytes().hex(),
                              np.asarray([[4.5]]).tobytes().hex()]


# ------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_shards_on_one_card(cuda_device):
    """Two shards of every batch on one card: the EM counts within the
    data-parallel tolerances of the unsharded run, and realign's pair
    sets equal."""
    from cpecan_tpu_torch.ops import fb_wavefront

    mesh = DataMesh([cuda_device, cuda_device])
    sequences, cigars = make_corpus(5, 30, seed=6)
    tasks = port_em.tasks_from_cigars(cigars, sequences, _P)
    plain = PortHmm(PortType.fiveState)
    port_em.expectation_step(state_machine5(), tasks, _P, plain,
                             device=cuda_device)
    fb_wavefront.reset_launch_counts()
    sharded = PortHmm(PortType.fiveState)
    port_em.expectation_step(state_machine5(), tasks, _P, sharded, mesh=mesh)
    assert fb_batch.LAST_ENGINE == "cuda_sharded"
    assert fb_wavefront.LAUNCHES["exp"] > 0
    _assert_counts_close(sharded, plain)
    jobs, p = align_jobs(4, 7)
    a = port_batch.get_aligned_pairs_batch(state_machine5(), jobs, p,
                                           device=cuda_device)
    b = port_batch.get_aligned_pairs_batch(state_machine5(), jobs, p,
                                           mesh=mesh)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
