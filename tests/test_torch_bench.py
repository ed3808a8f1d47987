"""The port's benchmark harness (cpecan_tpu_torch/bench.py) against the JAX
package's (bench.py, loaded read-only): the same workload builders give
the same inputs on the same seeds, and a --smoke run on the CPU runs every
config with every field bench.py prints for it and a passing output
check. A failing check, a failing C comparator and --device cuda without
a card make the run fail."""

import ast
import contextlib
import functools
import importlib.util
import io
import json
import math
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import cpecan_tpu.align.pairwise as j_pairwise
import cpecan_tpu.em.em as j_em
import cpecan_tpu.msa.aligner as j_aligner
import cpecan_tpu.utils.symbols as j_symbols
from cpecan_tpu.io import cigar as j_cigar
from cpecan_tpu_torch import bench as t_bench
from cpecan_tpu_torch.io import cigar as t_cigar

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
_BENCH_PY = _REPO / "bench.py"
# lane packing is TPU-only and not ported (cpecan_tpu_torch/bench.py)
_NOT_PORTED = {"dense_band_pack_factor"}


class _Stop(Exception):
    """Ends a bench.py config once its inputs are captured."""


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", _BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stop(*args, **kwargs):
    raise _Stop


# ------------------------------------------------------------ builders


def test_headline_batch_matches_bench_py(jax_bench):
    want = jax_bench.build_batch(np.random.default_rng(0))
    got = t_bench.build_batch(np.random.default_rng(0))
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[6] == want[6] == 128  # W: both ladders give 128 here
    assert got[7] == want[7]  # in-band cells


def test_dense_batch_matches_bench_py(jax_bench, monkeypatch):
    """bench.py builds the dense-anchor batch inside bench_headline: its
    fb_pass_batch is replaced by one that records the launch inputs."""
    import jax.numpy as jnp

    seen = []

    def record(params, *args, mode, width):
        seen.append((args, width))
        return {"post_match": jnp.zeros(1)}

    monkeypatch.setattr(jax_bench, "fb_batch",
                        types.SimpleNamespace(fb_pass_batch=record))
    jax_bench.bench_headline(1.0)
    want, w_width = seen[-1]
    got = t_bench.build_batch(np.random.default_rng(1), anchor_every=1)
    for g, w in zip(got[:6], want[:6]):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the same frame, launched at each package's own width bucket
    assert (w_width, got[6]) == (24, 32)


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_random_pair_stream_matches_bench_py(jax_bench, seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for n in (1000, 1000, 200, 1000):
        assert t_bench._random_pair(rt, n) == jax_bench._random_pair(rj, n)


def test_em_corpus_matches_bench_py(jax_bench, monkeypatch):
    seen = {}

    def record(cigars, sequences, p):
        seen.update(cigars=cigars, sequences=sequences)
        raise _Stop

    monkeypatch.setattr(j_em, "tasks_from_cigars", record)
    with pytest.raises(_Stop):
        jax_bench.bench_em(1.0, n_pairs=6)
    sequences, cigars = t_bench.em_corpus(6)
    assert sequences == seen["sequences"]
    assert ([t_cigar.cigar_format(c) for c in cigars]
            == [j_cigar.cigar_format(c) for c in seen["cigars"]])


@pytest.mark.parametrize("n_seqs,seq_len", [(20, 500), (100, 1000)])
def test_msa_fragments_match_bench_py(jax_bench, monkeypatch, n_seqs, seq_len):
    seen = []
    monkeypatch.setattr(j_aligner, "make_alignment",
                        lambda sm, frags, **kw: seen.append(frags) or _stop())
    with pytest.raises(_Stop):
        jax_bench.bench_msa(1.0, n_seqs=n_seqs, seq_len=seq_len)
    got = [(f.seq, f.left_end_id, f.right_end_id)
           for f in t_bench.msa_frags(n_seqs, seq_len)]
    assert got == [(f.seq, f.left_end_id, f.right_end_id) for f in seen[0]]


@pytest.mark.parametrize("genomic", [False, True])
def test_planted_pair_matches_bench_py(jax_bench, monkeypatch, genomic):
    seen = {}
    evolve = j_symbols.tracked_evolve

    def record(x, *args, **kwargs):
        seen["x"] = x
        seen["y"], seen["truth"] = evolve(x, *args, **kwargs)
        return seen["y"], seen["truth"]

    monkeypatch.setattr(j_symbols, "tracked_evolve", record)
    monkeypatch.setattr(j_pairwise, "get_aligned_pairs", _stop)
    with pytest.raises(_Stop):
        jax_bench.bench_anchored_50kb(1.0, n=3000, genomic=genomic)
    x, y, truth = t_bench._planted_pair(3000, genomic)
    assert (x, y) == (seen["x"], seen["y"])
    assert list(truth) == list(seen["truth"])


# ------------------------------------------------------- the smoke run


def _config_fields():
    """{config: the keys bench.py's config returns}, read from bench.py's
    source: the string keys of each returned dict literal, following a
    ** of another config's call."""
    tree = ast.parse(_BENCH_PY.read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    table = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "CONFIGS")

    def keys(name):
        out = set()
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
                for k, v in zip(node.value.keys, node.value.values):
                    if k is None:
                        out |= keys(v.func.id)
                    else:
                        out.add(k.value)
        return out

    return {k.value: keys(v.id) for k, v in zip(table.keys, table.values)}


_FIELDS = _config_fields()


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """main(--all --smoke --device cpu) once: (exit code, its report, the
    path it must not have written)."""
    report = tmp_path_factory.mktemp("bench") / "BENCH_TORCH_ALL.json"
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_bench, "REPORT", report)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = t_bench.main(["--all", "--smoke", "--device", "cpu"])
    return rc, json.loads(out.getvalue().splitlines()[-1]), report, err.getvalue()


def test_smoke_run_on_cpu(smoke_run):
    rc, report, path, err = smoke_run
    assert rc == 0, err[-3000:]
    assert report["backend"] == "cpu" and report["power_limit"] is None
    assert [c["name"] for c in report["configs"]] == list(t_bench.CONFIGS)
    assert list(t_bench.CONFIGS) == list(_FIELDS)
    rates = report["c_baseline_runs"]
    assert len(rates) == t_bench.C_RUNS and min(rates) > 0
    assert report["c_baseline_cells_per_sec"] == sorted(rates)[len(rates) // 2]
    assert not path.exists()  # a CPU run writes no report


@pytest.mark.parametrize("name", sorted(_FIELDS))
def test_smoke_config_has_bench_py_fields(smoke_run, name):
    result = next(c for c in smoke_run[1]["configs"] if c["name"] == name)
    assert result["check"] == "ok", result
    missing = _FIELDS[name] - _NOT_PORTED - set(result)
    assert not missing, missing
    assert isinstance(result["value"], (int, float))
    assert math.isfinite(result["value"])
    reps = ([p["rep_seconds"] for p in result["points"].values()]
            if name == "em_scaling" else [result["rep_seconds"]])
    assert all(r and min(r) > 0 for r in reps)


# ------------------------------------------------------------ failures


def test_perturbed_plain_output_fails_the_run(monkeypatch, capsys):
    plain = t_bench._plain_pass

    def perturbed(*args):
        out = plain(*args)
        out["post_match"] = out["post_match"] + 0.5
        return out

    monkeypatch.setattr(t_bench, "_plain_pass", perturbed)
    rc = t_bench.main(["--config", "headline", "--smoke", "--device", "cpu"])
    assert rc != 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["configs"][0]["check"].startswith("failed: post_match")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_bench.main(["--smoke", "--device", "cuda"])


@pytest.mark.parametrize("source,error", [
    ("int main(void) { return 0 }\n", RuntimeError),  # gcc fails
    ("int main(void) { return 3; }\n",
     subprocess.CalledProcessError),  # the run fails
    ('#include <stdio.h>\nint main(void) { puts("rate 1"); return 0; }\n',
     RuntimeError),  # prints no rate
])
def test_c_comparator_failure_raises(monkeypatch, tmp_path, source, error):
    src = tmp_path / "bench_cells.c"
    src.write_text(source)
    monkeypatch.setattr(t_bench, "C_SOURCE", src)
    monkeypatch.setattr(t_bench, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(error):
        t_bench.measure_c_baseline()


# ------------------------------------------------ commit and resume log


def _git(cwd, *args):
    return subprocess.run(["git", "-c", "user.name=bench", "-c",
                           "user.email=bench@example.com", "-c",
                           "commit.gpgsign=false", *args], cwd=cwd, check=True,
                          capture_output=True, text=True).stdout.strip()


def _checkout(tmp_path, kind):
    """A checkout of kind "repo" (a git repository with one commit),
    "dirty" (the same with a tracked file modified) or "copy" (no
    repository, as one unpacked from git archive); (its path, the commit
    git gives it or None)."""
    root = tmp_path / kind
    root.mkdir()
    (root / "tracked.txt").write_text("one\n")
    if kind == "copy":
        return root, None
    _git(root, "init", "-q")
    _git(root, "add", "tracked.txt")
    _git(root, "commit", "-q", "-m", "one")
    (root / "untracked.txt").write_text("not a change of the commit\n")
    head = _git(root, "rev-parse", "HEAD")
    if kind == "dirty":
        (root / "tracked.txt").write_text("two\n")
        return root, head + "+dirty"
    return root, head


# kind of checkout, --commit, $CPECAN_BENCH_COMMIT -> the source that wins
_COMMIT_CASES = {
    "git_over_flag_and_env": ("repo", "f1a9", "e4v", "git"),
    "git_dirty": ("dirty", "f1a9", None, "git"),
    "flag_over_env": ("copy", "f1a9", "e4v", "flag"),
    "flag": ("copy", "f1a9", None, "flag"),
    "env": ("copy", None, "e4v", "env"),
    "none": ("copy", None, None, "none"),
}


@pytest.mark.parametrize("case", sorted(_COMMIT_CASES))
def test_commit_source(case, tmp_path, monkeypatch):
    kind, flag, env, source = _COMMIT_CASES[case]
    root, head = _checkout(tmp_path, kind)
    monkeypatch.setattr(t_bench, "ROOT", root)
    if env is None:
        monkeypatch.delenv(t_bench.COMMIT_ENV, raising=False)
    else:
        monkeypatch.setenv(t_bench.COMMIT_ENV, env)
    want = {"git": head, "flag": flag, "env": env, "none": "unknown"}[source]
    assert t_bench.resolve_commit(flag) == (want, source)


_EM_STAMP = {"commit": "c0ffee", "smoke": False, "device": "cpu", "kwargs": {}}


@pytest.fixture
def em_run(tmp_path, monkeypatch):
    """main(--config em --device cpu --resume-log LOG) on a checkout with
    no repository, the C comparator stubbed and em at its smoke sizes
    under its full-size stamp: run(log lines, extra args) -> (exit code,
    the report, stderr)."""
    root, _ = _checkout(tmp_path, "copy")
    monkeypatch.setattr(t_bench, "ROOT", root)
    monkeypatch.delenv(t_bench.COMMIT_ENV, raising=False)
    monkeypatch.setattr(t_bench, "measure_c_baseline", lambda: (1.0, [1.0]))
    monkeypatch.setitem(t_bench.CONFIGS, "em", functools.partial(
        t_bench.bench_em, **t_bench.SMOKE_KWARGS["em"]))

    def run(lines, *args):
        log = tmp_path / "bench.log"
        log.write_text("".join(json.dumps(rec) + "\n" for rec in lines))
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = t_bench.main(["--config", "em", "--resume-log", str(log),
                               "--device", "cpu", *args])
        return rc, json.loads(out.getvalue().splitlines()[-1]), err.getvalue()

    return run


def test_resume_log_reuses_recorded_configs(em_run):
    """A config recorded in an earlier run's log with this run's stamp is
    not run again (an unknown name or a line that is no JSON object is
    skipped)."""
    rec = {"name": "em", "metric": "em_iterations_per_sec_64x1kb",
           "value": 1.0, "unit": "iters/s", "check": "ok", "stamp": _EM_STAMP}
    rc, report, err = em_run(["starting", {**rec, "name": "other"}, rec],
                             "--commit", "c0ffee")
    assert rc == 0
    assert report["configs"] == [{**rec, "resumed": True}]
    assert (report["commit"], report["commit_source"]) == ("c0ffee", "flag")
    assert "--resume-log" not in err


_CARD = {"backend": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
         "device_count": 1}
# the line's stamp, the run's --commit (None: none), the checkout, whether
# the run reports a card -> the field its refusal names
_REFUSALS = {
    "unstamped": (None, "c0ffee", "copy", False, "stamp"),
    "smoke_line_in_full_run": ({**_EM_STAMP, "smoke": True, "kwargs":
                                t_bench.SMOKE_KWARGS["em"]},
                               "c0ffee", "copy", False, "smoke"),
    "cpu_line_in_card_run": ({**_EM_STAMP, "device": "cpu"}, "c0ffee",
                             "copy", True, "device"),
    "other_commit": ({**_EM_STAMP, "commit": "0ther"}, "c0ffee", "copy",
                     False, "commit"),
    "unknown_commit": ({**_EM_STAMP, "commit": "unknown"}, None, "copy",
                       False, "commit"),
    "dirty_commit": ("dirty", None, "dirty", False, "commit"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_resume_log_refuses_lines_stamped_otherwise(case, em_run, tmp_path,
                                                    monkeypatch):
    """A line whose stamp is not this run's (or any line, while this run's
    commit is unknown or dirty) is named on stderr with the field that
    differs, and its config is run again."""
    stamp, commit, kind, card, field = _REFUSALS[case]
    if kind == "dirty":
        root, head = _checkout(tmp_path, kind)
        monkeypatch.setattr(t_bench, "ROOT", root)
        stamp = {**_EM_STAMP, "commit": head}  # the run's own stamp
    if card:
        monkeypatch.setattr(t_bench, "device_report", lambda device: _CARD)
    rec = {"name": "em", "metric": "em_iterations_per_sec_64x1kb",
           "value": -1.0, "unit": "iters/s", "check": "ok"}
    if stamp is not None:
        rec["stamp"] = stamp
    rc, report, err = em_run([rec], *(["--commit", commit] if commit else []))
    assert rc == 0, err[-3000:]
    (result,) = report["configs"]
    assert "resumed" not in result and result["value"] > 0
    assert result["check"] == "ok"
    want = {**_EM_STAMP, "commit": report["commit"],
            "device": _CARD["backend"] if card else "cpu"}
    assert result["stamp"] == want
    if case == "unknown_commit":
        assert (report["commit"], report["commit_source"]) == ("unknown", "none")
    refusals = [ln for ln in err.splitlines() if ln.startswith("--resume-log:")]
    assert refusals and refusals[0].startswith(
        f"--resume-log: em is run again: {field}: "), refusals


_OK = [{"name": "headline", "check": "ok"}]
_CUDA = torch.device("cuda", 0)
# configs, smoke, one config, device, commit -> why nothing is written
_WRITES = {
    "full_card_run": (_OK, False, False, _CUDA, "c0ffee", None),
    "dirty_commit": (_OK, False, False, _CUDA, "c0ffee+dirty", None),
    "smoke": (_OK, True, False, _CUDA, "c0ffee", "--smoke"),
    "one_config": (_OK, False, True, _CUDA, "c0ffee", "--config"),
    "cpu": (_OK, False, False, torch.device("cpu"), "c0ffee", "on the cpu"),
    "unknown_commit": (_OK, False, False, _CUDA, "unknown", "commit is unknown"),
    "failed_check": ([*_OK, {"name": "em", "check": "failed: counts"}], False,
                     False, _CUDA, "c0ffee", "check of em"),
}


@pytest.mark.parametrize("case", sorted(_WRITES))
def test_report_written_only_for_a_full_card_run(case):
    configs, smoke, one, device, commit, why = _WRITES[case]
    got = t_bench.report_refusal(configs, smoke=smoke, one_config=one,
                                 device=device, commit=commit)
    if why is None:
        assert got is None
    else:
        assert why in got
    assert (got == t_bench.NO_COMMIT) == (case == "unknown_commit")
