"""The harness on the CPU: its data, its generator, its result line, its
readers, and that a new cell needs only new files.

    python3 -m pytest -q benchmark/tests

The cells run here at small sizes on the CPU, with the program's plain
versions of its kernels (``--device cpu``); nothing here needs a card.
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark.lib import harness, readers, spec, trace  # noqa: E402
from benchmark.traffic import planted  # noqa: E402

SMALL = {
    "reads": dict(reference_bases=20000, records=12,
                  lengths=dict(dist="lognormal", median=300, sigma=0.6,
                               min=100, max=800)),
    "reads-4mb": dict(reference_bases=20000, corpus_bases=2500,
                      lengths=dict(dist="lognormal", median=300, sigma=0.6,
                                   min=100, max=800)),
}
BLOCKS = {"generator": "planted", "kind": "blocks", "records": 2,
          "lengths": {"dist": "uniform", "low": 1000, "high": 2000},
          "evolve": {"sub_rate": 0.05, "del_rate": 0.01, "ins_rate": 0.01,
                     "max_indel": 3}}


def small_tree(tmp: Path) -> Path:
    """A copy of the benchmark with every traffic mix cut to a CPU size;
    returns the copy's benchmark folder."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, upd in SMALL.items():
        p = tmp / "benchmark" / "traffic" / f"{name}.json"
        data = json.loads(p.read_text())
        data.update(upd)
        p.write_text(json.dumps(data))
    for p in (tmp / "benchmark" / "workloads").glob("*.json"):
        data = json.loads(p.read_text())
        data["check"]["records"] = min(data["check"].get("records", 4), 4)
        data["check"]["cell_budget"] = 1 << 22
        p.write_text(json.dumps(data))
    return tmp / "benchmark"


def small_cell(tmp: Path, name: str) -> spec.Cell:
    base = small_tree(tmp)
    return spec.Cell(name, bench=spec.load_json(tmp / "BENCHMARK.json"),
                     base=base)


# ------------------------------------------------------------------ data

def test_benchmark_json_meets_the_names_and_units_rules():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m["workloads"]:
            assert c in cells
            assert "workloads" not in moved or c in moved["workloads"], (m, c)
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert sum(1 for m in b["per_layer"] if w["name"] in m["workloads"])
        assert sum(1 for m in b["end_to_end"] if m["name"] != "setup_s" and
                   ("workloads" not in m or w["name"] in m["workloads"]))


def test_every_named_file_loads():
    b = spec.benchmark()
    for w in b["workloads"]:
        cell = spec.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["generator"] == "planted"
        assert cell.workload["check"]["limits"]
        cell.driver()
        cell.generator()
        for m in cell.end_to_end:
            assert callable(cell.reader("end_to_end", m["name"]).read)
        for m in cell.per_layer:
            assert callable(cell.reader("layer_metrics", m["name"]).read)
        for p in cell.config["passes"]:
            cell.roofline(p)
    for p in list((BENCH / "configs").glob("*.json")) + list(
            (BENCH / "workloads").glob("*.json")) + list(
            (BENCH / "traffic").glob("*.json")):
        json.loads(p.read_text())
    for c in b["configs"]:
        cfg = spec.load_json(ROOT / c["file"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_files_under_paths_are_named_by_the_rules():
    import re

    ok = re.compile(r"[A-Za-z0-9_./-]+\Z")
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert ok.match(str(p.relative_to(ROOT))), p


# ------------------------------------------------------------- generator

@pytest.mark.parametrize("mix", ["reads", "blocks"])
def test_generator_is_deterministic_by_seed(mix):
    traffic = (BLOCKS if mix == "blocks" else
               {**spec.load_json(BENCH / "traffic" / f"{mix}.json"), **SMALL[mix]})
    a = planted.generate(traffic, 2**31 + 5)
    b = planted.generate(traffic, 2**31 + 5)
    c = planted.generate(traffic, 7)
    assert a == b
    assert a[0] != c[0]
    # every seed gets the same lengths in the same order
    assert ([r["end1"] - r["start1"] for r in a[1]]
            == [r["end1"] - r["start1"] for r in c[1]])


def test_planted_alignment_covers_both_sequences():
    rng = np.random.default_rng(0)
    x = planted.genomic_like(rng, 3000)
    for _ in range(50):
        n = int(rng.integers(2, 400))
        y, ops = planted.evolve(rng, x[:n], 0.08, 0.03, 0.03, 5)
        assert sum(m for op, m in ops if op != "I") == n
        assert sum(m for op, m in ops if op != "D") == len(y)
        assert ops[0][0] == "M" and ops[-1][0] == "M"


def _columns(x, y, ops):
    """(matching M columns, mismatching M columns, D bases, I bases)."""
    i = j = same = diff = d = ins = 0
    for op, n in ops:
        if op == "M":
            eq = int((x[i:i + n] == y[j:j + n]).sum())
            same, diff = same + eq, diff + n - eq
            i, j = i + n, j + n
        elif op == "D":
            i, d = i + n, d + n
        else:
            j, ins = j + n, ins + n
    assert (i, j) == (len(x), len(y))
    return same, diff, d, ins


def test_reads_have_the_published_error_rates():
    """Substitutions 5.1%, insertions 4.9%, deletions 7.8% per base of
    the reference span (the rates of the traffic file's source)."""
    traffic = spec.load_json(BENCH / "traffic" / "reads.json")
    ev = traffic["evolve"]
    rng = np.random.default_rng(1)
    x = planted.genomic_like(rng, 200000)
    y, ops = planted.evolve(rng, x, ev["sub_rate"], ev["del_rate"],
                            ev["ins_rate"], ev["max_indel"])
    same, diff, d, ins = _columns(x, y, ops)
    assert diff / (same + diff) == pytest.approx(0.051, abs=0.003)
    assert d / len(x) == pytest.approx(0.078, abs=0.003)
    assert ins / len(x) == pytest.approx(0.049 * (1 - 0.078), abs=0.003)


def test_left_aligned_cigar_is_as_good_and_not_the_truth():
    rng = np.random.default_rng(4)
    x = planted.genomic_like(rng, 50000)
    y, ops = planted.evolve(rng, x, 0.068, 0.078, 0.049, 1)
    shifted = planted.left_align(x, y, ops)
    assert shifted != ops
    assert _columns(x, y, shifted) == _columns(x, y, ops)
    assert shifted[0][0] == "M" and shifted[-1][0] == "M"
    assert all(a[0] != b[0] for a, b in zip(shifted, shifted[1:]))
    # every gap after a match sits as far left as it goes: the base
    # before it differs from the gap's last base, or a single match is
    # left before it
    i = j = 0
    for k, (op, n) in enumerate(shifted):
        if op != "M" and shifted[k - 1][0] == "M" and shifted[k - 1][1] > 1:
            seq, pos = (x, i) if op == "D" else (y, j)
            assert seq[pos - 1] != seq[pos + n - 1]
        i += n if op != "I" else 0
        j += n if op != "D" else 0


# ---------------------------------------------------------------- readers

def test_roofline_costs_per_useful_cell():
    cell = spec.Cell("realign-reads")
    assert cell.roofline("fwd").cost(5, 13) == (20, 31)
    assert cell.roofline("bwd").cost(5, 13) == (24, 33)
    assert cell.roofline("exp").cost(5, 13) == (20, 70)


class _Event:
    def __init__(self, name, start, dur, device, annotation=False, tid=1):
        self._v = (name, start, dur, device, annotation, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def test_trace_reduction_busy_gaps_and_names():
    ev = [_Event("host_prep", 0, 100, False, True),
          _Event("fb_pass", 100, 900, False, True),
          _Event("fb_pass", 100, 900, True, True),  # mirrored range: not work
          _Event("wavefront_fwd<5>", 150, 100, True),
          _Event("wavefront_bwd<5>", 200, 100, True),  # overlaps
          _Event("Memcpy DtoH", 600, 50, True)]
    r = trace.reduce_events(ev, 1e-6)
    assert r["busy_s"] == pytest.approx(200e-9)
    assert r["kernels"]["wavefront_fwd<5>"] == pytest.approx(100e-9)
    assert r["idle_gaps"] == [["fb_pass", pytest.approx(300e-9)]]
    assert "fb_pass" not in r["kernels"]


def test_layer_readers_on_a_fake_run():
    import types

    cell = spec.Cell("em-reads")
    run = types.SimpleNamespace(
        cell=cell, stages={"host_prep": 1.0, "em_tasks": 6.0},
        window={"window_s": 10.0, "query_bases": 2_000_000, "iterations": 2},
        launches={"seg_fwd": 100, "seg_exp": 50, "wide_fwd": 7, "prep": 150,
                  "rows": 150},
        trace={"busy_s": 4.0, "window_s": 10.0,
               "kernels": {"wavefront_exp<5>": 2.0, "gemm": 1.0}},
        peaks={"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e13},
        driver=types.SimpleNamespace(useful_cells=lambda n: 1_000_000 * n))
    assert cell.reader("layer_metrics", "em_tasks_pct.em").read(run) == 60.0
    assert cell.reader("layer_metrics", "host_prep_pct.em").read(run) == 10.0
    assert readers.launches_per_mb(run) == 225.0
    assert readers.device_idle_pct(run) == pytest.approx(60.0)
    # 2e6 cells x (20 B / 1e12 + 20 B / 1e12) over 2 s of wavefront kernels
    assert readers.kernel_roofline_pct(run) == pytest.approx(4e-3)


# ------------------------------------------------------------ result line

def _check_line(result, traced):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert ("breakdown" in result) == traced
    d = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name", ["realign-reads", "em-reads"])
def test_a_small_run_prints_the_contract_line(tmp_path, name, capsys):
    cell = small_cell(tmp_path, name)
    result = harness.run_cell(cell, 2**31 + 3, 0.5, False, device="cpu")
    _check_line(result, traced=False)
    assert result["correct"] is True
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    harness.print_result(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert err.strip().splitlines()[-1].startswith("check ")


def test_a_traced_run_adds_the_breakdown(tmp_path, monkeypatch):
    """The traced line (here with a stand-in session: the CPU has no
    card to trace) carries busy_s, window_s and the breakdown."""
    class FakeSession:
        def start(self):
            pass

        def stop(self):
            pass

        def reduce(self):
            return {"busy_s": 0.25, "window_s": 1.0, "kernels": {},
                    "device_ops": [["k", 0.25]], "idle_gaps": [["h", 0.5]]}

    monkeypatch.setattr(trace, "Session", FakeSession)
    cell = small_cell(tmp_path, "realign-reads")
    result = harness.run_cell(cell, 11, 0.5, True, device="cpu")
    _check_line(result, traced=True)
    assert result["device"]["busy_s"] == 0.25
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert result["metrics"]["device_idle_pct.realign"]["value"] == 75.0


def test_non_finite_numbers_print_as_null(capsys):
    harness.print_result({"correct": False, "attempted": 1, "failed": 0,
                          "metrics": {}, "device": {},
                          "checks": {"gap": {"value": float("nan"),
                                             "limit": 1.0}}})
    out = json.loads(capsys.readouterr()[0].strip())
    assert out["checks"]["gap"]["value"] is None


# --------------------------------------------------------- data-driven

def test_a_new_cell_needs_only_new_files(tmp_path):
    """A throwaway cell: a new traffic file, a new workload file and a
    new entry in BENCHMARK.json, and no other change, run end to end."""
    base = small_tree(tmp_path)
    (base / "traffic" / "tiny-blocks.json").write_text(json.dumps({
        "generator": "planted", "kind": "blocks", "records": 2,
        "lengths": {"dist": "uniform", "low": 600, "high": 900},
        "evolve": {"sub_rate": 0.05, "del_rate": 0.01, "ins_rate": 0.01,
                   "max_indel": 3}}))
    (base / "workloads" / "em-tiny.json").write_text(json.dumps({
        "why": "throwaway", "check": {"steps": 1, "cell_budget": 1 << 20,
                                      "limits": {"count_gap": 1e-3,
                                                 "likelihood_gap": 1e-3,
                                                 "model_gap": 1e-3}}}))
    bench = spec.load_json(tmp_path / "BENCHMARK.json")
    bench["workloads"].append({"name": "em-tiny", "config": "em",
                               "traffic": "tiny-blocks", "chips": 1,
                               "why": "throwaway"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("em-tiny", bench=spec.load_json(tmp_path / "BENCHMARK.json"),
                     base=base)
    result = harness.run_cell(cell, 5, 0.2, False, device="cpu")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s"}


# ---------------------------------------------------------------- imports

def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for p in BENCH.rglob("*.py"):
        tops = set(_top_imports(p))
        assert not tops & {"jax", "jaxlib", "flax", "cpecan_tpu"}, p


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        assert "cpecan_tpu_torch" not in set(_top_imports(p)), p


def test_a_fresh_interpreter_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.lib import spec, harness\n"
        "for w in spec.benchmark()['workloads']:\n"
        "    c = spec.Cell(w['name']); c.driver(); c.generator()\n"
        "import cpecan_tpu_torch.cli.realign, cpecan_tpu_torch.em.em\n"
        "bad = harness.forbidden_modules()\n"
        "ref = [m for m in sys.modules if m.startswith('benchmark.reference')]\n"
        "print(bad, len(ref))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "[]"


def test_without_the_program_the_command_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    run.py exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "realign-reads",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
