"""The port's align and modify_hmm CLIs against the JAX package's.

align (port on the CPU): stdout identical to cpecan_tpu.cli.align's on
tests/test_cli.py's align fixture and on a 3-target x 2-query fasta,
with the default model and with --loadHmm. modify_hmm (host only): the
output model file byte-identical for each of its flags, on 5- and
3-state models. Each of the JAX package's console scripts in
pyproject.toml has a -torch counterpart whose target is a callable main of
cpecan_tpu_torch.cli, and --help through it loads no jax.
"""

import io
import json
import os
import random
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from cpecan_tpu.cli import align as jax_align
from cpecan_tpu.cli import modify_hmm as jax_modify_hmm
from cpecan_tpu.models.hmm import Hmm, StateMachineType
from cpecan_tpu.utils.symbols import evolve_sequence, get_random_sequence
from cpecan_tpu_torch.cli import align as port_align
from cpecan_tpu_torch.cli import modify_hmm as port_modify_hmm
from test_cli import write_fasta
from test_torch_batch_cli import _hmm_file

torch.set_num_threads(1)


@pytest.fixture
def one_pair(tmp_path):
    """tests/test_cli.py's TestAlign fixture."""
    rng = random.Random(7)
    t = "".join(rng.choice("ACGT") for _ in range(50))
    q = evolve_sequence(t, rng).upper() or "ACGT"
    write_fasta(tmp_path / "t.fa", {"t1": t})
    write_fasta(tmp_path / "q.fa", {"q1": q})
    return str(tmp_path / "t.fa"), str(tmp_path / "q.fa")


@pytest.fixture
def three_by_two(tmp_path):
    """Three targets and two queries evolved from them, of differing
    lengths: six pairs, related and unrelated."""
    rng = random.Random(29)
    targets = {f"t{i}": get_random_sequence(40 + 9 * i, rng).upper()
               for i in range(3)}
    queries = {f"q{i} query {i}": evolve_sequence(targets[f"t{i}"], rng).upper()
               for i in range(2)}
    write_fasta(tmp_path / "t.fa", targets)
    write_fasta(tmp_path / "q.fa", queries)
    return str(tmp_path / "t.fa"), str(tmp_path / "q.fa")


def _align(cli, fastas, *args):
    stdout = io.StringIO()
    assert cli.main([*fastas, *args], stdout=stdout) == 0
    return stdout.getvalue()


_ALIGN_CASES = {
    "one_pair": ("one_pair", None),
    "one_pair_load_hmm": ("one_pair", StateMachineType.fiveState),
    "three_by_two": ("three_by_two", None),
    "three_by_two_load_hmm_five_state": ("three_by_two",
                                         StateMachineType.fiveState),
    "three_by_two_load_hmm_three_state": ("three_by_two",
                                          StateMachineType.threeState),
}


@pytest.mark.parametrize("case", sorted(_ALIGN_CASES))
def test_align_cli_matches_jax(case, request, tmp_path):
    fixture, hmm_type = _ALIGN_CASES[case]
    fastas = request.getfixturevalue(fixture)
    args = () if hmm_type is None else ("--loadHmm",
                                        _hmm_file(tmp_path, hmm_type))
    ref = _align(jax_align, fastas, *args)
    new = _align(port_align, fastas, *args, "--device", "cpu")
    assert new == ref
    assert new.count("cigar:") == (1 if fixture == "one_pair" else 6)


def test_align_cli_device_cuda_without_a_gpu_raises(one_pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _align(port_align, one_pair, "--device", "cuda")


_MODIFY_FLAGS = {
    "gc_content": ("--gcContent", "0.6"),
    "substitution_rate": ("--substitutionRate", "0.1"),
    "flat_indel_emissions": ("--setFlatIndelEmissions",),
    "all": ("--gcContent", "0.6", "--substitutionRate", "0.1",
            "--setFlatIndelEmissions"),
}


@pytest.mark.parametrize("hmm_type", ["fiveState", "threeState"])
@pytest.mark.parametrize("flags", sorted(_MODIFY_FLAGS))
def test_modify_hmm_cli_matches_jax(flags, hmm_type, tmp_path):
    hmm = Hmm(StateMachineType[hmm_type])
    hmm.randomise(np.random.default_rng(0))
    in_file = str(tmp_path / "in.hmm")
    hmm.save(in_file, precise=True)
    out = {}
    for name, cli in (("jax", jax_modify_hmm), ("port", port_modify_hmm)):
        out_file = str(tmp_path / f"{name}.hmm")
        assert cli.main([in_file, out_file, *_MODIFY_FLAGS[flags]]) == 0
        with open(out_file, "rb") as fh:
            out[name] = fh.read()
    assert out["port"] == out["jax"]
    with open(in_file, "rb") as fh:
        assert out["port"] != fh.read()


_REPO = Path(__file__).resolve().parents[1]
_SCRIPTS = tomllib.loads((_REPO / "pyproject.toml").read_text())[
    "project"]["scripts"]
_JAX_SCRIPTS = sorted(k for k, v in _SCRIPTS.items()
                      if v.startswith("cpecan_tpu.cli."))

# the console script's call: main() with the script's name and --help in
# sys.argv, in a fresh interpreter; prints the exit code and what of jax
# and the JAX package got loaded
_HELP = """
import importlib, json, sys
module, func = sys.argv[1].split(":")
main = getattr(importlib.import_module(module), func)
sys.argv = [sys.argv[2], "--help"]
try:
    code = main()
except SystemExit as e:
    code = e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cpecan_tpu"))
print(json.dumps({"callable": callable(main), "code": code, "bad": bad}))
"""


@pytest.mark.parametrize("script", _JAX_SCRIPTS)
def test_console_script_has_a_torch_counterpart(script):
    assert len(_JAX_SCRIPTS) == 4
    target = _SCRIPTS[f"{script}-torch"]
    module = _SCRIPTS[script].split(":")[0].replace("cpecan_tpu.",
                                                    "cpecan_tpu_torch.", 1)
    assert target == f"{module}:main"
    proc = subprocess.run(
        [sys.executable, "-c", _HELP, target, f"{script}-torch"],
        capture_output=True, text=True, cwd=_REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(_REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    *help_text, last = proc.stdout.splitlines()
    assert json.loads(last) == {"callable": True, "code": 0, "bad": []}
    # the port's parsers keep the JAX package's program names
    assert any(line.startswith(f"usage: {script} ") for line in help_text)
