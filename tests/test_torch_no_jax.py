"""The PyTorch port imports neither jax nor anything of the JAX package
(cpecan_tpu), not even a module of it that has no jax in it: neither
directly (AST scan of every module) nor through what it imports (a fresh
interpreter imports every module of the package and chip_smoke.py's
imports, and checks sys.modules)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
_PKG = _REPO / "cpecan_tpu_torch"


def _modules():
    for path in sorted(_PKG.rglob("*.py")):
        rel = path.relative_to(_REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_no_module_imports_jax_by_name():
    offenders = []
    for path, mod in _modules():
        offenders += [(mod, n) for n in _imported_names(path)
                      if n == "jax" or n.startswith("jax.")]
    assert not offenders
    assert len(list(_modules())) >= 30


def test_no_module_imports_the_jax_package():
    offenders = []
    for path, mod in _modules():
        offenders += [(mod, n) for n in _imported_names(path)
                      if n == "cpecan_tpu" or n.startswith("cpecan_tpu.")]
    assert not offenders


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names neither jax nor a module of the JAX package:
    it reaches the system through cpecan_tpu_torch alone."""
    names = list(_imported_names(_REPO / "chip_smoke.py"))
    assert "cpecan_tpu_torch.cli" in names
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "cpecan_tpu"}, top


def test_importing_every_module_loads_no_jax():
    mods = [m for _, m in _modules()] + ["chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'cpecan_tpu')"
            " or m.startswith(('jax.', 'jaxlib', 'cpecan_tpu.')))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=_REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "cpecan_tpu_torch.cli.realign" in mods
