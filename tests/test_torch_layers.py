"""The port's import layering, by an AST scan of every module of
cpecan_tpu_torch (imports inside functions included):

  cli/*  ->  em/em.py, align/pairwise.py, msa/  ->  align/batch.py
         ->  ops/fb_batch.py  ->  ops/fb_wavefront.py, ops/fb_streaming.py

One case per rule. An arrow that goes against a rule and stays is listed
in ALLOWED with its reason."""

import ast
from pathlib import Path

import pytest

import cpecan_tpu_torch

PKG = "cpecan_tpu_torch"
ROOT = Path(cpecan_tpu_torch.__file__).resolve().parent

ALLOWED = {
    ("ops.band", "align.native"):
        "the band builder calls the host library, which align/native.py "
        "loads for every native helper",
    ("ops.mea", "align.native"):
        "the MEA decode calls the same host library",
    ("models.state_machine", "ops.fb_wavefront"):
        "PairHMM keeps the kernels' table of nonzero transitions",
    ("em.em", "cli.realign"):
        "cPecanEm's --updateTheBand runs cPecanRealign (em.realign_chunk)",
}


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _is_module(name: str) -> bool:
    """Whether PKG.name is a module or package of the port."""
    base = ROOT.joinpath(*name.split("."))
    return base.with_suffix(".py").exists() or (base / "__init__.py").exists()


def _imports():
    """(importer, target module, imported name or None) for every import
    of a port module, names relative to the package."""
    out = []
    for path in sorted(ROOT.rglob("*.py")):
        if "csrc" in path.parts:
            continue
        me = _module_name(path)
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.startswith(PKG + "."):
                        out.append((me, a.name[len(PKG) + 1:], None))
            elif (isinstance(node, ast.ImportFrom) and node.level == 0
                  and node.module and node.module.startswith(PKG)):
                mod = node.module[len(PKG) + 1:]
                for a in node.names:
                    sub = f"{mod}.{a.name}" if mod else a.name
                    if _is_module(sub):
                        out.append((me, sub, None))
                    else:
                        out.append((me, mod, a.name))
    return out


def _under(name: str, prefixes) -> bool:
    return any(name == p or name.startswith(p + ".") for p in prefixes)


def _sub_package(name: str) -> str:
    return name.split(".")[0]


def _private(target: str, name) -> bool:
    parts = target.split(".") + ([name] if name else [])
    return any(p.startswith("_") and not p.startswith("__") for p in parts)


RULES = {
    # rule: (importers, targets they must not import)
    "ops_below_the_batch_layer": (("ops",), ("align", "em", "cli", "msa")),
    "align_below_em_and_cli": (("align",), ("em", "cli")),
    "batch_below_pairwise": (("align.batch",), ("align.pairwise",)),
    "realign_cli_apart_from_em": (("cli.realign",), ("em",)),
    "em_below_cli": (("em",), ("cli",)),
    "models_below_ops": (("models",), ("ops", "align", "em", "cli", "msa")),
}


@pytest.mark.parametrize("rule", sorted(RULES) + ["private_names"])
def test_imports_point_down(rule):
    found = set()
    for me, target, name in _imports():
        if rule == "private_names":
            if (_sub_package(me) != _sub_package(target)
                    and _private(target, name)):
                found.add((me, f"{target}.{name}" if name else target))
            continue
        importers, targets = RULES[rule]
        if _under(me, importers) and _under(target, targets):
            found.add((me, target))
    assert not {arrow for arrow in found if arrow not in ALLOWED}, found


def test_allowed_arrows_exist():
    """Every arrow ALLOWED names is still there (else it leaves the list)."""
    arrows = {(me, target) for me, target, _ in _imports()}
    assert set(ALLOWED) <= arrows, set(ALLOWED) - arrows
