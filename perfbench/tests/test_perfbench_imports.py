"""No module of the benchmark imports jax, jaxlib, flax or the JAX
package ``madipm_tpu`` (by whole top-level name: ``madipm_tpu_torch``
is the port), and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

from perfbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "madipm_tpu"}
FILES = sorted(p for p in spec.HOME.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).partition(".")[0])
    return names


def test_whole_name_rule():
    assert "madipm_tpu_torch".partition(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HOME)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HOME / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "madipm_tpu_torch" not in top_level_imports(path)


def test_forbidden_module_check(monkeypatch):
    import sys
    import types

    assert "madipm_tpu_torch" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "madipm_tpu.ops", types.ModuleType("madipm_tpu.ops"))
    assert harness.loaded_forbidden() == ["madipm_tpu"]
