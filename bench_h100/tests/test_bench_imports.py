"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the program's package begins with the JAX package's
name), and the reference imports nothing of the program."""

import ast

import pytest

import harness
from tiny import BENCH


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(imports(path)) <= {"__future__", "dataclasses", "math", "re", "typing", "yaml",
                                  "numpy", "torch"}


def test_forbidden_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "wanq_tpu_torch_lookalike", types.ModuleType("x"))
    assert "wanq_tpu" not in harness.forbidden_modules() or "wanq_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "wanq_tpu.quant", types.ModuleType("y"))
    assert "wanq_tpu" in harness.forbidden_modules()
