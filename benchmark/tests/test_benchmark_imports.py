"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `surreal_tpu_torch` is not `surreal_tpu`), and the
reference imports nothing of the measured program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "surreal_tpu"}
MODULES = sorted(p for p in BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "surreal_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "contextlib", "dataclasses",
                                       "typing", "numpy", "torch"}


def test_the_check_compares_whole_names():
    from benchmark import harness

    assert "surreal_tpu" in harness.FORBIDDEN
    import sys
    sys.modules.setdefault("surreal_tpu_torch_lookalike", sys)
    try:
        assert "surreal_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["surreal_tpu_torch_lookalike"]
