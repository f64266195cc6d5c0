"""The port's import rule: nothing under surreal_tpu_torch/, nor
chip_smoke.py, imports jax, jaxlib, flax, optax or the surreal_tpu
package, and every module of the port imports on a machine without a
card."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "surreal_tpu"}
FILES = sorted((ROOT / "surreal_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rule_catches_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom surreal_tpu.envs import base\nimport jax.numpy as jnp\n")
    assert set(_imported_roots(f)) & FORBIDDEN == {"surreal_tpu", "jax"}


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name != "csrc" and p.name != "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_without_a_card(path):
    mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    importlib.import_module(mod.removesuffix(".__init__"))
