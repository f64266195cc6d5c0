"""The port's import rule: nothing under surreal_tpu_torch/, nor
chip_smoke.py, imports jax, jaxlib, flax, optax, orbax, the surreal_tpu
package, tensorboard, tensorflow or PIL (the card's machine has none of
the last three: the port writes its event files and GIFs itself), and
every module of the port imports on a machine without a card, and without
gymnasium, mujoco and dm_control (the host bridges import them where they
are used)."""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "surreal_tpu", "tensorboard",
             "tensorflow", "PIL"}
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


BRIDGES = ("gymnasium", "gym", "mujoco", "dm_control")
BLOCKED_IMPORTS = r"""
import importlib, sys
for name in sys.argv[1].split(","):
    sys.modules[name] = None  # an import of it now raises ImportError
try:
    import gymnasium
except ImportError:
    pass
else:
    raise SystemExit("the block did not take")
for mod in sys.argv[2:]:
    importlib.import_module(mod)
print("imported", len(sys.argv) - 2)
"""


def test_port_modules_import_without_the_bridge_packages():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
            for p in FILES if p.parent.name != "csrc" and p.name != "chip_smoke.py"]
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS, ",".join(BRIDGES), *mods],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["imported", str(len(mods))]
    assert {"surreal_tpu_torch.envs.gym_adapter", "surreal_tpu_torch.envs.oracle",
            "surreal_tpu_torch.train.video"} <= set(mods)
