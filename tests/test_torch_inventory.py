"""The port is complete against the JAX package, read from source with
`ast` (neither package is imported):

- every module of `surreal_tpu/` has its counterpart file under
  `surreal_tpu_torch/` at the same path, or the one in COUNTERPART (the
  two Pallas modules, whose kernels are the port's CUDA C++);
- every public top-level `def` and `class` of a JAX module is bound at the
  top of its counterpart (a def, a class, an assignment or an import), or
  is renamed there (RENAMED), or is JAX-only (JAX_ONLY, each with its
  reason, and named so in ROADMAP.md's known differences);
- the JAX package's `pallas_call` sites are the three that the port's
  kernels replace (PALLAS_SITES): a fourth is a TPU kernel to port.
"""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "surreal_tpu", ROOT / "surreal_tpu_torch"

COUNTERPART = {"ops/pallas_gae.py": "ops/gae_kernel.py",
               "ops/pallas_ppo_loss.py": "ops/ppo_loss_kernel.py"}
RENAMED = {("ops/pallas_gae.py", "gae_pallas"): "gae_cuda"}  # named after its route
JAX_ONLY = {
    ("envs/base.py", "vectorize"): "the port's envs are batched: there is nothing to vmap",
    ("utils/guards.py", "checked"): "checkify; the port's guards.checking() raises eagerly",
    ("utils/guards.py", "jit_checked"): "checkify under jit; the port has no jit to wrap",
    ("algos/ppo.py", "make_optimizer"): "optax; the port writes out the same clip and Adam",
    ("algos/ddpg.py", "make_optimizers"): "optax; the port writes out the same Adam",
    ("parallel/dp.py", "train_state_spec"): "GSPMD specs; the port places state per rank",
    ("parallel/dp.py", "place_by_spec"): "GSPMD placement; the port places state per rank",
    ("parallel/tp.py", "tp_tree_sharding"): "GSPMD shardings; each rank holds its own shard",
    ("parallel/tp.py", "shard_params_tp"): "GSPMD placement; each rank holds its own shard",
    ("parallel/zero.py", "zero_state_spec"): "GSPMD spec; each rank holds its own chunk",
}
PALLAS_SITES = {("ops/pallas_gae.py", 72), ("ops/pallas_ppo_loss.py", 134),
                ("ops/pallas_ppo_loss.py", 178)}

JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


def public_defs(tree: ast.Module) -> list[str]:
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def top_level_names(tree: ast.Module) -> set[str]:
    """Every name a module binds at its top level."""
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
        elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names.update(x.id for t in targets for x in ast.walk(t) if isinstance(x, ast.Name))
    return names


def check_module(module: str, jax_file: pathlib.Path, port_file: pathlib.Path,
                 renamed=RENAMED, jax_only=JAX_ONLY) -> None:
    """Fails, naming what is missing, unless `port_file` exists and binds
    every public def and class of `jax_file` (as renamed), but the JAX-only
    ones, which it must not bind."""
    assert port_file.exists(), f"{module} has no counterpart: {port_file} is missing"
    ours = top_level_names(ast.parse(port_file.read_text()))
    theirs = public_defs(ast.parse(jax_file.read_text()))
    missing = [name for name in theirs if (module, name) not in jax_only
               and renamed.get((module, name), name) not in ours]
    assert not missing, f"{port_file} lacks {missing} of {jax_file}"
    stale = [name for (m, name) in jax_only if m == module
             and (name not in theirs or name in ours)]
    assert not stale, f"JAX-only {stale} of {module} is not JAX-only any more"


def pallas_call_sites(package: pathlib.Path) -> set[tuple[str, int]]:
    """(module, line) of every call of `pallas_call` (bare or as an
    attribute, `pl.pallas_call`) under `package`."""
    sites = set()
    for path in package.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                f = node.func
                if (f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")) \
                        == "pallas_call":
                    sites.add((path.relative_to(package).as_posix(), node.lineno))
    return sites


def check_pallas_sites(package: pathlib.Path, known=PALLAS_SITES) -> None:
    new = sorted(pallas_call_sites(package) - known)
    assert not new, "TPU kernels the port has not ported: " + ", ".join(
        f"{package.name}/{m}:{line}" for m, line in new)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_has_its_counterpart(module):
    check_module(module, JAX_PKG / module, PORT_PKG / COUNTERPART.get(module, module))


def test_the_explicit_entries_name_real_modules():
    for module, port in COUNTERPART.items():
        assert (JAX_PKG / module).exists() and (PORT_PKG / port).exists(), (module, port)
        assert not (PORT_PKG / module).exists(), f"{module} has a namesake in the port"
    assert all(m in JAX_MODULES for m, _ in [*RENAMED, *JAX_ONLY])
    assert all(reason for reason in JAX_ONLY.values())


def test_the_pallas_sites_are_the_three_ported_kernels():
    assert pallas_call_sites(JAX_PKG) == PALLAS_SITES
    check_pallas_sites(JAX_PKG)


def test_the_jax_only_list_is_roadmaps_known_differences():
    """ROADMAP.md names each JAX-only helper as `module.py::name` in its
    known differences' JAX-only bullet, and names no other there."""
    text = (ROOT / "ROADMAP.md").read_text()
    bullet = re.search(r"- \*\*JAX-only helpers.*?(?=\n- |\n#|\Z)", text, re.S)
    assert bullet, "ROADMAP.md has no JAX-only bullet in its known differences"
    named = set(re.findall(r"`([\w/]+\.py)::(\w+)`", bullet.group(0)))
    assert named == set(JAX_ONLY), named ^ set(JAX_ONLY)


def test_a_missing_name_fails_the_check(tmp_path):
    """The checker on a synthetic pair: a name the port lacks, and a
    JAX-only entry the port does define, each fail."""
    jax_file, port_file = tmp_path / "jax_mod.py", tmp_path / "port_mod.py"
    jax_file.write_text("def kept():\n    pass\n\n\nclass Missing:\n    pass\n\n\n"
                        "def _private():\n    pass\n\n\ndef old():\n    pass\n")
    port_file.write_text("from x import kept\n\n\ndef new():\n    pass\n")
    renamed = {("m.py", "old"): "new"}
    with pytest.raises(AssertionError, match=r"lacks \['Missing'\]"):
        check_module("m.py", jax_file, port_file, renamed, {})
    check_module("m.py", jax_file, port_file, renamed, {("m.py", "Missing"): "a reason"})
    with pytest.raises(AssertionError, match=r"JAX-only \['kept'\]"):
        check_module("m.py", jax_file, port_file, renamed,
                     {("m.py", "Missing"): "a reason", ("m.py", "kept"): "a reason"})
    with pytest.raises(AssertionError, match="has no counterpart"):
        check_module("m.py", jax_file, tmp_path / "absent.py", renamed, {})


def test_a_fourth_pallas_call_fails_naming_its_site(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "ops" / "k.py").write_text(
        "from jax.experimental import pallas as pl\n\n\ndef f(x):\n"
        "    return pl.pallas_call(lambda r: r, out_shape=x)(x)\n")
    check_pallas_sites(pkg, known={("ops/k.py", 5)})
    with pytest.raises(AssertionError, match=r"pkg/ops/k\.py:5"):
        check_pallas_sites(pkg, known=PALLAS_SITES)
