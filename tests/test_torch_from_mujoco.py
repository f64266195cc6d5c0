"""The MuJoCo extractor and the baked-asset writer of the port
(`envs/physics/model.py::from_mujoco`, `mj_flip_flags`, `save`) against the
JAX package's, and the port's engine in float64 against MuJoCo itself.

- `from_mujoco` on every dm_control model the reference's asset bake
  reads, with the bake's own arguments (tools/bake_assets.py): every field
  of the port's PlanarModel equals the reference's exactly (arrays of the
  same dtype and values, tuples, scalars and strings equal).
- `save` then `load` gives the same fields back, and the reference's
  `load` reads the port's file as the port's `load` does; extras are
  stored under `x_`.
- The port's engine in float64 on the CPU against MuJoCo's own quantities
  on the nine domains of tests/test_physics_parity.py, at that file's
  tolerances: FK to 1e-12, the mass matrix, bias and passive forces to
  1e-10, actuation to 1e-12; from the port's own `from_mujoco` and from the
  baked assets. Until now the port was held against MuJoCo only through
  the JAX engine.
"""

import dataclasses

import numpy as np
import pytest
import torch

from surreal_tpu.envs.physics import model as jmodel
from surreal_tpu_torch.envs.base import ASSET_DIR
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as tmodel

mujoco = pytest.importorskip("mujoco")
suite = pytest.importorskip("dm_control.suite")

# (asset, domain, task, pair_collisions): every model tools/bake_assets.py bakes
BAKED = [
    ("cartpole", "cartpole", "balance", False), ("cheetah", "cheetah", "run", False),
    ("walker", "walker", "walk", False), ("pendulum", "pendulum", "swingup", False),
    ("acrobot", "acrobot", "swingup", False), ("hopper", "hopper", "stand", False),
    ("reacher", "reacher", "easy", False), ("point_mass", "point_mass", "easy", False),
    ("ball_in_cup", "ball_in_cup", "catch", True), ("finger", "finger", "spin", True),
    ("manipulator_ball", "manipulator", "bring_ball", True),
    ("manipulator_peg", "manipulator", "bring_peg", True),
    ("swimmer6", "swimmer", "swimmer6", False), ("swimmer15", "swimmer", "swimmer15", False),
    ("cartpole_2", "cartpole", "two_poles", False),
    ("cartpole_3", "cartpole", "three_poles", False),
]
# the domains of tests/test_physics_parity.py
PARITY = ["cartpole", "cheetah", "walker", "pendulum", "acrobot", "hopper", "point_mass",
          "ball_in_cup", "finger"]


@pytest.fixture(scope="module")
def compiled():
    """asset -> (dm_control env, the reference's model, the port's model)."""
    out = {}
    for asset, domain, task, pairs in BAKED:
        env = suite.load(domain, task)
        mj = env.physics.model._model
        out[asset] = (env, jmodel.from_mujoco(mj, pair_collisions=pairs),
                      tmodel.from_mujoco(mj, pair_collisions=pairs))
    return out


def assert_same_fields(got, want, label):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (
                label, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{label}.{f.name}")
        else:
            assert type(a) is type(b) and a == b, (label, f.name, a, b)


@pytest.mark.parametrize("asset", [b[0] for b in BAKED])
def test_from_mujoco_equals_reference(compiled, asset):
    _, ref, port = compiled[asset]
    assert_same_fields(port, ref, asset)


def test_flip_flags_and_quaternion_helpers_equal_reference(compiled):
    for asset, (env, _, _) in compiled.items():
        mj = env.physics.model._model
        for normal in (1, 2):
            assert tmodel.mj_flip_flags(mj, normal) == jmodel.mj_flip_flags(mj, normal), asset
        for b in range(mj.nbody):
            np.testing.assert_array_equal(tmodel._quat_to_mat(mj.body_quat[b]),
                                          jmodel._quat_to_mat(mj.body_quat[b]))
    # the manipulator's finger frame is mirrored: the canonicalization has work to do
    assert any(tmodel.mj_flip_flags(compiled["manipulator_ball"][0].physics.model._model, 1))
    for quat in ([1.0, 0.0, 0.0, 0.0], [0.8, 0.0, 0.6, 0.0], [0.0, 0.0, 1.0, 0.0]):
        assert tmodel._quat_to_yangle(quat) == jmodel._quat_to_yangle(quat)


@pytest.mark.parametrize("asset", ["cheetah", "ball_in_cup", "manipulator_peg", "swimmer6"])
def test_save_load_round_trip(compiled, asset, tmp_path):
    _, ref, port = compiled[asset]
    extras = {"site_names": np.asarray(["a", "bb"]), "site_pos": np.arange(6.0).reshape(3, 2)}
    path = str(tmp_path / f"{asset}.npz")
    tmodel.save(port, path, extras=extras)
    assert_same_fields(tmodel.load(path), ref, asset)
    assert_same_fields(jmodel.load(path), ref, asset)  # the reference reads the port's file
    z = np.load(path)
    for k, v in extras.items():
        np.testing.assert_array_equal(z[f"x_{k}"], v)
    ref_path = str(tmp_path / f"{asset}_ref.npz")
    jmodel.save(ref, ref_path, extras=extras)
    zr = np.load(ref_path)
    assert sorted(z.files) == sorted(zr.files)
    for k in zr.files:
        assert z[k].dtype == zr[k].dtype, k
        np.testing.assert_array_equal(z[k], zr[k], err_msg=k)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))[None]


@pytest.mark.parametrize("source", ["from_mujoco", "asset"])
@pytest.mark.parametrize("domain", PARITY)
def test_float64_engine_matches_mujoco(compiled, domain, source, rng):
    env, _, port = compiled[domain]
    pm = port if source == "from_mujoco" else tmodel.load(f"{ASSET_DIR}/{domain}.npz")
    mj, d = env.physics.model._model, env.physics.data._data
    cols = [0, 1] if pm.plane == "xy" else [0, 2]
    for _ in range(5):
        q, qd = rng.uniform(-1, 1, mj.nq), rng.uniform(-1, 1, mj.nv)
        d.qpos[:], d.qvel[:] = q, qd
        mujoco.mj_forward(mj, d)
        pos, ang = engine.fk(pm, _t(q))
        np.testing.assert_allclose(pos[0].numpy(), d.xpos[1:][:, cols], atol=1e-12)
        if pm.plane == "xz":
            xm = d.xmat[1:].reshape(-1, 3, 3)
            np.testing.assert_allclose(np.sin(ang[0].numpy()), xm[:, 0, 2], atol=1e-12)
        M_mj = np.zeros((mj.nv, mj.nv))
        mujoco.mj_fullM(mj, d, M_mj)
        np.testing.assert_allclose(engine.mass_matrix(pm, _t(q))[0].numpy(), M_mj, atol=1e-10)
        bias = engine.bias_forces(pm, _t(q), _t(qd))[0].numpy()
        np.testing.assert_allclose(bias, d.qfrc_bias, atol=1e-10)
        passive = engine.passive_spring_forces(pm, _t(q))[0].numpy() - pm.damping * qd
        np.testing.assert_allclose(passive, d.qfrc_passive, atol=1e-10)
        ctrl = rng.uniform(-1, 1, mj.nu)
        d.ctrl[:] = ctrl
        mujoco.mj_forward(mj, d)
        act = engine.actuation(pm, _t(ctrl))[0].numpy()
        np.testing.assert_allclose(act, d.qfrc_actuator, atol=1e-12)
