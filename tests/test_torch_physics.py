"""Port cheetah physics against the JAX engine on 64 pool states with
random velocities and controls.

Tolerance: max |port − ref| ≤ TOL · max(1, max |ref|), with TOL = 2e-6
for the closed-form functions (float32 rounding through sin/cos and
9-term sums, which the two libraries order differently) and 2e-5 for the
constraint projection and the full step (20 Jacobi sweeps amplify that
rounding by the Delassus operator's conditioning).

A contact row is active iff its depth is > 0, a discontinuity: a resting
contact sits within float32 rounding of depth 0 and may be active in one
implementation and not the other (the reference itself rounds such a
depth differently inside its fused step than alone). Envs whose active
sets differ, or with a contact within one float32 spacing of body heights
(6e-8) of depth 0, are excluded from the comparison of projected
velocities; the tests assert that such envs are rare.
"""

import os

import jax
import numpy as np
import pytest
import torch

from surreal_tpu.envs import cheetah as jcheetah
from surreal_tpu.envs.physics import engine as je
from surreal_tpu.envs.physics import linalg as jl
from surreal_tpu.envs.physics import model as jm
from surreal_tpu_torch.envs import flatten_obs, make_env
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.envs.cheetah import ASSET_DIR
from surreal_tpu_torch.envs.physics import engine as te
from surreal_tpu_torch.envs.physics import linalg as tl
from surreal_tpu_torch.envs.physics import model as tm
import torch_helpers  # noqa: F401  (one torch thread a test process)

B = 64
TOL_CLOSED, TOL_SOLVE = 2e-6, 2e-5
MAX_EXCLUDED = 6  # envs of 64 whose contact active set is ambiguous


@pytest.fixture(scope="module")
def data():
    path = f"{ASSET_DIR}/cheetah.npz"
    pool = np.load(f"{ASSET_DIR}/cheetah_pool.npz")
    rs = np.random.RandomState(0)
    idx = rs.randint(0, pool["q"].shape[0], B)
    q = pool["q"][idx]
    qd = pool["qd"][idx] + 0.5 * rs.randn(B, 9).astype(np.float32)
    ctrl = rs.uniform(-1.2, 1.2, (B, 6)).astype(np.float32)
    mj, mt = jm.load(path), tm.load(path)
    M = np.asarray(jax.vmap(lambda x: je.mass_matrix(mj, x))(q))
    depth_j = np.asarray(jax.vmap(lambda x: je._contact_kinematics(mj, x)[1])(q))
    depth_t = te._contact_kinematics(mt, torch.tensor(q))[1].numpy()
    same_active = ((depth_j > 0) == (depth_t > 0)).all(1) & (np.abs(depth_j).min(1) > 6e-8)
    return dict(mj=mj, mt=mt, q=q, qd=qd, ctrl=ctrl, M=M, b=rs.randn(B, 9).astype(np.float32),
                v=(qd + rs.randn(B, 9)).astype(np.float32), same_active=same_active)


def _close(ref, port, tol, rows=None):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    if rows is not None:
        ref, port = ref[rows], port[rows]
    assert ref.shape == port.shape
    err = np.abs(ref - port).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


ASSETS = sorted(p.removesuffix(".npz") for p in os.listdir(ASSET_DIR)
                if p.endswith(".npz") and not p.endswith("_pool.npz"))


@pytest.mark.parametrize("asset", ASSETS)
def test_model_load_matches_reference(asset):
    """Every field of every baked asset, the optional ones included."""
    path = f"{ASSET_DIR}/{asset}.npz"
    mj, mt = jm.load(path), tm.load(path)
    for f in jm._ARRAY_FIELDS + jm._OPT_ARRAY_FIELDS:
        a, b = getattr(mj, f), getattr(mt, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    for f in jm._TUPLE_FIELDS + jm._OPT_TUPLE_FIELDS + jm._SCALAR_FIELDS:
        assert getattr(mj, f) == getattr(mt, f), f


LINALG = {
    "chol_small": (lambda d: jl.chol_small(d["M"]), lambda d: tl.chol_small(*_t(d["M"]))),
    "solve_spd": (lambda d: jl.solve_spd(d["M"], d["b"]),
                  lambda d: tl.solve_spd(*_t(d["M"], d["b"]))),
    "inv_spd": (lambda d: jl.inv_spd(d["M"]), lambda d: tl.inv_spd(*_t(d["M"]))),
}


@pytest.mark.parametrize("name", sorted(LINALG))
def test_linalg_matches_reference(data, name):
    ref, port = LINALG[name]
    _close(jax.jit(lambda: ref(data))(), port(data), TOL_CLOSED)


def _vm(fn, *args):
    return jax.jit(jax.vmap(fn))(*args)


KINEMATICS = ["fk_dofs", "fk_dofs_dot", "mass_matrix", "bias_forces", "_contact_kinematics",
              "subtree_com_velocity", "actuation", "passive_spring_forces"]


@pytest.mark.parametrize("name", KINEMATICS)
def test_kinematics_matches_reference(data, name):
    mj, mt, q, qd, ctrl = data["mj"], data["mt"], data["q"], data["qd"], data["ctrl"]
    qt, qdt, ct = _t(q, qd, ctrl)
    if name in ("fk_dofs", "mass_matrix", "_contact_kinematics", "passive_spring_forces"):
        ref = _vm(lambda x: getattr(je, name)(mj, x), q)
        port = getattr(te, name)(mt, qt)
    elif name == "actuation":
        ref = _vm(lambda c: je.actuation(mj, c), ctrl)
        port = te.actuation(mt, ct)
    else:
        ref = _vm(lambda x, y: getattr(je, name)(mj, x, y), q, qd)
        port = getattr(te, name)(mt, qt, qdt)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(
            port, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        _close(a, b, TOL_CLOSED)


def test_project_jacobi_matches_reference(data):
    mj, mt, q, v = data["mj"], data["mt"], data["q"], data["v"]
    M_inv = np.asarray(jax.jit(jl.inv_spd)(data["M"]))
    ref = _vm(lambda x, y, mi: je._project_jacobi(mj, x, y, mi, mj.dt), q, v, M_inv)
    port = te._project_jacobi(mt, *_t(q, v, M_inv), mt.dt)
    keep = data["same_active"]
    assert (~keep).sum() <= MAX_EXCLUDED
    _close(ref, port, TOL_SOLVE, rows=keep)


def test_step_euler_matches_reference(data):
    mj, mt, q, qd, ctrl = data["mj"], data["mt"], data["q"], data["qd"], data["ctrl"]
    ref = _vm(lambda x, y, c: je.step_euler(mj, x, y, c), q, qd, ctrl)
    port = te.step_euler(mt, *_t(q, qd, ctrl))
    keep = data["same_active"]
    for a, b in zip(ref, port):
        _close(a, b, TOL_SOLVE, rows=keep)


def test_env_step_with_auto_reset_matches_reference(data):
    """CheetahRun.step on pool states, a quarter of them at t = 999 so the
    step ends their episode; the reference's reset draw (a pool row from
    each env's key) is injected as `reset_draw`."""
    q, qd, ctrl = data["q"], data["qd"], data["ctrl"]
    t = np.where(np.arange(B) % 4 == 0, 999, 7).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    jenv = jcheetah.CheetahRun()
    jstate = jcheetah.base.EnvState(q=q, qd=qd, t=t, key=keys)
    new_j, ts_j = jax.jit(jax.vmap(jenv.step))(jstate, ctrl)
    rows = np.asarray(jax.vmap(
        lambda k: jax.random.randint(jax.random.split(k)[0], (), 0, jenv._pool_q.shape[0])
    )(keys))

    tenv = make_env("cheetah-run", device="cpu")
    tstate = EnvState(*_t(q, qd, t))
    new_t, ts_t = tenv.step(tstate, *_t(ctrl), reset_draw={"row": torch.tensor(rows)})

    done = np.asarray(ts_j.done)
    assert done.sum() == B // 4
    np.testing.assert_array_equal(done, ts_t.done.numpy())
    np.testing.assert_array_equal(np.asarray(new_j.t), new_t.t.numpy())
    keep = data["same_active"]
    # reset envs carry the injected pool row exactly
    np.testing.assert_array_equal(np.asarray(new_j.q)[done], new_t.q.numpy()[done])
    np.testing.assert_array_equal(np.asarray(new_j.qd)[done], new_t.qd.numpy()[done])
    for a, b in ((new_j.q, new_t.q), (new_j.qd, new_t.qd), (ts_j.reward, ts_t.reward),
                 (jcheetah.base.flatten_obs(ts_j.obs), flatten_obs(ts_t.obs)),
                 (jcheetah.base.flatten_obs(ts_j.carry_obs), flatten_obs(ts_t.carry_obs))):
        _close(a, b, TOL_SOLVE, rows=keep)
    np.testing.assert_array_equal(np.asarray(ts_j.discount), ts_t.discount.numpy())


def test_env_step_divergence_guard():
    """A non-finite state ends the episode with reward 0 and exposes the
    fresh episode's obs, as in the reference."""
    env = make_env("cheetah-run", device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(4, gen)
    q = state.q.clone()
    q[1, 4] = float("nan")
    draw = {"row": torch.tensor([0, 1, 2, 3])}
    new, ts = env.step(EnvState(q, state.qd, state.t), torch.zeros(4, 6), reset_draw=draw)
    assert ts.done.tolist() == [False, True, False, False]
    assert float(ts.reward[1]) == 0.0
    q0, qd0 = env._init(draw)
    assert torch.equal(new.q[1], q0[1]) and torch.equal(ts.obs["velocity"][1], qd0[1])
    assert torch.isfinite(flatten_obs(ts.obs)).all()
