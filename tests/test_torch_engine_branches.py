"""The engine's branches beyond cheetah's, held against the JAX engine on
every baked asset that reaches them, at one substep (the control steps of
the envs are in tests/test_torch_envs_*.py).

States: 32 per asset from a numpy seed: limited joints ~ U(range widened by
10%, so some limits are violated), unlimited hinges ~ U(−π, π), unlimited
slides ~ N(0, 0.2) around the joint ref; qd ~ N(0, 1), ctrl ~ U(−1.2, 1.2).
Many of these states penetrate: every kind of constraint row is active in
some of them.

The reference's programs are compiled at XLA's backend optimisation level
0 (`torch_helpers.fast_jit`: half the compile time, the same functions).

Tolerance: max |port − ref| ≤ TOL · max(1, max |ref|), with
- TOL_CLOSED = 2e-6 for the closed-form functions (kinematics, Jacobians,
  mass matrix, bias, fluid drag, actuation, the autodiff cross-checks):
  float32 rounding through sin/cos and short sums that the two libraries
  order differently, as on cheetah (tests/test_torch_physics.py);
- TOL_SOLVE = 2e-5 for the linear solves, the constraint solvers and one
  integrator substep: a solve amplifies that rounding by the matrix's
  condition number (up to ~300 for the cartpoles' mass matrices), 20 Jacobi
  sweeps (or 10 Gauss-Seidel sweeps) by the Delassus operator's, as on
  cheetah;
- TOL_SWIMMER = 1e-4 for a swimmer substep (see test_step_euler).
A row is active iff its depth, stretch or limit violation is > 0; states
within MARGIN = 1e-6 of such a switch may take another row set in the two
implementations, and a pair whose capsule segments cross has a contact
normal made of rounding noise: such states are left out of the solver
comparisons (at most a quarter of them; `torch_helpers.switch_margin`), and
so are such pairs' rows in the contact-row comparison.
"""

import os

import jax
import numpy as np
import pytest
import torch

from surreal_tpu.envs.physics import engine as je
from surreal_tpu.envs.physics import linalg as jl
from surreal_tpu.envs.physics import model as jm
from surreal_tpu_torch.envs.base import ASSET_DIR
from surreal_tpu_torch.envs.physics import engine as te
from surreal_tpu_torch.envs.physics import model as tm
from torch_helpers import assert_close, fast_jit, switch_margin, to_torch

B = 32
TOL_CLOSED, TOL_SOLVE, TOL_SWIMMER = 2e-6, 2e-5, 1e-4
MARGIN = 1e-6
ALL = sorted(p.removesuffix(".npz") for p in os.listdir(ASSET_DIR)
             if p.endswith(".npz") and not p.endswith("_pool.npz") and p != "cheetah.npz")
# model options the envs set on top of the baked asset (finger.py), and the
# variants that reach branches no env takes
VARIANTS = {
    "finger": {"implicit_impulse": True, "contact_timeconst": 0.0025},
    "finger_stiff": {"pair_push": "stiff_dynamic"},
    "ball_in_cup_box": {"pair_cone": False},
    "swimmer6_visc": {"fluid_visc_lin": np.linspace(0.1, 0.6, 6),
                      "fluid_visc_ang": np.linspace(0.01, 0.06, 6)},
}


def _models(name):
    asset = name.split("_stiff")[0].split("_box")[0].split("_visc")[0]
    path = f"{ASSET_DIR}/{asset}.npz"
    kw = VARIANTS.get(name, {})
    return jm.load(path).replace(**kw), tm.load(path).replace(**kw)


def _states(m, seed):
    if m.neq:  # manipulator: see _manipulator_states
        return _manipulator_states(m, seed)
    rs = np.random.RandomState(seed)
    lo, hi = m.joint_range[:, 0], m.joint_range[:, 1]
    pad = 0.05 * (hi - lo)
    q = np.where(m.limited, rs.uniform(lo - pad, hi + pad, (B, m.nv)),
                 np.where(np.asarray(m.dof_type) == jm.HINGE, rs.uniform(-np.pi, np.pi, (B, m.nv)),
                          m.dof_refs + 0.2 * rs.randn(B, m.nv)))
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f(q), f(rs.randn(B, m.nv)), f(rs.uniform(-1.2, 1.2, (B, m.nu)))


def _manipulator_states(m, seed):
    """Random arm poses cross many capsule segments (their contact normals
    are rounding noise, see the module docstring). Instead: the env's own
    start states (collision-free), with the arm joints moved by N(0, 0.15)
    rad into shallow contacts."""
    from surreal_tpu_torch.envs.manipulator import Manipulator

    prop = "peg" if m.npair > 80 else "ball"
    env = Manipulator(prop, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    q = env._init(env.draw_reset(B, gen))[0][:, : m.nv].numpy()
    rs = np.random.RandomState(seed)
    q[:, env._arm_idx] += 0.15 * rs.randn(B, len(env._arm_idx))
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f(q), f(rs.randn(B, m.nv)), f(rs.uniform(-1.2, 1.2, (B, m.nu)))


@pytest.fixture(scope="module")
def cache():
    return {}


def _data(cache, name):
    if name not in cache:
        mj, mt = _models(name)
        q, qd, ctrl = _states(mj, sum(map(ord, name)))
        cache[name] = dict(mj=mj, mt=mt, q=q, qd=qd, ctrl=ctrl)
    return cache[name]


def _m_inv(d):
    """The reference's M⁻¹ at the states (the solvers' metric)."""
    mj = d["mj"]
    return jax.device_get(fast_jit(jax.vmap(lambda x: jl.inv_spd(je.mass_matrix(mj, x))))(d["q"]))


def _ref(fn, *args):
    return jax.device_get(fast_jit(jax.vmap(fn))(*args))


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _compare(ref, port, tol, rows=None):
    ref_l, port_l = jax.tree.leaves(ref), _leaves(port)
    assert len(ref_l) == len(port_l)
    for i, (a, b) in enumerate(zip(ref_l, port_l)):
        assert_close(a, b, tol, f"leaf {i}", rows)


@pytest.mark.parametrize("name", ["finger", "manipulator_ball", "point_mass"])
def test_kinematics_and_forces(cache, name):
    """fk (with the joint refs of finger and manipulator and the rotated
    body frames of manipulator; manipulator_peg's are the same kind and its
    env's control step covers them), its time derivative, COMs, body
    velocities, mass matrix, bias, springs, actuation (the tendon moment
    matrix of point_mass and manipulator) and the smooth forces. The
    swimmer's fluid drag is in test_fluid_forces and test_step_euler; the
    other assets reach no branch here that cheetah does not, and their envs'
    control steps cover them."""
    d = _data(cache, name)
    mj, mt = d["mj"], d["mt"]

    def ref(q, qd, c):
        return (je.fk_dofs(mj, q), je.fk_dofs_dot(mj, q, qd), je.com_positions(mj, q),
                je.body_velocities(mj, q, qd), je.mass_matrix(mj, q),
                je.bias_forces(mj, q, qd), je.passive_spring_forces(mj, q),
                je.actuation(mj, c), je.smooth_forces(mj, q, qd, c),
                je.subtree_com_velocity(mj, q, qd))

    q, qd, c = to_torch(d["q"]), to_torch(d["qd"]), to_torch(d["ctrl"])
    port = (te.fk_dofs(mt, q), te.fk_dofs_dot(mt, q, qd), te.com_positions(mt, q),
            te.body_velocities(mt, q, qd), te.mass_matrix(mt, q), te.bias_forces(mt, q, qd),
            te.passive_spring_forces(mt, q), te.actuation(mt, c),
            te.smooth_forces(mt, q, qd, c), te.subtree_com_velocity(mt, q, qd))
    _compare(_ref(ref, d["q"], d["qd"], d["ctrl"]), port, TOL_CLOSED)


@pytest.mark.parametrize("name", ["finger", "ball_in_cup"])
def test_autodiff_cross_checks(cache, name):
    """kinetic and potential energy, and the mass matrix and bias forces by
    autodiff (torch.func against jax.grad/jvp), which also match the
    analytic assembly."""
    d = _data(cache, name)
    mj, mt = d["mj"], d["mt"]
    ref = _ref(lambda q, qd: (je.kinetic_energy(mj, q, qd), je.potential_energy(mj, q),
                              je.mass_matrix_autodiff(mj, q), je.bias_forces_autodiff(mj, q, qd)),
               d["q"], d["qd"])
    q, qd = to_torch(d["q"]), to_torch(d["qd"])
    port = (te.kinetic_energy(mt, q, qd), te.potential_energy(mt, q),
            te.mass_matrix_autodiff(mt, q), te.bias_forces_autodiff(mt, q, qd))
    _compare(ref, port, TOL_CLOSED)
    _compare((ref[2], ref[3]), (te.mass_matrix(mt, q), te.bias_forces(mt, q, qd)), TOL_CLOSED)


@pytest.mark.parametrize("name", ["swimmer15", "swimmer6_visc"])
def test_fluid_forces(cache, name):
    """Quadratic drag (swimmer6's is in test_step_euler), and the linear
    viscous terms (no baked asset has them: swimmer6 with
    coefficients set)."""
    d = _data(cache, name)
    mj, mt = d["mj"], d["mt"]
    ref = _ref(lambda q, qd: je.fluid_forces(mj, q, qd), d["q"], d["qd"])
    port = te.fluid_forces(mt, to_torch(d["q"]), to_torch(d["qd"]))
    _compare(ref, port, TOL_CLOSED)
    assert np.abs(ref).max() > 1e-3  # the drag is not trivially zero


def test_seg_seg_closest():
    """Random segment pairs and points (degenerate segments). Exactly
    parallel pairs are left out: their closest points are not unique, and
    which pair each implementation returns depends on rounding."""
    rs = np.random.RandomState(0)
    p1, q1, p2, q2 = (rs.randn(64, 2).astype(np.float32) for _ in range(4))
    q1[:8] = p1[:8]  # first segment a point
    q2[8:16] = p2[8:16]  # second a point
    q1[16:20], q2[16:20] = p1[16:20], p2[16:20]  # both points
    ref = fast_jit(je._seg_seg_closest)(p1, q1, p2, q2)
    port = te._seg_seg_closest(*map(to_torch, (p1, q1, p2, q2)))
    _compare(ref, port, TOL_CLOSED)


CONTACT = ["acrobot", "ball_in_cup", "finger", "hopper", "manipulator_ball"]


@pytest.mark.parametrize("name", CONTACT)
def test_contact_rows(cache, name):
    """Ground, body-body pair, wall and rope rows (Jacobians, depths,
    friction) and the max penetration the rejection sampling reads."""
    d = _data(cache, name)
    mj, mt = d["mj"], d["mt"]

    def rows(e, m, q):
        out = [e.penetration(m, q)]
        if m.ncon:
            out.append(e._contact_kinematics(m, q))
        if m.npair:
            out.append(e._pair_kinematics(m, q))
        if m.nwall:
            out.append(e._wall_kinematics(m, q))
        if m.nrope:
            out.append(e._rope_kinematics(m, q))
        return out

    ref = _ref(lambda q: rows(je, mj, q), d["q"])
    port = rows(te, mt, to_torch(d["q"]))
    keep = switch_margin(mt, d["q"]) > MARGIN
    assert (~keep).sum() <= B // 4
    # constant friction leaves (mu) are not batched in the port
    port = [tuple(x[None].expand(B, *x.shape) if x.ndim == 1 and i == 3 else x
                  for i, x in enumerate(p)) if isinstance(p, tuple) else p for p in port]
    _compare(ref, port, TOL_CLOSED, rows=keep)


PROJECT = ["ball_in_cup", "ball_in_cup_box", "cartpole_3", "finger", "finger_stiff",
           "hopper", "manipulator_ball", "point_mass", "reacher"]


@pytest.mark.parametrize("name", PROJECT)
def test_project_jacobi_with_impulses(cache, name):
    """The whole row layout (ground, pair with the elliptic cone or the box,
    wall, dof friction, rope, limits, equality) and the normal impulses."""
    d = _data(cache, name)
    mj, mt = d["mj"], d["mt"]
    v = (d["qd"] + np.float32(0.5)).astype(np.float32)
    h, M_inv = mj.dt, _m_inv(d)
    ref = _ref(lambda q, vv, mi: je.constraint_project_impulses(mj, q, vv, mi, h),
               d["q"], v, M_inv)
    port = te.constraint_project_impulses(mt, *map(to_torch, (d["q"], v, M_inv)), h)
    keep = switch_margin(mt, d["q"]) > MARGIN
    assert (~keep).sum() <= B // 4
    _compare(ref, port, TOL_SOLVE, rows=keep)
    moved = np.abs(np.asarray(ref[0]) - v)[keep].max()
    assert moved > 1e-3, moved  # some row is active and the projection moved v


@pytest.mark.parametrize("name", ["hopper"])
def test_project_gs(cache, name):
    """The sequential Gauss-Seidel solver (ground contacts and limits)."""
    d = _data(cache, name)
    mj, mt = d["mj"], d["mt"]
    v, M_inv = d["qd"], _m_inv(d)
    ref = _ref(lambda q, vv, mi: je.constraint_project(mj, q, vv, mi, mj.dt, solver="gs"),
               d["q"], v, M_inv)
    port = te.constraint_project(mt, *map(to_torch, (d["q"], v, M_inv)), mt.dt,
                                 solver="gs")
    keep = switch_margin(mt, d["q"]) > MARGIN
    _compare(ref, port, TOL_SOLVE, rows=keep)


EULER = ["ball_in_cup", "finger", "pendulum", "point_mass", "reacher", "swimmer6"]


@pytest.mark.parametrize("name", EULER)
def test_step_euler(cache, name):
    """One Euler substep: implicit impulses and returned impulses on the
    finger (as finger.py configures it), M⁻¹ impulses elsewhere. The
    swimmer's mass matrix has condition numbers up to 1.8e4 on these states,
    so its solve carries float32 rounding × 1.8e4 ≈ 1e-3 relative into qacc
    and h·qacc into qd: it is held to TOL_SWIMMER."""
    d = _data(cache, name)
    mj, mt = d["mj"], d["mt"]
    imp = bool(mj.npair)
    ref = _ref(lambda q, qd, c: je.step_euler(mj, q, qd, c, return_impulses=imp),
               d["q"], d["qd"], d["ctrl"])
    port = te.step_euler(mt, *map(to_torch, (d["q"], d["qd"], d["ctrl"])), return_impulses=imp)
    keep = switch_margin(mt, d["q"]) > MARGIN
    assert (~keep).sum() <= B // 4
    _compare(ref, port, TOL_SWIMMER if mj.has_fluid else TOL_SOLVE, rows=keep)


@pytest.mark.parametrize("name", ["cartpole"])
def test_rk4(cache, name):
    """forward_explicit (an RK4 stage: a linear solve, so TOL_SOLVE) and
    one RK4 step with the constraint projection after it (the limit row;
    the acrobot's RK4 with its ground rows is its env's control step)."""
    d = _data(cache, name)
    mj, mt = d["mj"], d["mt"]
    assert mj.integrator == "rk4" and je.has_constraints(mj) == te.has_constraints(mt)
    args = (d["q"], d["qd"], d["ctrl"])
    ref = _ref(lambda q, qd, c: (je.forward_explicit(mj, q, qd, c), je.step_rk4(mj, q, qd, c)),
               *args)
    t = tuple(map(to_torch, args))
    acc, step = te.forward_explicit(mt, *t), te.step_rk4(mt, *t)
    _compare(ref[0], acc, TOL_SOLVE)
    keep = switch_margin(mt, np.asarray(ref[1][0])) > MARGIN
    _compare(ref[1], step, TOL_SOLVE, rows=keep)


def test_make_stepper_sums_impulses(cache):
    """Two finger substeps, the impulses summed over them."""
    d = _data(cache, "finger")
    mj, mt = d["mj"], d["mt"]
    ref = _ref(je.make_stepper(mj, 2, return_impulses=True), d["q"], d["qd"], d["ctrl"])
    port = te.make_stepper(mt, 2, return_impulses=True)(
        *map(to_torch, (d["q"], d["qd"], d["ctrl"])))
    q1 = te.step_euler(mt, to_torch(d["q"]), to_torch(d["qd"]), to_torch(d["ctrl"]))[0]
    keep = (switch_margin(mt, d["q"]) > MARGIN) & (switch_margin(mt, q1) > MARGIN)
    assert (~keep).sum() <= B // 4
    _compare(ref, port, TOL_SOLVE, rows=keep)
    assert np.abs(np.asarray(ref[2]["pair"])[keep]).max() > 0  # some pair row pushed


@pytest.mark.parametrize("name", ALL)
def test_has_constraints(name):
    mj, mt = _models(name)
    assert je.has_constraints(mj) == te.has_constraints(mt)


def test_autodiff_in_float64():
    """The torch.func cross-checks agree with the analytic mass matrix and
    bias far below float32 rounding when run in float64."""
    mt = tm.load(f"{ASSET_DIR}/manipulator_peg.npz")
    q, qd, _ = _states(mt, 3)
    q, qd = torch.tensor(q, dtype=torch.float64), torch.tensor(qd, dtype=torch.float64)
    assert torch.allclose(te.mass_matrix_autodiff(mt, q), te.mass_matrix(mt, q), atol=1e-10)
    assert torch.allclose(te.bias_forces_autodiff(mt, q, qd), te.bias_forces(mt, q, qd),
                          atol=1e-9)
