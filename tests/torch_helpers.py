"""What the port's parity tests share: numpy -> torch, a relative closeness
check, the reference's reset draws recomputed from its keys, the port's envs
replaying them, the distance of a state to a switch of the constraint
solver's active set (from chip_smoke.py, whose envs phase excludes states
the same way), and the envs' reset and control-step checks."""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import torch

from surreal_tpu_torch.envs.cheetah import CheetahRun


# XLA's backend optimisation level 0 halves the reference programs' compile
# time on the CPU (walker's step 5.3 -> 2.5 s, a manipulator step 11.4 ->
# 6.0 s); they compute the same functions.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    """`jax.jit(fn)`, compiled once per input signature with FAST_COMPILE."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = (jax.tree.structure(args),
               tuple((np.shape(x), np.result_type(x)) for x in jax.tree.leaves(args)))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=FAST_COMPILE)
        return compiled[key](*args)

    return call


def to_torch(x):
    return torch.tensor(np.asarray(x))


def assert_close(ref, port, tol, name, rows=None):
    """|ref − port| <= tol · max(1, max|ref|), over `rows` if given."""
    ref = np.asarray(ref)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert ref.shape == port.shape, (name, ref.shape, port.shape)
    if rows is not None:
        ref, port = ref[rows], port[rows]
    err = np.abs(ref.astype(np.float64) - port).max() if ref.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max() if ref.size else 0.0), (name, err)


def _draw_fn(env):
    """key -> the random values the reference env's `_init(key)` draws, under
    the names of the port env's `draw_reset`, by the same jax.random calls."""
    kind, m, dt, U = type(env).__name__, getattr(env, "model", None), env.dtype, jax.random.uniform
    pi = jnp.pi
    if kind == "CheetahRun":
        return lambda k: {"row": jax.random.randint(k, (), 0, env._pool_q.shape[0])}
    if kind in ("Walker", "Hopper"):
        lo, hi = jnp.asarray(m.joint_range[:, 0], dt), jnp.asarray(m.joint_range[:, 1], dt)
        return lambda k: {"u_lim": U(k, (m.nv,), dt, minval=lo, maxval=hi),
                          "u_rot": U(jax.random.fold_in(k, 1), (m.nv,), dt, -pi, pi)}
    if kind == "PendulumSwingup":
        return lambda k: {"theta": U(k, (1,), dt, -pi, pi)}
    if kind == "AcrobotSwingup":
        return lambda k: {"q": U(k, (2,), dt, -pi, pi)}
    if kind == "PointMass":
        lo, hi = jnp.asarray(m.joint_range[:, 0], dt), jnp.asarray(m.joint_range[:, 1], dt)
        return lambda k: {"q": U(k, (2,), dt, lo, hi)}
    if kind == "Cartpole":
        n = env.n_poles

        def cartpole(k):
            k1, k2, k3, k4 = jax.random.split(k, 4)
            N = jax.random.normal
            if env.swing_up:
                d = {"x": 0.01 * N(k1, (), dt), "theta": jnp.pi + 0.01 * N(k2, (), dt),
                     "rest": 0.1 * N(k4, (n - 1,), dt)}
            else:
                d = {"x": U(k1, (), dt, -0.1, 0.1), "theta": U(k2, (), dt, -0.034, 0.034),
                     "rest": U(k4, (n - 1,), dt, -0.034, 0.034)}
            return d | {"qd": 0.01 * N(k3, (1 + n,), dt)}

        return cartpole
    if kind == "Reacher":
        lo, hi = m.joint_range[1]

        def reacher(k):
            k1, k2, k3, k4 = jax.random.split(k, 4)
            return {"shoulder": U(k1, (), dt, -pi, pi), "wrist": U(k2, (), dt, lo, hi),
                    "angle": U(k3, (), dt, 0.0, 2 * pi), "radius": U(k4, (), dt, 0.05, 0.20)}

        return reacher
    if kind == "Swimmer":
        lo = jnp.asarray(m.joint_range[3:, 0], dt)
        hi = jnp.asarray(m.joint_range[3:, 1], dt)

        def swimmer(k):
            k_rot, k_joints, k_close, k_target = jax.random.split(k, 4)
            return {"rootz": U(k_rot, (), dt, -pi, pi),
                    "joints": U(k_joints, (m.nv - 3,), dt) * (hi - lo) + lo,
                    "close": jax.random.bernoulli(k_close, 0.2),
                    "target": U(k_target, (2,), dt, -1.0, 1.0)}

        return swimmer
    if kind == "Finger":
        lo, hi = jnp.asarray(m.joint_range[:2, 0], dt), jnp.asarray(m.joint_range[:2, 1], dt)

        def finger(k):
            kj, kh, kt = jax.random.split(k, 3)
            d = {"joints": U(kj, (8, 2), dt, lo, hi), "hinge": U(kh, (8, 1), dt, -pi, pi)}
            if env.task == "turn":
                d["target_angle"] = U(kt, (), dt, -pi, pi)
            return d

        return finger
    if kind == "BallInCup":
        def ball_in_cup(k):
            kx, kz = jax.random.split(k)
            return {"bx": U(kx, (8,), dt, -0.2, 0.2), "bz": U(kz, (8,), dt, 0.2, 0.5)}

        return ball_in_cup
    if kind == "Manipulator":
        def candidate(k):
            ks = jax.random.split(k, 8)
            kA, kB = jax.random.split(ks[7])
            return {"arm": U(ks[0], (8,), dt), "tx": U(ks[1], (), dt, -0.4, 0.4),
                    "tz": U(ks[2], (), dt, 0.1, 0.4), "ta": U(ks[3], (), dt, -pi, pi),
                    "r": U(ks[4], (), dt), "ox": U(ks[5], (), dt, -0.5, 0.5),
                    "oz": U(ks[6], (), dt, 0.0, 0.7), "oa": U(kA, (), dt, 0.0, 2 * pi),
                    "vx": U(kB, (), dt, -5.0, 5.0)}

        return lambda k: jax.vmap(candidate)(jax.random.split(k, 16))
    raise KeyError(kind)


def reference_reset_draws(env, env_state, dones):
    """The reset draw every env of the reference makes at each step of a
    rollout whose done flags were `dones` (T, B): the draw comes from the
    env's key, which moves on only when the env resets."""
    draw = fast_jit(jax.vmap(lambda k: _draw_fn(env)(jax.random.split(k)[0])))
    keys, out = env_state.key, []
    for done in np.asarray(dones):
        out.append(jax.device_get(draw(keys)))
        keys = jnp.where(done[:, None], jax.vmap(lambda k: jax.random.split(k)[1])(keys), keys)
    return out


def reference_reset_rows(env, env_state, dones):
    """Cheetah's reset draws as pool rows, one (B,) array per step."""
    return [d["row"] for d in reference_reset_draws(env, env_state, dones)]


def as_draw(draw: dict) -> dict:
    return {k: to_torch(v) for k, v in draw.items()}


def scripted(env, draws):
    """The port env `env`, auto-resetting to `draws` (one dict per step)."""
    queue = [as_draw(d) for d in draws]
    env.draw_reset = lambda batch, generator: queue.pop(0)
    return env


class ScriptedResets(CheetahRun):
    """The port's cheetah env, auto-resetting to the reference's pool rows."""

    def __init__(self, rows):
        super().__init__(device="cpu")
        self._rows = [torch.tensor(r) for r in rows]

    def draw_reset(self, batch, generator):
        return {"row": self._rows.pop(0)}


def switch_margin(m, q) -> np.ndarray:
    """(B,) distance of each state to the nearest switch of the constraint
    solver's active set (`chip_smoke.switch_margin`, which the card's envs
    phase uses the same way)."""
    return chip_smoke.switch_margin(m, torch.as_tensor(np.array(q))).numpy()


def substep_margin(m, q, qd, ctrl, n_substeps) -> np.ndarray:
    """(B,) least `switch_margin` over the states a control step of
    n_substeps passes through, stepped with the port's engine."""
    q, qd, ctrl = (torch.as_tensor(np.array(x)) for x in (q, qd, ctrl))
    return chip_smoke.substep_margin(m, q, qd, ctrl, n_substeps).numpy()


# ---------------------------------------------------------------------------
# Env reset and control-step parity (tests/test_torch_envs_*.py)
# ---------------------------------------------------------------------------

TOL_CLOSED = 2e-6  # closed-form functions, as in tests/test_torch_physics.py
MARGIN = 1e-5  # distance to an active-set switch below which a step is not compared


def physics_group(name):
    """Tasks whose reference `_physics_step` is the same function."""
    domain, task = name.split("-")
    if domain == "finger":
        return "finger-spin" if task == "spin" else "finger-turn"
    if domain in ("swimmer", "manipulator") or task.endswith("poles"):
        return name  # another model per task
    return domain


def reference_env_fns(cache, name):
    """(reference env, its `_physics_step` jitted over a batch, the rest of
    its `Environment.step` jitted over a batch with the physics result as
    its input). The two together are the reference's control step; the
    first is compiled once per physics group and shared by its tasks."""
    import copy

    from surreal_tpu.envs import make_env as jmake_env

    if name not in cache:
        jenv = jmake_env(name)
        group = physics_group(name)
        if group not in cache:
            cache[group] = fast_jit(jax.vmap(jenv._physics_step))
        after = copy.copy(jenv)
        after._physics_step = lambda q, qd, action: (q, qd)
        cache[name] = (jenv, cache[group], fast_jit(jax.vmap(after.step)))
    return cache[name]


def _jstate(q, qd, t, keys):
    from surreal_tpu.envs import base as jbase

    return jbase.EnvState(q=jnp.asarray(q), qd=jnp.asarray(qd), t=jnp.asarray(t), key=keys)


def _seed(name):
    return sum(map(ord, name))


def _candidates(tenv, draw):
    """(B, K, c) rejection candidates of a draw, and the (B, c) columns of q
    that hold the chosen one."""
    kind = type(tenv).__name__
    if kind == "Finger":
        return torch.cat([draw["joints"], draw["hinge"]], -1), slice(0, 3)
    if kind == "BallInCup":
        return torch.stack([draw["bx"], draw["bz"]], -1), slice(2, 4)
    return torch.stack([draw["tx"], draw["tz"], draw["ta"]], -1), slice(11, 14)


def chosen_candidate(tenv, draw, q):
    """(B,) index of the candidate each start state q was built from."""
    cand, cols = _candidates(tenv, draw)
    q = torch.as_tensor(np.array(q))
    return torch.argmin((cand - q[:, None, cols]).abs().sum(-1), 1).numpy()


def check_reset(cache, name, B=32):
    """The port's `_init` on the reference's draws against the reference's
    `_init` on the keys they come from, and their observations; for the
    rejection-sampled envs, the same candidate is chosen. The reference's
    start states are read from its step with every env at its last step."""
    from surreal_tpu_torch.envs import make_env

    jenv, _, after = reference_env_fns(cache, name)
    tenv = make_env(name, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(_seed(name)), B)
    q_any, qd_any = tenv._init(tenv.draw_reset(B, torch.Generator().manual_seed(0)))
    t = np.full(B, jenv.episode_steps - 1, np.int32)
    action = np.zeros((B, tenv.action_dim), np.float32)
    new_j, ts_j = after(_jstate(q_any.numpy(), qd_any.numpy(), t, keys), action)
    draw = as_draw(reference_reset_draws(jenv, _jstate(0, 0, 0, keys), np.zeros((1, B)))[0])
    q, qd = tenv._init(draw)
    assert np.asarray(ts_j.done).all()
    assert_close(new_j.q, q, TOL_CLOSED, "q")
    assert_close(new_j.qd, qd, TOL_CLOSED, "qd")
    from surreal_tpu.envs.base import flatten_obs as jflatten
    from surreal_tpu_torch.envs import flatten_obs

    assert_close(jflatten(ts_j.carry_obs), flatten_obs(tenv._obs(q, qd)), TOL_CLOSED, "obs")
    if type(tenv).__name__ in ("Finger", "BallInCup", "Manipulator"):
        idx = chosen_candidate(tenv, draw, new_j.q)
        np.testing.assert_array_equal(idx, chosen_candidate(tenv, draw, q))
        assert (idx > 0).any(), "no start state rejected a candidate"
    return new_j, q


def check_step(cache, name, n_substeps, tol, B=32, q_noise=0.05, qd_noise=0.5,
               max_excluded=None):
    """One control step of the port's env against the reference's, from the
    same states (the env's start states, moved by N(0, q_noise) and
    N(0, qd_noise) on the physics dofs), actions ~ U(−1.2, 1.2) and reset
    draws; a quarter of the envs are at their last step, so they auto-reset.
    States within MARGIN of an active-set switch at any substep are left
    out (at most `max_excluded`, default a quarter). Returns the number of
    excluded envs."""
    from surreal_tpu.envs.base import flatten_obs as jflatten
    from surreal_tpu_torch.envs import flatten_obs, make_env
    from surreal_tpu_torch.envs.base import EnvState

    jenv, phys, after = reference_env_fns(cache, name)
    tenv = make_env(name, device="cpu")
    rs = np.random.RandomState(_seed(name))
    q, qd = tenv._init(tenv.draw_reset(B, torch.Generator().manual_seed(_seed(name))))
    nv = tenv.model.nv
    q[:, :nv] += torch.tensor(q_noise * rs.randn(B, nv), dtype=q.dtype)
    qd[:, :nv] += torch.tensor(qd_noise * rs.randn(B, nv), dtype=q.dtype)
    t = np.where(np.arange(B) % 4 == 0, jenv.episode_steps - 1, 7).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(_seed(name) + 1), B)
    action = rs.uniform(-1.2, 1.2, (B, tenv.action_dim)).astype(np.float32)
    q1, qd1 = phys(q.numpy(), qd.numpy(), action)
    new_j, ts_j = after(_jstate(q1, qd1, t, keys), action)
    draw = reference_reset_draws(jenv, _jstate(0, 0, 0, keys), np.zeros((1, B)))[0]
    new_t, ts_t = tenv.step(EnvState(q, qd, torch.tensor(t)), torch.tensor(action),
                            reset_draw=as_draw(draw))
    keep = substep_margin(tenv.model, q[:, :nv], qd[:, :nv], action, n_substeps) > MARGIN
    excluded = int((~keep).sum())
    assert excluded <= (B // 4 if max_excluded is None else max_excluded), excluded
    np.testing.assert_array_equal(np.asarray(ts_j.done), ts_t.done.numpy())
    assert np.asarray(ts_j.done).sum() == B // 4  # no env diverged
    np.testing.assert_array_equal(np.asarray(new_j.t), new_t.t.numpy())
    for label, a, b in (("q", new_j.q, new_t.q), ("qd", new_j.qd, new_t.qd),
                        ("reward", ts_j.reward, ts_t.reward),
                        ("obs", jflatten(ts_j.obs), flatten_obs(ts_t.obs)),
                        ("carry_obs", jflatten(ts_j.carry_obs), flatten_obs(ts_t.carry_obs))):
        assert_close(a, b, tol, label, rows=keep)
    np.testing.assert_array_equal(np.asarray(ts_j.discount), ts_t.discount.numpy())
    moved = np.abs(np.asarray(new_j.qd) - qd.numpy())[~np.asarray(ts_j.done)].max()
    assert moved > 1e-4, moved  # the step did something
    return excluded
