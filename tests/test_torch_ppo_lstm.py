"""The port's recurrent PPO against the JAX reference on cheetah-run: one
rollout and one update from the same parameters, env states, action noise
and env permutations (the noise is recovered from the reference trajectory
as (action − mean)/exp(log_std), the permutations and the auto-reset draws
are recomputed from the reference's keys); then the port's trainer.

A quarter of the envs start at t = 995, so their episodes end inside the
rollout: the terminal-value probe runs, on the carry before its reset, and
the carry of those envs is zeroed. Tolerances, as in test_torch_ppo.py:
trajectory 1e-4 · max(1, |ref|); values, and the carry they come from,
2e-4 · max(1, |ref|) (the fresh Z-filter scales an observation component
near zero by 1000, rounding included; measured 7e-6 on the values and
2e-5 on the final carry); updated parameters 1e-5 abs (measured 6e-8);
metrics rtol 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.algos import ppo as jppo
from surreal_tpu.algos import ppo_lstm as jlstm
from surreal_tpu.envs import base as jbase
from surreal_tpu.envs import make_env as jmake_env
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.algos import ppo_lstm as tlstm
from surreal_tpu_torch.envs import flatten_obs
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.ops import gae_kernel
from torch_helpers import ScriptedResets, assert_close, reference_reset_rows, to_torch

TOL_TRAJ, TOL_VALUE, RTOL_METRIC, ATOL_PARAM = 1e-4, 2e-4, 1e-4, 1e-5
B, T, HIDDEN, LSTM = 8, 8, (32, 32), 16
CFG = dict(horizon=T, epochs=2, num_minibatches=2)


@pytest.fixture(scope="module")
def reference():
    cfg = jppo.PPOConfig(**CFG)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    env_state, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    env_state = dataclasses.replace(
        env_state, t=jnp.where(jnp.arange(B) % 4 == 0, 995, 0).astype(jnp.int32))
    obs = jbase.flatten_obs(ts0.obs)
    net = FlaxAC(action_dim=env.action_dim, hidden=HIDDEN, use_lstm=True, lstm_size=LSTM)
    # a carry that is not zero, as after an earlier chunk
    rs = np.random.RandomState(0)
    carry = tuple(jnp.asarray(0.3 * rs.randn(B, LSTM), jnp.float32) for _ in range(2))
    params = net.init(jax.random.PRNGKey(0), obs[:1], jax.tree.map(lambda c: c[:1], carry))
    state = jppo.init_state(cfg, params, obs.shape[-1])
    k_roll, k_up = jax.random.split(jax.random.PRNGKey(7))
    traj, _, obs2, carry2, ep_ret2, stats = jax.jit(
        lambda s, es, o, c, r, k: jlstm.rollout(cfg, net.apply, step_fn, jbase.flatten_obs,
                                                s, es, o, c, r, k))(
        state, env_state, obs, carry, jnp.zeros((B,), jnp.float32), k_roll)
    new_state, metrics = jax.jit(
        lambda s, tr, k: jlstm.update(cfg, net.apply, s, tr, k))(state, traj, k_up)
    metrics.update(stats)
    metrics["reward_per_step"] = jnp.mean(traj.reward)
    perms = np.stack([np.asarray(jax.random.permutation(k, B))
                      for k in jax.random.split(k_up, cfg.epochs)])
    noise = (np.asarray(traj.action) - np.asarray(traj.mean)) / np.exp(np.asarray(traj.log_std))
    assert np.asarray(traj.done).any(), "the rollout must cross an episode boundary"
    return dict(net=net, params=jax.device_get(params), env_state=env_state, obs=obs,
                carry=carry, traj=traj, obs2=obs2, carry2=carry2, new_state=new_state,
                metrics=jax.device_get(metrics), perms=perms, noise=noise,
                reset_rows=reference_reset_rows(env, env_state, traj.done))


def _port_inputs(ref):
    cfg = tppo.PPOConfig(**CFG)
    net = PPOActorCritic(17, 6, HIDDEN, use_lstm=True, lstm_size=LSTM)
    net.load_state_dict(params_from_flax(ref["params"]))
    es = ref["env_state"]
    return (cfg, ScriptedResets(ref["reset_rows"]), tppo.init_state(cfg, net, 17),
            EnvState(to_torch(es.q), to_torch(es.qd), to_torch(es.t)),
            tuple(to_torch(c) for c in ref["carry"]))


def test_rollout_matches_reference(reference):
    cfg, env, state, env_state, carry = _port_inputs(reference)
    traj, _, obs2, carry2, _, _ = tlstm.rollout(
        cfg, env, flatten_obs, state, env_state, to_torch(reference["obs"]), carry,
        torch.zeros(B), torch.Generator().manual_seed(0), noise=to_torch(reference["noise"]))
    tr = reference["traj"]
    for name in ("obs", "action", "log_prob", "mean", "log_std", "reward", "discount"):
        assert_close(getattr(tr, name), getattr(traj, name), TOL_TRAJ, name)
    for name in ("value", "next_value"):
        assert_close(getattr(tr, name), getattr(traj, name), TOL_VALUE, name)
    np.testing.assert_array_equal(np.asarray(tr.done), traj.done.numpy())
    assert_close(reference["obs2"], obs2, TOL_TRAJ, "final obs")
    for a, b, c0 in zip(reference["carry2"], carry2, traj.init_carry):
        assert_close(a, b, TOL_VALUE, "final carry")
        assert not c0.requires_grad
    for a, b in zip(reference["carry"], traj.init_carry):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # The terminal-value probe: at the `done` step next_value is the value of
    # the terminal obs from the carry before its reset. It differs from what
    # the next step sees (the reset obs from a zeroed carry), far beyond the
    # tolerance, so agreement with the reference above is agreement on the probe.
    t_done, b_done = np.argwhere(np.asarray(tr.done))[0]
    assert t_done < T - 1
    gap = abs(float(traj.next_value[t_done, b_done]) - float(traj.value[t_done + 1, b_done]))
    assert gap > 50 * TOL_VALUE
    not_done = ~np.asarray(tr.done)[:-1]
    np.testing.assert_array_equal(traj.next_value[:-1].numpy()[not_done],
                                  traj.value[1:].numpy()[not_done])


class RecordingResets(ScriptedResets):
    """Keeps every step's Timestep, the terminal observations among them."""

    def __init__(self, rows):
        super().__init__(rows)
        self.timesteps = []

    def step(self, state, action, generator=None, reset_draw=None):
        state, ts = super().step(state, action, generator, reset_draw)
        self.timesteps.append(ts)
        return state, ts


def test_probe_uses_the_carry_before_its_reset(reference):
    """At the first `done` step the stored next_value is the forward on the
    terminal obs from the carry as the step left it; from the zeroed carry
    the same forward lands far outside the tolerance to the reference."""
    cfg, env, state, env_state, carry = _port_inputs(reference)
    env = RecordingResets(reference["reset_rows"])
    traj, *_ = tlstm.rollout(
        cfg, env, flatten_obs, state, env_state, to_torch(reference["obs"]), carry,
        torch.zeros(B), torch.Generator().manual_seed(0), noise=to_torch(reference["noise"]))
    done = traj.done.numpy()
    t_done = int(np.argwhere(done)[0][0])
    rows = np.flatnonzero(done[t_done])
    net = state.net
    with torch.no_grad():
        c = carry
        for t in range(t_done + 1):
            *_, c = net(tppo._norm(cfg, state, traj.obs[t]), c)
            if t < t_done:
                c = tlstm._reset_carry(c, traj.done[t])
        terminal = tppo._norm(cfg, state, flatten_obs(env.timesteps[t_done].obs))
        before = net(terminal, c)[2]
        after = net(terminal, tlstm._reset_carry(c, traj.done[t_done]))[2]
    torch.testing.assert_close(traj.next_value[t_done, rows], before[rows], rtol=0, atol=0)
    ref = np.asarray(reference["traj"].next_value)[t_done, rows]
    assert np.abs(after.numpy()[rows] - ref).min() > 50 * TOL_VALUE


def test_update_matches_reference(reference):
    cfg, _, state, _, _ = _port_inputs(reference)
    tr = reference["traj"]
    traj = tlstm.LSTMTrajectory(
        init_carry=tuple(to_torch(c) for c in tr.init_carry),
        **{f.name: to_torch(getattr(tr, f.name)) for f in dataclasses.fields(tr)
           if f.name != "init_carry"})
    launches = gae_kernel.GAE.launches
    state, metrics = tlstm.update(cfg, state, traj, None, perms=to_torch(reference["perms"]))
    assert gae_kernel.GAE.launches == launches  # CPU tensors: the plain version
    ref_state = reference["new_state"]
    got = params_to_flax(dict(state.net.named_parameters()))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref_state.params),
                                 jax.tree_util.tree_leaves_with_path(got), strict=True):
        err = np.abs(np.asarray(a) - b).max()
        assert err <= ATOL_PARAM, (jax.tree_util.keystr(path), err)
    lstm_moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(ref_state.params["params"]["lstm"]),
        jax.tree.leaves(reference["params"]["params"]["lstm"])))
    assert lstm_moved > 50 * ATOL_PARAM  # gradients reached the cell through time
    ref_metrics = {k: v for k, v in reference["metrics"].items()
                   if k not in ("episodes_done", "episode_return_sum", "reward_per_step")}
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=RTOL_METRIC, atol=1e-7,
                                   err_msg=k)
    assert float(ref_state.lr_scale) == float(state.lr_scale)
    assert int(ref_state.update_step) == state.update_step == 1
    assert int(ref_state.opt_state[1].count) == state.opt_state.count == 4


def test_train_step_matches_reference(reference):
    cfg, env, state, env_state, carry = _port_inputs(reference)
    state, _, _, carry2, _, metrics = tlstm.train_step(
        cfg, env, flatten_obs, state, env_state, to_torch(reference["obs"]), carry,
        torch.zeros(B), torch.Generator().manual_seed(0), noise=to_torch(reference["noise"]),
        perms=to_torch(reference["perms"]))
    got = params_to_flax(dict(state.net.named_parameters()))
    for a, b in zip(jax.tree.leaves(reference["new_state"].params), jax.tree.leaves(got),
                    strict=True):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=ATOL_PARAM)
    assert set(metrics) == set(reference["metrics"])
    for k, v in reference["metrics"].items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=RTOL_METRIC, atol=1e-6,
                                   err_msg=k)
    for a, b in zip(reference["carry2"], carry2):
        assert_close(a, b, TOL_VALUE, "final carry")


def test_sequence_outputs_equal_the_step_by_step_forward(reference):
    """`_sequence_outputs` runs the input projection and the heads once over
    the sequence; step by step through `net.forward`, with the resets, gives
    the same to 1e-6."""
    cfg, _, state, _, carry = _port_inputs(reference)
    net = state.net
    rs = np.random.RandomState(2)
    obs = to_torch(rs.randn(T, B, 17).astype(np.float32))
    done = to_torch(rs.rand(T, B) < 0.2)
    with torch.no_grad():
        mean, log_std, value = tlstm._sequence_outputs(net, obs, done, carry)
        c = carry
        for t in range(T):
            m, ls, v, c = net(obs[t], c)
            c = tlstm._reset_carry(c, done[t])
            torch.testing.assert_close(m, mean[t], rtol=0, atol=1e-6)
            torch.testing.assert_close(v, value[t], rtol=0, atol=1e-6)
    assert log_std.shape == (6,) and bool(done.any())


def _small_trainer(cfg, **kw):
    from surreal_tpu_torch.train import PPOTrainer

    return PPOTrainer("cheetah-run", cfg, num_envs=4, hidden=(16, 16), seed=0, device="cpu",
                      use_lstm=True, lstm_size=8, **kw)


def test_trainer_runs_and_reports_finite_metrics():
    tr = _small_trainer(tppo.PPOConfig(horizon=6, epochs=2, num_minibatches=2))
    assert all(float(c.abs().max()) == 0 for c in tr.carry)
    logs = tr.run(3, log_every=1)
    assert [m["iteration"] for m in logs] == [1, 2, 3]
    assert all(np.isfinite(v) for m in logs for v in m.values())
    assert tr.state.update_step == 3 and "updates" not in logs[0]
    assert all(c.shape == (4, 8) and float(c.abs().max()) > 0 for c in tr.carry)
    assert tr.deterministic_policy() is None


@pytest.mark.parametrize("stochastic", [False, True])
def test_trainer_evaluate_threads_the_carry(stochastic):
    tr = _small_trainer(tppo.PPOConfig(horizon=4, epochs=1, num_minibatches=1))
    tr.env.episode_steps = 5
    out = tr.evaluate(episodes=3, stochastic=stochastic)
    assert out["episodes"] == 3 and all(np.isfinite(v) for v in out.values())
    again = tr.evaluate(episodes=3, stochastic=stochastic)
    assert out == again  # the seed fixes the start states and the noise
    assert tr.evaluate(episodes=3, stochastic=stochastic, seed=1) != out


def test_publish_every_on_the_lstm_path():
    tr = _small_trainer(tppo.PPOConfig(horizon=4, epochs=1, num_minibatches=1,
                                       publish_every=2))
    p0 = tr.state.net.lstm.weight_hh.detach().clone()
    tr.run(1, log_every=1)
    assert tr.state.psync.version == 0
    assert torch.equal(tr.state.psync.actor_params.lstm.weight_hh, p0)
    assert not torch.equal(tr.state.net.lstm.weight_hh, p0)
    tr.run(1, log_every=1)
    assert tr.state.psync.version == 2
    assert torch.equal(tr.state.psync.actor_params.lstm.weight_hh, tr.state.net.lstm.weight_hh)


def test_publish_every_matches_reference():
    """Three chained recurrent train steps with publish_every=2 on both
    sides, from the same parameters, noise, permutations and reset draws:
    the snapshot's version is the reference's after each step (0, 2, 2), the
    snapshot and the learner agree with the reference's to 1e-5, and the
    rollouts' means, which come from the weights acted on, to the trajectory
    tolerance."""
    kw = dict(horizon=T, epochs=1, num_minibatches=2, publish_every=2)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    jes, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    jobs = jbase.flatten_obs(ts0.obs)
    fnet = FlaxAC(action_dim=env.action_dim, hidden=HIDDEN, use_lstm=True, lstm_size=LSTM)
    jcarry = tuple(jnp.zeros((B, LSTM), jnp.float32) for _ in range(2))
    params = fnet.init(jax.random.PRNGKey(0), jobs[:1], jax.tree.map(lambda c: c[:1], jcarry))
    jstate = jppo.init_state(jcfg, params, jobs.shape[-1])
    jep = jnp.zeros((B,), jnp.float32)
    roll = jax.jit(lambda s, es, o, c, r, k: jlstm.rollout(
        jcfg, fnet.apply, step_fn, jbase.flatten_obs, s, es, o, c, r, k))
    upd = jax.jit(lambda s, tr, k: jlstm.update(jcfg, fnet.apply, s, tr, k))

    net = PPOActorCritic(17, 6, HIDDEN, use_lstm=True, lstm_size=LSTM)
    net.load_state_dict(params_from_flax(jax.device_get(params)))
    state = tppo.init_state(cfg, net, 17)
    es = EnvState(to_torch(jes.q), to_torch(jes.qd), to_torch(jes.t))
    obs, ep_ret = to_torch(jobs), torch.zeros(B)
    carry = tuple(torch.zeros(B, LSTM) for _ in range(2))

    def close(ref_tree, module, name):
        got = params_to_flax(dict(module.named_parameters()))
        for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(got), strict=True):
            assert np.abs(np.asarray(a) - b).max() <= ATOL_PARAM, name

    versions = []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3), 3)):
        k_roll, k_up = jax.random.split(key)
        jtraj, jes2, jobs, jcarry, jep, _ = roll(jstate, jes, jobs, jcarry, jep, k_roll)
        rows = reference_reset_rows(env, jes, jtraj.done)
        jes = jes2
        noise = (np.asarray(jtraj.action) - np.asarray(jtraj.mean)) / np.exp(
            np.asarray(jtraj.log_std))
        traj, es, obs, carry, ep_ret, _ = tlstm.rollout(
            cfg, ScriptedResets(rows), flatten_obs, state, es, obs, carry, ep_ret,
            torch.Generator().manual_seed(0), noise=to_torch(noise))
        assert_close(jtraj.mean, traj.mean, TOL_TRAJ, f"rollout {i}: means of the weights acted on")
        for a, b in zip(jcarry, carry):
            assert_close(a, b, TOL_VALUE, f"rollout {i}: final carry")
        jstate, _ = upd(jstate, jtraj, k_up)
        perms = np.stack([np.asarray(jax.random.permutation(k, B))
                          for k in jax.random.split(k_up, jcfg.epochs)])
        tlstm.update(cfg, state, traj, None, perms=to_torch(perms))
        assert state.psync.version == int(jstate.psync.version)
        close(jstate.psync.actor_params, state.psync.actor_params, f"snapshot after step {i}")
        close(jstate.params, state.net, f"learner after step {i}")
        versions.append(state.psync.version)
    assert versions == [0, 2, 2]
