"""The slice as a whole: one PPO train_step of the port against the JAX
reference on cheetah-run, from the same params, env states, action noise
and minibatch permutations.

The action noise is recovered from the reference trajectory as
(action − mean)/exp(log_std), the permutations are recomputed from the
reference's keys, and so are its auto-reset draws: a quarter of the envs
start at t = 995, so their episodes end inside the rollout (the terminal
value forward and the reset both run). Tolerances, from float32 rounding compounded along the
path (the two sides agree to ~1e-7 per physics function, see
test_torch_physics.py):
- trajectory: 1e-4 · max(1, |ref|) after 8–16 physics steps with
  contacts; values, value targets and advantages: 1e-3 · max(1, |ref|).
  The Z-filter starts with std sqrt(1e-6) = 1e-3, so an observation
  component near zero enters the network with its rounding error scaled
  by 1000 (components beyond ±5e-3 are clipped and insensitive); the value
  head (orthogonal gain 1) passes that on, the mean head (gain 0.01)
  damps it;
- metrics: rtol 1e-4; the Z-filter: rtol 1e-5;
- updated params: 4e-6 abs (measured up to 1e-6). Each Adam step moves a parameter by at most
  lr = 3e-4 and normalizes the gradient, so a small relative error in the
  gradient moves the result by a far smaller amount.
The lr_scale decision is discrete and must agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.algos import ppo as jppo
from surreal_tpu.envs import base as jbase
from surreal_tpu.envs import make_env as jmake_env
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu.ops import pallas_ppo_loss
from surreal_tpu.ops import returns as jret
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.envs import flatten_obs
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.ops import gae_kernel, returns
from torch_helpers import ScriptedResets, assert_close as _close, reference_reset_rows
from torch_helpers import to_torch as _t

TOL_TRAJ, TOL_VALUE, RTOL_METRIC, RTOL_ZF, ATOL_PARAM = 1e-4, 1e-3, 1e-4, 1e-5, 4e-6
HIDDEN = (32, 32)


@pytest.fixture(scope="module", params=[(8, 8), (32, 16)], ids=["B8_T8", "B32_T16_fused"])
def reference(request):
    """The reference's rollout and update for B envs and horizon T (epochs
    2, minibatches 2). At B=32, T=16 the minibatch is 256 rows and the
    fused-loss gate admits on both sides (the reference's Pallas kernel
    runs in interpret mode on the CPU)."""
    B, T = request.param
    cfg = jppo.PPOConfig(horizon=T, epochs=2, num_minibatches=2, fused_loss=True)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    env_state, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    env_state = dataclasses.replace(
        env_state, t=jnp.where(jnp.arange(B) % 4 == 0, 995, 0).astype(jnp.int32))
    obs = jbase.flatten_obs(ts0.obs)
    net = FlaxAC(action_dim=env.action_dim, hidden=HIDDEN)
    params = net.init(jax.random.PRNGKey(0), obs[:1])
    state = jppo.init_state(cfg, params, obs.shape[-1])
    ep_ret = jnp.zeros((B,), jnp.float32)
    k_roll, k_up = jax.random.split(jax.random.PRNGKey(7))
    traj, env_state2, obs2, ep_ret2, stats = jax.jit(
        lambda s, es, o, r, k: jppo.rollout(cfg, net.apply, step_fn, jbase.flatten_obs,
                                            s, es, o, r, k))(state, env_state, obs, ep_ret, k_roll)
    orig = pallas_ppo_loss.fused_clip_loss
    pallas_ppo_loss.fused_clip_loss = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        new_state, metrics = jax.jit(
            lambda s, tr, k: jppo.update(cfg, net.apply, s, tr, k))(state, traj, k_up)
    finally:
        pallas_ppo_loss.fused_clip_loss = orig
    metrics.update(stats)
    metrics["reward_per_step"] = jnp.mean(traj.reward)
    N = B * T
    perms = np.stack([np.asarray(jax.random.permutation(k, N))
                      for k in jax.random.split(k_up, cfg.epochs)])
    noise = (np.asarray(traj.action) - np.asarray(traj.mean)) / np.exp(np.asarray(traj.log_std))
    reset_rows = reference_reset_rows(env, env_state, traj.done)
    assert np.asarray(traj.done).any(), "the rollout must cross an episode boundary"
    return dict(B=B, T=T, params=jax.device_get(params), env_state=env_state, obs=obs,
                traj=traj, obs2=obs2, new_state=new_state, metrics=jax.device_get(metrics),
                perms=perms, noise=noise, reset_rows=reset_rows)


def _port_inputs(ref):
    cfg = tppo.PPOConfig(horizon=ref["T"], epochs=2, num_minibatches=2, fused_loss=True)
    net = PPOActorCritic(17, 6, HIDDEN)
    net.load_state_dict(params_from_flax(ref["params"]))
    state = tppo.init_state(cfg, net, 17)
    es = ref["env_state"]
    env_state = EnvState(_t(es.q), _t(es.qd), _t(es.t))
    return cfg, ScriptedResets(ref["reset_rows"]), state, env_state


def test_rollout_matches_reference(reference):
    cfg, env, state, env_state = _port_inputs(reference)
    traj, _, obs2, _, _ = tppo.rollout(
        cfg, env, flatten_obs, state, env_state, _t(reference["obs"]),
        torch.zeros(reference["B"]), torch.Generator().manual_seed(0),
        noise=_t(reference["noise"]))
    tr = reference["traj"]
    for name in ("obs", "action", "log_prob", "mean", "log_std", "reward", "discount"):
        _close(getattr(tr, name), getattr(traj, name), TOL_TRAJ, name)
    for name in ("value", "next_value"):
        _close(getattr(tr, name), getattr(traj, name), TOL_VALUE, name)
    np.testing.assert_array_equal(np.asarray(tr.done), traj.done.numpy())
    _close(reference["obs2"], obs2, TOL_TRAJ, "final obs")
    adv_j, vt_j = jret.gae(tr.reward, tr.value, tr.next_value, tr.discount, tr.done,
                           cfg.gamma, cfg.lam)
    adv_t, vt_t = returns.gae(traj.reward, traj.value, traj.next_value, traj.discount,
                              traj.done, cfg.gamma, cfg.lam)
    _close(adv_j, adv_t, TOL_VALUE, "advantages")
    _close(vt_j, vt_t, TOL_VALUE, "value targets")


def test_train_step_matches_reference(reference):
    cfg, env, state, env_state = _port_inputs(reference)
    launches = gae_kernel.GAE.launches
    state, _, _, _, metrics = tppo.train_step(
        cfg, env, flatten_obs, state, env_state, _t(reference["obs"]),
        torch.zeros(reference["B"]), torch.Generator().manual_seed(0),
        noise=_t(reference["noise"]), perms=_t(reference["perms"]))
    assert gae_kernel.GAE.launches == launches  # CPU tensors: plain versions
    ref_state = reference["new_state"]
    got = params_to_flax(dict(state.net.named_parameters()))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref_state.params),
                                 jax.tree_util.tree_leaves_with_path(got)):
        err = np.abs(np.asarray(a) - b).max()
        assert err <= ATOL_PARAM, (jax.tree_util.keystr(path), err)
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(ref_state.params), jax.tree.leaves(reference["params"])))
    assert moved > 50 * ATOL_PARAM  # the update moved the params well past the tolerance
    for k, v in reference["metrics"].items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=RTOL_METRIC, atol=1e-7,
                                   err_msg=k)
    assert set(metrics) == set(reference["metrics"])
    for f in ("count", "mean", "m2"):
        np.testing.assert_allclose(np.asarray(getattr(ref_state.zfilter, f)),
                                   getattr(state.zfilter, f).numpy(), rtol=RTOL_ZF, atol=1e-6)
    assert float(ref_state.lr_scale) == float(state.lr_scale)
    assert int(ref_state.update_step) == state.update_step == 1
    assert int(ref_state.opt_state[1].count) == state.opt_state.count


def test_trainer_runs_and_reports_finite_metrics():
    from surreal_tpu_torch.train import PPOTrainer

    cfg = tppo.PPOConfig(horizon=8, epochs=2, num_minibatches=2)
    tr = PPOTrainer("cheetah-run", cfg, num_envs=8, hidden=HIDDEN, seed=0, device="cpu")
    logs = tr.run(2, log_every=1)
    assert [m["iteration"] for m in logs] == [1, 2]
    for m in logs:
        assert all(np.isfinite(v) for v in m.values())
    assert tr.state.update_step == 2


def test_config_keeps_reference_fields_and_defaults():
    import dataclasses

    ref = {f.name: f.default for f in dataclasses.fields(jppo.PPOConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tppo.PPOConfig)}
    assert ref == port
    # the mesh knobs are accepted as the reference accepts them (the
    # trainers set them from the mesh; tests/test_torch_zero.py and
    # test_torch_tshard.py run them)
    for kw in ({"time_shards": 2}, {"zero_shards": 2, "zero_optimizer": True}):
        assert dataclasses.asdict(tppo.PPOConfig(**kw)) == dataclasses.asdict(
            jppo.PPOConfig(**kw))
    assert tppo.PPOConfig(publish_every=2).publish_every == 2


def test_entropy_anneal_schedule():
    cfg = tppo.PPOConfig(entropy_coef=0.01)
    assert tppo.entropy_coef_at(cfg, 7) == pytest.approx(0.01)
    cfg = tppo.PPOConfig(entropy_coef=0.01, entropy_final=0.002, entropy_anneal_iters=100)
    for step in (0, 50, 400):
        assert tppo.entropy_coef_at(cfg, step) == pytest.approx(
            float(jppo.entropy_coef_at(cfg, jnp.asarray(step))))


def test_optimizer_matches_optax():
    """clip_by_global_norm → scale_by_adam(eps=1e-5) over three steps, on a
    gradient above and below the clip norm."""
    import optax

    rs = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (3,)}
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.scale_by_adam(eps=1e-5))
    jp = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jstate = opt.init(jp)
    tstate = tppo.AdamState(0, {k: torch.zeros(s) for k, s in shapes.items()},
                            {k: torch.zeros(s) for k, s in shapes.items()})
    for scale in (1.0, 0.01, 3.0):
        g = {k: (scale * rs.randn(*s)).astype(np.float32) for k, s in shapes.items()}
        ju, jstate = opt.update(g, jstate)
        tu = tppo.scale_by_adam(tppo.clip_by_global_norm({k: _t(v) for k, v in g.items()}, 0.5),
                                tstate)
        for k in shapes:
            np.testing.assert_allclose(np.asarray(ju[k]), tu[k].numpy(), rtol=1e-6, atol=1e-7)


def test_publish_every_param_staleness():
    """cfg.publish_every > 1: the rollouts act on a snapshot refreshed every
    K learner updates (as tests/test_ppo.py shows for the reference)."""
    from surreal_tpu_torch.train import PPOTrainer

    cfg = tppo.PPOConfig(horizon=6, epochs=1, num_minibatches=1, publish_every=3)
    tr = PPOTrainer("cheetah-run", cfg, num_envs=4, hidden=(16, 16), seed=0, device="cpu")
    p0 = tr.state.net.mean_head.weight.detach().clone()
    snap = tr.state.psync.actor_params
    assert tppo.acting_params(cfg, tr.state) is snap and snap is not tr.state.net
    for _ in range(2):
        tr.run(1, log_every=1)
        # the learner moved, the snapshot is still the initial network, version 0
        assert tr.state.psync.version == 0
        assert torch.equal(snap.mean_head.weight, p0)
        assert not torch.equal(tr.state.net.mean_head.weight, p0)
    tr.run(1, log_every=1)  # the third update: the snapshot adopts the learner
    assert tr.state.psync.version == 3
    for a, b in zip(snap.parameters(), tr.state.net.parameters()):
        assert torch.equal(a, b)
    assert tppo.acting_params(tppo.PPOConfig(), tppo.init_state(
        tppo.PPOConfig(), tr.state.net, 17)) is tr.state.net


def test_trainer_evaluate_and_refused_options():
    from surreal_tpu_torch.train import PPOTrainer

    tr = PPOTrainer("cheetah-run", tppo.PPOConfig(horizon=4, epochs=1, num_minibatches=1),
                    num_envs=4, hidden=(16, 16), seed=0, device="cpu")
    tr.env.episode_steps = 5
    for stochastic in (False, True):
        out = tr.evaluate(episodes=3, stochastic=stochastic)
        assert out["episodes"] == 3 and all(np.isfinite(v) for v in out.values())
    policy, zf = tr.deterministic_policy()
    assert policy(tr.obs).shape == (4, 6) and zf is tr.state.zfilter
    from surreal_tpu_torch.parallel.mesh import Mesh

    model_axis = Mesh(shape={"data": 1, "model": 2, "time": 1}, rank=0, world_size=2,
                      device=torch.device("cpu"), group=None)
    with pytest.raises(ValueError, match="does not compose with use_lstm"):  # the reference's
        PPOTrainer("cheetah-run", device="cpu", mesh=model_axis, overlap=True)


def test_publish_every_matches_reference():
    """Three chained train steps with publish_every=2, the reference's and
    the port's, from the same parameters, noise, permutations and reset
    draws: after each step the snapshot's version is the reference's, the
    snapshot and the learner agree with the reference's to 1e-5, and each
    rollout's means, which come from the weights acted on, agree to the
    trajectory tolerance (the second rollout acts on the initial weights
    while the learner has moved)."""
    B, T, steps = 8, 8, 3
    kw = dict(horizon=T, epochs=1, num_minibatches=2, publish_every=2, fused_loss=False)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    jes, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    jobs = jbase.flatten_obs(ts0.obs)
    fnet = FlaxAC(action_dim=env.action_dim, hidden=HIDDEN)
    params = fnet.init(jax.random.PRNGKey(0), jobs[:1])
    jstate = jppo.init_state(jcfg, params, jobs.shape[-1])
    jep = jnp.zeros((B,), jnp.float32)
    roll = jax.jit(lambda s, es, o, r, k: jppo.rollout(
        jcfg, fnet.apply, step_fn, jbase.flatten_obs, s, es, o, r, k))
    upd = jax.jit(lambda s, tr, k: jppo.update(jcfg, fnet.apply, s, tr, k))

    net = PPOActorCritic(17, 6, HIDDEN)
    net.load_state_dict(params_from_flax(jax.device_get(params)))
    state = tppo.init_state(cfg, net, 17)
    es, obs, ep_ret = EnvState(_t(jes.q), _t(jes.qd), _t(jes.t)), _t(jobs), torch.zeros(B)

    def close(ref_tree, module, name):
        got = params_to_flax(dict(module.named_parameters()))
        for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(got), strict=True):
            assert np.abs(np.asarray(a) - b).max() <= 1e-5, name

    versions = []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3), steps)):
        k_roll, k_up = jax.random.split(key)
        jtraj, jes2, jobs, jep, _ = roll(jstate, jes, jobs, jep, k_roll)
        rows = reference_reset_rows(env, jes, jtraj.done)
        jes = jes2
        noise = (np.asarray(jtraj.action) - np.asarray(jtraj.mean)) / np.exp(
            np.asarray(jtraj.log_std))
        traj, es, obs, ep_ret, _ = tppo.rollout(
            cfg, ScriptedResets(rows), flatten_obs, state, es, obs, ep_ret,
            torch.Generator().manual_seed(0), noise=_t(noise))
        _close(jtraj.mean, traj.mean, TOL_TRAJ, f"rollout {i}: means of the weights acted on")
        _close(jtraj.action, traj.action, TOL_TRAJ, f"rollout {i}: actions")
        if i == 1:  # the learner has moved, the snapshot has not: the lag shows
            with torch.no_grad():
                live = state.net(tppo._norm(cfg, state, traj.obs))[0]
            scale = max(1.0, float(traj.mean.abs().max()))
            assert float((live - traj.mean).abs().max()) > 50 * TOL_TRAJ * scale
        jstate, _ = upd(jstate, jtraj, k_up)
        perms = np.stack([np.asarray(jax.random.permutation(k, B * T))
                          for k in jax.random.split(k_up, jcfg.epochs)])
        tppo.update(cfg, state, traj, None, perms=_t(perms))
        assert state.psync.version == int(jstate.psync.version)
        assert state.update_step == int(jstate.update_step) == i + 1
        close(jstate.psync.actor_params, state.psync.actor_params, f"snapshot after step {i}")
        close(jstate.params, state.net, f"learner after step {i}")
        versions.append(state.psync.version)
    assert versions == [0, 2, 2]

