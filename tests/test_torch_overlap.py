"""The overlapped PPO step (ROADMAP A17) of the port against the JAX
reference on cheetah-run: the priming rollout and three chained
train_step_overlapped calls from the same parameters, action noise,
minibatch permutations and reset draws, with publish_every 1 and 2; and
PPOTrainer(overlap=True), with state and pixel observations. Tolerances
are tests/test_torch_ppo.py's: the trajectory 1e-4 · max(1, |ref|), the
parameters 1e-5 after each update (the publish_every test's bar), the
metrics rtol 1e-4.
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
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.envs import flatten_obs
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from torch_helpers import ScriptedResets, assert_close as _close, fast_jit, reference_reset_rows
from torch_helpers import to_torch as _t

TOL_TRAJ, RTOL_METRIC = 1e-4, 1e-4
HIDDEN = (32, 32)


@pytest.mark.parametrize("publish_every", [1, 2])
def test_overlapped_steps_match_reference(publish_every):
    """The priming rollout and three chained train_step_overlapped calls,
    the reference's and the port's, from the same parameters, noise,
    permutations and reset draws (a quarter of the envs start at t = 995,
    so episodes end in the first chunk): each rollout acts with the
    pre-update weights (the published snapshot with publish_every 2) and
    agrees to the trajectory tolerance; each update consumes the trajectory
    the previous call returned (reward_per_step is its mean reward, the
    episode statistics the new rollout's); after each step the learner and
    the snapshot agree with the reference's to 1e-5."""
    B, T, steps = 8, 8, 3
    kw = dict(horizon=T, epochs=1, num_minibatches=2, publish_every=publish_every)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    jes, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    jes = dataclasses.replace(jes, t=jnp.where(jnp.arange(B) % 4 == 0, 995, 0).astype(jnp.int32))
    jobs = jbase.flatten_obs(ts0.obs)
    fnet = FlaxAC(action_dim=env.action_dim, hidden=HIDDEN)
    params = fnet.init(jax.random.PRNGKey(0), jobs[:1])
    jstate = jppo.init_state(jcfg, params, jobs.shape[-1])
    jep = jnp.zeros((B,), jnp.float32)
    prime = fast_jit(lambda s, es, o, r, k: jppo.rollout(
        jcfg, fnet.apply, step_fn, jbase.flatten_obs, s, es, o, r, k))
    overlapped = fast_jit(lambda s, es, o, r, p, k: jppo.train_step_overlapped(
        jcfg, fnet.apply, step_fn, jbase.flatten_obs, s, es, o, r, p, k))

    net = PPOActorCritic(17, 6, HIDDEN)
    net.load_state_dict(params_from_flax(jax.device_get(params)))
    state = tppo.init_state(cfg, net, 17)
    es, obs, ep_ret = EnvState(_t(jes.q), _t(jes.qd), _t(jes.t)), _t(jobs), torch.zeros(B)

    def noise_of(jtraj):
        return _t((np.asarray(jtraj.action) - np.asarray(jtraj.mean))
                  / np.exp(np.asarray(jtraj.log_std)))

    def close(ref_tree, module, name):
        got = params_to_flax(dict(module.named_parameters()))
        for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(got), strict=True):
            assert np.abs(np.asarray(a) - b).max() <= 1e-5, name

    def traj_close(jtraj, traj, name):
        for f in ("action", "mean", "reward"):
            _close(getattr(jtraj, f), getattr(traj, f), TOL_TRAJ, f"{name}: {f}")
        np.testing.assert_array_equal(np.asarray(jtraj.done), traj.done.numpy())

    gen = torch.Generator().manual_seed(0)
    jpending, jes2, jobs, jep, _ = prime(jstate, jes, jobs, jep, jax.random.PRNGKey(2))
    pending, es, obs, ep_ret, _ = tppo.rollout(
        cfg, ScriptedResets(reference_reset_rows(env, jes, jpending.done)), flatten_obs,
        state, es, obs, ep_ret, gen, noise=noise_of(jpending))
    jes = jes2
    traj_close(jpending, pending, "prime")
    assert state.update_step == 0
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3), steps)):
        jstate, jes2, jobs, jep, jtraj, jm = overlapped(jstate, jes, jobs, jep, jpending, key)
        k_up = jax.random.split(key)[1]
        perms = np.stack([np.asarray(jax.random.permutation(k, B * T))
                          for k in jax.random.split(k_up, jcfg.epochs)])
        consumed = pending
        state, es, obs, ep_ret, pending, metrics = tppo.train_step_overlapped(
            cfg, ScriptedResets(reference_reset_rows(env, jes, jtraj.done)), flatten_obs, state,
            es, obs, ep_ret, consumed, gen, noise=noise_of(jtraj), perms=_t(perms))
        jes, jpending = jes2, jtraj
        traj_close(jtraj, pending, f"rollout {i + 1}")
        assert pending is not consumed
        assert float(metrics["reward_per_step"]) == float(torch.mean(consumed.reward))
        for k in ("reward_per_step", "episodes_done", "episode_return_sum", "kl", "policy_loss"):
            np.testing.assert_allclose(float(jm[k]), float(metrics[k]), rtol=RTOL_METRIC,
                                       atol=1e-6, err_msg=f"step {i}: {k}")
        assert state.update_step == int(jstate.update_step) == i + 1
        close(jstate.params, state.net, f"learner after step {i}")
        if publish_every > 1:
            assert state.psync.version == int(jstate.psync.version)
            close(jstate.psync.actor_params, state.psync.actor_params, f"snapshot after {i}")


@pytest.mark.parametrize("pixels", [False, True], ids=["state", "pixel"])
def test_overlap_trainer_primes_once_and_again_after_a_restore(monkeypatch, pixels):
    """PPOTrainer(overlap=True), as the reference's: the first run() primes
    the double buffer with one rollout whose env steps are not counted, a
    later run() does not; load_full_state drops the pending trajectory
    (the full state does not hold it), so the next run() primes again and
    a resumed overlapped run is not the uninterrupted one."""
    from surreal_tpu_torch.train import PPOTrainer

    cfg = tppo.PPOConfig(horizon=4, epochs=1, num_minibatches=1)
    kw = dict(num_envs=4, hidden=(16, 16), seed=0, device="cpu", overlap=True)
    if pixels:
        kw.update(pixel_obs=True, pixel_kwargs={"height": 48, "width": 48,
                                                "action_repeat": 2})
    env = "cartpole-balance" if pixels else "cheetah-run"
    with pytest.raises(ValueError, match="overlap"):
        PPOTrainer(env, cfg, use_lstm=True, **{**kw, "pixel_obs": False, "pixel_kwargs": None})
    calls = {"rollout": 0, "update": 0}
    for name in calls:
        def counted(*a, _f=getattr(tppo, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tppo, name, counted)
    t = PPOTrainer(env, cfg, **kw)
    logs = t.run(2, log_every=1)
    assert calls == {"rollout": 3, "update": 2}
    assert [m["env_steps"] for m in logs] == [16, 32]  # the priming rollout's are not counted
    assert all(np.isfinite(v) for m in logs for v in m.values())
    t.run(1, log_every=1)
    assert calls == {"rollout": 4, "update": 3} and t.global_iter == 3
    fs = t.full_state
    assert not any(isinstance(v, tppo.Trajectory) for v in fs.values())

    straight = PPOTrainer(env, cfg, **kw)
    straight.run(3, log_every=3)
    resumed = PPOTrainer(env, cfg, **kw)
    resumed.run(1, log_every=1)
    resumed.load_full_state(PPOTrainer(env, cfg, **kw).full_state)  # a fresh state, iteration 0
    assert resumed._pending is None and resumed.global_iter == 0
    calls.update(rollout=0, update=0)
    resumed.run(3, log_every=3)
    assert calls == {"rollout": 4, "update": 3}  # primed again
    first = PPOTrainer(env, cfg, **kw)
    first.run(1, log_every=1)
    fs1 = first.full_state
    first.load_full_state(fs1)
    first.run(2, log_every=2)  # resumed at iteration 1: a second priming rollout
    assert first.global_iter == straight.global_iter == 3
    assert not torch.equal(first.state.net.mean_head.weight, straight.state.net.mean_head.weight)
    for a, b in zip(resumed.state.net.parameters(), straight.state.net.parameters()):
        assert torch.equal(a, b)  # from the same fresh state, the same run
