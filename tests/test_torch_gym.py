"""The gymnasium bridge of the port (`envs/gym_adapter.py::GymEnv`, the
registry's "gym:" names, trainers on a pre-built env) against the JAX
package's, on gym:Pendulum-v1.

- GymEnv fed the same actions as the reference's for 205 steps, across
  the episode end (step 199 truncates) and gymnasium 1.x's next-step reset
  (step 200: reward 0, the action ignored): obs, carry_obs, reward,
  discount and done are equal, exactly (the same host arithmetic in
  float32).
- One PPO train_step on it against the reference's, from the same params,
  host env states (both batches stepped 195 times with the same actions,
  so the rollout crosses the episode end), action noise and permutations;
  at the tolerances of tests/test_torch_ppo.py: trajectory 1e-4 ·
  max(1, |ref|), values and advantages 1e-3 · max(1, |ref|), metrics rtol
  1e-4 (the policy loss, which cancels, at its terms' scale), the Z-filter
  rtol 1e-5, parameters 4e-6. The actions agree to float32 rounding, and
  the pendulum carries that on.
- A trainer on a pre-built env instance equals the trainer on its name,
  bit for bit; a gym name gets `num_envs` as its default env kwarg.
- DDPG keeps the reference's behaviour: a name only, no `num_envs` default,
  so it fails as the reference's does without `env_kwargs={"num_envs": n}`
  and runs with it.
- An evaluation runs on a batch of its own, so the training envs keep
  their episodes.
"""

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
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.envs import flatten_obs, make_env
from surreal_tpu_torch.envs.gym_adapter import GymEnv
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from torch_helpers import assert_close as _close
from torch_helpers import to_torch as _t

gym = pytest.importorskip("gymnasium")

TOL_TRAJ, TOL_VALUE, RTOL_METRIC, RTOL_ZF, ATOL_PARAM = 1e-4, 1e-3, 1e-4, 1e-5, 4e-6
HIDDEN = (32, 32)
ENV = "gym:Pendulum-v1"
PRE_STEPS = 195  # Pendulum's episodes are 200 steps: the rollout crosses the end


def _actions(steps, B, seed):
    """Actions in [-1.2, 1.2]: the adapter rescales without clipping."""
    return np.random.RandomState(seed).uniform(-1.2, 1.2, (steps, B, 1)).astype(np.float32)


def test_gym_env_matches_reference_across_the_episode_end():
    B, steps = 4, 205
    ref, env = jmake_env(ENV, num_envs=B, seed=3), make_env(ENV, num_envs=B, seed=3,
                                                            device="cpu")
    assert isinstance(env, GymEnv) and env.episode_steps == ref.episode_steps == 200
    assert env.action_dim == ref.action_dim == 1
    assert env.obs_spec()["observations"].shape == ref.obs_spec()["observations"].shape
    assert env.action_spec().shape == ref.action_spec().shape
    rstate, rts = ref.reset(jax.random.PRNGKey(0))
    state, ts = env.reset(B)
    assert state.q.shape == state.qd.shape == (B, 0) and state.t.shape == (B,)

    def check(label):
        for k in ("obs", "carry_obs"):
            np.testing.assert_array_equal(np.asarray(getattr(rts, k)["observations"]),
                                          getattr(ts, k)["observations"].numpy(), label)
        for k in ("reward", "discount", "done"):
            np.testing.assert_array_equal(np.asarray(getattr(rts, k)),
                                          getattr(ts, k).numpy(), f"{label} {k}")

    check("reset")
    seen = []
    for i, a in enumerate(_actions(steps, B, 0)):
        rstate, rts = ref.step(rstate, jnp.asarray(a))
        state, ts = env.step(state, torch.from_numpy(a))
        check(f"step {i}")
        seen.append((ts.done.numpy().copy(), ts.reward.numpy().copy(),
                     ts.discount.numpy().copy()))
    done, reward, discount = map(np.stack, zip(*seen))
    assert done[199].all() and not done[:199].any() and not done[200:].any()
    assert (discount == 1.0).all()  # a truncation is no termination
    assert (reward[200] == 0.0).all() and (reward[:200] < 0).all()  # the late reset
    # reset reseeds every call
    _, a = env.reset(B)
    _, b = env.reset(B)
    np.testing.assert_array_equal(a.obs["observations"].numpy(), b.obs["observations"].numpy())


def test_batch_other_than_num_envs_is_refused():
    env = make_env(ENV, num_envs=4, device="cpu")
    with pytest.raises(ValueError, match="batch of 3 envs.*num_envs=4"):
        env.reset(3)
    state, _ = env.reset(4)
    with pytest.raises(ValueError, match="batch of 2 envs.*num_envs=4"):
        env.step(state, torch.zeros(2, 1))


@pytest.fixture(scope="module")
def reference():
    """The reference's rollout and update for 32 envs and horizon 16 (epochs
    2, minibatches 2 of 256 rows: the fused loss admits on both sides; the
    Pallas kernel in interpret mode), from host envs 195 steps in."""
    B, T = 32, 16
    cfg = jppo.PPOConfig(horizon=T, epochs=2, num_minibatches=2, fused_loss=True)
    env = jmake_env(ENV, num_envs=B, seed=0)
    reset_fn, step_fn = jbase.vectorize(env)
    env_state, _ = reset_fn(jax.random.split(jax.random.PRNGKey(1), B))
    pre = _actions(PRE_STEPS, B, 1)
    for a in pre:
        env_state, ts = step_fn(env_state, jnp.asarray(a))
    obs = jbase.flatten_obs(ts.carry_obs)
    net = FlaxAC(action_dim=1, hidden=HIDDEN)
    params = net.init(jax.random.PRNGKey(0), obs[:1])
    state = jppo.init_state(cfg, params, obs.shape[-1])
    ep_ret = jnp.zeros((B,), jnp.float32)
    k_roll, k_up = jax.random.split(jax.random.PRNGKey(7))
    traj, _, obs2, _, stats = jax.jit(
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
    perms = np.stack([np.asarray(jax.random.permutation(k, B * T))
                      for k in jax.random.split(k_up, cfg.epochs)])
    noise = (np.asarray(traj.action) - np.asarray(traj.mean)) / np.exp(np.asarray(traj.log_std))
    assert np.asarray(traj.done).any()
    return dict(B=B, T=T, pre=pre, params=jax.device_get(params), obs=np.asarray(obs),
                traj=traj, obs2=obs2, new_state=new_state, metrics=jax.device_get(metrics),
                perms=perms, noise=noise)


def _port_inputs(ref):
    cfg = tppo.PPOConfig(horizon=ref["T"], epochs=2, num_minibatches=2, fused_loss=True)
    net = PPOActorCritic(3, 1, HIDDEN)
    net.load_state_dict(params_from_flax(ref["params"]))
    env = GymEnv("Pendulum-v1", ref["B"], seed=0, device="cpu")
    env_state, _ = env.reset(ref["B"])
    for a in ref["pre"]:
        env_state, ts = env.step(env_state, torch.from_numpy(a))
    obs = flatten_obs(ts.carry_obs)
    np.testing.assert_array_equal(obs.numpy(), ref["obs"])  # the same host states
    return cfg, env, tppo.init_state(cfg, net, 3), env_state, obs


def test_rollout_matches_reference(reference):
    cfg, env, state, env_state, obs = _port_inputs(reference)
    traj, _, obs2, _, _ = tppo.rollout(cfg, env, flatten_obs, state, env_state, obs,
                                       torch.zeros(reference["B"]), torch.Generator(),
                                       noise=_t(reference["noise"]))
    tr = reference["traj"]
    for name in ("obs", "action", "log_prob", "mean", "log_std", "reward", "discount"):
        _close(getattr(tr, name), getattr(traj, name), TOL_TRAJ, name)
    for name in ("value", "next_value"):
        _close(getattr(tr, name), getattr(traj, name), TOL_VALUE, name)
    np.testing.assert_array_equal(np.asarray(tr.done), traj.done.numpy())
    assert traj.done[199 - PRE_STEPS].all() and (traj.reward[200 - PRE_STEPS] == 0).all()
    _close(reference["obs2"], obs2, TOL_TRAJ, "final obs")


def _check_update(reference, state, metrics, cancelling=()):
    ref_state = reference["new_state"]
    got = params_to_flax(dict(state.net.named_parameters()))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref_state.params),
                                 jax.tree_util.tree_leaves_with_path(got)):
        err = np.abs(np.asarray(a) - b).max()
        assert err <= ATOL_PARAM, (jax.tree_util.keystr(path), err)
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(ref_state.params), jax.tree.leaves(reference["params"])))
    assert moved > 50 * ATOL_PARAM
    for k in metrics:
        v = reference["metrics"][k]
        if k in cancelling:
            assert abs(float(v) - float(metrics[k])) <= RTOL_METRIC, k
        else:
            np.testing.assert_allclose(float(v), float(metrics[k]), rtol=RTOL_METRIC,
                                       atol=1e-7, err_msg=k)
    for f in ("count", "mean", "m2"):
        np.testing.assert_allclose(np.asarray(getattr(ref_state.zfilter, f)),
                                   getattr(state.zfilter, f).numpy(), rtol=RTOL_ZF, atol=1e-6)
    assert float(ref_state.lr_scale) == float(state.lr_scale)


def test_train_step_matches_reference(reference):
    """The whole step. The policy loss is a mean of ratio · advantage terms
    over advantages normalized to unit std, which cancel to ~4e-3 here: it
    is held to the metric tolerance at its terms' scale of 1. Measured 6.4e-7
    apart, and 6.7e-7 when the port's update is fed the reference's own
    trajectory: the update's rounding of the ratios, not the rollout's."""
    cfg, env, state, env_state, obs = _port_inputs(reference)
    state, _, _, _, metrics = tppo.train_step(
        cfg, env, flatten_obs, state, env_state, obs, torch.zeros(reference["B"]),
        torch.Generator(), noise=_t(reference["noise"]), perms=_t(reference["perms"]))
    assert set(metrics) == set(reference["metrics"])
    _check_update(reference, state, metrics, cancelling=("policy_loss",))


def _equal_trainers(a, b):
    for (n, x), (_, y) in zip(a.state.net.named_parameters(), b.state.net.named_parameters()):
        assert torch.equal(x, y), n
    assert torch.equal(a.obs, b.obs) and torch.equal(a.ep_ret, b.ep_ret)


@pytest.mark.parametrize("name,kwargs", [("cheetah-run", {}), (ENV, {"num_envs": 4})],
                         ids=["cheetah", "pendulum"])
def test_trainer_on_an_instance_equals_the_named_trainer(name, kwargs):
    from surreal_tpu_torch.train import PPOTrainer

    cfg = tppo.PPOConfig(horizon=8, epochs=1, num_minibatches=2)
    common = dict(num_envs=4, hidden=(16, 16), seed=0, device="cpu")
    named = PPOTrainer(name, cfg, **common)
    inst = PPOTrainer(make_env(name, device="cpu", **kwargs), cfg, **common)
    named.run(2, log_every=1)
    inst.run(2, log_every=1)
    _equal_trainers(named, inst)


def test_gym_name_gets_num_envs_and_trains():
    from surreal_tpu_torch.train import PPOTrainer

    cfg = tppo.PPOConfig(horizon=8, epochs=1, num_minibatches=1)
    tr = PPOTrainer(ENV, cfg, num_envs=4, seed=0, hidden=(16, 16), device="cpu")
    assert tr.env.num_envs == 4 and tr.obs.shape == (4, 3)
    logs = tr.run(2, log_every=1)
    assert all(np.isfinite(v) for m in logs for v in m.values())
    with pytest.raises(ValueError, match="num_envs=6"):  # an env_kwarg wins over the default
        PPOTrainer(ENV, cfg, num_envs=4, hidden=(16, 16), device="cpu",
                   env_kwargs={"num_envs": 6})


def test_ddpg_on_a_gym_name_behaves_as_the_reference():
    from surreal_tpu.algos.ddpg import DDPGConfig as JCfg
    from surreal_tpu.train.ddpg_trainer import DDPGTrainer as JDDPG
    from surreal_tpu_torch.algos.ddpg import DDPGConfig
    from surreal_tpu_torch.train import DDPGTrainer

    small = dict(rollout_steps=4, updates_per_iteration=2, batch_size=8,
                 replay_capacity=256, min_replay=16)
    nets = dict(actor_hidden=(16, 16), critic_hidden=(16, 16))
    with pytest.raises(TypeError):
        JDDPG(ENV, JCfg(**small), num_envs=4, **nets)
    with pytest.raises(TypeError):
        DDPGTrainer(ENV, DDPGConfig(**small), num_envs=4, device="cpu", **nets)
    ref = JDDPG(ENV, JCfg(**small), num_envs=4, env_kwargs={"num_envs": 4}, **nets)
    port = DDPGTrainer(ENV, DDPGConfig(**small), num_envs=4, device="cpu",
                       env_kwargs={"num_envs": 4}, **nets)
    for tr in (ref, port):
        logs = tr.run(2, log_every=1)
        assert all(np.isfinite(v) for m in logs for v in m.values())
    assert port.replay.total == int(ref.replay.total) == 2 * 4  # steps of the env batch
    assert port.state.update_step == int(ref.state.update_step) > 0


def test_evaluation_leaves_the_training_envs_their_episodes():
    """Two twin trainers of 8 envs; one evaluates 2 episodes between its
    iterations (the reference fails on that width, and at 8 it would reseed
    the training envs): the next iteration is the same, bit for bit."""
    from surreal_tpu_torch.train import PPOTrainer

    cfg = tppo.PPOConfig(horizon=8, epochs=1, num_minibatches=1)
    a, b = (PPOTrainer(ENV, cfg, num_envs=8, hidden=(16, 16), seed=0, device="cpu")
            for _ in range(2))
    a.run(1, log_every=1)
    b.run(1, log_every=1)
    ev = a.evaluate(episodes=2)
    assert ev["episodes"] == 2 and np.isfinite(ev["return_mean"])
    assert ev == a.evaluate(episodes=2)  # a fresh batch from the seed each time
    a.run(1, log_every=1)
    b.run(1, log_every=1)
    _equal_trainers(a, b)
