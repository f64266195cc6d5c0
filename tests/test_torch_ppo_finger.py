"""One PPO train_step of the port against the JAX reference on finger-spin,
the recipe's PPO settings (4 minibatches, entropy 0.005, lr_max_scale 2)
at a small width, from the same params, env states, action noise,
minibatch permutations and auto-reset draws (recomputed from the
reference's keys: the finger's 8-candidate rejection draws).

Two sizes: 8 envs x horizon 8 with hidden (16, 16), where the 16-row
minibatches keep the fused loss out on both sides (its gate wants a
multiple of 256 rows) and GAE runs its plain version; and 64 envs x
horizon 16, where the 256-row minibatches let the fused loss in on both
sides (the port's plain versions of the loss kernels on the CPU, the
reference's Pallas kernel in interpret mode). A quarter of the envs start
at t = 995, so their episodes end inside the rollout.

A trajectory that brings a joint to rest against its limit sits within
rounding of the limit row's switch at every step, and the two
implementations may part there (32 envs x horizon 32 from these seeds: one
proximal joint, stopped at its limit in the port, 0.05 rad past it at
5 rad/s in the reference after 26 steps). The sizes and seeds here stay
clear of that; the per-step agreement is 1e-5.

Tolerances, as for cheetah (tests/test_torch_ppo.py): trajectory 1e-4 ·
max(1, |ref|) (the finger's control step agrees to 1e-5,
tests/test_torch_envs_manipulation.py); values, value targets and
advantages 1e-3 · max(1, |ref|) (the Z-filter's initial std of 1e-3
scales an observation's rounding by 1000); metrics rtol 1e-4; Z-filter
rtol 1e-5; updated params 4e-6 abs. The lr_scale decision must agree
exactly. The reference's rollout and update are compiled at XLA's backend
optimisation level 0 (`torch_helpers.fast_jit`).
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
from surreal_tpu_torch.envs import flatten_obs, make_env
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.ops import gae_kernel, ppo_loss_kernel, returns
from torch_helpers import assert_close, fast_jit, reference_reset_draws, scripted
from torch_helpers import to_torch as _t

TOL_TRAJ, TOL_VALUE, RTOL_METRIC, RTOL_ZF, ATOL_PARAM = 1e-4, 1e-3, 1e-4, 1e-5, 4e-6
RECIPE = dict(num_minibatches=4, entropy_coef=0.005, lr_max_scale=2.0, fused_loss=True)
OBS, ACT = 9, 2


@pytest.fixture(scope="module", params=[(8, 8, (16, 16)), (64, 16, (16, 16))],
                ids=["B8_T8", "B64_T16_fused"])
def reference(request):
    B, T, hidden = request.param
    cfg = jppo.PPOConfig(horizon=T, **RECIPE)
    env = jmake_env("finger-spin")
    reset_fn, step_fn = jbase.vectorize(env)
    env_state, ts0 = fast_jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    env_state = dataclasses.replace(
        env_state, t=jnp.where(jnp.arange(B) % 4 == 0, 995, 0).astype(jnp.int32))
    obs = jbase.flatten_obs(ts0.obs)
    net = FlaxAC(action_dim=env.action_dim, hidden=hidden)
    params = net.init(jax.random.PRNGKey(0), obs[:1])
    state = jppo.init_state(cfg, params, obs.shape[-1])
    k_roll, k_up = jax.random.split(jax.random.PRNGKey(7))
    traj, _, obs2, _, stats = fast_jit(
        lambda s, es, o, r, k: jppo.rollout(cfg, net.apply, step_fn, jbase.flatten_obs,
                                            s, es, o, r, k))(
        state, env_state, obs, jnp.zeros((B,), jnp.float32), k_roll)
    orig = pallas_ppo_loss.fused_clip_loss
    pallas_ppo_loss.fused_clip_loss = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        new_state, metrics = fast_jit(
            lambda s, tr, k: jppo.update(cfg, net.apply, s, tr, k))(state, traj, k_up)
    finally:
        pallas_ppo_loss.fused_clip_loss = orig
    metrics.update(stats)
    metrics["reward_per_step"] = jnp.mean(traj.reward)
    perms = np.stack([np.asarray(jax.random.permutation(k, B * T))
                      for k in jax.random.split(k_up, cfg.epochs)])
    noise = (np.asarray(traj.action) - np.asarray(traj.mean)) / np.exp(np.asarray(traj.log_std))
    assert np.asarray(traj.done).any(), "the rollout must cross an episode boundary"
    return dict(B=B, T=T, hidden=hidden, params=jax.device_get(params), env_state=env_state,
                obs=obs, traj=traj, obs2=obs2, new_state=new_state,
                metrics=jax.device_get(metrics), perms=perms, noise=noise,
                draws=reference_reset_draws(env, env_state, traj.done))


def _port_inputs(ref):
    cfg = tppo.PPOConfig(horizon=ref["T"], **RECIPE)
    net = PPOActorCritic(OBS, ACT, ref["hidden"])
    net.load_state_dict(params_from_flax(ref["params"]))
    es = ref["env_state"]
    env = scripted(make_env("finger-spin", device="cpu"), ref["draws"])
    return cfg, env, tppo.init_state(cfg, net, OBS), EnvState(_t(es.q), _t(es.qd), _t(es.t))


def test_rollout_matches_reference(reference):
    cfg, env, state, env_state = _port_inputs(reference)
    traj, _, obs2, _, _ = tppo.rollout(
        cfg, env, flatten_obs, state, env_state, _t(reference["obs"]),
        torch.zeros(reference["B"]), torch.Generator().manual_seed(0),
        noise=_t(reference["noise"]))
    tr = reference["traj"]
    for name in ("obs", "action", "log_prob", "mean", "log_std", "reward", "discount"):
        assert_close(getattr(tr, name), getattr(traj, name), TOL_TRAJ, name)
    for name in ("value", "next_value"):
        assert_close(getattr(tr, name), getattr(traj, name), TOL_VALUE, name)
    np.testing.assert_array_equal(np.asarray(tr.done), traj.done.numpy())
    assert_close(reference["obs2"], obs2, TOL_TRAJ, "final obs")
    adv_j, vt_j = jret.gae(tr.reward, tr.value, tr.next_value, tr.discount, tr.done,
                           cfg.gamma, cfg.lam)
    adv_t, vt_t = returns.gae(traj.reward, traj.value, traj.next_value, traj.discount,
                              traj.done, cfg.gamma, cfg.lam)
    assert_close(adv_j, adv_t, TOL_VALUE, "advantages")
    assert_close(vt_j, vt_t, TOL_VALUE, "value targets")
    touch = traj.obs[..., 7:9]  # flattened obs: position (4), touch (2), velocity (3)
    assert_close(np.asarray(tr.obs)[..., 7:9], touch, TOL_TRAJ, "touch")


def test_train_step_matches_reference(reference):
    cfg, env, state, env_state = _port_inputs(reference)
    launches = (gae_kernel.GAE.launches, ppo_loss_kernel.FWD.launches,
                ppo_loss_kernel.BWD.launches)
    state, _, _, _, metrics = tppo.train_step(
        cfg, env, flatten_obs, state, env_state, _t(reference["obs"]),
        torch.zeros(reference["B"]), torch.Generator().manual_seed(0),
        noise=_t(reference["noise"]), perms=_t(reference["perms"]))
    # CPU tensors: the plain versions ran, no kernel
    assert launches == (gae_kernel.GAE.launches, ppo_loss_kernel.FWD.launches,
                        ppo_loss_kernel.BWD.launches)
    rows = reference["B"] * reference["T"] // cfg.num_minibatches
    assert tppo.fused_loss_admits(cfg, rows) == (rows % 256 == 0)
    ref_state = reference["new_state"]
    got = params_to_flax(dict(state.net.named_parameters()))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref_state.params),
                                 jax.tree_util.tree_leaves_with_path(got)):
        err = np.abs(np.asarray(a) - b).max()
        assert err <= ATOL_PARAM, (jax.tree_util.keystr(path), err)
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(ref_state.params), jax.tree.leaves(reference["params"])))
    assert moved > 50 * ATOL_PARAM
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


def test_trainer_runs_finger_spin_at_the_recipe():
    """PPOTrainer on finger-spin with the recipe's settings and hidden
    (64, 64), 8 envs, 2 iterations of horizon 8: finite metrics."""
    from surreal_tpu_torch.train import PPOTrainer

    cfg = tppo.PPOConfig(horizon=8, **RECIPE)
    tr = PPOTrainer("finger-spin", cfg, num_envs=8, hidden=(64, 64), seed=0, device="cpu")
    logs = tr.run(2, log_every=1)
    assert [m["iteration"] for m in logs] == [1, 2]
    assert all(np.isfinite(v) for m in logs for v in m.values())
    assert tr.state.update_step == 2 and tr.obs.shape == (8, OBS)
