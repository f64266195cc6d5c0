"""The port's DDPG against the JAX reference on cheetah-run: the optimizer,
one block of updates and one rollout, each from the same parameters, replay
contents and random draws (replay indices, target-smoothing noise and
exploration noise are recomputed from the reference's keys and fed to the
port); then the port's own train_step mechanics and trainer.

Tolerances:
- optimizer: rtol 1e-6 (the same float32 operations);
- update block: parameters, targets and Adam moments within 1e-5 abs after
  three or four updates (each Adam step moves a parameter by at most its
  learning rate, 1e-3 for the critic, and normalises the gradient, so a
  relative rounding error of the gradient moves the result far less);
  metrics rtol 1e-4;
- rollout: 1e-4 · max(1, |ref|), the bar of the PPO rollout test, after 8
  physics steps with contacts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surreal_tpu.algos import ddpg as jddpg
from surreal_tpu.data import replay as jreplay
from surreal_tpu.envs import base as jbase
from surreal_tpu.envs import make_env as jmake_env
from surreal_tpu.models import ddpg_nets as jnets
from surreal_tpu.models import z_filter as jz
from surreal_tpu_torch.algos import ddpg as tddpg
from surreal_tpu_torch.data import replay as treplay
from surreal_tpu_torch.envs import flatten_obs
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.models import ddpg_nets as tnets
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from torch_helpers import ScriptedResets, assert_close, reference_reset_rows, to_torch

ATOL_PARAM, RTOL_METRIC, TOL_TRAJ = 1e-5, 1e-4, 1e-4
OBS_DIM, ACT_DIM, B = 17, 6, 8
A_HID, C_HID = (24, 16), (32, 24)


def _flax_nets():
    actor, critic = jnets.DDPGActor(ACT_DIM, A_HID), jnets.DDPGCritic(C_HID)
    ap = actor.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)))
    cp = critic.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS_DIM)), jnp.zeros((1, ACT_DIM)))
    return actor, critic, ap, cp


def _port_state(cfg, ap, cp):
    actor, critic = tnets.DDPGActor(OBS_DIM, ACT_DIM, A_HID), tnets.DDPGCritic(OBS_DIM, ACT_DIM, C_HID)
    actor.load_state_dict(params_from_flax(jax.device_get(ap)))
    critic.load_state_dict(params_from_flax(jax.device_get(cp)))
    return tddpg.init_state(cfg, actor, critic, OBS_DIM)


def _params_close(ref_tree, module, tol, name):
    got = params_to_flax(dict(module.named_parameters()))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref_tree),
                                 jax.tree_util.tree_leaves_with_path(got), strict=True):
        err = np.abs(np.asarray(a) - b).max()
        assert err <= tol, (name, jax.tree_util.keystr(path), err)


def test_config_keeps_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(jddpg.DDPGConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tddpg.DDPGConfig)}
    assert ref == port
    for refused in ({"shared_encoder": True}, {"aug_shift": 4}, {"zero_optimizer": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tddpg.DDPGConfig(**refused)
    np.testing.assert_array_equal(jddpg.noise_ladder(jddpg.DDPGConfig(), 16),
                                  tddpg.noise_ladder(tddpg.DDPGConfig(), 16))


def test_optimizer_matches_optax():
    """clip_by_global_norm(10) → scale_by_adam() (optax's default eps 1e-8)
    → scale(-lr) over three steps, on a gradient above and below the clip
    norm and on a tiny one, where eps 1e-5 would show."""
    rs = np.random.RandomState(0)
    lr = 1e-3
    module = torch.nn.Linear(3, 4)
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.scale_by_adam(), optax.scale(-lr))
    jp = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
    jstate = opt.init(jp)
    tstate = tddpg.adam_init(module)
    for scale in (1.0, 30.0, 1e-6):
        g = {n: (scale * rs.randn(*p.shape)).astype(np.float32) for n, p in jp.items()}
        ju, jstate = opt.update(g, jstate)
        jp = optax.apply_updates(jp, ju)
        loss = sum((p * to_torch(g[n])).sum() for n, p in module.named_parameters())
        tddpg._adam_step(module, loss, tstate, lr, 10.0)
        for n, p in module.named_parameters():
            np.testing.assert_allclose(np.asarray(jp[n]), p.detach().numpy(), rtol=1e-6,
                                       atol=1e-9)
    assert tstate.count == 3


@pytest.fixture(scope="module")
def filled_replay():
    """Both rings holding the same 40 steps of random transitions (capacity
    32: wrapped), with dones."""
    rs = np.random.RandomState(3)
    cfg = jddpg.DDPGConfig(replay_capacity=32 * B, rollout_steps=8)
    jr = jddpg.init_replay(cfg, B, OBS_DIM, ACT_DIM)
    tr = tddpg.init_replay(tddpg.DDPGConfig(replay_capacity=32 * B, rollout_steps=8), B,
                           OBS_DIM, ACT_DIM, "cpu")
    for _ in range(5):
        chunk = {"obs": rs.randn(8, B, OBS_DIM).astype(np.float32),
                 "action": rs.uniform(-1, 1, (8, B, ACT_DIM)).astype(np.float32),
                 "reward": rs.rand(8, B).astype(np.float32),
                 "done": rs.rand(8, B) < 0.1}
        jr = jreplay.replay_insert(jr, jax.tree.map(jnp.asarray, chunk))
        tr = treplay.replay_insert(tr, {k: to_torch(v) for k, v in chunk.items()})
    assert tr.capacity_t == 32 and tr.total == 40
    return jr, tr


UPDATE_CASES = {
    "defaults": dict(updates_per_iteration=3),
    "td3_hard_sync": dict(updates_per_iteration=4, actor_delay=2, hard_sync_every=2,
                          target_noise=0.2),
    "zfilter": dict(updates_per_iteration=2, use_zfilter=True),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_block_matches_reference(filled_replay, case):
    jr, tr = filled_replay
    kw = dict(batch_size=32, n_step=3, **UPDATE_CASES[case])
    jcfg, tcfg = jddpg.DDPGConfig(**kw), tddpg.DDPGConfig(**kw)
    actor, critic, ap, cp = _flax_nets()
    jstate = jddpg.init_state(jcfg, ap, cp, OBS_DIM)
    tstate = _port_state(tcfg, ap, cp)
    if jcfg.use_zfilter:
        obs = np.asarray(jr.data["obs"])
        jstate = dataclasses.replace(jstate, zfilter=jz.zfilter_update(jstate.zfilter, obs))
        tstate.zfilter = type(tstate.zfilter)(*(to_torch(getattr(jstate.zfilter, f))
                                                for f in ("count", "mean", "m2")))
    key = jax.random.PRNGKey(11)
    new, jm = jax.jit(lambda s, r, k: jddpg.update(jcfg, actor.apply, critic.apply, s, r, k))(
        jstate, jr, key)
    # the reference's draws, from its keys
    indices, target_eps = [], []
    for key_u in jax.random.split(key, jcfg.updates_per_iteration):
        k_sample, k_tnoise, _, _ = jax.random.split(key_u, 4)
        k_t, k_b = jax.random.split(k_sample)
        oldest = max(int(jr.total) - jr.capacity_t, 0)
        num_valid = int(jr.total) - (jcfg.n_step + 1) + 1 - oldest
        indices.append((to_torch(oldest + jax.random.randint(k_t, (32,), 0, num_valid)),
                        to_torch(jax.random.randint(k_b, (32,), 0, B))))
        target_eps.append(np.asarray(jax.random.normal(k_tnoise, (32, ACT_DIM))))
    zf_before = tstate.zfilter
    tstate, tm = tddpg.update(tcfg, tstate, tr, None, indices, to_torch(np.stack(target_eps)))

    for name, ref_tree, module in (
            ("actor", new.actor_params, tstate.actor), ("critic", new.critic_params, tstate.critic),
            ("target_actor", new.target_actor_params, tstate.target_actor),
            ("target_critic", new.target_critic_params, tstate.target_critic)):
        _params_close(ref_tree, module, ATOL_PARAM, name)
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(new.critic_params), jax.tree.leaves(cp)))
    assert moved > 50 * ATOL_PARAM  # the block moved the critic well past the tolerance
    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(v), float(tm[k]), rtol=RTOL_METRIC, atol=1e-7, err_msg=k)
    assert tstate.update_step == int(new.update_step) == jcfg.updates_per_iteration
    for ref_opt, opt in ((new.actor_opt, tstate.actor_opt), (new.critic_opt, tstate.critic_opt)):
        assert int(ref_opt[1].count) == opt.count
        for ref_tree, moments in ((ref_opt[1].mu, opt.mu), (ref_opt[1].nu, opt.nu)):
            got = params_to_flax(moments)
            for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(got), strict=True):
                np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=ATOL_PARAM)
    if jcfg.actor_delay == 2:  # the actor and its Adam state moved on even steps only
        assert tstate.actor_opt.count == 2 and tstate.critic_opt.count == 4
        for t, s in zip(tstate.target_critic.parameters(), tstate.critic.parameters()):
            assert torch.equal(t, s)  # step 4: a hard sync
    else:
        assert not torch.equal(next(tstate.target_critic.parameters()),
                               next(tstate.critic.parameters()))
    assert tstate.zfilter is zf_before  # `update` does not move the Z-filter
    # the actor's gradient left nothing on the critic
    assert all(p.grad is None for p in tstate.critic.parameters())


def test_actor_delay_freezes_actor_and_targets_on_odd_steps(filled_replay):
    _, tr = filled_replay
    cfg = tddpg.DDPGConfig(batch_size=16, updates_per_iteration=1, actor_delay=2,
                           target_noise=0.2)
    _, _, ap, cp = _flax_nets()
    state = _port_state(cfg, ap, cp)
    before = {n: p.clone() for n, p in state.actor.named_parameters()}
    target_before = [p.clone() for p in state.target_critic.parameters()]
    critic_before = next(state.critic.parameters()).clone()
    state, m = tddpg.update(cfg, state, tr, torch.Generator().manual_seed(0))  # step 1: odd
    assert all(torch.equal(p, before[n]) for n, p in state.actor.named_parameters())
    assert all(torch.equal(a, b) for a, b in zip(state.target_critic.parameters(), target_before))
    assert not torch.equal(next(state.critic.parameters()), critic_before)
    assert state.actor_opt.count == 0 and np.isfinite(float(m["actor_loss"]))
    state, _ = tddpg.update(cfg, state, tr, torch.Generator().manual_seed(1))  # step 2: even
    assert not any(torch.equal(p, before[n]) for n, p in state.actor.named_parameters()
                   if n.endswith("weight"))
    assert state.actor_opt.count == 1


@pytest.fixture(scope="module")
def reference_rollout():
    """The reference's 8-step rollout on 8 cheetah envs, of which two start
    at t = 995, so that their episodes end inside it, and two at t = 992, so
    that theirs end with its last step; the Z-filter is on and holds
    statistics of a first batch."""
    cfg = jddpg.DDPGConfig(rollout_steps=8, replay_capacity=12 * B, use_zfilter=True)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    env_state, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    env_state = dataclasses.replace(
        env_state, t=jnp.asarray([995, 992, 0, 0] * (B // 4), jnp.int32))
    obs = jbase.flatten_obs(ts0.obs)
    actor, critic, ap, cp = _flax_nets()
    ap = jax.device_get(ap)
    ap["params"]["Dense_0"]["kernel"] = ap["params"]["Dense_0"]["kernel"] * 100  # a_det off 0
    state = jddpg.init_state(cfg, ap, cp, OBS_DIM)
    state = dataclasses.replace(state, zfilter=jz.zfilter_update(
        state.zfilter, obs + np.random.RandomState(0).randn(32, B, OBS_DIM).astype(np.float32)))
    replay = jddpg.init_replay(cfg, B, OBS_DIM, ACT_DIM)
    replay = jreplay.replay_insert(replay, jax.tree.map(
        lambda x: jnp.ones((8,) + x.shape[1:], x.dtype), replay.data))  # cursor at 8 of 12
    sigma = jnp.asarray(jddpg.noise_ladder(cfg, B))
    ou0 = 0.1 * jnp.asarray(np.random.RandomState(1).randn(B, ACT_DIM), jnp.float32)
    key = jax.random.PRNGKey(5)
    out = jax.jit(lambda s, es, o, ou, r, k, rp: jddpg.rollout(
        cfg, actor.apply, step_fn, jbase.flatten_obs, s, es, o, ou, sigma, r, k, rp))(
        state, env_state, obs, ou0, jnp.zeros((B,)), key, replay)
    eps = np.stack([np.asarray(jax.random.normal(k, (B, ACT_DIM)))
                    for k in jax.random.split(key, cfg.rollout_steps)])
    chunk = out[5]
    assert np.asarray(chunk["done"]).any(), "the rollout must cross an episode boundary"
    return dict(cfg=cfg, ap=ap, cp=cp, zfilter=state.zfilter, env_state=env_state, obs=obs,
                ou0=ou0, sigma=sigma, eps=eps, out=out,
                reset_rows=reference_reset_rows(env, env_state, chunk["done"]))


def test_rollout_matches_reference(reference_rollout):
    ref = reference_rollout
    cfg = tddpg.DDPGConfig(rollout_steps=8, replay_capacity=12 * B, use_zfilter=True)
    state = _port_state(cfg, ref["ap"], ref["cp"])
    state.zfilter = type(state.zfilter)(*(to_torch(getattr(ref["zfilter"], f))
                                          for f in ("count", "mean", "m2")))
    replay = tddpg.init_replay(cfg, B, OBS_DIM, ACT_DIM, "cpu")
    replay = treplay.replay_insert(replay, {k: torch.ones((8,) + v.shape[1:], dtype=v.dtype)
                                            for k, v in replay.data.items()})
    es = ref["env_state"]
    replay, _, obs2, ou, ep_ret, chunk, stats = tddpg.rollout(
        cfg, ScriptedResets(ref["reset_rows"]), flatten_obs, state,
        EnvState(to_torch(es.q), to_torch(es.qd), to_torch(es.t)), to_torch(ref["obs"]),
        to_torch(ref["ou0"]), to_torch(ref["sigma"]), torch.zeros(B),
        torch.Generator().manual_seed(0), replay, eps=to_torch(ref["eps"]))
    jreplay_out, _, jobs2, jou, jep_ret, jchunk, jstats = ref["out"]
    for k in ("obs", "action", "reward"):
        assert_close(jchunk[k], chunk[k], TOL_TRAJ, k)
    np.testing.assert_array_equal(np.asarray(jchunk["done"]), chunk["done"].numpy())
    assert np.abs(np.asarray(jchunk["action"])).max() == 1.0  # the clip binds somewhere
    assert_close(jou, ou, TOL_TRAJ, "ou state")
    done_last = np.asarray(jchunk["done"])[-1]
    assert (ou.numpy()[done_last] == 0).all() and done_last.any()  # reset at `done`
    assert_close(jobs2, obs2, TOL_TRAJ, "final obs")
    assert_close(jep_ret, ep_ret, TOL_TRAJ, "episode return accumulator")
    for k in jstats:
        assert_close(jstats[k], stats[k], TOL_TRAJ, k)
    # the chunk landed at the cursor and wrapped: steps 8..11, then 0..3
    assert replay.total == int(jreplay_out.total) == 16
    for k in jreplay_out.data:
        assert_close(np.asarray(jreplay_out.data[k], np.float32),
                     replay.data[k].to(torch.float32), TOL_TRAJ, f"replay {k}")
    assert torch.equal(replay.data["obs"][:4], chunk["obs"][4:])


def test_gaussian_noise_rollout_leaves_ou_state_alone():
    cfg = tddpg.DDPGConfig(rollout_steps=2, replay_capacity=64, noise_type="gaussian")
    tr = _small_trainer(cfg)
    ou0 = tr.ou_state.clone()
    out = tddpg.rollout(cfg, tr.env, flatten_obs, tr.state, tr.env_state, tr.obs, tr.ou_state,
                        tr.sigma, tr.ep_ret, tr.generator, tr.replay,
                        eps=torch.ones(2, 4, ACT_DIM))
    assert torch.equal(out[3], ou0)
    with torch.no_grad():
        want = torch.clamp(tr.state.actor(tr.obs) + tr.sigma[:, None], -1, 1)
    torch.testing.assert_close(out[5]["action"][0], want)


def _small_trainer(cfg, num_envs=4, **kw):
    from surreal_tpu_torch.train import DDPGTrainer

    return DDPGTrainer("cheetah-run", cfg, num_envs=num_envs, seed=0, actor_hidden=(16, 16),
                       critic_hidden=(16, 16), device="cpu", **kw)


def test_trainer_gates_updates_until_min_replay_and_logs_finite_metrics():
    cfg = tddpg.DDPGConfig(rollout_steps=4, updates_per_iteration=2, batch_size=16,
                           min_replay=32, replay_capacity=256, n_step=3, use_zfilter=True)
    tr = _small_trainer(cfg)
    assert tr.steps_per_iteration == 16 and tr.replay.capacity_t == 64
    logs = tr.run(3, log_every=1)
    assert all(np.isfinite(v) for m in logs for v in m.values())
    # 16 transitions an iteration: the warm-up of 32 is reached at the second
    assert [m["updates"] for m in logs] == [0, 2, 4]
    assert logs[0]["critic_loss"] == logs[0]["actor_loss"] == logs[0]["q_mean"] == 0.0
    assert logs[1]["critic_loss"] > 0
    assert tr.replay.total == 12 and tr.state.update_step == 4
    # the Z-filter saw every rollout chunk, the first, update-less one included
    assert float(tr.state.zfilter.count) == pytest.approx(3 * 16, abs=1e-3)
    ta, a = next(tr.state.target_actor.parameters()), next(tr.state.actor.parameters())
    assert not torch.equal(ta, a)


def test_publish_every_staleness():
    """The rollouts act on a snapshot that lags the learner (as the
    reference's tests/test_replay_ddpg.py shows for the JAX trainer)."""
    cfg = tddpg.DDPGConfig(rollout_steps=4, updates_per_iteration=2, batch_size=16,
                           min_replay=16, replay_capacity=256, publish_every=5)
    tr = _small_trainer(cfg)
    p0 = next(tr.state.actor.parameters()).detach().clone()
    tr.run(2, log_every=2)  # update_step -> 4: both iterations are past min_replay
    snap = next(tr.state.psync.actor_params.parameters())
    assert tr.state.update_step == 4 and tr.state.psync.version == 0
    assert torch.equal(snap, p0) and not torch.equal(next(tr.state.actor.parameters()), p0)
    assert tddpg.acting_params(cfg, tr.state) is tr.state.psync.actor_params
    tr.run(1, log_every=1)  # update_step -> 6 >= 5: the snapshot adopts the learner
    assert tr.state.psync.version == 6
    assert torch.equal(snap, next(tr.state.actor.parameters()))


def test_trainer_evaluate_and_refused_options():
    from surreal_tpu_torch.train import DDPGTrainer

    tr = _small_trainer(tddpg.DDPGConfig(rollout_steps=2, replay_capacity=64))
    tr.env.episode_steps = 5
    out = tr.evaluate(episodes=3)
    assert out["episodes"] == 3 and all(np.isfinite(v) for v in out.values())
    assert out["return_min"] <= out["return_mean"] <= out["return_max"]
    policy, zf = tr.deterministic_policy()
    assert zf is None and policy(tr.obs).shape == (4, ACT_DIM)
    for kw in ({"pixel_obs": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            DDPGTrainer("cheetah-run", device="cpu", **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the default device resolves")
        DDPGTrainer("cheetah-run")


def test_train_steps_with_publish_every_match_reference():
    """Four chained train steps with publish_every=3, the reference's and the
    port's, from the same networks and the reference's draws (exploration
    noise, replay indices, reset rows). The warm-up gate opens at the second
    step, so update_step reads 0, 2, 4, 6 and the snapshot's version 0, 0,
    4, 4: the third rollout acts on the initial actor while the learner has
    moved. After each step the version is the reference's, the snapshot, the
    actor and the critic agree with the reference's to 1e-5 and the ring's
    actions, which come from the weights acted on, to the rollout's
    tolerance."""
    kw = dict(rollout_steps=4, updates_per_iteration=2, batch_size=16, n_step=3,
              min_replay=8 * B, replay_capacity=32 * B, publish_every=3)
    jcfg, cfg = jddpg.DDPGConfig(**kw), tddpg.DDPGConfig(**kw)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    jes, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    jobs = jbase.flatten_obs(ts0.obs)
    actor, critic, ap, cp = _flax_nets()
    ap = jax.device_get(ap)
    ap["params"]["Dense_0"]["kernel"] = ap["params"]["Dense_0"]["kernel"] * 100  # a_det off 0
    jstate = jddpg.init_state(jcfg, ap, cp, OBS_DIM)
    jrep = jddpg.init_replay(jcfg, B, OBS_DIM, ACT_DIM)
    sigma = jnp.asarray(jddpg.noise_ladder(jcfg, B))
    jou, jep = jnp.zeros((B, ACT_DIM)), jnp.zeros((B,))
    jstep = jax.jit(lambda s, rp, es, o, ou, r, k: jddpg.train_step(
        jcfg, actor.apply, critic.apply, step_fn, jbase.flatten_obs, s, rp, es, o, ou, sigma, r,
        k))

    state = _port_state(cfg, ap, cp)
    rep = tddpg.init_replay(cfg, B, OBS_DIM, ACT_DIM, "cpu")
    es, obs = EnvState(to_torch(jes.q), to_torch(jes.qd), to_torch(jes.t)), to_torch(jobs)
    ou, ep_ret = torch.zeros(B, ACT_DIM), torch.zeros(B)
    no_done = np.zeros((cfg.rollout_steps, B), bool)  # 16 steps from t = 0: no episode ends

    seen, lagging = [], []
    for key in jax.random.split(jax.random.PRNGKey(9), 4):
        k_roll, k_up = jax.random.split(key)
        lagging.append(not torch.equal(next(state.psync.actor_params.parameters()),
                                       next(state.actor.parameters())))
        rows = reference_reset_rows(env, jes, no_done)
        jstate, jrep, jes, jobs, jou, jep, _ = jstep(jstate, jrep, jes, jobs, jou, jep, key)
        eps = np.stack([np.asarray(jax.random.normal(k, (B, ACT_DIM)))
                        for k in jax.random.split(k_roll, cfg.rollout_steps)])
        indices = []
        total = int(jrep.total)  # the updates sample after the rollout's insert
        for key_u in jax.random.split(k_up, cfg.updates_per_iteration):
            k_t, k_b = jax.random.split(jax.random.split(key_u, 4)[0])
            num_valid = total - (cfg.n_step + 1) + 1  # the ring has not wrapped
            indices.append((to_torch(jax.random.randint(k_t, (16,), 0, num_valid)),
                            to_torch(jax.random.randint(k_b, (16,), 0, B))))
        state, rep, es, obs, ou, ep_ret, _ = tddpg.train_step(
            cfg, ScriptedResets(rows), flatten_obs, state, rep, es, obs, ou, to_torch(sigma),
            ep_ret, torch.Generator().manual_seed(0), eps=to_torch(eps), indices=indices)
        assert state.psync.version == int(jstate.psync.version)
        assert state.update_step == int(jstate.update_step) and rep.total == total
        _params_close(jstate.psync.actor_params, state.psync.actor_params, ATOL_PARAM, "snapshot")
        _params_close(jstate.actor_params, state.actor, ATOL_PARAM, "actor")
        _params_close(jstate.critic_params, state.critic, ATOL_PARAM, "critic")
        assert_close(jrep.data["action"], rep.data["action"], TOL_TRAJ, "ring actions")
        assert not np.asarray(jrep.data["done"]).any()
        seen.append((state.update_step, state.psync.version))
    assert seen == [(0, 0), (2, 0), (4, 4), (6, 4)]
    assert lagging == [False, False, True, False]  # the third rollout acted on stale weights
