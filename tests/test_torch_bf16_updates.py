"""One bfloat16 update on each learner path of the port (ROADMAP A13)
against the JAX package on the CPU: a PPO update (unfused and fused), an
LSTM-PPO update and a DDPG update block (state, and pixels with a shared
encoder), each fed the same synthetic trajectory or replay contents and the
reference's own draws (permutations, replay indices, target-smoothing
noise, shifts), so that no physics program is compiled. The blocks
themselves are held in tests/test_torch_bf16.py.

Tolerances, each with the largest value measured on the CPU:
- the parameters after an update: every element within ATOL_PARAM but for
  a share PARAM_SHARE (0.2; measured 0.036 PPO, 0.128 LSTM-PPO, 0.022
  DDPG, 0.114 pixel DDPG), and all within the Adam steps' reach
  (`_reach`; measured 4.3e-4 of 2.4e-3 PPO, 5.4e-4 of 2.4e-3 LSTM-PPO,
  2.0e-3 of 6.1e-3 DDPG, 4.4e-3 of 6.1e-3 pixel DDPG). bfloat16 gradients
  round differently on the two sides, and Adam moves an element by ~lr x
  sign(g) whatever the size of g, so an element whose gradient is near 0
  can move apart by up to that reach;
- the metrics of the last minibatch: RTOL_METRIC (1e-2) relative, or 1e-3
  absolute for those near 0 (measured at most 1.5e-3 relative, DDPG's
  q_mean), from networks whose parameters differ as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.algos import ddpg as jddpg
from surreal_tpu.algos import ppo as jppo
from surreal_tpu.algos import ppo_lstm as jlstm
from surreal_tpu.data import replay as jreplay
from surreal_tpu.models import ddpg_nets as jnets
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu.ops import pallas_ppo_loss
from surreal_tpu_torch.algos import ddpg as tddpg
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.algos import ppo_lstm as tlstm
from surreal_tpu_torch.data import replay as treplay
from surreal_tpu_torch.models import ddpg_nets as tnets
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.ops import ppo_loss_kernel as plk
from torch_helpers import fast_jit, to_torch

BF, TBF = jnp.bfloat16, torch.bfloat16
ATOL_PARAM, PARAM_SHARE, RTOL_METRIC = 1e-5, 0.2, 1e-2
OBS_DIM, ACT_DIM, HIDDEN = 17, 6, (32, 32)


def _param_errs(ref_tree, module, stem_key="stem") -> tuple[float, float]:
    """(largest |ref - port| over all parameters, share of elements beyond
    ATOL_PARAM)."""
    got = params_to_flax(dict(module.named_parameters()), stem_key)
    errs = [np.abs(np.asarray(a) - b).ravel() for a, b in
            zip(jax.tree.leaves(ref_tree), jax.tree.leaves(got), strict=True)]
    errs = np.concatenate(errs)
    return float(errs.max()), float((errs > ATOL_PARAM).mean())


def _hold(ref_tree, before, module, reach, stem_key="stem") -> None:
    """Share and reach; and the update moved the parameters well past
    ATOL_PARAM."""
    err, share = _param_errs(ref_tree, module, stem_key)
    assert err <= reach and share <= PARAM_SHARE, (err, share, reach)
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max()
                for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(before)))
    assert moved > 10 * ATOL_PARAM


def _reach(steps: int, lr: float) -> float:
    """How far apart `steps` Adam steps can carry an element on two sides
    whose gradient signs differ: each side moves it ~lr a step, in opposite
    directions at worst."""
    return 2 * steps * lr * 1.01


def _metrics_close(ref: dict, got: dict) -> None:
    assert set(ref) <= set(got)
    for k, v in ref.items():
        np.testing.assert_allclose(float(v), float(got[k]), rtol=RTOL_METRIC, atol=1e-3,
                                   err_msg=k)


def _trajectory(T, B, rs, lstm=False) -> dict:
    """A synthetic rollout chunk: the old policy's means and log-std with
    actions drawn from it (their log-probs the reference's), values, rewards
    and a few episode ends."""
    from surreal_tpu.models.distributions import DiagGauss as JGauss

    mean = (0.5 * rs.randn(T, B, ACT_DIM)).astype(np.float32)
    log_std = np.full((T, B, ACT_DIM), -0.5, np.float32)
    action = (mean + np.exp(log_std) * rs.randn(T, B, ACT_DIM)).astype(np.float32)
    done = rs.rand(T, B) < 0.08
    out = dict(obs=(2 * rs.randn(T, B, OBS_DIM)).astype(np.float32), action=action,
               log_prob=np.asarray(JGauss.log_prob(mean, log_std, action)), mean=mean,
               log_std=log_std, value=rs.randn(T, B).astype(np.float32),
               next_value=rs.randn(T, B).astype(np.float32),
               reward=rs.rand(T, B).astype(np.float32),
               discount=np.where(rs.rand(T, B) < 0.03, 0.0, 1.0).astype(np.float32), done=done)
    if lstm:
        out["init_carry"] = tuple((0.3 * rs.randn(B, 16)).astype(np.float32) for _ in range(2))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_ppo_update_bf16_matches_reference(fused):
    """One update (2 epochs x 2 minibatches of 256 rows) of a bfloat16
    actor-critic. Fused, the reference's Pallas loss runs in interpret mode
    and the port's wrapper takes its plain version (CPU tensors): both are
    fed the float32 outputs of the bfloat16 heads."""
    T, B = 16, 32
    kw = dict(horizon=T, epochs=2, num_minibatches=2, fused_loss=fused)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    tr = _trajectory(T, B, np.random.RandomState(7))
    fnet = FlaxAC(action_dim=ACT_DIM, hidden=HIDDEN, compute_dtype=BF)
    params = jax.device_get(fnet.init(jax.random.PRNGKey(0), tr["obs"][0, :1]))
    jstate = jppo.init_state(jcfg, params, OBS_DIM)
    key = jax.random.PRNGKey(3)
    orig = pallas_ppo_loss.fused_clip_loss
    pallas_ppo_loss.fused_clip_loss = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        new, jm = fast_jit(lambda s, t, k: jppo.update(jcfg, fnet.apply, s, t, k))(
            jstate, jppo.Trajectory(**tr), key)
    finally:
        pallas_ppo_loss.fused_clip_loss = orig
    perms = np.stack([np.asarray(jax.random.permutation(k, T * B))
                      for k in jax.random.split(key, cfg.epochs)])
    net = PPOActorCritic(OBS_DIM, ACT_DIM, HIDDEN, compute_dtype=TBF)
    net.load_state_dict(params_from_flax(params))
    state = tppo.init_state(cfg, net, OBS_DIM)
    fwd = plk.FWD.launches
    state, metrics = tppo.update(cfg, state, tppo.Trajectory(
        **{k: to_torch(v) for k, v in tr.items()}), None, perms=to_torch(perms))
    assert plk.FWD.launches == fwd  # CPU tensors: the plain versions
    _hold(new.params, params, state.net, reach=_reach(4, cfg.lr))
    _metrics_close(jax.device_get(jm), metrics)
    assert float(new.lr_scale) == float(state.lr_scale)
    assert all(p.dtype == torch.float32 for p in state.net.parameters())


def test_lstm_ppo_update_bf16_matches_reference():
    """One LSTM-PPO update (2 epochs x 2 minibatches of 4 whole sequences)
    from a bfloat16 initial carry, through time over 8 steps with episode
    ends."""
    T, B = 8, 8
    kw = dict(horizon=T, epochs=2, num_minibatches=2)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    tr = _trajectory(T, B, np.random.RandomState(8), lstm=True)
    fnet = FlaxAC(action_dim=ACT_DIM, hidden=HIDDEN, use_lstm=True, lstm_size=16,
                  compute_dtype=BF)
    carry = tuple(jnp.asarray(c, BF) for c in tr.pop("init_carry"))
    params = jax.device_get(fnet.init(jax.random.PRNGKey(0), tr["obs"][0, :1],
                                      jax.tree.map(lambda c: c[:1], carry)))
    jstate = jppo.init_state(jcfg, params, OBS_DIM)
    key = jax.random.PRNGKey(4)
    new, jm = fast_jit(lambda s, t, k: jlstm.update(jcfg, fnet.apply, s, t, k))(
        jstate, jlstm.LSTMTrajectory(init_carry=carry, **tr), key)
    perms = np.stack([np.asarray(jax.random.permutation(k, B))
                      for k in jax.random.split(key, cfg.epochs)])
    net = PPOActorCritic(OBS_DIM, ACT_DIM, HIDDEN, use_lstm=True, lstm_size=16,
                         compute_dtype=TBF)
    net.load_state_dict(params_from_flax(params))
    state = tppo.init_state(cfg, net, OBS_DIM)
    traj = tlstm.LSTMTrajectory(
        init_carry=tuple(to_torch(np.asarray(c.astype(jnp.float32))).to(TBF) for c in carry),
        **{k: to_torch(v) for k, v in tr.items()})
    state, metrics = tlstm.update(cfg, state, traj, None, perms=to_torch(perms))
    _hold(new.params, params, state.net, reach=_reach(4, cfg.lr))
    _metrics_close(jax.device_get(jm), metrics)


@pytest.mark.parametrize("pixels", [False, True], ids=["state", "pixel"])
def test_ddpg_update_block_bf16_matches_reference(pixels):
    """Three DDPG updates in bfloat16 from the same replay contents and the
    reference's draws (indices, target-smoothing noise; on pixels the shifts
    too, with a shared encoder and aug_shift 4): the live networks, the
    targets (which follow the live ones in float32) and the metrics."""
    rs = np.random.RandomState(3)
    shape = (48, 64, 3)
    B, batch = 4, 8
    kw = dict(replay_capacity=16 * B, rollout_steps=8, batch_size=batch, n_step=3,
              updates_per_iteration=3, target_noise=0.2)
    if pixels:
        kw.update(shared_encoder=True, aug_shift=4)
    jcfg, cfg = jddpg.DDPGConfig(**kw), tddpg.DDPGConfig(**kw)
    layout = dict(obs_shape=shape) if pixels else {}
    jr = jddpg.init_replay(jcfg, B, OBS_DIM, ACT_DIM, obs_dtype=jnp.uint8 if pixels
                           else jnp.float32, **layout)
    tr = tddpg.init_replay(cfg, B, OBS_DIM, ACT_DIM, "cpu", obs_dtype=torch.uint8 if pixels
                           else torch.float32, **layout)
    for _ in range(3):
        chunk = {"obs": (rs.randint(0, 256, (8, B, *shape)).astype(np.uint8) if pixels
                         else rs.randn(8, B, OBS_DIM).astype(np.float32)),
                 "action": rs.uniform(-1, 1, (8, B, ACT_DIM)).astype(np.float32),
                 "reward": rs.rand(8, B).astype(np.float32), "done": rs.rand(8, B) < 0.1}
        jr = jreplay.replay_insert(jr, jax.tree.map(jnp.asarray, chunk))
        tr = treplay.replay_insert(tr, {k: to_torch(v) for k, v in chunk.items()})
    net_in = shape if pixels else OBS_DIM
    actor = jnets.DDPGActor(ACT_DIM, (24, 16), pixel_obs=pixels, detach_stem=pixels,
                            compute_dtype=BF)
    critic = jnets.DDPGCritic((32, 24), pixel_obs=pixels, compute_dtype=BF)
    x = jnp.zeros((1, *shape), jnp.uint8) if pixels else jnp.zeros((1, OBS_DIM))
    ap = actor.init(jax.random.PRNGKey(0), x)
    cp = critic.init(jax.random.PRNGKey(1), x, jnp.zeros((1, ACT_DIM)))
    if pixels:
        ap = jddpg.sync_encoder(ap, cp)
    ap, cp = jax.device_get((ap, cp))
    key = jax.random.PRNGKey(11)
    new, jm = fast_jit(lambda s, r, k: jddpg.update(jcfg, actor.apply, critic.apply, s, r, k))(
        jddpg.init_state(jcfg, ap, cp, OBS_DIM), jr, key)
    indices, target_eps, offsets = [], [], []
    for key_u in jax.random.split(key, jcfg.updates_per_iteration):
        k_sample, k_tnoise, k_aug, k_aug2 = jax.random.split(key_u, 4)
        k_t, k_b = jax.random.split(k_sample)
        oldest = max(int(jr.total) - jr.capacity_t, 0)
        num_valid = int(jr.total) - (jcfg.n_step + 1) + 1 - oldest
        indices.append((to_torch(oldest + jax.random.randint(k_t, (batch,), 0, num_valid)),
                        to_torch(jax.random.randint(k_b, (batch,), 0, B))))
        target_eps.append(np.asarray(jax.random.normal(k_tnoise, (batch, ACT_DIM))))
        offsets.append(tuple(to_torch(jax.random.randint(k, (batch, 2), 0, 9))
                             for k in (k_aug, k_aug2)))
    stem = "ConvStem_0"
    ta = tnets.DDPGActor(net_in, ACT_DIM, (24, 16), pixel_obs=pixels, detach_stem=pixels,
                         compute_dtype=TBF)
    tc = tnets.DDPGCritic(net_in, ACT_DIM, (32, 24), pixel_obs=pixels, compute_dtype=TBF)
    ta.load_state_dict(params_from_flax(ap, stem))
    tc.load_state_dict(params_from_flax(cp, stem))
    state = tddpg.init_state(cfg, ta, tc, OBS_DIM)
    state, tm = tddpg.update(cfg, state, tr, None, indices, to_torch(np.stack(target_eps)),
                             aug_offsets=offsets if pixels else None)
    steps = jcfg.updates_per_iteration
    # with a shared encoder the actor's stem is a copy of the critic's, which
    # moves at the critic's rate
    actor_lr = cfg.critic_lr if pixels else cfg.actor_lr
    for ref_tree, before, module, lr in ((new.actor_params, ap, state.actor, actor_lr),
                                         (new.critic_params, cp, state.critic, cfg.critic_lr)):
        _hold(ref_tree, before, module, _reach(steps, lr), stem)
    for ref_tree, module, lr in ((new.target_actor_params, state.target_actor, actor_lr),
                                 (new.target_critic_params, state.target_critic, cfg.critic_lr)):
        err, share = _param_errs(ref_tree, module, stem)
        assert err <= _reach(steps, lr) and share <= PARAM_SHARE, (err, share)
    _metrics_close(jax.device_get(jm), tm)
    if pixels:  # the actor's stem follows the critic's, in float32
        for a, c in zip(state.actor.stem.parameters(), state.critic.stem.parameters()):
            assert torch.equal(a, c) and a.dtype == torch.float32
