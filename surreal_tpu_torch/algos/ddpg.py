"""DDPG: off-policy TD learning with uniform on-device replay and target
networks (port of surreal_tpu/algos/ddpg.py, single device, vector
observations).

A deterministic tanh actor explores with Ornstein-Uhlenbeck or Gaussian
noise, scaled per env by a ladder so the lockstep envs explore at different
intensities; the critic learns n-step TD targets through target actor and
critic; targets follow softly (tau) or by periodic hard copies.

As in `algos/ppo.py`, the steps run eagerly and the train state (the four
networks, the two Adam states) is updated in place. `rollout` accepts the
pre-drawn noise `eps` and `update` pre-drawn replay indices and
target-smoothing noise; tests feed the reference's draws.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.algos.ppo import (
    AdamState,
    adam_init,
    clip_by_global_norm,
    scale_by_adam,
)
from surreal_tpu_torch.data.replay import (
    ReplayState,
    replay_init,
    replay_insert,
    replay_sample_nstep,
)
from surreal_tpu_torch.envs.base import EnvState, Environment
from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic
from surreal_tpu_torch.models.z_filter import (
    ZFilterState,
    zfilter_init,
    zfilter_normalize,
    zfilter_update,
)
from surreal_tpu_torch.ops.returns import nstep_returns
from surreal_tpu_torch.parallel.param_sync import (
    ParamSyncState,
    param_sync_init,
    param_sync_refresh,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """The reference's DDPGConfig: same fields, same defaults. The pixel
    knobs (`shared_encoder`, `aug_shift`) and the sharded optimizer must keep
    their off values."""

    rollout_steps: int = 16  # env steps per train iteration
    updates_per_iteration: int = 16
    batch_size: int = 256
    replay_capacity: int = 1_000_000  # total transitions (across envs)
    min_replay: int = 10_000  # warmup transitions before updates
    gamma: float = 0.99
    n_step: int = 3
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    tau: float = 5e-3  # soft target update rate
    hard_sync_every: int = 0  # if > 0, hard-copy targets every N updates instead
    max_grad_norm: float = 10.0
    use_zfilter: bool = False
    noise_type: str = "ou"  # 'ou' | 'gaussian'
    ou_theta: float = 0.15
    ou_dt: float = 1.0  # noise step in units of control steps
    sigma_min: float = 0.05
    sigma_max: float = 0.4
    # TD3-style stabilizers, off by default: target_noise > 0 smooths the
    # bootstrap target action with clipped Gaussian noise; actor_delay > 1
    # updates the actor (and the targets) every N critic steps.
    target_noise: float = 0.0
    target_noise_clip: float = 0.5
    actor_delay: int = 1
    shared_encoder: bool = False
    aug_shift: int = 0
    # Rollouts act on a snapshot of the actor refreshed every K updates
    # (as PPOConfig.publish_every). 1 = no staleness.
    publish_every: int = 1
    zero_optimizer: bool = False
    zero_shards: int = 1

    def __post_init__(self):
        if self.shared_encoder or self.aug_shift > 0:
            raise NotImplementedError(
                "shared_encoder and aug_shift are pixel-mode knobs, which come with the "
                "pixel observations (ROADMAP.md, Queue A)")
        if self.zero_optimizer or self.zero_shards != 1:
            raise NotImplementedError(
                "zero_optimizer is a multi-device feature that is not ported yet "
                "(ROADMAP.md, Queue A)")
        if self.noise_type not in ("ou", "gaussian"):
            raise ValueError(f"unknown noise_type {self.noise_type!r}")


@dataclasses.dataclass
class DDPGTrainState:
    actor: DDPGActor
    critic: DDPGCritic
    target_actor: DDPGActor
    target_critic: DDPGCritic
    actor_opt: AdamState
    critic_opt: AdamState
    zfilter: ZFilterState
    update_step: int
    # Snapshot of the actor when cfg.publish_every > 1, else None.
    psync: ParamSyncState | None = None


def init_state(cfg: DDPGConfig, actor: DDPGActor, critic: DDPGCritic,
               obs_dim: int) -> DDPGTrainState:
    device = next(actor.parameters()).device
    return DDPGTrainState(
        actor=actor,
        critic=critic,
        target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=adam_init(actor),
        critic_opt=adam_init(critic),
        zfilter=zfilter_init(obs_dim, device),
        update_step=0,
        psync=param_sync_init(actor) if cfg.publish_every > 1 else None,
    )


def acting_params(cfg: DDPGConfig, state: DDPGTrainState) -> DDPGActor:
    """The actor the rollout side uses (the published snapshot under staleness)."""
    return state.psync.actor_params if cfg.publish_every > 1 else state.actor


def noise_ladder(cfg: DDPGConfig, num_envs: int) -> np.ndarray:
    """Per-env exploration scale, a geometric ladder from sigma_min to sigma_max."""
    return np.geomspace(cfg.sigma_min, cfg.sigma_max, num_envs).astype(np.float32)


def init_replay(cfg: DDPGConfig, num_envs: int, obs_dim: int, action_dim: int,
                device: torch.device | str) -> ReplayState:
    """The ring on `device`: replay_capacity transitions across the envs,
    and never fewer steps than one rollout chunk."""
    capacity_t = max(cfg.replay_capacity // num_envs, cfg.rollout_steps)
    example = {
        "obs": torch.zeros(num_envs, obs_dim, device=device),
        "action": torch.zeros(num_envs, action_dim, device=device),
        "reward": torch.zeros(num_envs, device=device),
        "done": torch.zeros(num_envs, dtype=torch.bool, device=device),
    }
    return replay_init(example, capacity_t)


def _norm(cfg: DDPGConfig, state: DDPGTrainState, obs: Tensor) -> Tensor:
    return zfilter_normalize(state.zfilter, obs) if cfg.use_zfilter else obs


# ---------------------------------------------------------------------------
# Rollout (exploration actors)
# ---------------------------------------------------------------------------


@torch.no_grad()
def rollout(cfg: DDPGConfig, env: Environment, flatten_obs: Callable, state: DDPGTrainState,
            env_state: EnvState, obs: Tensor, ou_state: Tensor, sigma: Tensor, ep_ret: Tensor,
            generator: torch.Generator, replay: ReplayState, eps: Tensor | None = None):
    """Steps the B lockstep envs `rollout_steps` times with the noisy actor
    and inserts the chunk into `replay`. `ou_state` (B, A) is the persistent
    OU noise, `sigma` (B,) the per-env scale; `eps` (T, B, A), if given,
    replaces the standard-normal draws from `generator`. Returns (replay,
    env_state, obs, ou_state, ep_ret, chunk, episode stats)."""
    actor = acting_params(cfg, state)
    done_sum = torch.zeros_like(ep_ret)
    done_ret = torch.zeros_like(ep_ret)
    cols: dict[str, list] = {"obs": [], "action": [], "reward": [], "done": []}
    for t in range(cfg.rollout_steps):
        a_det = actor(_norm(cfg, state, obs))
        eps_t = eps[t] if eps is not None else torch.randn(
            a_det.shape, generator=generator, device=a_det.device, dtype=a_det.dtype)
        if cfg.noise_type == "ou":
            ou_state = (ou_state + cfg.ou_theta * (0.0 - ou_state) * cfg.ou_dt
                        + sigma[:, None] * math.sqrt(cfg.ou_dt) * eps_t)
            noise = ou_state
        else:
            noise = sigma[:, None] * eps_t
        action = torch.clamp(a_det + noise, -1.0, 1.0)
        env_state, ts = env.step(env_state, action, generator)
        for k, x in (("obs", obs), ("action", action), ("reward", ts.reward), ("done", ts.done)):
            cols[k].append(x)
        done_f = ts.done.to(ep_ret.dtype)
        # the OU state restarts at episode boundaries (a fresh exploration process)
        ou_state = ou_state * (1.0 - done_f)[:, None]
        new_ep = ep_ret + ts.reward
        done_sum = done_sum + done_f
        done_ret = done_ret + done_f * new_ep
        ep_ret = new_ep * (1.0 - done_f)
        obs = flatten_obs(ts.carry_obs)
    chunk = {k: torch.stack(v) for k, v in cols.items()}
    replay = replay_insert(replay, chunk)
    stats = {"episodes_done": done_sum.sum(), "episode_return_sum": done_ret.sum()}
    return replay, env_state, obs, ou_state, ep_ret, chunk, stats


# ---------------------------------------------------------------------------
# Update (learner)
# ---------------------------------------------------------------------------


def _adam_step(module: torch.nn.Module, loss: Tensor, opt: AdamState, lr: float,
               max_grad_norm: float) -> None:
    """optax.chain(clip_by_global_norm, scale_by_adam(), scale(-lr)) on the
    module's parameters, in place: optax's default eps of 1e-8, not PPO's
    1e-5. The gradient is taken with respect to this module's parameters
    only, so a loss that runs through another network leaves it alone."""
    names, params = zip(*module.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    with torch.no_grad():
        updates = scale_by_adam(clip_by_global_norm(grads, max_grad_norm), opt, eps=1e-8)
        for n, p in zip(names, params):
            p.add_(-lr * updates[n])


def update(cfg: DDPGConfig, state: DDPGTrainState, replay: ReplayState,
           generator: torch.Generator | None, indices=None, target_eps: Tensor | None = None):
    """`updates_per_iteration` critic and actor steps on batches sampled from
    `replay`; updates `state` in place. `indices`, if given, is one (a, b)
    pair of replay index tensors per update, and `target_eps` (U, batch, A)
    the standard-normal draws of the target smoothing: they replace the draws
    from `generator`. Returns (state, metrics of the last update)."""
    metrics = {}
    for u in range(cfg.updates_per_iteration):
        with torch.no_grad():
            w = replay_sample_nstep(replay, generator, cfg.batch_size, cfg.n_step,
                                    index=None if indices is None else indices[u])
            obs = _norm(cfg, state, w["obs"][0])
            action = w["action"][0]
            next_obs = _norm(cfg, state, w["obs"][-1])
            G, cont = nstep_returns(w["reward"][:-1], w["done"][:-1], cfg.gamma)
            next_a = state.target_actor(next_obs)
            if cfg.target_noise > 0:  # TD3 target-policy smoothing
                e = target_eps[u] if target_eps is not None else torch.randn(
                    next_a.shape, generator=generator, device=next_a.device)
                e = torch.clamp(cfg.target_noise * e, -cfg.target_noise_clip,
                                cfg.target_noise_clip)
                next_a = torch.clamp(next_a + e, -1.0, 1.0)
            y = G + cont * state.target_critic(next_obs, next_a)

        q = state.critic(obs, action)
        c_loss = torch.mean((q - y) ** 2)
        _adam_step(state.critic, c_loss, state.critic_opt, cfg.critic_lr, cfg.max_grad_norm)

        step_no = state.update_step + 1
        # TD3's delayed actor: on the other steps the actor's parameters and
        # its Adam state (count and moments) stay as they are, and so do the
        # targets; the loss is still reported
        do_actor = cfg.actor_delay <= 1 or step_no % cfg.actor_delay == 0
        with torch.set_grad_enabled(do_actor):
            # the actor's loss runs through the critic as just updated
            a_loss = -torch.mean(state.critic(obs, state.actor(obs)))
        if do_actor:
            _adam_step(state.actor, a_loss, state.actor_opt, cfg.actor_lr, cfg.max_grad_norm)
            hard = cfg.hard_sync_every > 0
            if not hard or step_no % cfg.hard_sync_every == 0:
                with torch.no_grad():
                    for target, live in ((state.target_actor, state.actor),
                                         (state.target_critic, state.critic)):
                        for t, s in zip(target.parameters(), live.parameters()):
                            t.copy_(s if hard else t + cfg.tau * (s - t))
        state.update_step = step_no
        metrics = {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
                   "q_mean": torch.mean(q.detach())}
    return state, metrics


def train_step(cfg: DDPGConfig, env: Environment, flatten_obs: Callable, state: DDPGTrainState,
               replay: ReplayState, env_state: EnvState, obs: Tensor, ou_state: Tensor,
               sigma: Tensor, ep_ret: Tensor, generator: torch.Generator,
               eps: Tensor | None = None, indices=None, target_eps: Tensor | None = None):
    """One iteration: `rollout_steps` env steps, then the updates once the
    replay holds `min_replay` transitions (zero metrics before that).
    Returns (state, replay, env_state, obs, ou_state, ep_ret, metrics)."""
    replay, env_state, obs, ou_state, ep_ret, chunk, ep_stats = rollout(
        cfg, env, flatten_obs, state, env_state, obs, ou_state, sigma, ep_ret, generator,
        replay, eps)
    if cfg.use_zfilter:
        state.zfilter = zfilter_update(state.zfilter, chunk["obs"])
    if replay.total * replay.num_envs >= cfg.min_replay:
        state, metrics = update(cfg, state, replay, generator, indices, target_eps)
    else:
        zero = torch.zeros((), device=obs.device)
        metrics = {"critic_loss": zero, "actor_loss": zero, "q_mean": zero}
    if cfg.publish_every > 1:
        param_sync_refresh(state.psync, state.actor, state.update_step, cfg.publish_every)
    metrics.update(ep_stats)
    return state, replay, env_state, obs, ou_state, ep_ret, metrics
