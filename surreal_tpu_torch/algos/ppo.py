"""PPO: rollout + GAE + clipped-surrogate / adaptive-KL update (port of
surreal_tpu/algos/ppo.py, single device).

The reference jits one fused function over pure state; here the same steps
run eagerly and the train state is updated in place (the network's
parameters, the Adam moments): `update` and `train_step` return the same
state object they were given.

Randomness comes from explicit `torch.Generator`s. The reference's threefry
streams cannot be reproduced, so `rollout` accepts pre-drawn action noise
and `update` pre-drawn permutations; tests feed the reference's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.envs.base import EnvState, Environment
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.distributions import DiagGauss
from surreal_tpu_torch.models.z_filter import (
    ZFilterState,
    zfilter_init,
    zfilter_normalize,
    zfilter_update,
)
from surreal_tpu_torch.ops.returns import gae
from surreal_tpu_torch.parallel.param_sync import (
    ParamSyncState,
    param_sync_init,
    param_sync_refresh,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The reference's PPOConfig: same fields, same defaults. The port runs
    one device, so `zero_optimizer`/`zero_shards` and `time_shards` must
    keep their single-device values."""

    horizon: int = 128
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    epochs: int = 4
    num_minibatches: int = 4
    lr: float = 3e-4
    entropy_coef: float = 0.0
    entropy_final: float | None = None
    entropy_anneal_iters: int = 0
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    normalize_adv: bool = True
    use_zfilter: bool = True
    objective: str = "clip"  # 'clip' | 'adaptive_kl'
    kl_target: float = 0.01
    kl_beta_init: float = 1.0
    adapt_lr: bool = True
    lr_adapt_factor: float = 1.5
    lr_min_scale: float = 0.01
    lr_max_scale: float = 10.0
    fused_loss: bool = False  # CUDA fused loss kernel (ops/ppo_loss_kernel.py)
    publish_every: int = 1
    zero_optimizer: bool = False
    zero_shards: int = 1
    time_shards: int = 1

    def __post_init__(self):
        if self.time_shards != 1 or self.zero_shards != 1:
            raise NotImplementedError(
                "time_shards and zero_shards > 1 are multi-device features that "
                "are not ported yet (ROADMAP.md, Queue A)"
            )
        if self.objective not in ("clip", "adaptive_kl"):
            raise ValueError(f"unknown objective {self.objective!r}")


@dataclasses.dataclass
class AdamState:
    """optax.scale_by_adam state: step count and per-parameter moments."""

    count: int
    mu: dict[str, Tensor]
    nu: dict[str, Tensor]


@dataclasses.dataclass
class PPOTrainState:
    net: PPOActorCritic  # holds the parameters
    opt_state: AdamState
    zfilter: ZFilterState
    kl_beta: Tensor  # () f32, adaptive-KL penalty coefficient
    lr_scale: Tensor  # () f32, KL-adaptive LR multiplier
    update_step: int
    # Snapshot of the network the rollouts act on when cfg.publish_every > 1,
    # else None (the rollouts act on `net` itself: no staleness).
    psync: ParamSyncState | None = None


@dataclasses.dataclass
class Trajectory:
    """One rollout chunk, time-major (T, B, ...); obs stored raw."""

    obs: Tensor
    action: Tensor
    log_prob: Tensor
    mean: Tensor
    log_std: Tensor
    value: Tensor
    next_value: Tensor
    reward: Tensor
    discount: Tensor
    done: Tensor


def adam_init(module: torch.nn.Module) -> AdamState:
    return AdamState(count=0,
                     mu={n: torch.zeros_like(p) for n, p in module.named_parameters()},
                     nu={n: torch.zeros_like(p) for n, p in module.named_parameters()})


def init_state(cfg: PPOConfig, net: PPOActorCritic, obs_dim: int) -> PPOTrainState:
    device = next(net.parameters()).device
    return PPOTrainState(
        net=net,
        opt_state=adam_init(net),
        zfilter=zfilter_init(obs_dim, device),
        kl_beta=torch.tensor(cfg.kl_beta_init, dtype=torch.float32, device=device),
        lr_scale=torch.tensor(1.0, dtype=torch.float32, device=device),
        update_step=0,
        psync=param_sync_init(net) if cfg.publish_every > 1 else None,
    )


def acting_params(cfg: PPOConfig, state: PPOTrainState) -> PPOActorCritic:
    """The network the actor side uses: the published snapshot under
    staleness (cfg.publish_every > 1), the live learner network otherwise."""
    return state.psync.actor_params if cfg.publish_every > 1 else state.net


# ---------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, scale_by_adam(eps=1e-5),
# scale(-1)) with lr·lr_scale applied by the caller, written out so the
# arithmetic follows optax (torch's clip_grad_norm_ adds 1e-6 to the norm).
# ---------------------------------------------------------------------------


def global_norm(tensors) -> Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: dict[str, Tensor], max_norm: float) -> dict[str, Tensor]:
    g_norm = global_norm(grads.values())
    trigger = g_norm < max_norm
    return {n: torch.where(trigger, g, (g / g_norm) * max_norm) for n, g in grads.items()}


def scale_by_adam(grads: dict[str, Tensor], state: AdamState, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-5) -> dict[str, Tensor]:
    """Returns the Adam direction and advances `state` in place."""
    state.count += 1
    # optax's bias corrections 1 - decay**count, evaluated in float32
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(state.count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(state.count))
    out = {}
    for n, g in grads.items():
        mu = (1 - b1) * g + b1 * state.mu[n]
        nu = (1 - b2) * (g * g) + b2 * state.nu[n]
        state.mu[n], state.nu[n] = mu, nu
        out[n] = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    return out


# ---------------------------------------------------------------------------
# Rollout
# ---------------------------------------------------------------------------


def _norm(cfg: PPOConfig, state: PPOTrainState, obs: Tensor) -> Tensor:
    return zfilter_normalize(state.zfilter, obs) if cfg.use_zfilter else obs


@torch.no_grad()
def rollout(cfg: PPOConfig, env: Environment, flatten_obs: Callable,
            state: PPOTrainState, env_state: EnvState, obs: Tensor, ep_ret: Tensor,
            generator: torch.Generator, noise: Tensor | None = None):
    """Collects T steps from B lockstep envs. `noise` (T, B, A), if given,
    replaces the standard-normal action noise drawn from `generator`.
    Returns (traj, env_state, obs, ep_ret, episode stats)."""
    net = acting_params(cfg, state)
    B = obs.shape[0]
    done_sum = obs.new_zeros(B)
    done_ret = obs.new_zeros(B)
    cols: dict[str, list] = {f.name: [] for f in dataclasses.fields(Trajectory)
                             if f.name != "next_value"}
    term_values = []
    for t in range(cfg.horizon):
        mean, log_std, value = net(_norm(cfg, state, obs))
        action = DiagGauss.sample(mean, log_std, None if noise is None else noise[t], generator)
        log_prob = DiagGauss.log_prob(mean, log_std, action)
        env_state, ts = env.step(env_state, action, generator)
        # The bootstrap target at `done` is V(terminal obs); it is computed
        # only on steps where some env finished. The test costs one host
        # sync per step, accepted here.
        term_values.append(net(_norm(cfg, state, flatten_obs(ts.obs)))[2]
                           if bool(ts.done.any()) else torch.zeros_like(value))
        for k, x in (("obs", obs), ("action", action), ("log_prob", log_prob), ("mean", mean),
                     ("log_std", log_std.expand_as(mean)), ("value", value),
                     ("reward", ts.reward), ("discount", ts.discount), ("done", ts.done)):
            cols[k].append(x)
        ep_ret = ep_ret + ts.reward
        done_f = ts.done.to(ep_ret.dtype)
        done_sum = done_sum + done_f
        done_ret = done_ret + done_f * ep_ret
        ep_ret = ep_ret * (1.0 - done_f)
        obs = flatten_obs(ts.carry_obs)
    tr = {k: torch.stack(v) for k, v in cols.items()}
    # next_value(t) = V(obs_{t+1}) except at done (the terminal value); one
    # chunk-end forward on the final carry obs closes the sequence.
    v_last = net(_norm(cfg, state, obs))[2]
    next_value = torch.cat([tr["value"][1:], v_last[None]], 0)
    next_value = torch.where(tr["done"], torch.stack(term_values), next_value)
    traj = Trajectory(next_value=next_value, **tr)
    stats = {"episodes_done": done_sum.sum(), "episode_return_sum": done_ret.sum()}
    return traj, env_state, obs, ep_ret, stats


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------


def entropy_coef_at(cfg: PPOConfig, update_step: int) -> float:
    """Entropy coefficient at `update_step` (linear anneal, or constant)."""
    base = cfg.entropy_coef
    if cfg.entropy_final is None or cfg.entropy_anneal_iters <= 0:
        return base
    frac = min(max(update_step / cfg.entropy_anneal_iters, 0.0), 1.0)
    return base + (cfg.entropy_final - base) * frac


def fused_loss_admits(cfg: PPOConfig, rows: int) -> bool:
    """The reference's gate for the fused loss kernel (ppo.py _loss_fn)."""
    return (cfg.fused_loss and cfg.objective == "clip"
            and cfg.entropy_final is None  # the kernel takes a static coef
            and rows % 256 == 0)


def surrogate_loss(cfg: PPOConfig, mean: Tensor, log_std: Tensor, value: Tensor, batch,
                   kl_beta: Tensor, ent_coef: float):
    """The PPO loss and its metrics from the network's outputs on a batch
    (action, logp_old, mean_old, log_std_old, adv, vtarg, v_old), whose
    leading axes are the outputs': (N,) rows, or (T, B) sequences."""
    action, logp_old, mean_old, log_std_old, adv, vtarg, v_old = batch
    logp = DiagGauss.log_prob(mean, log_std, action)
    # log-ratio clamp: keeps exp finite for a diverging policy
    ratio = torch.exp(torch.clamp(logp - logp_old, -20.0, 20.0))
    kl = torch.mean(DiagGauss.kl(mean_old, log_std_old, mean, log_std))
    if cfg.objective == "clip":
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        )
        policy_loss = -torch.mean(surr)
    else:  # adaptive_kl
        policy_loss = -torch.mean(ratio * adv) + kl_beta * kl
    v_clipped = v_old + torch.clamp(value - v_old, -cfg.clip_eps, cfg.clip_eps)
    value_loss = 0.5 * torch.mean(
        torch.maximum((value - vtarg) ** 2, (v_clipped - vtarg) ** 2)
    )
    entropy = torch.mean(DiagGauss.entropy(mean, log_std))
    loss = policy_loss + cfg.value_coef * value_loss - ent_coef * entropy
    clip_frac = torch.mean((torch.abs(ratio - 1.0) > cfg.clip_eps).to(torch.float32))
    return loss, {
        "policy_loss": policy_loss.detach(),
        "value_loss": value_loss.detach(),
        "entropy": entropy.detach(),
        "kl": kl.detach(),
        "clip_frac": clip_frac,
    }


def _loss_fn(cfg: PPOConfig, net: PPOActorCritic, batch, kl_beta: Tensor, ent_coef: float):
    obs, *rest = batch
    mean, log_std, value = net(obs)
    if fused_loss_admits(cfg, mean.shape[0]):
        from surreal_tpu_torch.ops.ppo_loss_kernel import fused_clip_loss

        return fused_clip_loss(
            mean, log_std, value, *rest, clip_eps=cfg.clip_eps,
            value_coef=cfg.value_coef, entropy_coef=cfg.entropy_coef,
        )
    return surrogate_loss(cfg, mean, log_std, value, rest, kl_beta, ent_coef)


def apply_gradients(cfg: PPOConfig, state: PPOTrainState, loss: Tensor, lr: Tensor) -> Tensor:
    """One optimizer step on `loss`: global-norm clip, Adam, the step scaled
    by `lr` (cfg.lr · lr_scale); the network's parameters move in place.
    Returns the gradient's norm."""
    names, params = zip(*state.net.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    with torch.no_grad():
        updates = scale_by_adam(clip_by_global_norm(grads, cfg.max_grad_norm), state.opt_state)
        for n, p in zip(names, params):
            p.add_(lr * (-1.0 * updates[n]))
        return global_norm(grads.values())


def finish_update(cfg: PPOConfig, state: PPOTrainState, raw_obs: Tensor, metrics: dict) -> None:
    """What follows the epochs: the KL-triggered adaptation on the last
    minibatch's KL, the Z-filter update from the rollout's raw observations,
    the step count and the publish-to-actors cadence."""
    kl = metrics["kl"]
    hi, lo = kl > 2.0 * cfg.kl_target, kl < cfg.kl_target / 2.0
    if cfg.objective == "adaptive_kl":
        state.kl_beta = torch.where(
            hi, state.kl_beta * cfg.lr_adapt_factor,
            torch.where(lo, state.kl_beta / cfg.lr_adapt_factor, state.kl_beta))
    if cfg.adapt_lr:
        lr_scale = torch.where(
            hi, state.lr_scale / cfg.lr_adapt_factor,
            torch.where(lo, state.lr_scale * cfg.lr_adapt_factor, state.lr_scale))
        state.lr_scale = torch.clamp(lr_scale, cfg.lr_min_scale, cfg.lr_max_scale)
    if cfg.use_zfilter:
        state.zfilter = zfilter_update(state.zfilter, raw_obs)
    state.update_step += 1
    if cfg.publish_every > 1:
        param_sync_refresh(state.psync, state.net, state.update_step, cfg.publish_every)
    metrics["lr_scale"] = state.lr_scale
    metrics["kl_beta"] = state.kl_beta


def update(cfg: PPOConfig, state: PPOTrainState, traj: Trajectory,
           generator: torch.Generator, perms: Tensor | None = None):
    """K epochs of minibatched SGD on the rollout chunk; updates `state` in
    place. `perms` (epochs, T·B), if given, replaces the per-epoch random
    permutations drawn from `generator`. Returns (state, metrics)."""
    T, B = traj.reward.shape
    net = state.net
    with torch.no_grad():
        obs = _norm(cfg, state, traj.obs)
        adv, vtarg = gae(traj.reward, traj.value, traj.next_value, traj.discount, traj.done,
                         cfg.gamma, cfg.lam)
        if cfg.normalize_adv:
            a_mean = torch.mean(adv)
            a_var = torch.mean((adv - a_mean) ** 2)
            adv = (adv - a_mean) * torch.rsqrt(a_var + 1e-8)
    N = T * B
    flat = (
        obs.reshape((N,) + obs.shape[2:]),
        traj.action.reshape(N, -1),
        traj.log_prob.reshape(N),
        traj.mean.reshape(N, -1),
        traj.log_std.reshape(N, -1),
        adv.reshape(N),
        vtarg.reshape(N),
        traj.value.reshape(N),
    )
    mb_size = N // cfg.num_minibatches
    ent_coef = entropy_coef_at(cfg, state.update_step)
    lr = cfg.lr * state.lr_scale
    metrics = {}
    for e in range(cfg.epochs):
        perm = perms[e] if perms is not None else torch.randperm(
            N, generator=generator, device=generator.device)
        idxs = perm[: mb_size * cfg.num_minibatches].reshape(cfg.num_minibatches, mb_size)
        for idx in idxs:
            mb = tuple(x[idx] for x in flat)
            loss, metrics = _loss_fn(cfg, net, mb, state.kl_beta, ent_coef)
            metrics["grad_norm"] = apply_gradients(cfg, state, loss, lr)
    finish_update(cfg, state, traj.obs, metrics)
    return state, metrics


def train_step(cfg: PPOConfig, env: Environment, flatten_obs: Callable,
               state: PPOTrainState, env_state: EnvState, obs: Tensor, ep_ret: Tensor,
               generator: torch.Generator, noise: Tensor | None = None,
               perms: Tensor | None = None):
    """rollout + update. Returns (state, env_state, obs, ep_ret, metrics)."""
    traj, env_state, obs, ep_ret, ep_stats = rollout(
        cfg, env, flatten_obs, state, env_state, obs, ep_ret, generator, noise)
    state, metrics = update(cfg, state, traj, generator, perms)
    metrics.update(ep_stats)
    metrics["reward_per_step"] = torch.mean(traj.reward)
    return state, env_state, obs, ep_ret, metrics
