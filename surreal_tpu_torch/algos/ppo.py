"""PPO: rollout + GAE + clipped-surrogate / adaptive-KL update (port of
surreal_tpu/algos/ppo.py).

The reference jits one fused function over pure state; here the same steps
run eagerly and the train state is updated in place (the network's
parameters, the Adam moments): `update` and `train_step` return the same
state object they were given.

Randomness comes from explicit `torch.Generator`s. The reference's threefry
streams cannot be reproduced, so `rollout` accepts pre-drawn action noise
and `update` pre-drawn permutations; tests feed the reference's draws.

`update` and the steps take `axis`, a mesh (`parallel.mesh`), where the
reference takes `axis_name`: they then reduce across the data ranks at the
reference's points, in its order (the advantages' mean and variance, each
minibatch's gradients, the KL that drives the adaptation, the Z-filter).
With `axis=None` they compute what the one-device path computes. Under
`zero_optimizer` with `zero_shards` > 1 the Adam moments are split over the
data ranks (`parallel.zero`); with `time_shards` > 1 the GAE scan is split
over the mesh's time axis (`parallel.tshard`); a network sharded over the
model axis (`parallel.tp`) completes its gradients and their norm over it.
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
from surreal_tpu_torch.ops.returns import gae, gae_delta_coef
from surreal_tpu_torch.parallel import tp
from surreal_tpu_torch.parallel.mesh import pmean, pmean_flat
from surreal_tpu_torch.parallel.param_sync import (
    ParamSyncState,
    param_sync_init,
    param_sync_refresh,
)
from surreal_tpu_torch.parallel.tshard import replicated_reverse_scan
from surreal_tpu_torch.parallel.zero import (
    ZeroAdamState,
    scale_by_zero_adam,
    uses_zero,
    zero_adam_init,
)
from surreal_tpu_torch.utils import guards
from surreal_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The reference's PPOConfig: same fields, same defaults. The trainers
    set `zero_shards` and `time_shards` from the mesh, as the reference's
    do."""

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
    opt_state: AdamState | ZeroAdamState
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
        opt_state=zero_adam_init(net, cfg.zero_shards) if uses_zero(cfg) else adam_init(net),
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


def clip_by_global_norm(grads: dict[str, Tensor], max_norm: float,
                        g_norm: Tensor | None = None) -> dict[str, Tensor]:
    """`g_norm`, if given, is the gradients' global norm (a sharded
    network's counts each element once over the model axis)."""
    if g_norm is None:
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
            generator: torch.Generator, noise: Tensor | None = None,
            rows: tuple[int, int, int] | None = None):
    """Collects T steps from B lockstep envs. `noise` (T, B, A), if given,
    replaces the standard-normal action noise drawn from `generator`;
    `rows` (lo, hi, total) draws it for a whole batch of `total` envs and
    keeps rows lo:hi, these envs' (the tensor-parallel step's slice of a
    one-device batch). Returns (traj, env_state, obs, ep_ret, episode
    stats)."""
    net = acting_params(cfg, state)
    done_sum = torch.zeros_like(ep_ret)
    done_ret = torch.zeros_like(ep_ret)
    cols: dict[str, list] = {f.name: [] for f in dataclasses.fields(Trajectory)
                             if f.name != "next_value"}
    term_values = []
    for t in range(cfg.horizon):
        with span("ppo.rollout.step"):
            with span("ppo.rollout.policy"):
                mean, log_std, value = net(_norm(cfg, state, obs))
                eps = None if noise is None else noise[t]
                if eps is None and rows is not None:
                    lo, hi, total = rows
                    eps = torch.randn((total,) + mean.shape[1:], generator=generator,
                                      device=mean.device, dtype=mean.dtype)[lo:hi]
                action = DiagGauss.sample(mean, log_std, eps, generator)
                log_prob = DiagGauss.log_prob(mean, log_std, action)
            env_state, ts = env.step(env_state, action, generator)
            # The bootstrap target at `done` is V(terminal obs); it is computed
            # only on steps where some env finished. The test costs one host
            # sync per step, accepted here.
            with span("ppo.rollout.done_check"):
                term_values.append(net(_norm(cfg, state, flatten_obs(ts.obs)))[2]
                                   if bool(ts.done.any()) else torch.zeros_like(value))
            for k, x in (("obs", obs), ("action", action), ("log_prob", log_prob),
                         ("mean", mean), ("log_std", log_std.expand_as(mean)),
                         ("value", value), ("reward", ts.reward), ("discount", ts.discount),
                         ("done", ts.done)):
                cols[k].append(x)
            ep_ret = ep_ret + ts.reward
            done_f = ts.done.to(ep_ret.dtype)
            done_sum = done_sum + done_f
            done_ret = done_ret + done_f * ep_ret
            ep_ret = ep_ret * (1.0 - done_f)
            obs = flatten_obs(ts.carry_obs)
    with span("ppo.rollout.finish"):
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
    return loss_of_outputs(cfg, mean, log_std, value, rest, kl_beta, ent_coef)


def loss_of_outputs(cfg: PPOConfig, mean: Tensor, log_std: Tensor, value: Tensor, rest,
                    kl_beta: Tensor, ent_coef: float):
    """The loss of the network's outputs on flat rows (N, ...): the fused
    kernels where `fused_loss_admits`, else `surrogate_loss`. `rest` is
    (action, logp_old, mean_old, log_std_old, adv, vtarg, v_old)."""
    if fused_loss_admits(cfg, mean.shape[0]):
        from surreal_tpu_torch.ops.ppo_loss_kernel import fused_clip_loss

        return fused_clip_loss(
            mean, log_std, value, *rest, clip_eps=cfg.clip_eps,
            value_coef=cfg.value_coef, entropy_coef=cfg.entropy_coef,
        )
    return surrogate_loss(cfg, mean, log_std, value, rest, kl_beta, ent_coef)


def adam_direction(grads: dict[str, Tensor], opt: AdamState | ZeroAdamState, axis,
                   eps: float) -> dict[str, Tensor]:
    """Adam's direction from the clipped gradients: ZeRO's over `axis`'s
    data ranks for a ZeroAdamState, the replicated one otherwise."""
    if isinstance(opt, ZeroAdamState):
        return scale_by_zero_adam(grads, opt, axis, eps=eps)
    return scale_by_adam(grads, opt, eps=eps)


def apply_gradients(cfg: PPOConfig, state: PPOTrainState, loss: Tensor, lr: Tensor,
                    axis=None) -> Tensor:
    """One optimizer step on `loss`: the gradients averaged across `axis`'s
    data ranks (one flat all-reduce), completed over the model axis for a
    sharded network (`parallel.tp`), global-norm clip, Adam (ZeRO's under
    a ZeroAdamState), the step scaled by `lr` (cfg.lr · lr_scale); the
    network's parameters move in place. Returns the averaged gradient's
    norm."""
    names, params = zip(*state.net.named_parameters())
    with span("ppo.update.backward"):
        grads = torch.autograd.grad(loss, params)
        with span("ppo.update.allreduce"):
            grads = dict(zip(names, pmean_flat(grads, axis)))
    sharded = tp.sharding_of(state.net)
    with torch.no_grad(), span("ppo.update.optimizer"):
        if sharded is None:
            g_norm = global_norm(grads.values())
        else:
            grads = sharded.complete_grads(grads)
            g_norm = sharded.global_norm(grads)
        guards.assert_finite(g_norm, "ppo.update.grad_norm")
        updates = adam_direction(clip_by_global_norm(grads, cfg.max_grad_norm, g_norm),
                                 state.opt_state, axis, 1e-5)
        for n, p in zip(names, params):
            p.add_(lr * (-1.0 * updates[n]))
        return g_norm


def finish_update(cfg: PPOConfig, state: PPOTrainState, raw_obs: Tensor, metrics: dict,
                  axis=None) -> None:
    """What follows the epochs: the KL-triggered adaptation on the last
    minibatch's KL (its mean across `axis`'s ranks, so every rank decides
    alike), the Z-filter update from the rollout's raw observations, the
    step count and the publish-to-actors cadence."""
    with span("ppo.update.finish"):
        kl = pmean(metrics["kl"], axis)
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
            state.zfilter = zfilter_update(state.zfilter, raw_obs, axis)
        state.update_step += 1
        if cfg.publish_every > 1:
            param_sync_refresh(state.psync, state.net, state.update_step, cfg.publish_every)
        metrics["lr_scale"] = state.lr_scale
        metrics["kl_beta"] = state.kl_beta


def normalize_advantages(adv: Tensor, axis=None) -> Tensor:
    """(adv − mean) / std over the whole batch: across `axis`'s ranks, the
    mean of the local means, then the mean of the local mean squared
    deviations from it."""
    a_mean = pmean(torch.mean(adv), axis)
    a_var = pmean(torch.mean((adv - a_mean) ** 2), axis)
    return (adv - a_mean) * torch.rsqrt(a_var + 1e-8)


def update(cfg: PPOConfig, state: PPOTrainState, traj: Trajectory,
           generator: torch.Generator, perms: Tensor | None = None, axis=None):
    """K epochs of minibatched SGD on the rollout chunk; updates `state` in
    place. `perms` (epochs, T·B), if given, replaces the per-epoch random
    permutations drawn from `generator`. With `axis`, the chunk is this
    rank's share of the batch. Returns (state, metrics)."""
    T, B = traj.reward.shape
    net = state.net
    with torch.no_grad(), span("ppo.update.advantages"):
        obs = _norm(cfg, state, traj.obs)
        if cfg.time_shards > 1:  # GAE with its reverse scan split over the time axis
            adv = replicated_reverse_scan(*gae_delta_coef(
                traj.reward, traj.value, traj.next_value, traj.discount, traj.done, cfg.gamma,
                cfg.lam), axis)
            vtarg = adv + traj.value
        else:
            adv, vtarg = gae(traj.reward, traj.value, traj.next_value, traj.discount,
                             traj.done, cfg.gamma, cfg.lam)
        if cfg.normalize_adv:
            adv = normalize_advantages(adv, axis)
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
            with span("ppo.update.minibatch"):
                with span("ppo.update.loss"):
                    mb = tuple(x[idx] for x in flat)
                    loss, metrics = _loss_fn(cfg, net, mb, state.kl_beta, ent_coef)
                metrics["grad_norm"] = apply_gradients(cfg, state, loss, lr, axis)
    finish_update(cfg, state, traj.obs, metrics, axis)
    return state, metrics


def train_step(cfg: PPOConfig, env: Environment, flatten_obs: Callable,
               state: PPOTrainState, env_state: EnvState, obs: Tensor, ep_ret: Tensor,
               generator: torch.Generator, noise: Tensor | None = None,
               perms: Tensor | None = None, axis=None):
    """rollout + update. Returns (state, env_state, obs, ep_ret, metrics)."""
    traj, env_state, obs, ep_ret, ep_stats = rollout(
        cfg, env, flatten_obs, state, env_state, obs, ep_ret, generator, noise)
    state, metrics = update(cfg, state, traj, generator, perms, axis)
    metrics.update(ep_stats)
    metrics["reward_per_step"] = torch.mean(traj.reward)
    return state, env_state, obs, ep_ret, metrics


def train_step_overlapped(cfg: PPOConfig, env: Environment, flatten_obs: Callable,
                          state: PPOTrainState, env_state: EnvState, obs: Tensor,
                          ep_ret: Tensor, pending: Trajectory, generator: torch.Generator,
                          noise: Tensor | None = None, perms: Tensor | None = None,
                          axis=None):
    """The double-buffered step: iteration k collects trajectory k with the
    pre-update parameters (through `acting_params`, so `publish_every`
    composes) and updates on `pending`, trajectory k-1: an actor/learner
    staleness of one update, as the reference's actors always ran one
    publish behind. The generator's draws come in the reference's key
    order, the rollout's, then the update's. The rollout is done reading
    the parameters before the update writes them in place: both halves stay
    on one stream, in this order. `metrics["reward_per_step"]` is
    `pending`'s; the episode statistics are the new rollout's. Returns
    (state, env_state, obs, ep_ret, traj, metrics): `traj` is the next
    call's `pending`."""
    traj, env_state, obs, ep_ret, ep_stats = rollout(
        cfg, env, flatten_obs, state, env_state, obs, ep_ret, generator, noise)
    state, metrics = update(cfg, state, pending, generator, perms, axis)
    metrics.update(ep_stats)
    metrics["reward_per_step"] = torch.mean(pending.reward)
    return state, env_state, obs, ep_ret, traj, metrics
