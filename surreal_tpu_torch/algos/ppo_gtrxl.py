"""PPO with a GTrXL policy (`models/gtrxl.py`), on one device: a port-only
algorithm, shaped as `ppo_lstm` is.

The rollout carries the torso's ring of the last m layer inputs of every
env (`GTrXLCarry`: the ring, each slot's validity for its env's episode, the
shared clock). At the rollout's start the keys and values of the whole ring
are rebuilt under the acting weights (`prefill`); each step then decodes one
position against them and writes its own into the ring. Where an env
finished, the terminal value is probed at the next time on the memory as it
stood before the reset, and the probe's writes are dropped. An episode's
end leaves the ring as it is and marks the env's slots invalid.

The trajectory stores the ring and its validity as they stood at the
chunk's start; the update recomputes each env's whole chunk over them under
the current weights (`GTrXL.segment`, causal and masked), with minibatches of
whole env sequences. The loss goes through PPO's own gate
(`ppo.loss_of_outputs`: the fused kernels where they apply), and the step
through `ppo.apply_gradients`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from surreal_tpu_torch.algos.ppo import (
    PPOConfig,
    PPOTrainState,
    _norm,
    acting_params,
    apply_gradients,
    entropy_coef_at,
    finish_update,
    loss_of_outputs,
    normalize_advantages,
)
from surreal_tpu_torch.envs.base import EnvState, Environment
from surreal_tpu_torch.models.distributions import DiagGauss
from surreal_tpu_torch.ops.returns import gae
from surreal_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


@dataclasses.dataclass
class GTrXLCarry:
    """memory (L, B, m, d): each layer's inputs of the last m steps, ring
    slot t % m for time t; valid (B, m) bool: the slot holds a step of the
    env's current episode; t: the steps taken (the lockstep envs' clock)."""

    memory: Tensor
    valid: Tensor
    t: int

    def to_dict(self) -> dict:
        return {"memory": self.memory, "valid": self.valid, "t": self.t}

    @classmethod
    def from_dict(cls, d: dict) -> "GTrXLCarry":
        return cls(memory=d["memory"], valid=d["valid"], t=int(d["t"]))


def initial_carry(net, batch: int, device=None) -> GTrXLCarry:
    """An empty memory: no slot valid, the clock at 0."""
    memory = net.gtrxl.empty_memory(batch, device)
    return GTrXLCarry(memory=memory,
                      valid=torch.zeros(batch, net.gtrxl.memory, dtype=torch.bool,
                                        device=device), t=0)


@dataclasses.dataclass
class GTrXLTrajectory:
    obs: Tensor  # (T, B, D) raw
    action: Tensor
    log_prob: Tensor
    mean: Tensor
    log_std: Tensor
    value: Tensor
    next_value: Tensor
    reward: Tensor
    discount: Tensor
    done: Tensor
    memory: Tensor  # (L, B, m, d): the ring at the chunk's start
    valid: Tensor  # (B, m): its validity then
    t0: int  # the clock then


def act(net, x: Tensor, cache, t: int, valid: Tensor, write: bool = True):
    """(mean, log_std, value) of one position a env at time t."""
    return net.heads(net.gtrxl.step(x, cache, t, valid, write))


@torch.no_grad()
def rollout(cfg: PPOConfig, env: Environment, flatten_obs: Callable, state: PPOTrainState,
            env_state: EnvState, obs: Tensor, carry: GTrXLCarry, ep_ret: Tensor,
            generator: torch.Generator, noise: Tensor | None = None):
    """Collects T steps from B lockstep envs, the memory threaded through.
    `noise` (T, B, A), if given, replaces the standard-normal action noise
    drawn from `generator`. The ring of `carry` is written in place. Returns
    (traj, env_state, obs, carry, ep_ret, episode stats)."""
    net = acting_params(cfg, state)
    m = net.gtrxl.memory
    start_memory, start_valid, t0 = carry.memory.clone(), carry.valid.clone(), carry.t
    cache = net.gtrxl.prefill(carry.memory)
    valid, t = carry.valid.clone(), carry.t
    done_sum = torch.zeros_like(ep_ret)
    done_ret = torch.zeros_like(ep_ret)
    names = ("obs", "action", "log_prob", "mean", "log_std", "value", "reward", "discount",
             "done")
    cols: dict[str, list] = {k: [] for k in names}
    term_values = []
    for s in range(cfg.horizon):
        with span("ppo.rollout.step"):
            with span("ppo.rollout.policy"):
                mean, log_std, value = act(net, _norm(cfg, state, obs), cache, t, valid)
                action = DiagGauss.sample(mean, log_std, None if noise is None else noise[s],
                                          generator)
                log_prob = DiagGauss.log_prob(mean, log_std, action)
            valid[:, t % m] = True
            env_state, ts = env.step(env_state, action, generator)
            # The terminal value: a probe at the next time on the terminal
            # observation, over the memory before the reset; its writes are
            # dropped. Paid only where some env finished (one host sync a
            # step, as in `ppo.rollout`).
            with span("ppo.rollout.done_check"):
                term_values.append(
                    act(net, _norm(cfg, state, flatten_obs(ts.obs)), cache, t + 1, valid,
                        write=False)[2]
                    if bool(ts.done.any()) else torch.zeros_like(value))
            for k, x in (("obs", obs), ("action", action), ("log_prob", log_prob),
                         ("mean", mean), ("log_std", log_std.expand_as(mean)),
                         ("value", value), ("reward", ts.reward), ("discount", ts.discount),
                         ("done", ts.done)):
                cols[k].append(x)
            valid &= ~ts.done[:, None]
            t += 1
            ep_ret = ep_ret + ts.reward
            done_f = ts.done.to(ep_ret.dtype)
            done_sum = done_sum + done_f
            done_ret = done_ret + done_f * ep_ret
            ep_ret = ep_ret * (1.0 - done_f)
            obs = flatten_obs(ts.carry_obs)
    with span("ppo.rollout.finish"):
        tr = {k: torch.stack(v) for k, v in cols.items()}
        v_last = act(net, _norm(cfg, state, obs), cache, t, valid, write=False)[2]
        next_value = torch.cat([tr["value"][1:], v_last[None]], 0)
        next_value = torch.where(tr["done"], torch.stack(term_values), next_value)
        traj = GTrXLTrajectory(next_value=next_value, memory=start_memory, valid=start_valid,
                               t0=t0, **tr)
    stats = {"episodes_done": done_sum.sum(), "episode_return_sum": done_ret.sum()}
    return traj, env_state, obs, GTrXLCarry(cache.memory, valid, t), ep_ret, stats


def sequence_outputs(net, obs_n: Tensor, traj: GTrXLTrajectory, idx: Tensor):
    """The envs `idx`'s chunks recomputed over their chunk-start memory:
    (mean (T, b, A), log_std (A,), value (T, b))."""
    h = net.gtrxl.segment(obs_n[:, idx], traj.memory[:, idx], traj.valid[idx],
                          traj.done[:, idx], traj.t0)
    return net.heads(h)


def update(cfg: PPOConfig, state: PPOTrainState, traj: GTrXLTrajectory,
           generator: torch.Generator, perms: Tensor | None = None):
    """K epochs of SGD over minibatches of whole env sequences; updates
    `state` in place. `perms` (epochs, B), if given, replaces the per-epoch
    random permutations of the envs drawn from `generator`. Returns (state,
    metrics), the metrics of the last minibatch of the last epoch."""
    T, B = traj.reward.shape
    net = state.net
    with torch.no_grad(), span("ppo.update.advantages"):
        obs = _norm(cfg, state, traj.obs)
        adv, vtarg = gae(traj.reward, traj.value, traj.next_value, traj.discount, traj.done,
                         cfg.gamma, cfg.lam)
        if cfg.normalize_adv:
            adv = normalize_advantages(adv)
    mb_envs = B // cfg.num_minibatches
    ent_coef = entropy_coef_at(cfg, state.update_step)
    lr = cfg.lr * state.lr_scale
    metrics = {}
    for e in range(cfg.epochs):
        perm = perms[e] if perms is not None else torch.randperm(
            B, generator=generator, device=generator.device)
        idxs = perm[: mb_envs * cfg.num_minibatches].reshape(cfg.num_minibatches, mb_envs)
        for idx in idxs:
            with span("ppo.update.minibatch"):
                with span("ppo.update.loss"):
                    mean, log_std, value = sequence_outputs(net, obs, traj, idx)
                    n = mean.shape[0] * mean.shape[1]
                    rest = tuple(x[:, idx].reshape(n, *x.shape[2:]) for x in (
                        traj.action, traj.log_prob, traj.mean, traj.log_std, adv, vtarg,
                        traj.value))
                    loss, metrics = loss_of_outputs(cfg, mean.reshape(n, -1), log_std,
                                                    value.reshape(n), rest, state.kl_beta,
                                                    ent_coef)
                metrics["grad_norm"] = apply_gradients(cfg, state, loss, lr)
    finish_update(cfg, state, traj.obs, metrics)
    return state, metrics


def train_step(cfg: PPOConfig, env: Environment, flatten_obs: Callable, state: PPOTrainState,
               env_state: EnvState, obs: Tensor, carry: GTrXLCarry, ep_ret: Tensor,
               generator: torch.Generator, noise: Tensor | None = None,
               perms: Tensor | None = None):
    """rollout + update. Returns (state, env_state, obs, carry, ep_ret, metrics)."""
    traj, env_state, obs, carry, ep_ret, ep_stats = rollout(
        cfg, env, flatten_obs, state, env_state, obs, carry, ep_ret, generator, noise)
    state, metrics = update(cfg, state, traj, generator, perms)
    metrics.update(ep_stats)
    metrics["reward_per_step"] = torch.mean(traj.reward)
    return state, env_state, obs, carry, ep_ret, metrics
