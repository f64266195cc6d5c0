"""PPO with a recurrent (LSTM) policy: sub-trajectory chunk training (port
of surreal_tpu/algos/ppo_lstm.py).

The rollout carries the LSTM state across env steps and zeroes it at
episode boundaries; each chunk stores only its initial carry, and the
update recomputes the forward pass through time from it (truncated BPTT
over the chunk). Minibatches are taken over the env axis so sequences stay
whole.

Shares PPOConfig, PPOTrainState, the optimizer and the entropy schedule with
`algos/ppo.py`. As there, the steps run eagerly, the train state is updated
in place, `rollout` accepts pre-drawn action noise and `update` pre-drawn
permutations (of the envs here), and `axis` (a data mesh) reduces across
the ranks at the reference's points.
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
    normalize_advantages,
    surrogate_loss,
)
from surreal_tpu_torch.envs.base import EnvState, Environment
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.distributions import DiagGauss
from surreal_tpu_torch.ops.returns import gae

Tensor = torch.Tensor
Carry = tuple[Tensor, Tensor]  # (c, h), each (B, H)


@dataclasses.dataclass
class LSTMTrajectory:
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
    init_carry: Carry  # LSTM carry at chunk start


def _reset_carry(carry: Carry, done: Tensor) -> Carry:
    """Zeroes the carry rows where `done` (episode boundary)."""
    keep = (1.0 - done.to(torch.float32))[:, None]
    return tuple(c * keep.to(c.dtype) for c in carry)


@torch.no_grad()
def rollout(cfg: PPOConfig, env: Environment, flatten_obs: Callable, state: PPOTrainState,
            env_state: EnvState, obs: Tensor, carry: Carry, ep_ret: Tensor,
            generator: torch.Generator, noise: Tensor | None = None):
    """Collects T steps from B lockstep envs with the carry threaded through.
    `noise` (T, B, A), if given, replaces the standard-normal action noise
    drawn from `generator`. Returns (traj, env_state, obs, carry, ep_ret,
    episode stats)."""
    net = acting_params(cfg, state)
    init_carry = carry
    done_sum = torch.zeros_like(ep_ret)
    done_ret = torch.zeros_like(ep_ret)
    cols: dict[str, list] = {f.name: [] for f in dataclasses.fields(LSTMTrajectory)
                             if f.name not in ("next_value", "init_carry")}
    term_values = []
    for t in range(cfg.horizon):
        mean, log_std, value, new_carry = net(_norm(cfg, state, obs), carry)
        action = DiagGauss.sample(mean, log_std, None if noise is None else noise[t], generator)
        log_prob = DiagGauss.log_prob(mean, log_std, action)
        env_state, ts = env.step(env_state, action, generator)
        # Terminal-obs bootstrap value: one LSTM probe ahead on the pre-reset
        # obs with the pre-reset carry (the probe's carry is discarded).
        # Where no env finished, the probe equals value(t+1) of the next
        # step, so it is paid only when some env finished; the test costs
        # one host sync per step, as in `ppo.rollout`.
        term_values.append(net(_norm(cfg, state, flatten_obs(ts.obs)), new_carry)[2]
                           if bool(ts.done.any()) else torch.zeros_like(value))
        for k, x in (("obs", obs), ("action", action), ("log_prob", log_prob), ("mean", mean),
                     ("log_std", log_std.expand_as(mean)), ("value", value),
                     ("reward", ts.reward), ("discount", ts.discount), ("done", ts.done)):
            cols[k].append(x)
        carry = _reset_carry(new_carry, ts.done)
        ep_ret = ep_ret + ts.reward
        done_f = ts.done.to(ep_ret.dtype)
        done_sum = done_sum + done_f
        done_ret = done_ret + done_f * ep_ret
        ep_ret = ep_ret * (1.0 - done_f)
        obs = flatten_obs(ts.carry_obs)
    tr = {k: torch.stack(v) for k, v in cols.items()}
    v_last = net(_norm(cfg, state, obs), carry)[2]  # a probe too: its carry is dropped
    next_value = torch.cat([tr["value"][1:], v_last[None]], 0)
    next_value = torch.where(tr["done"], torch.stack(term_values), next_value)
    traj = LSTMTrajectory(next_value=next_value, init_carry=init_carry, **tr)
    stats = {"episodes_done": done_sum.sum(), "episode_return_sum": done_ret.sum()}
    return traj, env_state, obs, carry, ep_ret, stats


def _sequence_outputs(net: PPOActorCritic, obs_seq: Tensor, done_seq: Tensor,
                      init_carry: Carry):
    """Recomputes (mean (T, B, A), log_std (A,), value (T, B)) through time from
    the stored initial carry: truncated BPTT over the chunk, the carry zeroed
    at episode bounds. Only the cell's recurrence runs step by step: the
    input's share of the gates is one matmul over the whole sequence before
    the loop, and the torsos and heads, which have no state, take all T
    outputs at once after it."""
    input_gates = net.lstm.input_gates(net.encode(obs_seq))
    carry = tuple(c.detach() for c in init_carry)
    outs = []
    for t in range(obs_seq.shape[0]):
        carry, h = net.lstm.step(input_gates[t], carry)
        carry = _reset_carry(carry, done_seq[t])
        outs.append(h)
    return net.heads(torch.stack(outs))


def update(cfg: PPOConfig, state: PPOTrainState, traj: LSTMTrajectory,
           generator: torch.Generator, perms: Tensor | None = None, axis=None):
    """K epochs of SGD over minibatches of whole env sequences; updates
    `state` in place. `perms` (epochs, B), if given, replaces the per-epoch
    random permutations of the envs drawn from `generator`. Returns (state,
    metrics), the metrics of the last minibatch of the last epoch."""
    T, B = traj.reward.shape
    net = state.net
    with torch.no_grad():
        obs = _norm(cfg, state, traj.obs)
        adv, vtarg = gae(traj.reward, traj.value, traj.next_value, traj.discount, traj.done,
                         cfg.gamma, cfg.lam)
        if cfg.normalize_adv:
            adv = normalize_advantages(adv, axis)
    mb_envs = B // cfg.num_minibatches
    ent_coef = entropy_coef_at(cfg, state.update_step)
    lr = cfg.lr * state.lr_scale
    metrics = {}
    for e in range(cfg.epochs):
        perm = perms[e] if perms is not None else torch.randperm(
            B, generator=generator, device=generator.device)
        idxs = perm[: mb_envs * cfg.num_minibatches].reshape(cfg.num_minibatches, mb_envs)
        for idx in idxs:
            carry0 = tuple(c[idx] for c in traj.init_carry)
            mean, log_std, value = _sequence_outputs(net, obs[:, idx], traj.done[:, idx], carry0)
            batch = tuple(x[:, idx] for x in (traj.action, traj.log_prob, traj.mean,
                                              traj.log_std, adv, vtarg, traj.value))
            loss, metrics = surrogate_loss(cfg, mean, log_std, value, batch, state.kl_beta,
                                           ent_coef)
            metrics["grad_norm"] = apply_gradients(cfg, state, loss, lr, axis)
    finish_update(cfg, state, traj.obs, metrics, axis)
    return state, metrics


def train_step(cfg: PPOConfig, env: Environment, flatten_obs: Callable, state: PPOTrainState,
               env_state: EnvState, obs: Tensor, carry: Carry, ep_ret: Tensor,
               generator: torch.Generator, noise: Tensor | None = None,
               perms: Tensor | None = None, axis=None):
    """rollout + update. Returns (state, env_state, obs, carry, ep_ret, metrics)."""
    traj, env_state, obs, carry, ep_ret, ep_stats = rollout(
        cfg, env, flatten_obs, state, env_state, obs, carry, ep_ret, generator, noise)
    state, metrics = update(cfg, state, traj, generator, perms, axis)
    metrics.update(ep_stats)
    metrics["reward_per_step"] = torch.mean(traj.reward)
    return state, env_state, obs, carry, ep_ret, metrics
