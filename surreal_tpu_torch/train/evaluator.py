"""Deterministic / stochastic policy evaluation (port of
surreal_tpu/train/evaluator.py): the policy runs over one full episode on
its own batch of envs, and the episode returns are reported. Supports
stateful (LSTM) policies through the policy-state carry."""

from __future__ import annotations

from typing import Callable

import torch

from surreal_tpu_torch.envs import base as env_base
from surreal_tpu_torch.models.z_filter import ZFilterState, zfilter_normalize


@torch.no_grad()
def evaluate_policy(env: env_base.Environment, policy_fn: Callable,
                    zfilter: ZFilterState | None = None, episodes: int = 16, seed: int = 0,
                    flatten: Callable | None = None, init_policy_state=None) -> dict:
    """policy_fn(obs, generator[, pstate]) -> action | (action, pstate); the
    policy closes over its network. Runs `episodes` parallel envs, on the
    env's device, for one full episode each; returns the mean, std, min and
    max of their returns."""
    flatten = flatten or env_base.flatten_obs
    stateful = init_policy_state is not None
    generator = torch.Generator(device=env.device).manual_seed(seed)
    env_state, ts = env.reset(episodes, generator)
    obs = flatten(ts.obs)
    pstate = init_policy_state
    ep_ret = torch.zeros(episodes, device=obs.device)
    for _ in range(env.episode_steps):
        o = zfilter_normalize(zfilter, obs) if zfilter is not None else obs
        if stateful:
            action, pstate = policy_fn(o, generator, pstate)
        else:
            action = policy_fn(o, generator)
        env_state, ts = env.step(env_state, action, generator)
        ep_ret = ep_ret + ts.reward
        obs = flatten(ts.carry_obs)
    returns = ep_ret.cpu()
    return {
        "return_mean": float(returns.mean()),
        "return_std": float(returns.std(unbiased=False)),
        "return_min": float(returns.min()),
        "return_max": float(returns.max()),
        "episodes": episodes,
    }
