"""Single-device PPO trainer (port of surreal_tpu/train/ppo_trainer.py
without the mesh, LSTM and overlap paths): builds the env batch and the
network, then runs train steps."""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.algos import ppo
from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base as env_base
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.models.actor_critic import PPOActorCritic

log = logging.getLogger("surreal_tpu_torch.ppo")


class PPOTrainer:
    def __init__(self, env_name: str, cfg: ppo.PPOConfig | None = None, num_envs: int = 256,
                 seed: int = 0, hidden=(64, 64), device: str | torch.device | None = None,
                 env_kwargs: dict | None = None):
        self.cfg = cfg or ppo.PPOConfig()
        self.device = resolve_device(device)
        self.env = make_env(env_name, device=self.device, **(env_kwargs or {}))
        self._flatten = env_base.flatten_obs
        self.num_envs = num_envs
        # Parameters are drawn on the CPU, so a seed gives the same network
        # on every device; the run's own randomness comes from `generator`.
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        obs_dim = env_base.obs_flat_dim(self.env)
        net = PPOActorCritic(obs_dim, self.env.action_dim, hidden=tuple(hidden),
                             generator=init_gen).to(self.device)
        self.env_state, ts0 = self.env.reset(num_envs, self.generator)
        self.obs = self._flatten(ts0.obs)
        self.state = ppo.init_state(self.cfg, net, obs_dim)
        self.ep_ret = torch.zeros(num_envs, dtype=torch.float32, device=self.device)
        self.global_iter = 0

    @property
    def steps_per_iteration(self) -> int:
        return self.cfg.horizon * self.num_envs

    def run(self, iterations: int, log_every: int = 10,
            metric_sink: Callable | None = None) -> list[dict]:
        """Returns host-side metric dicts, one per log interval. Raises
        FloatingPointError on a non-finite metric."""
        logs = []
        ep_ret_acc = torch.zeros((), device=self.device)
        ep_cnt_acc = torch.zeros((), device=self.device)
        t0 = time.perf_counter()
        for it in range(1, iterations + 1):
            self.state, self.env_state, self.obs, self.ep_ret, metrics = ppo.train_step(
                self.cfg, self.env, self._flatten, self.state, self.env_state, self.obs,
                self.ep_ret, self.generator)
            ep_ret_acc = ep_ret_acc + metrics["episode_return_sum"]
            ep_cnt_acc = ep_cnt_acc + metrics["episodes_done"]
            self.global_iter += 1
            if it % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}  # syncs the device
                bad = [k for k, v in m.items() if not np.isfinite(v)]
                if bad:
                    raise FloatingPointError(
                        f"non-finite training metrics at iteration {it}: {bad} ({m})")
                m.pop("episode_return_sum")
                m.pop("episodes_done")
                cnt = float(ep_cnt_acc)
                dt = time.perf_counter() - t0
                m["iteration"] = self.global_iter
                m["env_steps"] = self.global_iter * self.steps_per_iteration
                m["env_steps_per_s"] = log_every * self.steps_per_iteration / dt
                if cnt > 0:
                    m["episode_return"] = float(ep_ret_acc) / cnt
                    ep_ret_acc = torch.zeros((), device=self.device)
                    ep_cnt_acc = torch.zeros((), device=self.device)
                logs.append(m)
                if metric_sink:
                    metric_sink(m)
                log.info("it %d steps %.2e sps %.0f ret %s kl %.4f", it, m["env_steps"],
                         m["env_steps_per_s"],
                         f"{m.get('episode_return', float('nan')):.1f}", m["kl"])
                t0 = time.perf_counter()
        return logs
