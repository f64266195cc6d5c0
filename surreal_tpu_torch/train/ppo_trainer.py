"""Single-device PPO trainer (port of surreal_tpu/train/ppo_trainer.py
without the mesh, pixel and overlap paths): builds the env batch and the
network, feed-forward or recurrent, then runs train steps."""

from __future__ import annotations

import torch

from surreal_tpu_torch.algos import ppo, ppo_lstm
from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base as env_base
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.distributions import DiagGauss
from surreal_tpu_torch.train.evaluator import evaluate_policy
from surreal_tpu_torch.train.loop import Trainer


class PPOTrainer(Trainer):
    def __init__(self, env_name: str, cfg: ppo.PPOConfig | None = None, num_envs: int = 256,
                 seed: int = 0, hidden=(64, 64), device: str | torch.device | None = None,
                 pixel_obs: bool = False, use_lstm: bool = False, lstm_size: int = 128,
                 env_kwargs: dict | None = None, mesh=None, overlap: bool = False):
        if pixel_obs or mesh is not None or overlap:
            raise NotImplementedError(
                "pixel_obs, mesh and overlap are not ported yet (ROADMAP.md, Queue A)")
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
        self.use_lstm = use_lstm
        net = PPOActorCritic(obs_dim, self.env.action_dim, hidden=tuple(hidden),
                             use_lstm=use_lstm, lstm_size=lstm_size,
                             generator=init_gen).to(self.device)
        self.env_state, ts0 = self.env.reset(num_envs, self.generator)
        self.obs = self._flatten(ts0.obs)
        self.carry = net.initial_carry((num_envs,))  # None without an LSTM
        self.state = ppo.init_state(self.cfg, net, obs_dim)
        self.ep_ret = torch.zeros(num_envs, dtype=torch.float32, device=self.device)
        self.global_iter = 0

    @property
    def steps_per_iteration(self) -> int:
        return self.cfg.horizon * self.num_envs

    def _iterate(self) -> dict:
        if self.use_lstm:
            (self.state, self.env_state, self.obs, self.carry, self.ep_ret,
             metrics) = ppo_lstm.train_step(
                self.cfg, self.env, self._flatten, self.state, self.env_state, self.obs,
                self.carry, self.ep_ret, self.generator)
        else:
            self.state, self.env_state, self.obs, self.ep_ret, metrics = ppo.train_step(
                self.cfg, self.env, self._flatten, self.state, self.env_state, self.obs,
                self.ep_ret, self.generator)
        return metrics

    def _describe(self, m: dict) -> str:
        return f"kl {m['kl']:.4f}"

    def deterministic_policy(self):
        """(policy_fn, zfilter): policy_fn(obs) -> the mean action, for
        recording; None for LSTM policies (policy_fn has no state)."""
        if self.use_lstm:
            return None
        zf = self.state.zfilter if self.cfg.use_zfilter else None
        return (lambda obs: self.state.net(obs)[0]), zf

    def evaluate(self, episodes: int = 16, stochastic: bool = False, seed: int = 0) -> dict:
        """One full episode on `episodes` fresh envs with the mean action (or
        a sampled one); the mean, std, min and max of the returns."""
        net = self.state.net
        zf = self.state.zfilter if self.cfg.use_zfilter else None

        def act(mean, log_std, generator):
            return DiagGauss.sample(mean, log_std, generator=generator) if stochastic else mean

        if self.use_lstm:
            def policy(obs, generator, carry):
                mean, log_std, _, carry = net(obs, carry)
                return act(mean, log_std, generator), carry

            return evaluate_policy(self.env, policy, zf, episodes=episodes, seed=seed,
                                   flatten=self._flatten,
                                   init_policy_state=net.initial_carry((episodes,)))

        def policy(obs, generator):
            mean, log_std, _ = net(obs)
            return act(mean, log_std, generator)

        return evaluate_policy(self.env, policy, zf, episodes=episodes, seed=seed,
                               flatten=self._flatten)
