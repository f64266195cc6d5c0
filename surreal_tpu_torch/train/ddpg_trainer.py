"""Single-device DDPG trainer (port of surreal_tpu/train/ddpg_trainer.py
without the mesh and pixel paths): builds the env batch, the four networks
and the replay ring on the device, then runs train steps."""

from __future__ import annotations

import torch

from surreal_tpu_torch.algos import ddpg
from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base as env_base
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic
from surreal_tpu_torch.train.evaluator import evaluate_policy
from surreal_tpu_torch.train.loop import Trainer


class DDPGTrainer(Trainer):
    default_log_every = 50  # the reference's default: DDPG's iterations are short

    def __init__(self, env_name: str, cfg: ddpg.DDPGConfig | None = None, num_envs: int = 128,
                 seed: int = 0, actor_hidden=(300, 200), critic_hidden=(400, 300),
                 device: str | torch.device | None = None, pixel_obs: bool = False,
                 env_kwargs: dict | None = None, mesh=None):
        if pixel_obs or mesh is not None:
            raise NotImplementedError(
                "pixel_obs and mesh are not ported yet (ROADMAP.md, Queue A)")
        self.cfg = cfg or ddpg.DDPGConfig()
        self.device = resolve_device(device)
        self.env = make_env(env_name, device=self.device, **(env_kwargs or {}))
        self._flatten = env_base.flatten_obs
        self.num_envs = num_envs
        # Parameters are drawn on the CPU, so a seed gives the same networks
        # on every device; the run's own randomness comes from `generator`.
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        obs_dim = env_base.obs_flat_dim(self.env)
        act_dim = self.env.action_dim
        actor = DDPGActor(obs_dim, act_dim, tuple(actor_hidden), generator=init_gen)
        critic = DDPGCritic(obs_dim, act_dim, tuple(critic_hidden), generator=init_gen)
        self.state = ddpg.init_state(self.cfg, actor.to(self.device), critic.to(self.device),
                                     obs_dim)
        self.replay = ddpg.init_replay(self.cfg, num_envs, obs_dim, act_dim, self.device)
        self.sigma = torch.as_tensor(ddpg.noise_ladder(self.cfg, num_envs), device=self.device)
        self.env_state, ts0 = self.env.reset(num_envs, self.generator)
        self.obs = self._flatten(ts0.obs)
        self.ou_state = torch.zeros(num_envs, act_dim, device=self.device)
        self.ep_ret = torch.zeros(num_envs, dtype=torch.float32, device=self.device)
        self.global_iter = 0

    @property
    def steps_per_iteration(self) -> int:
        return self.cfg.rollout_steps * self.num_envs

    def _iterate(self) -> dict:
        (self.state, self.replay, self.env_state, self.obs, self.ou_state, self.ep_ret,
         metrics) = ddpg.train_step(
            self.cfg, self.env, self._flatten, self.state, self.replay, self.env_state,
            self.obs, self.ou_state, self.sigma, self.ep_ret, self.generator)
        metrics["updates"] = self.state.update_step  # a host count: no device read
        return metrics

    def _describe(self, m: dict) -> str:
        return f"upd {m['updates']} q {m['q_mean']:.2f}"

    def deterministic_policy(self):
        """(policy_fn, zfilter): policy_fn(obs) -> action, for recording."""
        zf = self.state.zfilter if self.cfg.use_zfilter else None
        return self.state.actor, zf

    def evaluate(self, episodes: int = 16, seed: int = 0) -> dict:
        zf = self.state.zfilter if self.cfg.use_zfilter else None
        return evaluate_policy(self.env, lambda obs, generator: self.state.actor(obs), zf,
                               episodes=episodes, seed=seed, flatten=self._flatten)
