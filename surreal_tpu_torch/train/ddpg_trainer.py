"""DDPG trainer (port of surreal_tpu/train/ddpg_trainer.py): builds the env
batch, pixel-wrapped or not, the four networks and the replay ring on the
device, then runs train steps, on one device or, given a data `mesh`
(`parallel.mesh`), on this rank's share of the envs with its shard of the
ring and of the noise ladder (`parallel.dp.make_sharded_ddpg_step`), ZeRO's
moments split over the data axis under `zero_optimizer`. Pixel
frames are stored raw, uint8, in the ring and scaled inside the conv
stems; the Z-filter stays off for them."""

from __future__ import annotations

import dataclasses
import functools

import torch

from surreal_tpu_torch.algos import ddpg
from surreal_tpu_torch.data.replay import ReplayState
from surreal_tpu_torch.envs import base as env_base
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.envs.wrappers import PixelWrapper, pixel_flatten_obs
from surreal_tpu_torch.models.blocks import resolve_dtype
from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic
from surreal_tpu_torch.models.z_filter import ZFilterState
from surreal_tpu_torch.parallel import dp
from surreal_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, TIME_AXIS
from surreal_tpu_torch.train.evaluator import evaluate_policy
from surreal_tpu_torch.train.loop import (
    Trainer,
    adam_state,
    load_adam_state,
    zfilter_state,
)

NETS = ("actor", "critic", "target_actor", "target_critic")


def check_layout(model: int, time: int) -> None:
    """The reference trainer's refusal of the model and time axes."""
    for ax, size in ((MODEL_AXIS, model), (TIME_AXIS, time)):
        if size > 1:
            raise ValueError(f"mesh.{ax} > 1 is a PPO-only feature; the DDPG "
                             "trainer supports the data axis only")


class DDPGTrainer(Trainer):
    default_log_every = 50  # the reference's default: DDPG's iterations are short
    rank_keys = Trainer.rank_keys + ("replay", "ou_state")

    def __init__(self, env_name: str, cfg: ddpg.DDPGConfig | None = None, num_envs: int = 128,
                 seed: int = 0, actor_hidden=(300, 200), critic_hidden=(400, 300),
                 device: str | torch.device | None = None,
                 compute_dtype: str | torch.dtype = torch.float32, pixel_obs: bool = False,
                 pixel_kwargs: dict | None = None, env_kwargs: dict | None = None,
                 debug_checks: bool = False, mesh=None):
        cfg = cfg or ddpg.DDPGConfig()
        if mesh is not None and cfg.zero_optimizer:  # ZeRO's chunks are sized up front
            cfg = dataclasses.replace(cfg, zero_shards=mesh.shape[DATA_AXIS])
        self.mesh = mesh
        shards = self._check_mesh(num_envs, debug_checks)
        if mesh is not None:
            check_layout(mesh.shape[MODEL_AXIS], mesh.shape[TIME_AXIS])
        self.device = self._resolve_device(device)
        self.env = make_env(env_name, device=self.device, **(env_kwargs or {}))
        if pixel_obs:
            self.env = PixelWrapper(self.env, **(pixel_kwargs or {}))
            self._flatten = pixel_flatten_obs
            cfg = dataclasses.replace(cfg, use_zfilter=False)
            pix = self.env.obs_spec()["pixel"]
            net_in, obs_dim = pix.shape, 1  # obs_dim: the Z-filter's placeholder
            layout = {"obs_shape": pix.shape, "obs_dtype": pix.dtype}
        else:
            self._flatten = env_base.flatten_obs
            net_in = obs_dim = env_base.obs_flat_dim(self.env)
            layout = {}
        if cfg.shared_encoder and not pixel_obs:
            raise ValueError("shared_encoder is a pixel-mode knob (conv stem)")
        if cfg.aug_shift > 0 and not pixel_obs:
            raise ValueError("aug_shift is a pixel-mode knob (image shift)")
        self.cfg = cfg
        self.num_envs = num_envs
        # Parameters are drawn on the CPU, so a seed gives the same networks
        # on every device; the run's own randomness comes from `generator`.
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        act_dim = self.env.action_dim
        dtype = resolve_dtype(compute_dtype)
        actor = DDPGActor(net_in, act_dim, tuple(actor_hidden), pixel_obs=pixel_obs,
                          detach_stem=cfg.shared_encoder, generator=init_gen,
                          compute_dtype=dtype)
        critic = DDPGCritic(net_in, act_dim, tuple(critic_hidden), pixel_obs=pixel_obs,
                            generator=init_gen, compute_dtype=dtype)
        if cfg.shared_encoder:  # one stem from step 0, the targets' too
            ddpg.sync_encoder(actor, critic)
        self.state = ddpg.init_state(self.cfg, actor.to(self.device), critic.to(self.device),
                                     obs_dim)
        # the ring is as deep as the global num_envs make it; a rank holds
        # its envs' columns
        self.replay = ddpg.init_replay(self.cfg, num_envs, obs_dim, act_dim, self.device,
                                       **layout, shards=shards)
        self.sigma = torch.as_tensor(ddpg.noise_ladder(self.cfg, num_envs), device=self.device)
        self.env_state, ts0 = self.env.reset(num_envs, self.generator)
        self.obs = self._flatten(ts0.obs)
        self.ou_state = torch.zeros(num_envs, act_dim, device=self.device)
        self.ep_ret = torch.zeros(num_envs, dtype=torch.float32, device=self.device)
        self.local_envs = num_envs
        self.global_iter = 0
        self.debug_checks = debug_checks
        if mesh is not None:
            self._shard(seed)
            self.sigma, self.ou_state = dp.shard_env_batch(mesh, (self.sigma, self.ou_state))
            self._step = dp.make_sharded_ddpg_step(self.cfg, self.env, self._flatten,
                                                   mesh)(self.replay)
            self.state = dp.replicate(mesh, self.state)
        else:
            self._step = functools.partial(ddpg.train_step, self.cfg, self.env, self._flatten)

    @property
    def steps_per_iteration(self) -> int:
        return self.cfg.rollout_steps * self.num_envs

    # ---- full-state checkpointing: the four networks and both Adam states,
    # the replay ring's contents and count, the exploration noise, the env
    # batch (and its frame stacks), the generator and the counters ----
    @property
    def full_state(self) -> dict:
        s = self.state
        fs = {**{n: getattr(s, n).state_dict() for n in NETS},
              "actor_opt": adam_state(s.actor_opt, self.mesh),
              "critic_opt": adam_state(s.critic_opt, self.mesh),
              "zfilter": zfilter_state(s.zfilter), "update_step": s.update_step,
              "replay": {"data": dict(self.replay.data), "total": self.replay.total},
              "ou_state": self.ou_state, **self._run_state()}
        if s.psync is not None:
            fs["psync"] = {"net": s.psync.actor_params.state_dict(), "version": s.psync.version}
        return fs

    def load_full_state(self, fs: dict) -> None:
        s = self.state
        for n in NETS:
            getattr(s, n).load_state_dict(fs[n])
        load_adam_state(s.actor_opt, fs["actor_opt"], self.mesh)
        load_adam_state(s.critic_opt, fs["critic_opt"], self.mesh)
        s.zfilter = ZFilterState(**fs["zfilter"])
        s.update_step = int(fs["update_step"])
        if s.psync is not None:
            s.psync.actor_params.load_state_dict(fs["psync"]["net"])
            s.psync.version = int(fs["psync"]["version"])
        for k, buf in self.replay.data.items():
            buf.copy_(fs["replay"]["data"][k])
        self.replay = ReplayState(data=self.replay.data, total=int(fs["replay"]["total"]))
        self.ou_state = fs["ou_state"]
        self._load_run_state(fs)

    def _fresh_episodes(self) -> None:
        # a fresh exploration process, as at every episode end; and the
        # ring's last stored step ends its episode, so no n-step window
        # bootstraps across the restart
        self.ou_state = torch.zeros_like(self.ou_state)
        if self.replay.total > 0:
            self.replay.data["done"][(self.replay.total - 1) % self.replay.capacity_t] = True

    def _iterate(self) -> dict:
        (self.state, self.replay, self.env_state, self.obs, self.ou_state, self.ep_ret,
         metrics) = self._step(
            self.state, self.replay, self.env_state, self.obs, self.ou_state, self.sigma,
            self.ep_ret, self.generator)
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
