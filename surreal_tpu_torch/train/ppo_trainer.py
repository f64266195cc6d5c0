"""PPO trainer (port of surreal_tpu/train/ppo_trainer.py): builds the env
batch from a name (a "gym:" name gets `num_envs` as its default env kwarg)
or takes a pre-built env, pixel-wrapped or not, and the network,
feed-forward or recurrent, in its compute dtype, then runs train steps,
fused or overlapped (`overlap`: the update of iteration k consumes the
trajectory of iteration k - 1), on one device or, given a `mesh`
(`parallel.mesh`), on this rank's share of the envs: with the sharded
steps of `parallel.dp` over the data axis, the GAE scan split over the
time axis (`cfg.time_shards`) and ZeRO's moments over the data axis
(`cfg.zero_shards`), each set from the mesh as the reference's trainer
sets them; or, with a model axis, with the network sharded over it and the
one-device step's semantics (`parallel.tp`). With `torso="gtrxl"` the
policy is a GTrXL (`models/gtrxl.py`, `algos/ppo_gtrxl.py`), on one device
only: no mesh, no overlap, no LSTM."""

from __future__ import annotations

import dataclasses
import functools

import torch

from surreal_tpu_torch.algos import ppo, ppo_gtrxl, ppo_lstm
from surreal_tpu_torch.envs import base as env_base
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.envs.wrappers import PixelWrapper, pixel_flatten_obs
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.blocks import resolve_dtype
from surreal_tpu_torch.models.distributions import DiagGauss
from surreal_tpu_torch.models.z_filter import ZFilterState
from surreal_tpu_torch.parallel import dp, tp
from surreal_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, TIME_AXIS
from surreal_tpu_torch.train.evaluator import evaluate_policy
from surreal_tpu_torch.train.loop import (
    Trainer,
    adam_state,
    load_adam_state,
    zfilter_state,
)


TORSOS = ("mlp", "gtrxl")
ONE_DEVICE = ("torso 'gtrxl' runs on one device only: it does not compose with a mesh (data, "
              "model or time axis), overlap or use_lstm")


def check_layout(cfg: ppo.PPOConfig, model: int, time: int, use_lstm: bool = False,
                 overlap: bool = False, torso: str = "mlp", data: int = 1) -> None:
    """The reference trainer's refusals of a mesh's model and time axes, with
    its messages (the CLI checks them before it starts the ranks), and the
    port's of a GTrXL torso anywhere but on one device."""
    if torso not in TORSOS:
        raise ValueError(f"unknown torso {torso!r} (one of {', '.join(TORSOS)})")
    if torso == "gtrxl" and (data > 1 or model > 1 or time > 1 or overlap or use_lstm):
        raise ValueError(ONE_DEVICE)
    if model > 1 and time > 1:
        raise ValueError("mesh.model and mesh.time cannot both be > 1")
    if model > 1 and (use_lstm or cfg.zero_optimizer or cfg.publish_every > 1 or overlap):
        raise ValueError("mesh.model > 1 (GSPMD TP path) does not compose with "
                         "use_lstm / zero_optimizer / publish_every / overlap yet")
    if time > 1 and cfg.horizon % time != 0:
        raise ValueError(f"horizon {cfg.horizon} not divisible by time axis {time}")


class PPOTrainer(Trainer):
    rank_keys = Trainer.rank_keys + ("carry",)

    def __init__(self, env_name: str | env_base.Environment, cfg: ppo.PPOConfig | None = None,
                 num_envs: int = 256, seed: int = 0, hidden=(64, 64),
                 device: str | torch.device | None = None,
                 compute_dtype: str | torch.dtype = torch.float32,
                 pixel_obs: bool = False, pixel_kwargs: dict | None = None,
                 use_lstm: bool = False, lstm_size: int = 128, env_kwargs: dict | None = None,
                 debug_checks: bool = False, mesh=None, overlap: bool = False,
                 torso: str = "mlp", gtrxl: dict | None = None):
        if overlap and use_lstm:
            raise ValueError("overlap does not compose with use_lstm")
        self.use_gtrxl = torso == "gtrxl"
        if self.use_gtrxl and mesh is not None:  # a one-rank mesh too: the sharded steps
            raise ValueError(ONE_DEVICE)
        self.overlap = overlap
        self._pending = None  # overlap: the trajectory awaiting its update
        cfg = cfg or ppo.PPOConfig()
        self.mesh = mesh
        model_shards = time_shards = 1
        if mesh is not None:
            if cfg.zero_optimizer:  # ZeRO's moment chunks are sized up front
                cfg = dataclasses.replace(cfg, zero_shards=mesh.shape[DATA_AXIS])
            model_shards, time_shards = mesh.shape[MODEL_AXIS], mesh.shape[TIME_AXIS]
        self._check_mesh(num_envs, debug_checks)
        check_layout(cfg, model_shards, time_shards, use_lstm, overlap, torso)
        if time_shards > 1:
            cfg = dataclasses.replace(cfg, time_shards=time_shards)
        self.device = self._resolve_device(device)
        if isinstance(env_name, str):
            env_kwargs = dict(env_kwargs or {})
            if env_name.startswith("gym:"):
                env_kwargs.setdefault("num_envs", num_envs)
            self.env = make_env(env_name, device=self.device, **env_kwargs)
        else:  # a pre-built Environment instance (physics-variant probes)
            self.env = env_name
        if pixel_obs:
            self.env = PixelWrapper(self.env, **(pixel_kwargs or {}))
            self._flatten = pixel_flatten_obs
            cfg = dataclasses.replace(cfg, use_zfilter=False)  # the stem scales uint8
            net_in, obs_dim = self.env.obs_spec()["pixel"].shape, 1  # the Z-filter's placeholder
        else:
            self._flatten = env_base.flatten_obs
            obs_dim = net_in = env_base.obs_flat_dim(self.env)
        self.cfg = cfg
        self.num_envs = num_envs
        # Parameters are drawn on the CPU, so a seed gives the same network
        # on every device; the run's own randomness comes from `generator`.
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.use_lstm = use_lstm
        net = PPOActorCritic(net_in, self.env.action_dim, hidden=tuple(hidden),
                             pixel_obs=pixel_obs, use_lstm=use_lstm, lstm_size=lstm_size,
                             generator=init_gen, compute_dtype=resolve_dtype(compute_dtype),
                             gtrxl=dict(gtrxl or {}) if self.use_gtrxl else None
                             ).to(self.device)
        self.env_state, ts0 = self.env.reset(num_envs, self.generator)
        self.obs = self._flatten(ts0.obs)
        self.local_envs = num_envs
        self.carry = (ppo_gtrxl.initial_carry(net, num_envs, self.device) if self.use_gtrxl
                      else net.initial_carry((num_envs,)))  # None without either
        self.sharding = tp.shard_module(net, mesh) if model_shards > 1 else None
        self.state = ppo.init_state(self.cfg, net, obs_dim)
        self.ep_ret = torch.zeros(num_envs, dtype=torch.float32, device=self.device)
        self.global_iter = 0
        self.debug_checks = debug_checks
        if self.sharding is not None:
            # the one-device step's semantics: no fold, whole-batch draws
            self._shard(seed, fold=False)
            self._step = tp.make_tp_ppo_step(self.cfg, self.env, self._flatten, mesh)
        elif mesh is not None:
            self._shard(seed)
            if overlap:
                self._step, self._prime = dp.make_sharded_ppo_overlap_step(
                    self.cfg, self.env, self._flatten, mesh)
            else:
                maker = dp.make_sharded_ppo_lstm_step if use_lstm else dp.make_sharded_ppo_step
                self._step = maker(self.cfg, self.env, self._flatten, mesh)
            self.state = dp.replicate(mesh, self.state)
            if use_lstm:
                self.carry = dp.shard_env_batch(mesh, self.carry)
        else:  # one device: the algorithm's own steps
            self._step = (ppo.train_step_overlapped if overlap else
                          ppo_lstm.train_step if use_lstm else
                          ppo_gtrxl.train_step if self.use_gtrxl else ppo.train_step)
            self._step = functools.partial(self._step, self.cfg, self.env, self._flatten)
            self._prime = functools.partial(ppo.rollout, self.cfg, self.env, self._flatten)

    @property
    def steps_per_iteration(self) -> int:
        return self.cfg.horizon * self.num_envs

    # ---- full-state checkpointing: the network, Adam, the Z-filter, the
    # KL/LR adaptation, the actors' snapshot, the env batch (and its frame
    # stacks), the LSTM carry or the GTrXL memory, the generator and the
    # counters all survive.
    # The overlapped step's pending trajectory does not, as in the
    # reference: a restored trainer primes again, so a resumed overlapped
    # run is not the uninterrupted one. The learner is held whole: ZeRO's
    # moments and a sharded network gathered (collective under a mesh) ----
    @property
    def full_state(self) -> dict:
        s = self.state
        net = s.net.state_dict()
        if self.sharding is not None:
            net = self.sharding.gather(net)
        fs = {"net": net, "opt": adam_state(s.opt_state, self.mesh, self.sharding),
              "zfilter": zfilter_state(s.zfilter), "kl_beta": s.kl_beta,
              "lr_scale": s.lr_scale, "update_step": s.update_step, **self._run_state()}
        if s.psync is not None:
            fs["psync"] = {"net": s.psync.actor_params.state_dict(), "version": s.psync.version}
        if self.use_lstm:
            fs["carry"] = list(self.carry)
        if self.use_gtrxl:
            fs["carry"] = self.carry.to_dict()
        return fs

    def load_full_state(self, fs: dict) -> None:
        s = self.state
        s.net.load_state_dict(fs["net"] if self.sharding is None
                              else self.sharding.shard(fs["net"]))
        load_adam_state(s.opt_state, fs["opt"], self.mesh, self.sharding)
        s.zfilter = ZFilterState(**fs["zfilter"])
        s.kl_beta, s.lr_scale = fs["kl_beta"], fs["lr_scale"]
        s.update_step = int(fs["update_step"])
        if s.psync is not None:
            s.psync.actor_params.load_state_dict(fs["psync"]["net"])
            s.psync.version = int(fs["psync"]["version"])
        if self.use_lstm:
            self.carry = tuple(fs["carry"])
        if self.use_gtrxl:
            self.carry = ppo_gtrxl.GTrXLCarry.from_dict(fs["carry"])
        self._load_run_state(fs)
        self._pending = None  # overlap: primed again by the next run()

    def _fresh_episodes(self) -> None:
        if self.use_lstm:  # the carry of a new episode, as the rollout sets it
            self.carry = self.state.net.initial_carry((self.local_envs,))
        if self.use_gtrxl:  # an empty memory
            self.carry = ppo_gtrxl.initial_carry(self.state.net, self.local_envs, self.device)

    def run(self, iterations: int, log_every: int | None = None, metric_sink=None) -> list[dict]:
        """With `overlap`, the first call (and the first after
        `load_full_state`) primes the double buffer with one rollout on the
        current parameters; its env steps are not counted (`env_steps` is
        `global_iter` x `steps_per_iteration`, as in the reference)."""
        if self.overlap and self._pending is None:
            self._pending, self.env_state, self.obs, self.ep_ret = self._prime(
                self.state, self.env_state, self.obs, self.ep_ret, self.generator)[:4]
        return super().run(iterations, log_every, metric_sink)

    def _iterate(self) -> dict:
        if self.overlap:
            (self.state, self.env_state, self.obs, self.ep_ret, self._pending,
             metrics) = self._step(self.state, self.env_state, self.obs, self.ep_ret,
                                   self._pending, self.generator)
        elif self.use_lstm or self.use_gtrxl:
            (self.state, self.env_state, self.obs, self.carry, self.ep_ret,
             metrics) = self._step(self.state, self.env_state, self.obs, self.carry,
                                   self.ep_ret, self.generator)
        else:
            self.state, self.env_state, self.obs, self.ep_ret, metrics = self._step(
                self.state, self.env_state, self.obs, self.ep_ret, self.generator)
        return metrics

    def _describe(self, m: dict) -> str:
        return f"kl {m['kl']:.4f}"

    def deterministic_policy(self):
        """(policy_fn, zfilter): policy_fn(obs) -> the mean action, for
        recording; None for LSTM and GTrXL policies (policy_fn has no state)."""
        if self.use_lstm or self.use_gtrxl:
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

        if self.use_gtrxl:
            m = net.gtrxl.memory

            def policy(obs, generator, pstate):
                cache, valid, t = pstate
                mean, log_std, _ = ppo_gtrxl.act(net, obs, cache, t, valid)
                valid[:, t % m] = True  # no episode ends within the evaluation's one
                return act(mean, log_std, generator), (cache, valid, t + 1)

            fresh = ppo_gtrxl.initial_carry(net, episodes, self.device)
            return evaluate_policy(self.env, policy, zf, episodes=episodes, seed=seed,
                                   flatten=self._flatten,
                                   init_policy_state=(net.gtrxl.prefill(fresh.memory),
                                                      fresh.valid, 0))

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
