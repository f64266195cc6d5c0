"""The loop the trainers share: iterate, sum the episode returns on the
device, and read the metrics on the host once per log interval; the parts
of a trainer's full state that every trainer has; and, given a mesh, the
share of the env batch that is this rank's."""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.algos.ppo import AdamState
from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.envs.gym_adapter import GymEnv
from surreal_tpu_torch.models.z_filter import ZFilterState
from surreal_tpu_torch.parallel import dp, zero
from surreal_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, data_axis_size
from surreal_tpu_torch.parallel.tp import TPSharding
from surreal_tpu_torch.utils import guards

log = logging.getLogger("surreal_tpu_torch.train")


class Trainer:
    """A trainer sets `device`, `env`, `_flatten`, `generator`, `env_state`,
    `obs`, `ep_ret`, `global_iter`, `steps_per_iteration` and
    `debug_checks`, and implements `_iterate` and `full_state` /
    `load_full_state`. With a `mesh`, the env batch is this rank's data
    index's share (`local_envs` of them); the learner is replicated, but
    for ZeRO's moments and a tensor-parallel network's shards, which the
    full state holds whole (`adam_state`)."""

    default_log_every = 10
    # The full state's keys that are this rank's own under a mesh (the rest,
    # the learner, is equal on every rank): a checkpoint keeps one per rank.
    # Each is the rank's data index's slice of the whole env batch (but the
    # generator), which a resume under another layout cuts anew
    # (`train.checkpoint`).
    rank_keys = ("env_state", "obs", "ep_ret", "generator")
    mesh: Mesh | None = None
    local_envs: int
    device: torch.device
    generator: torch.Generator
    env_state: EnvState  # or a wrapper's state with the same to_dict / from_dict
    obs: torch.Tensor
    ep_ret: torch.Tensor
    global_iter: int  # lifetime iteration count
    steps_per_iteration: int
    # Sanitizer mode: every iteration runs with the guards' hooks on, and
    # every floating tensor of the full state is checked after it.
    debug_checks: bool = False

    @property
    def full_state(self) -> dict:
        """Everything a resumed run needs to continue as if never stopped
        (but the episodes of host envs, which restart from their seed): a
        nested dict of tensors and Python scalars (`train.checkpoint`)."""
        raise NotImplementedError

    def load_full_state(self, fs: dict) -> None:
        """Restores `full_state` into this trainer's existing modules and
        tensors (it rebuilds nothing)."""
        raise NotImplementedError

    def _resolve_device(self, device) -> torch.device:
        """The mesh's device for this rank, else `device` ("cuda" by default)."""
        if self.mesh is None:
            return resolve_device(device)
        if device is not None and torch.device(device).type != self.mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's {self.mesh.device}")
        return self.mesh.device

    def _check_mesh(self, num_envs: int, debug_checks: bool) -> int:
        """The checks both trainers make of a mesh, as the reference's do;
        returns the data axis size (1 without a mesh)."""
        if self.mesh is None:
            return 1
        if debug_checks:
            raise ValueError("debug_checks is single-device only")
        shards = data_axis_size(self.mesh)
        if num_envs % shards != 0:
            raise ValueError(f"num_envs={num_envs} not divisible by data axis {shards}")
        return shards

    def _shard(self, seed: int, fold: bool = True) -> None:
        """Keeps this rank's slice of the env batch, drawn whole from the
        shared seed, and with `fold` moves its generator to its data index's
        stream (`parallel.dp.fold_in`)."""
        if isinstance(self.env, GymEnv):
            raise ValueError("a data mesh shards the device envs; gym: envs step on the host "
                             "as one batch")
        mesh = self.mesh
        self.local_envs = self.num_envs // data_axis_size(mesh)
        if fold:
            self.generator = dp.fold_in(self.generator, seed, mesh.index[DATA_AXIS])
        self.env_state, self.obs, self.ep_ret = dp.shard_env_batch(
            mesh, (self.env_state, self.obs, self.ep_ret))

    def _fresh_episodes(self) -> None:
        """What else belongs to an episode, set as a new episode starts it,
        after a resume restarted the host envs (each trainer's own)."""

    def _run_state(self) -> dict:
        """The full state's share of the env batch (with pixels, the frame
        stack too), the RNG and the counter."""
        return {"env_state": self.env_state.to_dict(), "obs": self.obs,
                "ep_ret": self.ep_ret, "generator": self.generator.get_state(),
                "global_iter": self.global_iter}

    def _load_run_state(self, fs: dict) -> None:
        self.generator.set_state(fs["generator"].cpu())  # a generator's state lives on the host
        self.global_iter = int(fs["global_iter"])
        if isinstance(self.env, GymEnv):
            # The host envs' state lives in gymnasium and cannot be restored:
            # they start again from their seed, with the learner restored, and
            # so does everything that belongs to their episodes.
            self.env_state, ts = self.env.reset(self.env.num_envs, self.generator)
            self.obs = self._flatten(ts.obs)
            self.ep_ret = torch.zeros_like(self.ep_ret)
            self._fresh_episodes()
            return
        # the trainer's own env state (from its reset) says which kind to rebuild
        self.env_state = type(self.env_state).from_dict(fs["env_state"])
        self.obs = fs["obs"]
        self.ep_ret = fs["ep_ret"]

    def _iterate(self) -> dict:
        """One train step on the trainer's own state; returns its metrics
        (scalar tensors, or numbers the host already knows),
        `episode_return_sum` and `episodes_done` among them."""
        raise NotImplementedError

    def _describe(self, m: dict) -> str:
        """The algorithm's part of the log line."""
        return ""

    def run(self, iterations: int, log_every: int | None = None,
            metric_sink: Callable | None = None) -> list[dict]:
        """Returns host-side metric dicts, one per log interval of `log_every`
        iterations (the trainer's `default_log_every` if None; reading them
        waits for the device). Raises FloatingPointError on a non-finite
        metric."""
        log_every = log_every or self.default_log_every
        logs = []
        ep_ret_acc = torch.zeros((), device=self.device)
        ep_cnt_acc = torch.zeros((), device=self.device)
        if self.debug_checks:
            with guards.checking():
                guards.assert_finite_tree(self.full_state, "full_state")
        t0 = time.perf_counter()
        for it in range(1, iterations + 1):
            if self.debug_checks:
                with guards.checking():
                    metrics = self._iterate()
                    guards.assert_finite_tree(self.full_state, "full_state")
            else:
                metrics = self._iterate()
            ep_ret_acc = ep_ret_acc + metrics["episode_return_sum"]
            ep_cnt_acc = ep_cnt_acc + metrics["episodes_done"]
            self.global_iter += 1
            if it % log_every == 0:
                m = {k: v if isinstance(v, int) else float(v) for k, v in metrics.items()}
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
                log.info("it %d steps %.2e sps %.0f ret %s %s", it, m["env_steps"],
                         m["env_steps_per_s"],
                         f"{m.get('episode_return', float('nan')):.1f}", self._describe(m))
                t0 = time.perf_counter()
        return logs


def adam_state(opt: AdamState | zero.ZeroAdamState, mesh: Mesh | None = None,
               sharding: TPSharding | None = None) -> dict:
    """An Adam state in the one-device layout, {count, mu, nu} with the
    moments by parameter name: a ZeRO state's chunks gathered over the data
    ranks, a sharded network's moments over the model ranks. Collective
    under a mesh: every rank calls it."""
    if isinstance(opt, zero.ZeroAdamState):
        mu, nu = zero.gather_moments(opt, mesh)
    else:
        mu, nu = dict(opt.mu), dict(opt.nu)
    if sharding is not None:
        mu, nu = sharding.gather(mu), sharding.gather(nu)
    return {"count": opt.count, "mu": mu, "nu": nu}


def load_adam_state(opt: AdamState | zero.ZeroAdamState, fs: dict, mesh: Mesh | None = None,
                    sharding: TPSharding | None = None) -> None:
    """Inverse of `adam_state`: this rank's chunk or shard of `fs`."""
    mu, nu = dict(fs["mu"]), dict(fs["nu"])
    if sharding is not None:
        mu, nu = sharding.shard(mu), sharding.shard(nu)
    if isinstance(opt, zero.ZeroAdamState):
        zero.load_moments(opt, mesh, fs["count"], mu, nu)
    else:
        opt.count = int(fs["count"])
        opt.mu, opt.nu = mu, nu


def zfilter_state(zf: ZFilterState) -> dict:
    return {"count": zf.count, "mean": zf.mean, "m2": zf.m2}
