"""Cheetah-run (port of surreal_tpu/envs/cheetah.py).

Episode start states come from the reference's pool of pre-settled states
(`cheetah_pool.npz`), read in place with the baked model; the reset draw is
a pool row. obs = qpos[1:] + qvel; reward = tolerance(torso-subtree COM
x-velocity, bounds=(10, inf), margin=10, linear).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.base import ASSET_DIR
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_ASSET = os.path.join(ASSET_DIR, "cheetah.npz")
_POOL = os.path.join(ASSET_DIR, "cheetah_pool.npz")

_RUN_SPEED = 10.0


class CheetahRun(base.Environment):
    episode_steps = 1000  # 10 s / 0.01 s control timestep

    def __init__(self, device: torch.device | str | None = None, dtype=torch.float32,
                 n_substeps: int = 1):
        m = pmodel.load(_ASSET)
        self.model = m.replace(dt=m.dt / n_substeps)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=n_substeps)
        pool = np.load(_POOL)
        self._pool_q = torch.as_tensor(pool["q"].astype(np.float32), device=self.device).to(dtype)
        self._pool_qd = torch.as_tensor(pool["qd"].astype(np.float32), device=self.device).to(dtype)

    def obs_spec(self):
        return {
            "position": base.ArraySpec((8,), self.dtype),
            "velocity": base.ArraySpec((9,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((6,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        return {"row": torch.randint(0, self._pool_q.shape[0], (batch,), generator=generator,
                                     device=self.device)}

    def _init(self, draw):
        return self._pool_q[draw["row"]], self._pool_qd[draw["row"]]

    def _physics_step(self, q, qd, action):
        return self._step_fn(q, qd, action)

    def _obs(self, q, qd):
        return {"position": q[:, 1:], "velocity": qd}

    def _reward(self, q, qd, action):
        speed = engine.subtree_com_velocity(self.model, q, qd)[:, 0]
        return rewards.tolerance(
            speed,
            bounds=(_RUN_SPEED, float("inf")),
            margin=_RUN_SPEED,
            value_at_margin=0,
            sigmoid="linear",
        )
