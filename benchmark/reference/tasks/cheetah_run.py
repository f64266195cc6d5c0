"""Reference of dm_control's cheetah-run on the planar engine (the frozen
copy in `reference/physics`), batched over envs: the baked model and the
pool of pre-settled start states read from the same `.npz` assets the
program reads; obs = qpos[1:] and qvel; reward = tolerance(the torso
subtree's COM x-velocity, bounds (10, inf), margin 10, linear); episodes of
1000 control steps, discount 1 throughout (no termination), a diverged env
(non-finite, or |x| >= 1e8) ends its episode with reward 0."""

from __future__ import annotations

import numpy as np
import torch

from ..physics import engine, rewards
from ..physics import model as pmodel

ASSET = "cheetah.npz"
POOL = "cheetah_pool.npz"
RUN_SPEED = 10.0


class Task:
    episode_steps = 1000

    def __init__(self, asset_dir: str, device):
        self.model = pmodel.load(f"{asset_dir}/{ASSET}")
        self.device = torch.device(device)
        self._step = engine.make_stepper(self.model)
        pool = np.load(f"{asset_dir}/{POOL}")
        self.pool_q = torch.as_tensor(pool["q"].astype(np.float32), device=self.device)
        self.pool_qd = torch.as_tensor(pool["qd"].astype(np.float32), device=self.device)
        self.action_dim = len(self.model.act_dof)
        self.obs_dim = self.model.nv - 1 + self.model.nv

    def obs_flat(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """The flat observation: position (qpos[1:]), then velocity."""
        return torch.cat([q[:, 1:], qd], -1)

    def start(self, rows: torch.Tensor):
        return self.pool_q[rows], self.pool_qd[rows]

    def step(self, q, qd, t, action):
        """One control step without the reset: (q, qd, t, reward, done,
        diverged), the state as it is after the physics."""
        q, qd = self._step(q, qd, action)
        t = t + 1

        def finite(x):
            return torch.isfinite(x).all(-1) & (torch.amax(torch.abs(x), -1) < 1e8)

        diverged = ~(finite(q) & finite(qd))
        q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
        qd = torch.where(torch.isfinite(qd), qd, torch.zeros_like(qd))
        speed = engine.subtree_com_velocity(self.model, q, qd)[:, 0]
        reward = rewards.tolerance(speed, bounds=(RUN_SPEED, float("inf")), margin=RUN_SPEED,
                                   value_at_margin=0, sigmoid="linear")
        reward = torch.where(diverged, torch.zeros_like(reward), reward)
        done = (t >= self.episode_steps) | diverged
        return q, qd, t, reward, done, diverged

    def pool_row_of(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """Per env, whether (q, qd) is bit for bit a row of the start pool."""
        state = torch.cat([q, qd], -1)
        pool = torch.cat([self.pool_q, self.pool_qd], -1)
        hit = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
        for i in range(0, q.shape[0], 1024):
            hit[i:i + 1024] = (state[i:i + 1024, None, :] == pool[None]).all(-1).any(-1)
        return hit
