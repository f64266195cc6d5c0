"""Point mass, easy (port of surreal_tpu/envs/pointmass.py): a 2-dof mass in
the horizontal plane, driven through fixed tendons, reaches the origin.
Start: both slides ~ U(range), at rest. obs: qpos, qvel. reward:
tolerance(‖q‖, (0, .015), margin .015) × (small_control + 4)/5."""

from __future__ import annotations

import os

import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_ASSET = os.path.join(base.ASSET_DIR, "point_mass.npz")

_TARGET_SIZE = 0.015


class PointMass(base.Environment):
    episode_steps = 1000  # 20 s / 0.02 s

    def __init__(self, device: torch.device | str | None = None, dtype=torch.float32):
        self.model = pmodel.load(_ASSET)
        assert self.model.plane == "xy"
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=1)

    def obs_spec(self):
        return {
            "position": base.ArraySpec((2,), self.dtype),
            "velocity": base.ArraySpec((2,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((2,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        rng = self._joint_range()
        return {"q": self._uniform((batch, 2), generator, rng[:, 0], rng[:, 1])}

    def _init(self, draw):
        return draw["q"], torch.zeros_like(draw["q"])

    def _physics_step(self, q, qd, action):
        return self._step_fn(q, qd, action)

    def _obs(self, q, qd):
        return {"position": q, "velocity": qd}

    def _reward(self, q, qd, action):
        dist = torch.linalg.vector_norm(q, dim=-1)  # mass at q; target at the origin
        near = rewards.tolerance(dist, (0.0, _TARGET_SIZE), margin=_TARGET_SIZE)
        ctrl = rewards.tolerance(torch.clamp(action, -1.0, 1.0), margin=1.0,
                                 value_at_margin=0.0, sigmoid="quadratic").mean(-1)
        return near * (ctrl + 4.0) / 5.0
