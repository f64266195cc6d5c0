"""Reacher, easy and hard (port of surreal_tpu/envs/reacher.py): a two-link
arm in the horizontal plane; the target size is .05 or .015.

Start: shoulder ~ U(−π, π), wrist ~ U(range); target at angle ~ U(0, 2π),
radius ~ U(.05, .2), appended to q as two frozen coordinates. obs: qpos,
target − finger, qvel. reward: tolerance(‖target − finger‖, (0, size + .01)).
"""

from __future__ import annotations

import math
import os

import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_ASSET = os.path.join(base.ASSET_DIR, "reacher.npz")

_FINGER_SIZE = 0.01
_FINGER_BODY = 2  # arm(0) -> hand(1) -> finger(2, welded)


class Reacher(base.Environment):
    episode_steps = 1000  # 20 s / 0.02 s

    def __init__(self, target_size: float = 0.05, device: torch.device | str | None = None,
                 dtype=torch.float32):
        self.model = pmodel.load(_ASSET)
        assert self.model.plane == "xy"
        self.target_size = float(target_size)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=1)

    def obs_spec(self):
        return {
            "position": base.ArraySpec((2,), self.dtype),
            "to_target": base.ArraySpec((2,), self.dtype),
            "velocity": base.ArraySpec((2,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((2,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        lo, hi = (float(x) for x in self.model.joint_range[1])
        u = lambda a, b: self._uniform((batch,), generator, a, b)  # noqa: E731
        return {"shoulder": u(-math.pi, math.pi), "wrist": u(lo, hi),
                "angle": u(0.0, 2 * math.pi), "radius": u(0.05, 0.20)}

    def _init(self, draw):
        r, a = draw["radius"], draw["angle"]
        # target x = r sin(angle), y = r cos(angle)
        target = torch.stack([r * torch.sin(a), r * torch.cos(a)], -1)
        q = torch.cat([torch.stack([draw["shoulder"], draw["wrist"]], -1), target], -1)
        return q, torch.zeros_like(q)  # the target's "velocities" stay zero

    def _physics_step(self, q, qd, action):
        q2, qd2 = self._step_fn(q[:, :2], qd[:, :2], action)
        return torch.cat([q2, q[:, 2:]], -1), torch.cat([qd2, qd[:, 2:]], -1)

    def _to_target(self, q):
        pos, _ = engine.fk(self.model, q[:, :2])
        return q[:, 2:] - pos[:, _FINGER_BODY]

    def _obs(self, q, qd):
        return {"position": q[:, :2], "to_target": self._to_target(q), "velocity": qd[:, :2]}

    def _reward(self, q, qd, action):
        dist = torch.linalg.vector_norm(self._to_target(q), dim=-1)
        return rewards.tolerance(dist, (0.0, self.target_size + _FINGER_SIZE))
