"""Swimmer with 6 or 15 links (port of surreal_tpu/envs/swimmer.py): a planar
chain in the horizontal plane, propelled by quadratic fluid drag.

Physics dt 0.002, control dt 0.03 (15 substeps). Start: limited joints
~ U(range), root angle ~ U(−π, π), root slides 0; the target ~ U(−.3, .3)²
with probability .2, else U(−2, 2)², appended to q as two frozen
coordinates. obs: joint angles, target − nose in the head frame, per-body
local (vx, vy, ωz). reward: tolerance(‖nose → target‖, (0, .1), margin .5,
long_tail).
"""

from __future__ import annotations

import math
import os

import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_TARGET_SIZE = 0.1
_NOSE = (0.0, -0.06)  # head-local nose geom position


class Swimmer(base.Environment):
    episode_steps = 1000  # 30 s / 0.03 s

    def __init__(self, n_links: int = 6, device: torch.device | str | None = None,
                 dtype=torch.float32):
        self.model = pmodel.load(os.path.join(base.ASSET_DIR, f"swimmer{n_links}.npz"))
        assert self.model.plane == "xy" and self.model.has_fluid
        self.n_links = n_links
        self.dtype = dtype
        self.device = resolve_device(device)
        self._nv = self.model.nv
        self._step_fn = engine.make_stepper(self.model, n_substeps=15)

    def obs_spec(self):
        return {
            "joints": base.ArraySpec((self._nv - 3,), self.dtype),
            "to_target": base.ArraySpec((2,), self.dtype),
            "body_velocities": base.ArraySpec((3 * self.model.nb,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((self.model.nu,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        rng = self._joint_range()[3:]
        g = generator
        return {"rootz": self._uniform((batch,), g, -math.pi, math.pi),
                "joints": self._uniform((batch, self._nv - 3), g, rng[:, 0], rng[:, 1]),
                "close": self._uniform((batch,), g) < 0.2,
                "target": self._uniform((batch, 2), g, -1.0, 1.0)}

    def _init(self, draw):
        box = torch.where(draw["close"], 0.3, 2.0).to(self.dtype)
        target = draw["target"] * box[:, None]
        rootz = draw["rootz"]
        q = torch.cat([rootz.new_zeros(rootz.shape[0], 2), rootz[:, None], draw["joints"],
                       target], -1)
        return q, torch.zeros_like(q)

    def _physics_step(self, q, qd, action):
        nv = self._nv
        q2, qd2 = self._step_fn(q[:, :nv], qd[:, :nv], action)
        return torch.cat([q2, q[:, nv:]], -1), torch.cat([qd2, qd[:, nv:]], -1)

    def _to_target(self, q):
        """(target − nose) in the head frame."""
        nv = self._nv
        pos, ang = engine.fk(self.model, q[:, :nv])
        nose = pos[:, 0] + engine._rot(ang[:, 0], self.model.tensor("swimmer_nose", q,
                                                                    lambda: _NOSE))
        return engine._rot(-ang[:, 0], q[:, nv:] - nose)

    def _obs(self, q, qd):
        nv = self._nv
        # site sensors: per-body local (vx, vy) of the frame origin and ωz;
        # the engine's angle is the negated MuJoCo angle in this plane
        (pos, ang, _, _), (pos_dot, ang_dot, _, _) = engine.fk_dofs_dot(
            self.model, q[:, :nv], qd[:, :nv])
        v_local = engine._rot(-ang, pos_dot)  # (B, nb, 2)
        body_vel = torch.cat([v_local, -ang_dot[..., None]], -1).reshape(q.shape[0], -1)
        return {"joints": q[:, 3:nv], "to_target": self._to_target(q),
                "body_velocities": body_vel}

    def _reward(self, q, qd, action):
        dist = torch.linalg.vector_norm(self._to_target(q), dim=-1)
        return rewards.tolerance(dist, (0.0, _TARGET_SIZE), margin=5 * _TARGET_SIZE,
                                 sigmoid="long_tail")
