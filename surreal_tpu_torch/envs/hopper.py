"""Hopper: stand, hop (port of surreal_tpu/envs/hopper.py).

Control dt 0.02 over physics dt 0.005 (4 substeps); start states as the
walker's. obs: qpos[1:], qvel, touch = log1p of the toe and heel contact
forces, estimated quasi-statically from the solver's constraint law,
F ≈ depth / (w · timeconst²) with w the contact's inverse effective mass.
stand: tolerance(height, (0.6, 2)) × (small_control + 4)/5; hop: the same
height term × tolerance(speed, (2, inf), margin 1, 0.5, linear).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_ASSET = os.path.join(base.ASSET_DIR, "hopper.npz")

_STAND_HEIGHT = 0.6
_HOP_SPEED = 2.0


class Hopper(base.Environment):
    episode_steps = 1000  # 20 s / 0.02 s control timestep

    def __init__(self, hopping: bool = False, device: torch.device | str | None = None,
                 dtype=torch.float32):
        self.model = pmodel.load(_ASSET)
        self.hopping = hopping
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=4)
        # torso body index 0, foot body index 4 (torso, pelvis, thigh, calf, foot)
        self._torso, self._foot = 0, 4
        # toe / heel: the foot capsule's end points, larger / smaller local x
        cb = np.asarray(self.model.con_body)
        foot_pts = np.where(cb == self._foot)[0]
        xs = self.model.con_pos[foot_pts, 0]
        self._toe = int(foot_pts[np.argmax(xs)])
        self._heel = int(foot_pts[np.argmin(xs)])

    def obs_spec(self):
        return {
            "position": base.ArraySpec((6,), self.dtype),
            "velocity": base.ArraySpec((7,), self.dtype),
            "touch": base.ArraySpec((2,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((4,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        return base.draw_limited_and_rotational(self, batch, generator)

    def _init(self, draw):
        return base.init_limited_and_rotational(self, draw)

    def _physics_step(self, q, qd, action):
        return self._step_fn(q, qd, action)

    def _touch(self, q):
        m = self.model
        J, depth = engine._contact_kinematics(m, q)
        # inv_ex: `inv`'s arithmetic without its check of the info, a host
        # sync that a CUDA graph cannot capture (M is SPD)
        M_inv = torch.linalg.inv_ex(engine.mass_matrix(m, q)).inverse
        Jn = J[:, :, 1, :]
        w = torch.clamp(torch.einsum("ncv,nvu,ncu->nc", Jn, M_inv, Jn), min=1e-9)
        force = torch.clamp(depth, min=0.0) / (w * m.contact_timeconst**2)
        return torch.log1p(torch.stack([force[:, self._toe], force[:, self._heel]], -1))

    def _obs(self, q, qd):
        return {"position": q[:, 1:], "velocity": qd, "touch": self._touch(q)}

    def _height(self, q):
        coms = engine.com_positions(self.model, q)
        return coms[:, self._torso, 1] - coms[:, self._foot, 1]

    def _reward(self, q, qd, action):
        standing = rewards.tolerance(self._height(q), (_STAND_HEIGHT, 2.0))
        if self.hopping:
            speed = engine.subtree_com_velocity(self.model, q, qd)[:, 0]
            hopping = rewards.tolerance(
                speed, bounds=(_HOP_SPEED, float("inf")), margin=_HOP_SPEED / 2,
                value_at_margin=0.5, sigmoid="linear",
            )
            return standing * hopping
        ctrl = torch.clamp(action, -1.0, 1.0)
        small_control = torch.mean(
            rewards.tolerance(ctrl, margin=1, value_at_margin=0, sigmoid="quadratic"), -1)
        return standing * (small_control + 4.0) / 5.0
