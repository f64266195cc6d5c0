"""Planar walker: stand, walk, run (port of surreal_tpu/envs/walker.py).

Control timestep 0.025 s over physics dt 0.0025 s (10 substeps). Start
states: limited joints ~ U(range), unlimited hinges ~ U(−π, π). obs: per-body
(cos θ, sin θ), torso height, qvel. reward: (3·standing + upright)/4, times
(5·move + 1)/6 for the moving tasks.
"""

from __future__ import annotations

import os

import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_ASSET = os.path.join(base.ASSET_DIR, "walker.npz")

_STAND_HEIGHT = 1.2
_TORSO_Z = 1.3  # world z of the torso frame at q = 0


class Walker(base.Environment):
    episode_steps = 1000  # 25 s / 0.025 s control timestep

    def __init__(self, move_speed: float = 1.0, device: torch.device | str | None = None,
                 dtype=torch.float32):
        self.model = pmodel.load(_ASSET)
        self.move_speed = float(move_speed)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=10)

    def obs_spec(self):
        return {
            "orientations": base.ArraySpec((14,), self.dtype),
            "height": base.ArraySpec((), self.dtype),
            "velocity": base.ArraySpec((9,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((6,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        return base.draw_limited_and_rotational(self, batch, generator)

    def _init(self, draw):
        return base.init_limited_and_rotational(self, draw)

    def _physics_step(self, q, qd, action):
        return self._step_fn(q, qd, action)

    def _obs(self, q, qd):
        _, ang = engine.fk(self.model, q)
        orientations = torch.stack([torch.cos(ang), torch.sin(ang)], -1).reshape(q.shape[0], -1)
        height = q[:, 0] + _TORSO_Z  # rootz is dof 0 (slide along z)
        return {"orientations": orientations, "height": height, "velocity": qd}

    def _reward(self, q, qd, action):
        _, ang = engine.fk(self.model, q)
        torso_upright = torch.cos(ang[:, 0])
        height = q[:, 0] + _TORSO_Z
        standing = rewards.tolerance(
            height, bounds=(_STAND_HEIGHT, float("inf")), margin=_STAND_HEIGHT / 2)
        upright = (1 + torso_upright) / 2
        stand_reward = (3 * standing + upright) / 4
        if self.move_speed == 0:
            return stand_reward
        com_vx = engine.subtree_com_velocity(self.model, q, qd)[:, 0]
        move = rewards.tolerance(
            com_vx,
            bounds=(self.move_speed, float("inf")),
            margin=self.move_speed / 2,
            value_at_margin=0.5,
            sigmoid="linear",
        )
        return stand_reward * (5 * move + 1) / 6
