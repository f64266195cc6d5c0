"""Pendulum swingup and acrobot swingup[_sparse] (port of
surreal_tpu/envs/classic.py).

pendulum: hinge ~ U(−π, π); obs (cos θ, sin θ) + qvel; reward
tolerance(cos θ, (cos 8°, 1)). acrobot (RK4): both joints ~ U(−π, π); obs
per-arm (sin, cos) + qvel; reward tolerance(‖tip − target‖, (0, 0.2),
margin 1, or 0 when sparse).
"""

from __future__ import annotations

import math
import os

import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_COSINE_BOUND = math.cos(math.radians(8.0))


class PendulumSwingup(base.Environment):
    episode_steps = 1000  # 20 s / 0.02 s

    def __init__(self, device: torch.device | str | None = None, dtype=torch.float32):
        self.model = pmodel.load(os.path.join(base.ASSET_DIR, "pendulum.npz"))
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=1)

    def obs_spec(self):
        return {
            "orientation": base.ArraySpec((2,), self.dtype),
            "velocity": base.ArraySpec((1,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((1,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        return {"theta": self._uniform((batch, 1), generator, -math.pi, math.pi)}

    def _init(self, draw):
        return draw["theta"], torch.zeros_like(draw["theta"])

    def _physics_step(self, q, qd, action):
        return self._step_fn(q, qd, action)

    def _obs(self, q, qd):
        return {"orientation": torch.stack([torch.cos(q[:, 0]), torch.sin(q[:, 0])], -1),
                "velocity": qd}

    def _reward(self, q, qd, action):
        return rewards.tolerance(torch.cos(q[:, 0]), (_COSINE_BOUND, 1.0))


class AcrobotSwingup(base.Environment):
    episode_steps = 1000  # 10 s / 0.01 s
    _TARGET = (0.0, 4.0)  # world (x, z) of the target site
    _TARGET_RADIUS = 0.2
    _TIP_LOCAL = (0.0, 1.0)  # tip site in the lower arm's frame

    def __init__(self, sparse: bool = False, device: torch.device | str | None = None,
                 dtype=torch.float32):
        self.model = pmodel.load(os.path.join(base.ASSET_DIR, "acrobot.npz"))
        self.sparse = sparse
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=1)

    def obs_spec(self):
        return {
            "orientations": base.ArraySpec((4,), self.dtype),
            "velocity": base.ArraySpec((2,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((1,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        return {"q": self._uniform((batch, 2), generator, -math.pi, math.pi)}

    def _init(self, draw):
        return draw["q"], torch.zeros_like(draw["q"])

    def _physics_step(self, q, qd, action):
        return self._step_fn(q, qd, action)

    def _tip(self, q):
        pos, ang = engine.fk(self.model, q)
        tip = self.model.tensor("acrobot_tip", q, lambda: self._TIP_LOCAL)
        return pos[:, 1] + engine._rot(ang[:, 1], tip)

    def _obs(self, q, qd):
        _, ang = engine.fk(self.model, q)
        # horizontal = xmat xz (= sin θ), vertical = xmat zz (= cos θ)
        return {"orientations": torch.cat([torch.sin(ang), torch.cos(ang)], -1), "velocity": qd}

    def _reward(self, q, qd, action):
        target = self.model.tensor("acrobot_target", q, lambda: self._TARGET)
        dist = torch.linalg.vector_norm(target - self._tip(q), dim=-1)
        return rewards.tolerance(dist, (0.0, self._TARGET_RADIUS),
                                 margin=0.0 if self.sparse else 1.0)
