"""Ball in cup, catch (port of surreal_tpu/envs/ball_in_cup.py): an actuated
planar cup swings a ball on a 0.3 m string (a rope row) and must catch it
(ball against the cup's five wall capsules: pair rows).

Physics dt 0.002, control dt 0.02 (10 substeps). Start: cup at rest, ball
x ~ U(−.2, .2), z ~ U(.2, .5), the first of K = 8 candidates without
penetration. obs: qpos, qvel. reward: 1 when the ball centre is inside the
target box in the cup by more than its radius.
"""

from __future__ import annotations

import os

import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_ASSET = os.path.join(base.ASSET_DIR, "ball_in_cup.npz")

_CUP_BODY_POS = (0.0, 0.6)
_BALL_BODY_POS = (0.0, 0.2)
_TARGET_IN_CUP = (0.0, -0.05)  # target site, cup frame
_TARGET_HALF = 0.05  # the site's half size in x and z
_BALL_RADIUS = 0.025
INIT_CANDIDATES = 8


class BallInCup(base.Environment):
    episode_steps = 1000  # 20 s / 0.02 s

    def __init__(self, device: torch.device | str | None = None, dtype=torch.float32):
        self.model = pmodel.load(_ASSET)
        assert self.model.npair == 5 and self.model.nrope == 1
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=10)

    def obs_spec(self):
        return {
            "position": base.ArraySpec((4,), self.dtype),
            "velocity": base.ArraySpec((4,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((2,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        K = INIT_CANDIDATES
        return {"bx": self._uniform((batch, K), generator, -0.2, 0.2),
                "bz": self._uniform((batch, K), generator, 0.2, 0.5)}

    def _init(self, draw):
        bx, bz = draw["bx"], draw["bz"]
        zero = torch.zeros_like(bx)
        qs = torch.stack([zero, zero, bx, bz], -1)  # (B, K, 4)
        B, K = bx.shape
        depth = torch.amax(engine._pair_kinematics(self.model, qs.reshape(B * K, 4))[2], 1)
        q = base.first_free(qs, depth.reshape(B, K))
        return q, torch.zeros_like(q)

    def _physics_step(self, q, qd, action):
        return self._step_fn(q, qd, action)

    def _obs(self, q, qd):
        return {"position": q, "velocity": qd}

    def _reward(self, q, qd, action):
        t = lambda name, v: self.model.tensor(name, q, lambda: v)  # noqa: E731
        cup = t("cup_pos", _CUP_BODY_POS) + q[:, :2]
        ball = t("ball_pos", _BALL_BODY_POS) + q[:, 2:]
        target = cup + t("cup_target", _TARGET_IN_CUP)
        gap = torch.abs(target - ball)
        return torch.all(gap < (_TARGET_HALF - _BALL_RADIUS), -1).to(q.dtype)
