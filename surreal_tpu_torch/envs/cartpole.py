"""Cartpole with 1, 2 or 3 poles (port of surreal_tpu/envs/cartpole.py).

balance[_sparse]: cart ~ U(−.1, .1), hinges ~ U(−.034, .034); swingup[_sparse]
and the multi-pole tasks: cart 0.01·N, first hinge π + 0.01·N, the others
0.1·N; qvel 0.01·N in every case. obs: cart x and per-pole (cos, sin) of the
world angle (hinge prefix sums) + qvel. Dense reward: upright · small_control
· small_velocity · centered; sparse: cart and every pole in bounds. RK4 at
dt 0.01, one substep.
"""

from __future__ import annotations

import math
import os

import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel


class Cartpole(base.Environment):
    episode_steps = 1000  # 10 s / 0.01 s control timestep

    def __init__(self, swing_up: bool = False, sparse: bool = False, n_poles: int = 1,
                 device: torch.device | str | None = None, dtype=torch.float32):
        name = "cartpole.npz" if n_poles == 1 else f"cartpole_{n_poles}.npz"
        self.model = pmodel.load(os.path.join(base.ASSET_DIR, name))
        self.swing_up = swing_up
        self.sparse = sparse
        self.n_poles = n_poles
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(self.model, n_substeps=1)

    def obs_spec(self):
        return {
            "position": base.ArraySpec((1 + 2 * self.n_poles,), self.dtype),
            "velocity": base.ArraySpec((1 + self.n_poles,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((1,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        n, g = self.n_poles, generator
        if self.swing_up:
            draw = {"x": 0.01 * self._normal((batch,), g),
                    "theta": math.pi + 0.01 * self._normal((batch,), g),
                    "rest": 0.1 * self._normal((batch, n - 1), g)}
        else:
            draw = {"x": self._uniform((batch,), g, -0.1, 0.1),
                    "theta": self._uniform((batch,), g, -0.034, 0.034),
                    "rest": self._uniform((batch, n - 1), g, -0.034, 0.034)}
        draw["qd"] = 0.01 * self._normal((batch, 1 + n), g)
        return draw

    def _init(self, draw):
        q = torch.cat([torch.stack([draw["x"], draw["theta"]], -1), draw["rest"]], -1)
        return q, draw["qd"]

    def _physics_step(self, q, qd, action):
        return self._step_fn(q, qd, action)

    def _world_angles(self, q):
        """World rotation of each pole body: hinge prefix sums."""
        return torch.cumsum(q[:, 1:], -1)

    def _obs(self, q, qd):
        phi = self._world_angles(q)
        pairs = torch.stack([torch.cos(phi), torch.sin(phi)], -1).reshape(q.shape[0], -1)
        return {"position": torch.cat([q[:, :1], pairs], -1), "velocity": qd}

    def _reward(self, q, qd, action):
        x = q[:, 0]
        cos_phi = torch.cos(self._world_angles(q))
        ctrl = torch.clamp(action, -1.0, 1.0)
        if self.sparse:
            cart_in_bounds = rewards.tolerance(x, (-0.25, 0.25))
            angle_in_bounds = torch.prod(rewards.tolerance(cos_phi, (0.995, 1.0)), -1)
            return cart_in_bounds * angle_in_bounds
        upright = torch.mean((cos_phi + 1) / 2, -1)
        centered = (1 + rewards.tolerance(x, margin=2)) / 2
        small_control = (
            4 + rewards.tolerance(ctrl[:, 0], margin=1, value_at_margin=0, sigmoid="quadratic")
        ) / 5
        small_velocity = (1 + torch.amin(rewards.tolerance(qd[:, 1:], margin=5), -1)) / 2
        return upright * small_control * small_velocity * centered
