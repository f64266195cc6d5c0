"""Finger: spin, turn_easy, turn_hard (port of surreal_tpu/envs/finger.py).

A 2-dof planar finger (gravity off) strikes a hinge-mounted spinner through
body-body contact; the spinner hinge has dry friction. Physics dt 0.01,
control dt 0.02 (2 substeps), impulses through the implicitly damped metric
and a stiff pair push-out (contact timeconst 0.0025), as the reference sets.

- Start: K = 8 candidates of proximal, distal ~ U(range) and hinge
  ~ U(−π, π); the first without penetration is taken (else the shallowest).
- obs: (proximal, distal, spinner tip − spinner), qvel, touch = log1p of the
  fingertip's contact force split by the side of the distal frame the
  contact lies on (from the solver's impulses over the control step).
- spin: hinge damping .03; reward 1 when the hinge turns at ≤ −15 rad/s.
- turn: target on the circle of radius .13 around the hinge; obs adds its
  position and the tip's distance to it; reward 1 inside the target.

q = [proximal, distal, hinge, touch_top, touch_bottom (, target x, z)]: the
touch readings and the target ride along as extra coordinates.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_ASSET = os.path.join(base.ASSET_DIR, "finger.npz")

_CTRL_DT = 0.02
_SPIN_VELOCITY = 15.0
_TIP_IN_SPINNER = (0.0, 0.13)  # 'tip' site, spinner frame
_SPINNER_POS = (0.2, 0.4)  # spinner body origin (= hinge anchor)
_TARGET_RADIUS_FROM_HINGE = 0.13
_DISTAL_BODY = 1
_SPINNER_BODY = 2
INIT_CANDIDATES = 8


class Finger(base.Environment):
    episode_steps = 1000  # 20 s / 0.02 s

    def __init__(self, task: str = "spin", target_radius: float = 0.07,
                 device: torch.device | str | None = None, dtype=torch.float32):
        assert task in ("spin", "turn")
        m = pmodel.load(_ASSET)
        m = m.replace(implicit_impulse=True, contact_timeconst=0.0025)
        if task == "spin":
            damping = m.damping.copy()
            damping[2] = 0.03  # the hinge damping of the spin task
            m = m.replace(damping=damping)
        self.model = m
        self.task = task
        self.target_radius = float(target_radius)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_fn = engine.make_stepper(m, n_substeps=2, return_impulses=True)
        # pairs whose first geom is the fingertip (body 1 = distal)
        gb = np.asarray(m.geom_body)
        self._tip_pairs = np.flatnonzero(gb[np.asarray(m.pair_geoms[:, 0])] == 1)
        assert len(self._tip_pairs) == 2
        self._nq = 5 + (2 if task == "turn" else 0)

    def obs_spec(self):
        spec = {
            "position": base.ArraySpec((4,), self.dtype),
            "velocity": base.ArraySpec((3,), self.dtype),
            "touch": base.ArraySpec((2,), self.dtype),
        }
        if self.task == "turn":
            spec["target_position"] = base.ArraySpec((2,), self.dtype)
            spec["dist_to_target"] = base.ArraySpec((), self.dtype)
        return spec

    def action_spec(self):
        return base.ArraySpec((2,), self.dtype, -1.0, 1.0)

    def _spinner_tip(self, q_phys):
        pos, ang = engine.fk(self.model, q_phys)
        s = pos[:, _SPINNER_BODY]
        tip = s + engine._rot(ang[:, _SPINNER_BODY],
                              self.model.tensor("finger_tip", q_phys, lambda: _TIP_IN_SPINNER))
        return tip - s, pos  # tip relative to the spinner

    def _touch_from_impulses(self, q_phys, imp):
        """Fingertip impulses as (top, bottom) site forces, by the side of
        the distal frame (sites at x = ±.01) the contact point lies on."""
        m = self.model
        fkd = engine.fk_dofs(m, q_phys)
        pos, ang, _, _ = fkd
        p0w, p1w = engine._geom_segments(m, q_phys, fkd)
        tips = engine._index(m, "finger_tip_pairs", q_phys, lambda: self._tip_pairs)
        ia, ib = (engine._index(m, f"finger_tip_geom_{s}", q_phys,
                                lambda s=s: m.pair_geoms[self._tip_pairs, s]) for s in (0, 1))
        c_a, c_b = engine._seg_seg_closest(p0w[:, ia], p1w[:, ia], p0w[:, ib], p1w[:, ib])
        mid = 0.5 * (c_a + c_b)
        u = engine._rot(-ang[:, _DISTAL_BODY, None], mid - pos[:, _DISTAL_BODY, None])
        is_top = (u[..., 0] > 0).to(q_phys.dtype)
        force = imp["pair"][:, tips] / _CTRL_DT
        return torch.stack([torch.sum(force * is_top, -1), torch.sum(force * (1 - is_top), -1)],
                           -1)

    def draw_reset(self, batch, generator):
        rng = self._joint_range()[:2]
        K, g = INIT_CANDIDATES, generator
        draw = {"joints": self._uniform((batch, K, 2), g, rng[:, 0], rng[:, 1]),
                "hinge": self._uniform((batch, K, 1), g, -math.pi, math.pi)}
        if self.task == "turn":
            draw["target_angle"] = self._uniform((batch,), g, -math.pi, math.pi)
        return draw

    def _init(self, draw):
        m = self.model
        qs = torch.cat([draw["joints"], draw["hinge"]], -1)  # (B, K, 3)
        B, K, _ = qs.shape
        flat = qs.reshape(B * K, 3)
        fkd = engine.fk_dofs(m, flat)
        pdepth = torch.amax(engine._pair_kinematics(m, flat, fkd=fkd)[2], 1)
        gdepth = torch.amax(engine._contact_kinematics(m, flat, fkd=fkd)[1], 1)
        q_phys = base.first_free(qs, torch.maximum(pdepth, gdepth).reshape(B, K))
        extras = [q_phys.new_zeros(B, 2)]  # touch
        if self.task == "turn":
            angle = draw["target_angle"]
            centre = m.tensor("finger_spinner_pos", q_phys, lambda: _SPINNER_POS)
            extras.append(centre + _TARGET_RADIUS_FROM_HINGE * torch.stack(
                [torch.sin(angle), torch.cos(angle)], -1))
        q = torch.cat([q_phys] + extras, -1)
        return q, torch.zeros_like(q)

    def _physics_step(self, q, qd, action):
        q2, qd2, imp = self._step_fn(q[:, :3], qd[:, :3], action)
        parts = [q2, self._touch_from_impulses(q2, imp)]
        if self.task == "turn":
            parts.append(q[:, 5:])
        return torch.cat(parts, -1), torch.cat([qd2, qd2.new_zeros(q.shape[0], self._nq - 3)], -1)

    def _obs(self, q, qd):
        tip_rel, pos = self._spinner_tip(q[:, :3])
        obs = {
            "position": torch.cat([q[:, :2], tip_rel], -1),
            "velocity": qd[:, :3],
            "touch": torch.log1p(torch.clamp(q[:, 3:5], min=0.0)),
        }
        if self.task == "turn":
            target_rel = q[:, 5:] - pos[:, _SPINNER_BODY]
            obs["target_position"] = target_rel
            obs["dist_to_target"] = (torch.linalg.vector_norm(target_rel - tip_rel, dim=-1)
                                     - self.target_radius)
        return obs

    def _reward(self, q, qd, action):
        if self.task == "spin":
            return (qd[:, 2] <= -_SPIN_VELOCITY).to(q.dtype)
        tip_rel, pos = self._spinner_tip(q[:, :3])
        target_rel = q[:, 5:] - pos[:, _SPINNER_BODY]
        dist = torch.linalg.vector_norm(target_rel - tip_rel, dim=-1) - self.target_radius
        return (dist <= 0).to(q.dtype)

