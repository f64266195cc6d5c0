"""Planar manipulator: bring_ball, bring_peg (port of
surreal_tpu/envs/manipulator.py).

A 4-joint arm in the vertical x-z plane with a two-finger hand (a tendon
"grasp" actuator closes both fingers, an equality row couples them) brings
a free prop to a target pose. Physics dt 0.001, control dt 0.01 (10
substeps); every constraint row kind but ropes and dof friction is reached
(ground, walls, 73 or 101 body-body pairs, limits, the equality).

- Start: K = 16 candidates of arm joints ~ U(range or ±π) with the finger
  set to the thumb, a target ~ U([−.4, .4] × [.1, .4]) at angle ~ U(−π, π),
  and the prop in the hand (p .1), at the target (p .1) or uniform with an
  x kick (p .8); the first candidate without penetration is taken.
- obs: arm (sin, cos) pairs, arm velocities, touch (log1p of the mean
  normal force on each sensor body, from the solver's impulses), hand,
  prop and target poses (x, z, cos a/2, sin a/2), prop velocity.
- reward: ball: tolerance(‖ball − target‖, (0, .01), margin .02); peg: the
  larger of bringing and grasping / 3.

The joint, body and site names come from the asset's metadata. q holds the
11 physics dofs, the target pose (3) and the touch readings (5).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base, rewards
from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics import model as pmodel

_NV = 11
_CLOSE = 0.01
_P_IN_HAND = 0.1
_P_IN_TARGET = 0.1
INIT_CANDIDATES = 16
# dm_control's named lookup order (not the model's)
_ARM_JOINTS = ["arm_root", "arm_shoulder", "arm_elbow", "arm_wrist",
               "finger", "fingertip", "thumb", "thumbtip"]
_TOUCH_BODIES = ["hand", "finger", "thumb", "fingertip", "thumbtip"]


class Manipulator(base.Environment):
    episode_steps = 1000  # 10 s / 0.01 s

    def __init__(self, prop: str = "ball", device: torch.device | str | None = None,
                 dtype=torch.float32):
        assert prop in ("ball", "peg")
        self.prop = prop
        asset = os.path.join(base.ASSET_DIR, f"manipulator_{prop}.npz")
        self.model = m = pmodel.load(asset)
        assert m.nv == _NV and m.neq == 1 and m.act_moment is not None
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n_substeps = 10
        self.control_dt = m.dt * self.n_substeps
        self._step_fn = engine.make_stepper(m, n_substeps=self.n_substeps,
                                            return_impulses=True)

        # --- name metadata from the baked asset ---
        z = np.load(asset, allow_pickle=False)
        joints = [str(s) for s in z["x_joint_names"]]
        bodies = [str(s) for s in z["x_body_names"]]
        sites = [str(s) for s in z["x_site_names"]]
        self._arm_idx = np.asarray([joints.index(j) for j in _ARM_JOINTS])
        self._obj_idx = np.asarray([joints.index(f"{prop}_{d}") for d in "xzy"])
        self._thumb_slot = _ARM_JOINTS.index("thumb")
        self._finger_slot = _ARM_JOINTS.index("finger")
        self._hand_b = bodies.index("hand")
        self._prop_b = bodies.index(prop)

        def site(name):
            s = sites.index(name)
            return int(z["x_site_body"][s]), np.asarray(z["x_site_pos"][s])

        hb, self._grasp_local = site("grasp")
        assert hb == self._hand_b
        if prop == "peg":
            self._site = {n: site(n) for n in (
                "grasp", "pinch", "peg", "peg_grasp", "peg_pinch", "peg_tip")}
            # the target sites' offsets in the target's frame
            self._target_offsets = {n: np.asarray(site(n)[1])
                                    for n in ("target_peg", "target_peg_tip")}

        # --- touch sensors: per-body masks over the impulse rows ---
        con_body = np.asarray(m.con_body)
        pair_body = np.asarray(m.geom_body)[np.asarray(m.pair_geoms)]  # (npair, 2)
        self._touch_masks = []
        for name in _TOUCH_BODIES:
            b = bodies.index(name)
            self._touch_masks.append({
                "ground": (con_body == b).astype(np.float32),
                "pair": np.any(pair_body == b, axis=1).astype(np.float32),
                "wall": np.tile((con_body == b), m.nwall).astype(np.float32),
            })

    def obs_spec(self):
        s = base.ArraySpec
        return {
            "arm_pos": s((16,), self.dtype),  # (sin, cos) per arm joint
            "arm_vel": s((8,), self.dtype),
            "touch": s((5,), self.dtype),
            "hand_pos": s((4,), self.dtype),  # x, z, qw, qy
            "object_pos": s((4,), self.dtype),
            "object_vel": s((3,), self.dtype),
            "target_pos": s((4,), self.dtype),
        }

    def action_spec(self):
        return base.ArraySpec((5,), self.dtype, -1.0, 1.0)

    def draw_reset(self, batch, generator):
        shape, g = (batch, INIT_CANDIDATES), generator
        u = lambda lo, hi: self._uniform(shape, g, lo, hi)  # noqa: E731
        return {"arm": self._uniform(shape + (8,), g),
                "tx": u(-0.4, 0.4), "tz": u(0.1, 0.4), "ta": u(-math.pi, math.pi),
                "r": u(0.0, 1.0), "ox": u(-0.5, 0.5), "oz": u(0.0, 0.7),
                "oa": u(0.0, 2 * math.pi), "vx": u(-5.0, 5.0)}

    def _index(self, which: str, like: torch.Tensor) -> torch.Tensor:
        """The arm's ("arm") or the prop's ("obj") joint indices on `like`'s
        device, cached."""
        idx = {"arm": self._arm_idx, "obj": self._obj_idx}[which]
        return engine._index(self.model, f"manip_{which}_idx", like, lambda: idx)

    def _candidates(self, draw):
        """(q (n, 11), qd (n, 11), target (n, 3)) of n = B·K candidates."""
        m = self.model
        d = {k: v.reshape(-1, *v.shape[2:]) for k, v in draw.items()}
        u = d["arm"]
        n = u.shape[0]
        arm = m.tensor("manip_arm_range", u, lambda: m.joint_range[self._arm_idx])
        limited = m.tensor("manip_arm_limited", u, lambda: m.limited[self._arm_idx]).bool()
        angles = torch.where(limited, arm[:, 0] + u * (arm[:, 1] - arm[:, 0]),
                             -math.pi + u * (2 * math.pi))
        angles = angles.clone()
        angles[:, self._finger_slot] = angles[:, self._thumb_slot]
        q_arm = u.new_zeros(n, _NV).index_copy(1, self._index("arm", u), angles)
        pos, ang = engine.fk(m, q_arm)
        grasp_w = pos[:, self._hand_b] + engine._rot(
            ang[:, self._hand_b], m.tensor("manip_grasp", u, lambda: self._grasp_local))
        # grasp direction = site xmat (xx, zx) = (cos φ, −sin φ);
        # object angle = π − atan2(dir_z, dir_x)
        phi = ang[:, self._hand_b]
        angle_ih = math.pi - torch.atan2(-torch.sin(phi), torch.cos(phi))
        r, tx, tz, ta = d["r"], d["tx"], d["tz"], d["ta"]
        in_hand = r < _P_IN_HAND
        in_target = (r >= _P_IN_HAND) & (r < _P_IN_HAND + _P_IN_TARGET)
        ox = torch.where(in_hand, grasp_w[:, 0], torch.where(in_target, tx, d["ox"]))
        oz = torch.where(in_hand, grasp_w[:, 1], torch.where(in_target, tz, d["oz"]))
        oa = torch.where(in_hand, angle_ih, torch.where(in_target, ta, d["oa"]))
        vx = torch.where(in_hand | in_target, torch.zeros_like(r), d["vx"])
        q = q_arm.index_copy(1, self._index("obj", u), torch.stack([ox, oz, oa], -1))
        qd = u.new_zeros(n, _NV)
        qd[:, int(self._obj_idx[0])] = vx
        return q, qd, torch.stack([tx, tz, ta], -1)

    def _init(self, draw):
        B, K = draw["r"].shape
        qs, qds, targets = self._candidates(draw)
        depths = engine.penetration(self.model, qs).reshape(B, K)
        q, qd, target = base.first_free(qs.reshape(B, K, _NV), depths,
                                        qds.reshape(B, K, _NV), targets.reshape(B, K, 3))
        return (torch.cat([q, target, q.new_zeros(B, 5)], -1),
                torch.cat([qd, qd.new_zeros(B, 8)], -1))

    def _physics_step(self, q, qd, action):
        q2, qd2, imp = self._step_fn(q[:, :_NV], qd[:, :_NV], action)
        touch = []
        for i, mk in enumerate(self._touch_masks):
            f = sum(torch.sum(self.model.tensor(f"touch_{i}_{k}", q, lambda mk=mk, k=k: mk[k])
                              * torch.clamp(imp[k], min=0.0), -1)
                    for k in ("ground", "pair", "wall"))
            touch.append(torch.log1p(f / self.control_dt))
        q_new = torch.cat([q2, q[:, _NV : _NV + 3], torch.stack(touch, -1)], -1)
        return q_new, torch.cat([qd2, qd2.new_zeros(q.shape[0], 8)], -1)

    def _obs(self, q, qd):
        q_phys, target, touch = q[:, :_NV], q[:, _NV : _NV + 3], q[:, _NV + 3 :]
        arm_q = q_phys[:, self._index("arm", q)]
        pos, ang = engine.fk(self.model, q_phys)

        def pose4(b):
            a = ang[:, b]
            return torch.cat([pos[:, b], torch.stack([torch.cos(a / 2), torch.sin(a / 2)], -1)],
                             -1)

        ta = target[:, 2]
        return {
            "arm_pos": torch.stack([torch.sin(arm_q), torch.cos(arm_q)], -1).reshape(-1, 16),
            "arm_vel": qd[:, self._index("arm", q)],
            "touch": touch,
            "hand_pos": pose4(self._hand_b),
            "object_pos": pose4(self._prop_b),
            "object_vel": qd[:, self._index("obj", q)],
            "target_pos": torch.stack(
                [target[:, 0], target[:, 1], torch.cos(ta / 2), torch.sin(ta / 2)], -1),
        }

    def _reward(self, q, qd, action):
        q_phys, target = q[:, :_NV], q[:, _NV : _NV + 3]
        pos, ang = engine.fk(self.model, q_phys)

        def is_close(d):
            return rewards.tolerance(d, (0.0, _CLOSE), margin=_CLOSE * 2)

        def norm(x):
            return torch.linalg.vector_norm(x, dim=-1)

        if self.prop == "ball":
            return is_close(norm(pos[:, self._prop_b] - target[:, :2]))

        def site_w(name):
            b, local = self._site[name]
            return pos[:, b] + engine._rot(
                ang[:, b], self.model.tensor(f"site_{name}", q, lambda: local))

        def target_w(name):
            off = self.model.tensor(f"site_{name}", q, lambda: self._target_offsets[name])
            return target[:, :2] + engine._rot(target[:, 2], off)

        grasping = (is_close(norm(site_w("peg_grasp") - site_w("grasp")))
                    + is_close(norm(site_w("peg_pinch") - site_w("pinch")))) / 2.0
        bringing = (is_close(norm(site_w("peg") - target_w("target_peg")))
                    + is_close(norm(target_w("target_peg_tip") - site_w("peg_tip")))) / 2.0
        return torch.maximum(bringing, grasping / 3.0)
