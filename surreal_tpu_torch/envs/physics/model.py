"""Planar articulated rigid-body model description (port of
surreal_tpu/envs/physics/model.py): the dataclass, `from_mujoco`, which
extracts one from a compiled `mujoco.MjModel` (numpy only; mujoco is
imported inside it), and the baked-asset `save` and `load`.

The model holds small NumPy constants. Engine functions need them as
tensors on the state's device; `PlanarModel.tensor` converts each field
(and each index) once per (device, dtype) and keeps it on the instance, so
a step copies nothing from the host and can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

SLIDE = 0
HINGE = 1


@dataclasses.dataclass(frozen=True, eq=False)
class PlanarModel:
    # --- bodies (nb entries; world excluded; parents precede children) ---
    parent: tuple[int, ...]
    body_pos: np.ndarray  # (nb, 2)
    mass: np.ndarray  # (nb,)
    com: np.ndarray  # (nb, 2)
    inertia: np.ndarray  # (nb,)

    # --- degrees of freedom (nv entries, MuJoCo dof order) ---
    dof_body: tuple[int, ...]
    dof_type: tuple[int, ...]  # SLIDE or HINGE
    dof_axis: np.ndarray  # (nv, 2) slide: unit planar axis; hinge: (sign, 0)
    dof_anchor: np.ndarray  # (nv, 2)
    damping: np.ndarray
    armature: np.ndarray
    stiffness: np.ndarray
    springref: np.ndarray
    limited: np.ndarray  # (nv,) bool
    joint_range: np.ndarray  # (nv, 2)

    # --- actuators (nu entries) ---
    act_dof: tuple[int, ...]
    gear: np.ndarray

    # --- ground contact candidate spheres (ncon entries) ---
    con_body: tuple[int, ...]
    con_pos: np.ndarray  # (ncon, 2)
    con_radius: np.ndarray
    con_friction: np.ndarray

    # --- options ---
    dt: float
    gravity: float = 9.81
    integrator: str = "euler"
    plane: str = "xz"
    contact_timeconst: float = 0.02
    limit_timeconst: float = 0.02
    pair_beta: float = 0.5
    pair_push: str = "soft"
    pair_cone: bool = True
    implicit_impulse: bool = False

    # --- optional fields (see the reference model.py for their meaning) ---
    body_angle: np.ndarray | None = None
    geom_body: tuple[int, ...] = ()
    geom_p0: np.ndarray | None = None
    geom_p1: np.ndarray | None = None
    geom_radius: np.ndarray | None = None
    geom_friction: np.ndarray | None = None
    pair_geoms: np.ndarray | None = None
    rope_body: np.ndarray | None = None
    rope_pos: np.ndarray | None = None
    rope_max: np.ndarray | None = None
    frictionloss: np.ndarray | None = None
    dof_ref: np.ndarray | None = None
    act_moment: np.ndarray | None = None
    eq_moment: np.ndarray | None = None
    eq_ref: np.ndarray | None = None
    eq_timeconst: float = 0.02
    wall_normal: np.ndarray | None = None
    wall_offset: np.ndarray | None = None
    fluid_lin: np.ndarray | None = None
    fluid_ang: np.ndarray | None = None
    fluid_visc_lin: np.ndarray | None = None
    fluid_visc_ang: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "_tensors", {})

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def nv(self) -> int:
        return len(self.dof_body)

    @property
    def nu(self) -> int:
        return len(self.act_dof)

    @property
    def ncon(self) -> int:
        return len(self.con_body)

    @property
    def npair(self) -> int:
        return 0 if self.pair_geoms is None else len(self.pair_geoms)

    @property
    def nrope(self) -> int:
        return 0 if self.rope_body is None else len(self.rope_body)

    @property
    def neq(self) -> int:
        return 0 if self.eq_moment is None else len(self.eq_moment)

    @property
    def nwall(self) -> int:
        return 0 if self.wall_normal is None else len(self.wall_normal)

    @property
    def has_dof_friction(self) -> bool:
        return self.frictionloss is not None and bool(np.any(self.frictionloss > 0))

    @property
    def has_fluid(self) -> bool:
        return self.fluid_lin is not None

    @property
    def body_angles(self) -> np.ndarray:
        return np.zeros(self.nb) if self.body_angle is None else self.body_angle

    @property
    def dof_refs(self) -> np.ndarray:
        return np.zeros(self.nv) if self.dof_ref is None else self.dof_ref

    @property
    def total_mass(self) -> float:
        return float(np.sum(self.mass))

    @property
    def body_dofs(self) -> tuple[tuple[int, ...], ...]:
        out: list[list[int]] = [[] for _ in range(self.nb)]
        for j, b in enumerate(self.dof_body):
            out[b].append(j)
        return tuple(tuple(x) for x in out)

    def replace(self, **kw) -> "PlanarModel":
        return dataclasses.replace(self, **kw)

    def tensor(self, name: str, like: torch.Tensor,
               make: Callable[[], np.ndarray] | None = None,
               dtype: torch.dtype | None = None) -> torch.Tensor:
        """Field `name` (or the array `make()` derives from the model) as a
        tensor on `like`'s device and dtype (or `dtype`: torch.long for an
        index), converted once and cached."""
        dtype = like.dtype if dtype is None else dtype
        key = (name, like.device, dtype)
        t = self._tensors.get(key)
        if t is None:
            arr = make() if make is not None else getattr(self, name)
            t = torch.as_tensor(np.asarray(arr), device=like.device).to(dtype)
            self._tensors[key] = t
        return t


def _quat_to_yangle(quat: Sequence[float]) -> float:
    """Angle about +y for a quaternion of the form (w, 0, qy, 0)."""
    w, qx, qy, qz = quat
    assert abs(qx) < 1e-8 and abs(qz) < 1e-8, f"non-planar quat {quat}"
    return 2.0 * float(np.arctan2(qy, w))


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def mj_flip_flags(m, normal: int) -> list[bool]:
    """Per-mj-body 'frame is mirrored' flags (index 0 = world, always
    False): True when the cumulative qpos0 orientation flips the plane
    normal. Mirrors the canonicalization inside `from_mujoco`; used by
    bake-time site/metadata extraction so site positions live in the same
    canonical frames as the baked model constants."""
    A = [np.eye(3)]
    for b in range(1, m.nbody):
        A.append(A[m.body_parentid[b]] @ _quat_to_mat(m.body_quat[b]))
    return [bool(Ab[normal, normal] < 0) for Ab in A]


def from_mujoco(
    m, contact_bodies: str = "all", pair_collisions: bool = False
) -> PlanarModel:
    """Extract a PlanarModel from a compiled `mujoco.MjModel`.

    Used offline to bake the assets (the reference's tools/bake_assets.py)
    and in parity tests — the training path loads baked .npz assets and
    never imports mujoco.

    Asserts the model really is planar (slide axes in the x-z plane, hinge
    axes ±y, no out-of-plane body offsets that matter, single-dof joints).

    `pair_collisions=True` additionally extracts body-body capsule/sphere
    contact pairs (MuJoCo's contype/conaffinity + parent-child filter).
    Off by default: the locomotion domains (cheetah, walker, hopper)
    nominally allow self-collision pairs but never hit them in practice
    (verified: 0 body-body contacts over long random-action MuJoCo
    rollouts), so the extra constraint rows would only slow the hot path.
    Manipulation domains (ball_in_cup, finger, manipulator) require them.
    """
    import mujoco  # local import: optional dependency

    nb = m.nbody - 1  # drop world

    # Plane detection: hinge axes ±y → "xz" plane (locomotion; gravity
    # in-plane), hinge axes ±z → "xy" plane (manipulation; gravity ⊥ plane,
    # so in-plane gravity is zero). The engine's R(θ) convention matches a
    # +y rotation in (x, z); a +z rotation in (x, y) is its mirror, so xy
    # hinges carry a NEGATED sign.
    hinge_axes = [m.jnt_axis[j] for j in range(m.njnt)
                  if m.jnt_type[j] == mujoco.mjtJoint.mjJNT_HINGE]
    slide_axes = [m.jnt_axis[j] for j in range(m.njnt)
                  if m.jnt_type[j] == mujoco.mjtJoint.mjJNT_SLIDE]
    # xy plane: all hinges about ±z; or (hinge-less, e.g. point_mass) any
    # slide along y — impossible in the xz plane.
    xy_by_slides = not hinge_axes and any(abs(a[1]) > 1e-8 for a in slide_axes)
    if xy_by_slides or (
        hinge_axes and all(abs(a[0]) < 1e-8 and abs(a[1]) < 1e-8 for a in hinge_axes)
    ):
        plane = "xy"
        cols = [0, 1]
        normal = 2
        hinge_sign = lambda ax: -np.sign(ax[normal])
        gravity = 0.0
        assert abs(m.opt.gravity[0]) < 1e-8 and abs(m.opt.gravity[1]) < 1e-8
        contact_bodies = "none"  # the world ground plane is ⊥ to this plane
    else:
        plane = "xz"
        cols = [0, 2]
        normal = 1
        hinge_sign = lambda ax: np.sign(ax[normal])
        gravity = float(-m.opt.gravity[2])
        if m.opt.disableflags & mujoco.mjtDisableBit.mjDSBL_GRAVITY:
            gravity = 0.0

    def bid(mj_body):  # mujoco body id -> planar body index
        return mj_body - 1

    # --- frame canonicalization: MIRRORED body frames -> rotations ---
    # Some models (dm_control manipulator's `finger`, euler="0 90 180")
    # attach bodies with a frame whose in-plane 2x2 block is a REFLECTION
    # (the cumulative rotation flips the plane normal). The planar engine
    # only represents rotations, so such frames are canonicalized offline:
    # post-multiply every flipped body's frame by S = diag(1,-1,-1) (a 180°
    # rotation about x — det +1), which restores +normal while re-expressing
    # all body-local constants p as S @ p and flipping local hinge senses.
    # This is exact: C_b = A_b @ S_b is a pure in-plane rotation, and every
    # local quantity is mapped through the accompanying change of basis.
    S_FLIP = np.diag([1.0, -1.0, -1.0])
    A = [np.eye(3)]  # cumulative body orientation at qpos=0; index 0 = world
    for b in range(1, m.nbody):
        A.append(A[m.body_parentid[b]] @ _quat_to_mat(m.body_quat[b]))
    flipped = [False]  # world
    for b in range(1, m.nbody):
        nn = A[b][normal, normal]
        assert abs(abs(nn) - 1.0) < 1e-6, f"non-planar cumulative frame, body {b}"
        flipped.append(nn < 0)

    def S_of(mj_body: int) -> np.ndarray:
        return S_FLIP if flipped[mj_body] else np.eye(3)

    def planar_angle_of_body(b: int) -> float:
        """Canonicalized local angle of mj body b relative to its parent:
        angle of S_parent @ R_local @ S_b, which has det +1 by construction."""
        M = S_of(m.body_parentid[b]) @ _quat_to_mat(m.body_quat[b]) @ S_of(b)
        # must be a pure rotation about the plane normal
        for ax in range(3):
            if ax != normal:
                assert abs(M[normal, ax]) < 1e-6 and abs(M[ax, normal]) < 1e-6, (
                    f"non-planar body frame after canonicalization, body {b}:\n{M}"
                )
        if normal == 1:  # Ry(phi): [[c,0,s],[0,1,0],[-s,0,c]]
            return float(np.arctan2(M[0, 2], M[0, 0]))
        # xy plane, Rz(psi): engine convention carries the NEGATED angle
        return float(-np.arctan2(M[1, 0], M[0, 0]))

    parent = []
    body_pos = np.zeros((nb, 2))
    body_angle = np.zeros(nb)
    mass = np.zeros(nb)
    com = np.zeros((nb, 2))
    inertia = np.zeros(nb)
    for b in range(1, m.nbody):
        i = bid(b)
        parent.append(bid(m.body_parentid[b]) if m.body_parentid[b] > 0 else -1)
        body_angle[i] = planar_angle_of_body(b)
        body_pos[i] = (S_of(m.body_parentid[b]) @ m.body_pos[b])[cols]
        mass[i] = m.body_mass[b]
        com[i] = (S_of(b) @ m.body_ipos[b])[cols]
        # Inertia about the plane normal, in the body frame (invariant to
        # the in-plane body_angle rotation).
        R = _quat_to_mat(m.body_iquat[b])
        I_body = R @ np.diag(m.body_inertia[b]) @ R.T
        inertia[i] = I_body[normal, normal]

    dof_body, dof_type = [], []
    nv = m.nv
    assert m.njnt == nv, "multi-dof joints unsupported (planar models are 1-dof)"
    dof_axis = np.zeros((nv, 2))
    dof_anchor = np.zeros((nv, 2))
    for j in range(m.njnt):
        jb = int(m.jnt_bodyid[j])
        dof_body.append(bid(jb))
        ax = S_of(jb) @ m.jnt_axis[j]
        if m.jnt_type[j] == mujoco.mjtJoint.mjJNT_SLIDE:
            dof_type.append(SLIDE)
            assert abs(ax[normal]) < 1e-8, f"slide axis out of plane: {ax}"
            dof_axis[j] = ax[cols]
        elif m.jnt_type[j] == mujoco.mjtJoint.mjJNT_HINGE:
            dof_type.append(HINGE)
            in_plane = [ax[c] for c in cols]
            assert all(abs(a) < 1e-8 for a in in_plane), f"hinge axis in plane: {ax}"
            dof_axis[j] = np.array([hinge_sign(ax), 0.0])
            dof_anchor[j] = (S_of(jb) @ m.jnt_pos[j])[cols]
        else:
            raise AssertionError(f"unsupported joint type {m.jnt_type[j]}")

    con_body, con_pos, con_radius, con_friction = [], [], [], []
    floor_contype = 0
    floor_conaff = 0
    wall_normal, wall_offset = [], []
    for g in range(m.ngeom):
        if m.geom_bodyid[g] == 0 and m.geom_type[g] == mujoco.mjtGeom.mjGEOM_PLANE:
            # Plane normal = geom-frame local +z in world coordinates.
            n3 = _quat_to_mat(m.geom_quat[g]) @ np.array([0.0, 0.0, 1.0])
            if abs(n3[normal]) > 1e-6:
                continue  # normal out of the working plane (backdrop) — decorative
            n2 = n3[cols]
            n2 = n2 / np.linalg.norm(n2)
            floor_contype |= int(m.geom_contype[g])
            floor_conaff |= int(m.geom_conaffinity[g])
            if n2[1] > 0.999 and abs(float(n2 @ m.geom_pos[g][cols])) < 1e-9:
                pass  # horizontal ground at height 0: the engine's built-in plane
            else:
                # tilted/offset plane: arena wall constraint
                wall_normal.append(n2)
                wall_offset.append(float(n2 @ m.geom_pos[g][cols]))
    contact_disabled = bool(m.opt.disableflags & mujoco.mjtDisableBit.mjDSBL_CONTACT)
    for g in range(m.ngeom):
        b = m.geom_bodyid[g]
        if b == 0 or contact_disabled or contact_bodies == "none":
            continue
        ct, ca = int(m.geom_contype[g]), int(m.geom_conaffinity[g])
        if not ((ct & floor_conaff) or (floor_contype & ca)):
            continue
        gpos = (S_of(b) @ m.geom_pos[g])[cols]
        if m.geom_type[g] == mujoco.mjtGeom.mjGEOM_CAPSULE:
            r, half = float(m.geom_size[g][0]), float(m.geom_size[g][1])
            # Capsule axis = geom-frame local z in the body frame; must lie
            # in the plane (an out-of-plane component would be 3-D).
            axis3 = S_of(b) @ _quat_to_mat(m.geom_quat[g]) @ np.array([0.0, 0.0, 1.0])
            assert abs(axis3[normal]) < 1e-8, f"capsule axis out of plane: {axis3}"
            d = axis3[cols] * half
            pts = [gpos + d, gpos - d]
        elif m.geom_type[g] == mujoco.mjtGeom.mjGEOM_SPHERE:
            r = float(m.geom_size[g][0])
            pts = [gpos]
        else:
            # Boxes etc. only appear with contacts disabled in our domains.
            continue
        for p in pts:
            con_body.append(bid(b))
            con_pos.append(p)
            con_radius.append(r)
            con_friction.append(float(m.geom_friction[g][0]))

    # --- body-body collision geoms (capsules/spheres) + candidate pairs ---
    # MuJoCo's default filter: different bodies, not parent-child, and
    # (contype_a & conaffinity_b) | (contype_b & conaffinity_a).
    geoms = []  # (body, p0, p1, radius, friction, contype, conaffinity)
    for g in range(m.ngeom if pair_collisions else 0):
        b = m.geom_bodyid[g]
        if b == 0 or contact_disabled:
            continue
        ct, ca = int(m.geom_contype[g]), int(m.geom_conaffinity[g])
        if ct == 0 and ca == 0:
            continue
        gpos = (S_of(b) @ m.geom_pos[g])[cols]
        if m.geom_type[g] == mujoco.mjtGeom.mjGEOM_CAPSULE:
            r, half = float(m.geom_size[g][0]), float(m.geom_size[g][1])
            axis3 = S_of(b) @ _quat_to_mat(m.geom_quat[g]) @ np.array([0.0, 0.0, 1.0])
            assert abs(axis3[normal]) < 1e-8, f"capsule axis out of plane: {axis3}"
            d = axis3[cols] * half
            p0, p1 = gpos + d, gpos - d
        elif m.geom_type[g] == mujoco.mjtGeom.mjGEOM_SPHERE:
            r = float(m.geom_size[g][0])
            p0 = p1 = gpos
        else:
            continue
        geoms.append((bid(b), p0, p1, r, float(m.geom_friction[g][0]), ct, ca))

    def _is_parent_child(a: int, b: int) -> bool:
        pa = parent[a] if a >= 0 else -2
        pb = parent[b] if b >= 0 else -2
        return pa == b or pb == a

    raw_pairs = []
    for i in range(len(geoms)):
        for j in range(i + 1, len(geoms)):
            ba, bb = geoms[i][0], geoms[j][0]
            if ba == bb or _is_parent_child(ba, bb):
                continue
            cti, cai = geoms[i][5], geoms[i][6]
            ctj, caj = geoms[j][5], geoms[j][6]
            if (cti & caj) or (ctj & cai):
                raw_pairs.append((i, j))
    used = sorted({g for p in raw_pairs for g in p})
    remap = {g: k for k, g in enumerate(used)}
    geom_body = tuple(geoms[g][0] for g in used)
    geom_p0 = np.asarray([geoms[g][1] for g in used]).reshape(-1, 2)
    geom_p1 = np.asarray([geoms[g][2] for g in used]).reshape(-1, 2)
    geom_radius = np.asarray([geoms[g][3] for g in used])
    geom_friction = np.asarray([geoms[g][4] for g in used])
    pair_geoms = np.asarray([(remap[a], remap[b]) for a, b in raw_pairs], np.int64)

    # --- rope constraints: limited spatial site-site tendons ---
    rope_body, rope_pos, rope_max = [], [], []
    for t in range(m.ntendon):
        if not m.tendon_limited[t]:
            continue
        adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
        wraps = [(int(m.wrap_type[w]), int(m.wrap_objid[w]))
                 for w in range(adr, adr + num)]
        if all(wt == mujoco.mjtWrap.mjWRAP_SITE for wt, _ in wraps) and num == 2:
            sids = [objid for _, objid in wraps]
            bodies, poses = [], []
            for s in sids:
                sb = int(m.site_bodyid[s])
                bodies.append(bid(sb) if sb > 0 else -1)
                poses.append((S_of(sb) @ m.site_pos[s])[cols])
            rope_body.append(bodies)
            rope_pos.append(poses)
            rope_max.append(float(m.tendon_range[t, 1]))
        else:
            raise AssertionError(f"unsupported limited tendon {t}: {wraps}")

    # --- equality constraints: single fixed-tendon equalities only
    # (manipulator's thumb-finger coupling). Enforce L(q) = L(qpos0) + data0
    # where L = Σ coef_j q_j over the tendon's wrap joints. ---
    eq_rows, eq_refs, eq_tcs = [], [], []
    for e in range(m.neq):
        if not m.eq_active0[e]:
            continue
        assert m.eq_type[e] == mujoco.mjtEq.mjEQ_TENDON, (
            f"unsupported equality type {m.eq_type[e]}"
        )
        t1, t2 = int(m.eq_obj1id[e]), int(m.eq_obj2id[e])
        assert t2 <= 0, "two-tendon (polynomial) equality unsupported"
        row = np.zeros(nv)
        adr, num = int(m.tendon_adr[t1]), int(m.tendon_num[t1])
        for w in range(adr, adr + num):
            assert int(m.wrap_type[w]) == int(mujoco.mjtWrap.mjWRAP_JOINT), (
                "equality over spatial tendons unsupported"
            )
            row[int(m.wrap_objid[w])] = float(m.wrap_prm[w])
        eq_rows.append(row)
        eq_refs.append(float(row @ m.qpos0.reshape(-1)) + float(m.eq_data[e, 0]))
        eq_tcs.append(float(m.eq_solref[e, 0]))

    # --- actuators: joint or fixed-tendon transmission -> moment matrix ---
    act_dof, gear = [], []
    act_moment = np.zeros((m.nu, nv))
    needs_moment = False
    for a in range(m.nu):
        trntype = int(m.actuator_trntype[a])
        g = float(m.actuator_gear[a, 0])
        tid = int(m.actuator_trnid[a, 0])
        if trntype == int(mujoco.mjtTrn.mjTRN_JOINT):
            act_dof.append(tid)
            gear.append(g)
            act_moment[a, tid] = g
        elif trntype == int(mujoco.mjtTrn.mjTRN_TENDON):
            assert m.tendon_num[tid] >= 1
            adr, num = int(m.tendon_adr[tid]), int(m.tendon_num[tid])
            for w in range(adr, adr + num):
                assert int(m.wrap_type[w]) == int(mujoco.mjtWrap.mjWRAP_JOINT), (
                    "only fixed tendons may drive actuators"
                )
                act_moment[a, int(m.wrap_objid[w])] = g * float(m.wrap_prm[w])
            act_dof.append(int(m.wrap_objid[adr]))  # placeholder for legacy path
            gear.append(g)
            needs_moment = True
        else:
            raise AssertionError(f"unsupported actuator transmission {trntype}")

    integrator = (
        "rk4" if m.opt.integrator == mujoco.mjtIntegrator.mjINT_RK4 else "euler"
    )

    # --- fluid drag (inertia-box model; density term only — swimmer) ---
    # Verified exact vs qfrc_passive: per body, equivalent box sides
    # box[i] = sqrt(6·(I_j + I_k − I_i)/mass); in the inertial frame
    #   f_i = −½ρ·box_j·box_k·|v_i|·v_i,
    #   t_i = −ρ·box_i·(box_j⁴+box_k⁴)/64·|ω_i|·ω_i.
    # For planar motion only the in-plane linear and normal angular terms
    # are nonzero, so bake them as per-body coefficients in engine axes.
    fluid_lin = fluid_ang = fluid_visc_lin = fluid_visc_ang = None
    rho, mu = float(m.opt.density), float(m.opt.viscosity)
    if rho > 0 or mu > 0:
        assert not np.any(m.opt.wind), "wind unsupported"
        fluid_lin = np.zeros((nb, 2))
        fluid_ang = np.zeros(nb)
        fluid_visc_lin = np.zeros(nb)
        fluid_visc_ang = np.zeros(nb)
        for b in range(1, m.nbody):
            mass_b = float(m.body_mass[b])
            if mass_b < 1e-12:
                continue
            # inertial frame must coincide with the body frame so the box
            # axes pair with the engine's body axes (true for the swimmer:
            # axis-aligned inertial geoms)
            assert abs(m.body_iquat[b][0] - 1.0) < 1e-9, (
                f"non-identity body_iquat unsupported for fluid, body {b}"
            )
            I = m.body_inertia[b]
            box = np.sqrt(np.maximum(
                1e-12, (I[[1, 2, 0]] + I[[2, 0, 1]] - I) * 6.0 / mass_b
            ))
            i0, i1 = cols
            other = lambda i: [j for j in range(3) if j != i]
            fluid_lin[bid(b), 0] = 0.5 * rho * box[other(i0)[0]] * box[other(i0)[1]]
            fluid_lin[bid(b), 1] = 0.5 * rho * box[other(i1)[0]] * box[other(i1)[1]]
            fluid_ang[bid(b)] = rho * box[normal] * (box[i0] ** 4 + box[i1] ** 4) / 64.0
            # linear (Stokes) drag on the equivalent sphere, d = mean side
            diam = float(np.mean(box))
            fluid_visc_lin[bid(b)] = 3.0 * np.pi * diam * mu
            fluid_visc_ang[bid(b)] = np.pi * diam ** 3 * mu
        if mu == 0:
            fluid_visc_lin = fluid_visc_ang = None

    # per-model limit solver timeconst: MuJoCo solreflimit (default 0.02)
    limited_js = np.flatnonzero(m.jnt_limited)
    limit_tc = (
        float(np.min(m.jnt_solref[limited_js, 0])) if len(limited_js) else 0.02
    )

    return PlanarModel(
        parent=tuple(parent),
        body_pos=body_pos,
        mass=mass,
        com=com,
        inertia=inertia,
        dof_body=tuple(dof_body),
        dof_type=tuple(dof_type),
        dof_axis=dof_axis,
        dof_anchor=dof_anchor,
        damping=m.dof_damping.copy(),
        armature=m.dof_armature.copy(),
        stiffness=m.jnt_stiffness.copy(),
        springref=m.qpos_spring.copy().reshape(-1),
        limited=m.jnt_limited.astype(bool).copy(),
        joint_range=m.jnt_range.copy(),
        act_dof=tuple(act_dof),
        gear=np.asarray(gear),
        con_body=tuple(con_body),
        con_pos=np.asarray(con_pos).reshape(-1, 2) if con_pos else np.zeros((0, 2)),
        con_radius=np.asarray(con_radius),
        con_friction=np.asarray(con_friction),
        dt=float(m.opt.timestep),
        gravity=gravity,
        integrator=integrator,
        plane=plane,
        body_angle=body_angle if np.any(body_angle != 0) else None,
        geom_body=geom_body if raw_pairs else (),
        geom_p0=geom_p0 if raw_pairs else None,
        geom_p1=geom_p1 if raw_pairs else None,
        geom_radius=geom_radius if raw_pairs else None,
        geom_friction=geom_friction if raw_pairs else None,
        pair_geoms=pair_geoms if raw_pairs else None,
        rope_body=np.asarray(rope_body, np.int64) if rope_body else None,
        rope_pos=np.asarray(rope_pos) if rope_pos else None,
        rope_max=np.asarray(rope_max) if rope_max else None,
        frictionloss=(
            m.dof_frictionloss.copy() if np.any(m.dof_frictionloss > 0) else None
        ),
        dof_ref=m.qpos0.copy().reshape(-1) if np.any(m.qpos0 != 0) else None,
        act_moment=act_moment if needs_moment else None,
        eq_moment=np.asarray(eq_rows) if eq_rows else None,
        eq_ref=np.asarray(eq_refs) if eq_rows else None,
        eq_timeconst=min(eq_tcs) if eq_rows else 0.02,
        wall_normal=np.asarray(wall_normal) if wall_normal else None,
        wall_offset=np.asarray(wall_offset) if wall_normal else None,
        fluid_lin=fluid_lin,
        fluid_ang=fluid_ang,
        fluid_visc_lin=fluid_visc_lin,
        fluid_visc_ang=fluid_visc_ang,
        limit_timeconst=limit_tc,
    )


_ARRAY_FIELDS = [
    "body_pos", "mass", "com", "inertia", "dof_axis", "dof_anchor",
    "damping", "armature", "stiffness", "springref", "limited", "joint_range",
    "gear", "con_pos", "con_radius", "con_friction",
]
_OPT_ARRAY_FIELDS = [
    "body_angle", "geom_p0", "geom_p1", "geom_radius", "geom_friction",
    "pair_geoms", "rope_body", "rope_pos", "rope_max", "frictionloss",
    "act_moment", "dof_ref", "eq_moment", "eq_ref", "wall_normal", "wall_offset",
    "fluid_lin", "fluid_ang", "fluid_visc_lin", "fluid_visc_ang",
]
_TUPLE_FIELDS = ["parent", "dof_body", "dof_type", "act_dof", "con_body"]
_OPT_TUPLE_FIELDS = ["geom_body"]
_SCALAR_FIELDS = [
    "dt", "gravity", "integrator", "plane", "contact_timeconst", "limit_timeconst",
    "eq_timeconst",
]


def save(model: PlanarModel, path: str, extras: dict | None = None) -> None:
    """Serialize to .npz. `extras` entries are stored under an `x_` prefix
    (ignored by `load`; env modules may read them for task metadata)."""
    data = {f: getattr(model, f) for f in _ARRAY_FIELDS}
    for k, v in (extras or {}).items():
        data[f"x_{k}"] = np.asarray(v)
    for f in _OPT_ARRAY_FIELDS:
        v = getattr(model, f)
        if v is not None:
            data[f] = v
    for f in _TUPLE_FIELDS:
        data[f] = np.asarray(getattr(model, f), dtype=np.int64)
    for f in _OPT_TUPLE_FIELDS:
        v = getattr(model, f)
        if v:
            data[f] = np.asarray(v, dtype=np.int64)
    for f in _SCALAR_FIELDS:
        data[f] = np.asarray(getattr(model, f))
    np.savez(path, **data)


def load(path: str) -> PlanarModel:
    """Reads a baked `.npz` model, field for field as the reference's
    `model.load` does."""
    z = np.load(path, allow_pickle=False)
    kw = {f: z[f] for f in _ARRAY_FIELDS}
    kw.update({f: z[f] for f in _OPT_ARRAY_FIELDS if f in z})
    kw.update({f: tuple(int(x) for x in z[f]) for f in _TUPLE_FIELDS})
    kw.update({f: tuple(int(x) for x in z[f]) for f in _OPT_TUPLE_FIELDS if f in z})
    for f in _SCALAR_FIELDS:
        if f not in z:
            continue
        v = z[f][()]
        kw[f] = str(v) if f in ("integrator", "plane") else float(v)
    return PlanarModel(**kw)
