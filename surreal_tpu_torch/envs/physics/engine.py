"""Planar rigid-body dynamics, batched over envs (port of
surreal_tpu/envs/physics/engine.py).

Every function takes a batch of states: q, qd (B, nv), ctrl (B, nu). The
reference writes one env and `vmap`s it; here the batch dimension is
written out. The per-body and per-dof loops are unrolled in Python as in
the reference, so an env step is many small launches on the card (the
rollout is launch-bound; CUDA graphs are the planned remedy).

Physics runs in full float32: `device.resolve` turns TF32 off, the
counterpart of the reference's `_highest_precision`.

The whole reference module is here: ground, body-body pair, wall, rope,
dof-friction, joint-limit and equality rows in the projected Jacobi solver
(the elliptic friction cone on pair rows), the sequential Gauss-Seidel
solver, fluid drag, tendon actuation, rotated body frames and joint refs,
the Euler integrator with or without implicit impulses, RK4, and the
autodiff cross-checks of the mass matrix and the bias forces (with
`torch.func` where the reference uses `jax.grad`/`jax.jvp`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.envs.physics.linalg import inv_spd, solve_spd
from surreal_tpu_torch.envs.physics.model import HINGE, SLIDE, PlanarModel

Tensor = torch.Tensor
FK = tuple[Tensor, Tensor, Tensor, Tensor]

# Baumgarte push-out velocity cap (m/s resp. rad/s); see the reference.
_PUSH_CAP = 2.0


def _rot(theta: Tensor, v: Tensor) -> Tensor:
    """Rotates planar (x, z) vectors by angle theta about +y (MuJoCo's
    xmat convention: x' = c·x + s·z, z' = −s·x + c·z)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([c * v[..., 0] + s * v[..., 1], -s * v[..., 0] + c * v[..., 1]], -1)


def _perp(v: Tensor) -> Tensor:
    """Ω·v with Ω = [[0, 1], [-1, 0]]; also d/dθ of `_rot(θ, ·)`."""
    return torch.stack([v[..., 1], -v[..., 0]], -1)


def _fk(m: PlanarModel, q: Tensor, qd: Tensor | None):
    """Forward kinematics and, when qd is given, its time derivative along
    qd (the reference takes it with `jax.jvp`; here it is written out:
    d/dt _rot(a, v) = ȧ·_perp(_rot(a, v)) for a body-fixed v). The static
    body-frame angles and joint refs are constants, so they shift the
    angles and joint coordinates but not their rates."""
    B = q.shape[0]
    pos, ang, danchor, daxis = [None] * m.nb, [None] * m.nb, [None] * m.nv, [None] * m.nv
    dpos, dang, ddanchor, ddaxis = [None] * m.nb, [None] * m.nb, [None] * m.nv, [None] * m.nv
    zero2 = q.new_zeros(B, 2)
    zero1 = q.new_zeros(B)
    body_pos = m.tensor("body_pos", q)
    axis = m.tensor("dof_axis", q)
    anchor = m.tensor("dof_anchor", q)
    # static offsets as Python floats, as in the reference
    frame = [float(x) for x in m.body_angles]
    ref = [float(x) for x in m.dof_refs]
    tangent = qd is not None
    for b in range(m.nb):
        par = m.parent[b]
        if par < 0:
            p, a = body_pos[b].expand(B, 2), q.new_full((B,), frame[b]) if frame[b] else zero1
            dp, da = zero2, zero1
        else:
            r = _rot(ang[par], body_pos[b])
            p, a = pos[par] + r, ang[par] + frame[b] if frame[b] else ang[par]
            if tangent:
                dp, da = dpos[par] + dang[par][:, None] * _perp(r), dang[par]
        for j in m.body_dofs[b]:
            qj = q[:, j] - ref[j] if ref[j] else q[:, j]
            if m.dof_type[j] == SLIDE:
                ax_w = _rot(a, axis[j])
                p = p + ax_w * qj[:, None]
                danchor[j], daxis[j] = zero2, ax_w
                if tangent:
                    dax_w = da[:, None] * _perp(ax_w)
                    dp = dp + dax_w * qj[:, None] + ax_w * qd[:, j, None]
                    ddanchor[j], ddaxis[j] = zero2, dax_w
            else:  # HINGE about anchor
                r1 = _rot(a, anchor[j])
                w = p + r1
                a = a + axis[j, 0] * qj
                r2 = _rot(a, anchor[j])
                p = w - r2
                danchor[j], daxis[j] = w, zero2
                if tangent:
                    dw = dp + da[:, None] * _perp(r1)
                    da = da + axis[j, 0] * qd[:, j]
                    dp = dw - da[:, None] * _perp(r2)
                    ddanchor[j], ddaxis[j] = dw, zero2
        pos[b], ang[b] = p, a
        if tangent:
            dpos[b], dang[b] = dp, da
    fkd = (torch.stack(pos, 1), torch.stack(ang, 1), torch.stack(danchor, 1),
           torch.stack(daxis, 1))
    if not tangent:
        return fkd
    return fkd, (torch.stack(dpos, 1), torch.stack(dang, 1),
                 torch.stack(ddanchor, 1), torch.stack(ddaxis, 1))


def fk_dofs(m: PlanarModel, q: Tensor) -> FK:
    """(body origins (B, nb, 2), body angles (B, nb), dof world anchors
    (B, nv, 2) [hinges; zeros for slides], dof world axes (B, nv, 2)
    [slides; zeros for hinges])."""
    return _fk(m, q, None)


def fk_dofs_dot(m: PlanarModel, q: Tensor, qd: Tensor) -> tuple[FK, FK]:
    """(fkd, fkd_dot): forward kinematics and its time derivative along qd."""
    return _fk(m, q, qd)


def fk(m: PlanarModel, q: Tensor) -> tuple[Tensor, Tensor]:
    """q -> (body frame origins (B, nb, 2), angles (B, nb))."""
    pos, ang, _, _ = fk_dofs(m, q)
    return pos, ang


def _ancestor_dof_mask(m: PlanarModel) -> np.ndarray:
    """(nb, nv) bool: dof j moves body b (j belongs to b or an ancestor)."""
    mask = np.zeros((m.nb, m.nv), bool)
    for b in range(m.nb):
        cur = b
        while cur >= 0:
            for j in range(m.nv):
                if m.dof_body[j] == cur:
                    mask[b, j] = True
            cur = m.parent[cur]
    return mask


def _hinge_sign(m: PlanarModel) -> np.ndarray:
    return np.asarray([m.dof_axis[j][0] if m.dof_type[j] == HINGE else 0.0
                       for j in range(m.nv)])


def _is_hinge(m: PlanarModel) -> np.ndarray:
    return np.asarray([t == HINGE for t in m.dof_type])


def point_jacobians(m: PlanarModel, q: Tensor, points_body, point_bodies,
                    fkd: FK | None = None):
    """World positions and Jacobians of material points. points_body is
    (P, 2) or (B, P, 2) in body coordinates, point_bodies (P,) owning body
    indices. Returns (points_world (B, P, 2), J (B, P, 2, nv), pos, ang)."""
    pos, ang, danchor, daxis = fkd if fkd is not None else fk_dofs(m, q)
    pb = torch.as_tensor(np.asarray(point_bodies), device=q.device)
    pts_w = pos[:, pb] + _rot(ang[:, pb], points_body)
    sign = m.tensor("hinge_sign", q, lambda: _hinge_sign(m))
    is_hinge = m.tensor("is_hinge", q, lambda: _is_hinge(m)).bool()
    mask = m.tensor("ancestor_mask", q, lambda: _ancestor_dof_mask(m))[pb]  # (P, nv)
    diff = pts_w[:, :, None, :] - danchor[:, None, :, :]  # (B, P, nv, 2)
    J_hinge = sign[None, None, :, None] * _perp(diff)
    J_slide = daxis[:, None].expand_as(J_hinge)
    J = torch.where(is_hinge[None, None, :, None], J_hinge, J_slide)
    J = J * mask[None, :, :, None]
    return pts_w, J.transpose(2, 3), pos, ang


def com_positions(m: PlanarModel, q: Tensor) -> Tensor:
    """World COM of each body (B, nb, 2)."""
    pos, ang = fk(m, q)
    return pos + _rot(ang, m.tensor("com", q))


def mass_matrix(m: PlanarModel, q: Tensor, fkd: FK | None = None) -> Tensor:
    """Joint-space inertia M(q) = Σ_b m_b J_vᵀJ_v + I_b J_ωᵀJ_ω + armature."""
    nb = m.nb
    _, Jv, _, _ = point_jacobians(m, q, m.tensor("com", q), np.arange(nb), fkd=fkd)
    mass = m.tensor("mass", q)
    M = torch.einsum("b,nbcj,nbck->njk", mass, Jv, Jv)

    def rot_inertia():  # q-independent: Σ_b I_b J_ωᵀJ_ω + diag(armature), in q's dtype
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=q.dtype)
        Jw = f(_ancestor_dof_mask(m)) * f(_hinge_sign(m))[None, :]
        return (torch.einsum("b,bj,bk->jk", f(m.inertia), Jw, Jw)
                + torch.diag(f(m.armature))).numpy()

    return M + m.tensor("rot_inertia", q, rot_inertia)


def bias_forces(m: PlanarModel, q: Tensor, qd: Tensor, fkd: FK | None = None,
                fkd_dot: FK | None = None) -> Tensor:
    """Coriolis + centrifugal + gravity c(q, qd) with M q̈ + c = τ, by the
    reference's analytic Newton-Euler assembly."""
    if fkd is None or fkd_dot is None:
        fkd, fkd_dot = fk_dofs_dot(m, q, qd)
    _, Jv, _, _ = point_jacobians(m, q, m.tensor("com", q), np.arange(m.nb), fkd=fkd)
    _, _, danchor_dot, daxis_dot = fkd_dot
    xdot = torch.einsum("nbcv,nv->nbc", Jv, qd)
    sign = m.tensor("hinge_sign", q, lambda: _hinge_sign(m))
    is_hinge = m.tensor("is_hinge", q, lambda: _is_hinge(m)).bool()
    mask = m.tensor("ancestor_mask", q, lambda: _ancestor_dof_mask(m))
    diff_dot = xdot[:, :, None, :] - danchor_dot[:, None, :, :]  # (B, nb, nv, 2)
    G_hinge = sign[None, None, :, None] * _perp(diff_dot)
    G_slide = daxis_dot[:, None].expand_as(G_hinge)
    G = torch.where(is_hinge[None, None, :, None], G_hinge, G_slide)
    G = G * mask[None, :, :, None]
    gamma = torch.einsum("nbvc,nv->nbc", G, qd)
    g_vec = m.tensor("gravity_vec", q,
                     lambda: np.stack([np.zeros(m.nb), np.full(m.nb, m.gravity)], -1))
    f = m.tensor("mass", q)[None, :, None] * (gamma + g_vec)
    return torch.einsum("nbcv,nbc->nv", Jv, f)


def body_velocities(m: PlanarModel, q: Tensor, qd: Tensor):
    """(COM velocities (B, nb, 2), angular velocities (B, nb))."""
    (_, ang, _, _), (dpos, dang, _, _) = fk_dofs_dot(m, q, qd)
    r = _rot(ang, m.tensor("com", q))
    return dpos + dang[..., None] * _perp(r), dang


def subtree_com_velocity(m: PlanarModel, q: Tensor, qd: Tensor) -> Tensor:
    """Whole-body COM velocity (B, 2): the torso_subtreelinvel sensor."""
    v, _ = body_velocities(m, q, qd)
    return torch.sum(m.tensor("mass", q)[None, :, None] * v, 1) / m.total_mass


# ---------------------------------------------------------------------------
# Autodiff cross-checks (the reference keeps them as oracles for the
# analytic assembly; here with torch.func, one env per vmapped call). One
# plain call first fills the model's tensor cache: a tensor made inside a
# torch.func transform is that transform's wrapper and must not be kept.
# ---------------------------------------------------------------------------


def kinetic_energy(m: PlanarModel, q: Tensor, qd: Tensor) -> Tensor:
    """(B,) kinetic energy, armature included."""
    v, w = body_velocities(m, q, qd)
    mass, inertia, arm = m.tensor("mass", q), m.tensor("inertia", q), m.tensor("armature", q)
    return (0.5 * torch.sum(mass * torch.sum(v * v, -1), -1)
            + 0.5 * torch.sum(inertia * w * w, -1)
            + 0.5 * torch.sum(arm * qd * qd, -1))


def potential_energy(m: PlanarModel, q: Tensor) -> Tensor:
    """(B,) gravitational potential energy."""
    coms = com_positions(m, q)
    return m.gravity * torch.sum(m.tensor("mass", q) * coms[..., 1], -1)


def mass_matrix_autodiff(m: PlanarModel, q: Tensor) -> Tensor:
    """M(q) as the Hessian of the kinetic energy in qd (at qd = 0)."""
    from torch.func import grad, jacfwd, vmap

    kinetic_energy(m, q, q)

    def one(qq):
        ke = lambda qdd: kinetic_energy(m, qq[None], qdd[None])[0]  # noqa: E731
        return jacfwd(grad(ke))(torch.zeros_like(qq))

    return vmap(one)(q)


def bias_forces_autodiff(m: PlanarModel, q: Tensor, qd: Tensor) -> Tensor:
    """Euler-Lagrange bias d/dt(∂T/∂q̇) − ∂T/∂q + ∂V/∂q by autodiff."""
    from torch.func import grad, jvp, vmap

    kinetic_energy(m, q, qd), potential_energy(m, q)

    def one(qq, vv):
        ke = lambda a, b: kinetic_energy(m, a[None], b[None])[0]  # noqa: E731
        _, dg1_dt = jvp(lambda a: grad(lambda b: ke(a, b))(vv), (qq,), (vv,))
        dT_dq = grad(lambda a: ke(a, vv))(qq)
        dV_dq = grad(lambda a: potential_energy(m, a[None])[0])(qq)
        return dg1_dt - dT_dq + dV_dq

    return vmap(one)(q, qd)


# ---------------------------------------------------------------------------
# Unilateral constraints: contact kinematics of every row kind.
# ---------------------------------------------------------------------------


def _contact_kinematics(m: PlanarModel, q: Tensor, fkd: FK | None = None):
    """(J (B, ncon, 2, nv), depth (B, ncon)) of the lowest point of each
    contact sphere against the ground plane z = 0."""
    cb = np.asarray(m.con_body)
    pos, ang, danchor, daxis = fkd if fkd is not None else fk_dofs(m, q)
    down = m.tensor("con_down", q,
                    lambda: np.stack([np.zeros(m.ncon), -np.float32(m.con_radius)], -1))
    u_pt = m.tensor("con_pos", q) + _rot(-ang[:, cb], down)
    pts_w, J, _, _ = point_jacobians(m, q, u_pt, cb, fkd=(pos, ang, danchor, daxis))
    return J, -pts_w[..., 1]


def _seg_seg_closest(p1, q1, p2, q2, eps: float = 1e-12):
    """Closest points between planar segments [p1, q1] and [p2, q2],
    elementwise over the leading axes (Ericson, Real-Time Collision
    Detection §5.1.9, branchless); degenerate segments handled."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = torch.sum(d1 * d1, -1)
    e = torch.sum(d2 * d2, -1)
    f = torch.sum(d2 * r, -1)
    c = torch.sum(d1 * r, -1)
    b = torch.sum(d1 * d2, -1)
    zero = torch.zeros_like(a)
    denom = a * e - b * b
    s = torch.where(denom > eps, torch.clamp((b * f - c * e) / torch.clamp(denom, min=eps),
                                             0.0, 1.0), zero)
    t_raw = (b * s + f) / torch.clamp(e, min=eps)
    t = torch.clamp(t_raw, 0.0, 1.0)
    s_fix = torch.clamp((b * t - c) / torch.clamp(a, min=eps), 0.0, 1.0)
    s = torch.where((t_raw < 0.0) | (t_raw > 1.0), s_fix, s)
    s = torch.where(a <= eps, zero, s)
    t = torch.where(a <= eps, torch.clamp(f / torch.clamp(e, min=eps), 0.0, 1.0), t)
    s = torch.where(e <= eps, torch.clamp(-c / torch.clamp(a, min=eps), 0.0, 1.0), s)
    t = torch.where(e <= eps, zero, t)
    return p1 + s[..., None] * d1, p2 + t[..., None] * d2


def _geom_segments(m: PlanarModel, q: Tensor, fkd: FK):
    """World end points (B, ng, 2) of every collision geom's segment."""
    pos, ang, _, _ = fkd
    gb = np.asarray(m.geom_body)
    p0_w = pos[:, gb] + _rot(ang[:, gb], m.tensor("geom_p0", q))
    p1_w = pos[:, gb] + _rot(ang[:, gb], m.tensor("geom_p1", q))
    return p0_w, p1_w


def _pair_kinematics(m: PlanarModel, q: Tensor, fkd: FK | None = None):
    """Body-body capsule/sphere contact rows: (Jn (B, npair, nv), Jt, depth
    (B, npair), mu (npair,)). Jn is the separation rate, Jt the tangential
    relative velocity; depth > 0 means penetrating."""
    fkd = fk_dofs(m, q) if fkd is None else fkd
    pos, ang, _, _ = fkd
    p0_w, p1_w = _geom_segments(m, q, fkd)
    ia = np.asarray(m.pair_geoms[:, 0])
    ib = np.asarray(m.pair_geoms[:, 1])
    c_a, c_b = _seg_seg_closest(p0_w[:, ia], p1_w[:, ia], p0_w[:, ib], p1_w[:, ib])
    delta = c_b - c_a
    dist = torch.linalg.vector_norm(delta, dim=-1)
    n = delta / torch.clamp(dist, min=1e-9)[..., None]  # a -> b
    radius = m.tensor("geom_radius", q)
    ra, rb = radius[ia], radius[ib]
    depth = (ra + rb) - dist
    x_a = c_a + n * ra[:, None]
    x_b = c_b - n * rb[:, None]
    gb = np.asarray(m.geom_body)
    ba, bb = gb[ia], gb[ib]
    u_a = _rot(-ang[:, ba], x_a - pos[:, ba])
    u_b = _rot(-ang[:, bb], x_b - pos[:, bb])
    _, Ja, _, _ = point_jacobians(m, q, u_a, ba, fkd=fkd)  # (B, P, 2, nv)
    _, Jb, _, _ = point_jacobians(m, q, u_b, bb, fkd=fkd)
    J_rel = Jb - Ja
    Jn = torch.einsum("npc,npcv->npv", n, J_rel)
    Jt = torch.einsum("npc,npcv->npv", _perp(n), J_rel)
    # MuJoCo combines pair friction with the elementwise max
    mu = m.tensor("pair_mu", q, lambda: np.maximum(np.float32(m.geom_friction[ia]),
                                                   np.float32(m.geom_friction[ib])))
    return Jn, Jt, depth, mu


def _wall_kinematics(m: PlanarModel, q: Tensor, fkd: FK | None = None):
    """The ground-contact spheres against the static walls (inside half
    space n·x − d ≥ 0): (Jn (B, ncon·nwall, nv), Jt, depth, mu)."""
    fkd = fk_dofs(m, q) if fkd is None else fkd
    pos, ang, _, _ = fkd
    cb = np.asarray(m.con_body)
    normals = m.tensor("wall_normal", q)
    Jns, Jts, depths = [], [], []
    for w in range(m.nwall):
        n = normals[w]
        d = float(m.wall_offset[w])
        # deepest material point toward the wall: center − r·n, in body frames
        out = m.tensor(f"wall_out_{w}", q, lambda w=w: (
            -np.float32(m.con_radius)[:, None] * np.float32(m.wall_normal[w])))
        u_pt = m.tensor("con_pos", q) + _rot(-ang[:, cb], out)
        pts_w, J, _, _ = point_jacobians(m, q, u_pt, cb, fkd=fkd)
        depths.append(d - pts_w @ n)
        Jns.append(torch.einsum("c,npcv->npv", n, J))
        Jts.append(torch.einsum("c,npcv->npv", _perp(n), J))
    mu = m.tensor("wall_mu", q, lambda: np.tile(np.float32(m.con_friction), m.nwall))
    return torch.cat(Jns, 1), torch.cat(Jts, 1), torch.cat(depths, 1), mu


def penetration(m: PlanarModel, q: Tensor) -> Tensor:
    """(B,) max penetration depth over every contact candidate (ground,
    walls, body-body pairs); −inf where the model has none."""
    fkd = fk_dofs(m, q)
    depths = [q.new_full((q.shape[0],), -float("inf"))]
    if m.ncon:
        _, d = _contact_kinematics(m, q, fkd=fkd)
        depths.append(torch.amax(d, 1))
        if m.nwall:
            depths.append(torch.amax(_wall_kinematics(m, q, fkd=fkd)[2], 1))
    if m.npair:
        depths.append(torch.amax(_pair_kinematics(m, q, fkd=fkd)[2], 1))
    return torch.amax(torch.stack(depths, 1), 1)


def _rope_kinematics(m: PlanarModel, q: Tensor, fkd: FK | None = None):
    """Tendon-limit (max-length rope) rows: (J (B, nrope, nv), stretch
    (B, nrope)). J is minus the extension rate, so a positive impulse
    shortens the rope; stretch > 0 means the limit is violated."""
    fkd = fk_dofs(m, q) if fkd is None else fkd
    pos, ang, _, _ = fkd
    rope_pos = m.tensor("rope_pos", q)
    xs, Js = [], []
    for side in (0, 1):
        b = np.asarray(m.rope_body[:, side])
        local = rope_pos[:, side]
        world = torch.as_tensor(b < 0, device=q.device)
        b_safe = np.maximum(b, 0)
        x_body = pos[:, b_safe] + _rot(ang[:, b_safe], local)
        xs.append(torch.where(world[None, :, None], local, x_body))
        _, J, _, _ = point_jacobians(m, q, local, b_safe, fkd=fkd)
        Js.append(J * (1.0 - world.to(q.dtype))[None, :, None, None])
    d = xs[1] - xs[0]
    length = torch.linalg.vector_norm(d, dim=-1)
    direction = d / torch.clamp(length, min=1e-9)[..., None]
    J = -torch.einsum("nrc,nrcv->nrv", direction, Js[1] - Js[0])
    return J, length - m.tensor("rope_max", q)


# ---------------------------------------------------------------------------
# Constraint solvers
# ---------------------------------------------------------------------------


def has_constraints(m: PlanarModel) -> bool:
    return bool(
        m.ncon or m.npair or m.nrope or m.has_dof_friction or np.any(m.limited)
        or m.neq
    )


def constraint_project(m: PlanarModel, q: Tensor, v: Tensor, M_inv: Tensor, h: float,
                       n_iter: int = 10, solver: str = "jacobi", fkd: FK | None = None):
    """Projects the candidate velocity v onto the feasible set of every
    constraint row. solver='jacobi' (and any model with rows beyond ground
    contacts and limits): projected Jacobi over all rows, at least 20
    sweeps; solver='gs': the sequential projected Gauss-Seidel."""
    if (
        solver == "jacobi"
        or m.npair or m.nrope or m.has_dof_friction or m.neq or m.nwall
    ):
        return _project_jacobi(m, q, v, M_inv, h, n_iter=max(n_iter, 20), fkd=fkd)
    return _project_gs(m, q, v, M_inv, h, n_iter=n_iter)


def constraint_project_impulses(m: PlanarModel, q: Tensor, v: Tensor, M_inv: Tensor,
                                h: float, n_iter: int = 20, fkd: FK | None = None):
    """`constraint_project` (Jacobi) that also returns the normal contact
    impulses: dict(ground (B, ncon), pair (B, npair), wall (B, ncon·nwall))."""
    return _project_jacobi(m, q, v, M_inv, h, n_iter=n_iter, return_impulses=True, fkd=fkd)


def _no_impulses(m: PlanarModel, like: Tensor) -> dict[str, Tensor]:
    B = like.shape[0]
    return {"ground": like.new_zeros(B, m.ncon), "pair": like.new_zeros(B, m.npair),
            "wall": like.new_zeros(B, m.ncon * m.nwall)}


def _project_jacobi(m: PlanarModel, q: Tensor, v: Tensor, M_inv: Tensor, h: float,
                    n_iter: int = 20, relax: float = 0.7, return_impulses: bool = False,
                    fkd: FK | None = None):
    """Projected Jacobi with the reference's row layout: [normals (ground,
    pair, wall) | tangents (the same) | dof friction (boxed by
    frictionloss·h) | λ ≥ 0 rows (ropes, limits) | free rows (equalities)].
    Pair rows project jointly onto the elliptic friction cone (when
    `pair_cone`), ground and wall rows onto the box |λt| ≤ μ·λn."""
    dtype = q.dtype
    B = q.shape[0]
    has_limits = bool(np.any(m.limited))
    nc, npair, nrope, ne = m.ncon, m.npair, m.nrope, m.neq
    nwall = nc * m.nwall
    has_fric = m.has_dof_friction
    if not (nc or npair or nrope or has_fric or has_limits or ne):
        return (v, _no_impulses(m, v)) if return_impulses else v

    if fkd is None and (nc or npair or nrope):
        fkd = fk_dofs(m, q)
    n_rows, n_targets, t_rows, mus = [], [], [], []
    if nc:
        J, depth = _contact_kinematics(m, q, fkd=fkd)
        active = (depth > 0).to(dtype)
        n_rows.append(J[:, :, 1, :] * active[..., None])
        t_rows.append(J[:, :, 0, :] * active[..., None])
        n_targets.append(torch.clamp(torch.clamp(depth, min=0.0) / m.contact_timeconst,
                                     max=_PUSH_CAP))
        mus.append(m.tensor("con_friction", q))
    if npair:
        Jn, Jt, depth, mu = _pair_kinematics(m, q, fkd=fkd)
        active = (depth > 0).to(dtype)
        n_rows.append(Jn * active[..., None])
        t_rows.append(Jt * active[..., None])
        # 'soft': depth/timeconst; 'stiff_dynamic': velocity-gated depth/(β·h)
        if m.pair_push == "stiff_dynamic":
            speed = (torch.abs(torch.einsum("npv,nv->np", Jn, v))
                     + torch.abs(torch.einsum("npv,nv->np", Jt, v)))
            dyn = torch.clamp((speed - 0.1) / 0.4, 0.0, 1.0)
            beta = 1.0 + dyn * (m.pair_beta - 1.0)
            tgt = torch.clamp(depth, min=0.0) / (beta * h)
        else:
            tgt = torch.clamp(depth, min=0.0) / m.contact_timeconst
        n_targets.append(torch.clamp(tgt, max=_PUSH_CAP))
        mus.append(mu)
    if nwall:
        Jn, Jt, depth, mu = _wall_kinematics(m, q, fkd=fkd)
        active = (depth > 0).to(dtype)
        n_rows.append(Jn * active[..., None])
        t_rows.append(Jt * active[..., None])
        n_targets.append(torch.clamp(torch.clamp(depth, min=0.0) / m.contact_timeconst,
                                     max=_PUSH_CAP))
        mus.append(mu)

    rows, targets = [], []
    if n_rows:
        rows += n_rows + t_rows
        targets += n_targets + [torch.zeros_like(t) for t in n_targets]
        mu_all = torch.cat(mus)
    N = nc + npair + nwall

    F = 0
    if has_fric:
        fric_dofs = np.flatnonzero(np.asarray(m.frictionloss) > 0)
        F = len(fric_dofs)
        Jf = m.tensor("fric_rows", q, lambda: np.eye(m.nv)[fric_dofs])
        fric_bound = m.tensor(f"fric_bound_{h!r}", q,
                              lambda: np.float32(m.frictionloss[fric_dofs] * h))
        rows.append(Jf.expand(B, F, m.nv))
        targets.append(q.new_zeros(B, F))
    if nrope:
        Jr, stretch = _rope_kinematics(m, q, fkd=fkd)
        active = (stretch > 0).to(dtype)
        rows.append(Jr * active[..., None])
        targets.append(torch.clamp(torch.clamp(stretch, min=0.0) / m.contact_timeconst,
                                   max=_PUSH_CAP))
    if has_limits:
        lo = m.tensor("joint_range", q)[:, 0]
        hi = m.tensor("joint_range", q)[:, 1]
        viol_lo = torch.clamp(lo - q, min=0.0)
        viol_hi = torch.clamp(q - hi, min=0.0)
        lim_sign = torch.sign(viol_lo - viol_hi) * m.tensor("limited", q)
        rows.append(torch.diag_embed(lim_sign))  # row j = s_j e_j (zero when inactive)
        targets.append(torch.clamp((viol_lo + viol_hi) / m.limit_timeconst, max=_PUSH_CAP))
    if ne:
        # bilateral coupling rows: drive E q back to eq_ref (λ unbounded)
        E = m.tensor("eq_moment", q)
        rows.append(E.expand(B, ne, m.nv))
        targets.append(torch.clamp(-(q @ E.T - m.tensor("eq_ref", q)) / m.eq_timeconst,
                                   -_PUSH_CAP, _PUSH_CAP))

    J_all = torch.cat(rows, 1)  # (B, C, nv)
    target = torch.cat(targets, 1)  # (B, C)
    C = J_all.shape[1]
    nn_end = C - ne  # rows in [2N + F, nn_end) are λ ≥ 0
    MJ = J_all @ M_inv
    W = MJ @ J_all.transpose(1, 2)  # (B, C, C) Delassus
    # Row-sum (mass-splitting) scaling; see the reference for why.
    diagW = torch.clamp(torch.sum(torch.abs(W), dim=2), min=1e-9)
    if N:
        # each contact's normal and tangent rows share one scale
        shared = torch.maximum(diagW[:, :N], diagW[:, N : 2 * N])
        diagW = torch.cat([shared, shared, diagW[:, 2 * N :]], 1)
    b = (J_all @ v[..., None])[..., 0] - target
    # Pair rows [nc, nc + npair) of each half project jointly onto the
    # elliptic cone; only they pay for it (the reference selects between
    # the cone and the box on every row, which its fused step gets free).
    cone = bool(npair and m.pair_cone)
    if cone:
        mu_pair = mu_all[nc : nc + npair]
        cone_den = 1.0 + mu_pair * mu_pair

    def project(lam):
        parts = []
        if N:
            ln, lt = lam[:, :N], lam[:, N : 2 * N]
            # boxed clamp: λn ≥ 0, |λt| ≤ μ·λn
            ln_box = torch.clamp(ln, min=0.0)
            bound = mu_all * ln_box
            lt_box = torch.clamp(lt, min=-bound, max=bound)
            if cone:
                pair = slice(nc, nc + npair)
                ln_box[:, pair], lt_box[:, pair] = _cone_project(ln[:, pair], lt[:, pair],
                                                                 mu_pair, cone_den)
            parts += [ln_box, lt_box]
        if F:
            parts.append(torch.clamp(lam[:, 2 * N : 2 * N + F], min=-fric_bound, max=fric_bound))
        if nn_end > 2 * N + F:
            parts.append(torch.clamp(lam[:, 2 * N + F : nn_end], min=0.0))
        if ne:
            parts.append(lam[:, nn_end:])  # equality impulses are free
        return torch.cat(parts, 1) if len(parts) > 1 else parts[0]

    lam = torch.zeros_like(target)
    for _ in range(n_iter):
        resid = (W @ lam[..., None])[..., 0] + b
        lam = project(lam - relax * resid / diagW)
    v_new = v + (MJ.transpose(1, 2) @ lam[..., None])[..., 0]
    if return_impulses:
        return v_new, {"ground": lam[:, :nc], "pair": lam[:, nc : nc + npair],
                       "wall": lam[:, nc + npair : N]}
    return v_new


def _cone_project(ln: Tensor, lt: Tensor, mu: Tensor, den: Tensor):
    """Projection of (λn, λt) onto {(n, t): n ≥ 0, |t| ≤ μ n}; den = 1 + μ²."""
    at = torch.abs(lt)
    inside = at <= mu * ln
    polar = mu * at <= -ln  # polar cone -> zero impulse
    s = (ln + mu * at) / den
    zero = torch.zeros_like(ln)
    return (torch.where(inside, torch.clamp(ln, min=0.0), torch.where(polar, zero, s)),
            torch.where(inside, lt, torch.where(polar, zero, torch.sign(lt) * mu * s)))


def _project_gs(m: PlanarModel, q: Tensor, v: Tensor, M_inv: Tensor, h: float,
                n_iter: int = 10):
    """Sequential projected Gauss-Seidel on ground contacts and limits (the
    reference's cross-check solver): each row in turn, batched over envs."""
    has_limits = bool(np.any(m.limited))
    if m.ncon == 0 and not has_limits:
        return v
    zero = torch.zeros_like(v[:, 0])
    if m.ncon:
        J, depth = _contact_kinematics(m, q)
        active = depth > 0
        mu = [float(x) for x in np.float32(m.con_friction)]
        Jn, Jt = J[:, :, 1, :], J[:, :, 0, :]
        MJn, MJt = Jn @ M_inv, Jt @ M_inv
        wn = torch.clamp(torch.sum(Jn * MJn, -1), min=1e-9)
        wt = torch.clamp(torch.sum(Jt * MJt, -1), min=1e-9)
        v_push = torch.clamp(torch.where(active, depth, torch.zeros_like(depth))
                             / m.contact_timeconst, max=_PUSH_CAP)
    if has_limits:
        lo = m.tensor("joint_range", q)[:, 0]
        hi = m.tensor("joint_range", q)[:, 1]
        viol_lo = torch.clamp(lo - q, min=0.0)
        viol_hi = torch.clamp(q - hi, min=0.0)
        lim_sign = torch.sign(viol_lo - viol_hi) * m.tensor("limited", q)
        lim_push = torch.clamp((viol_lo + viol_hi) / m.limit_timeconst, max=_PUSH_CAP)
        w_dof = torch.clamp(torch.diagonal(M_inv, dim1=1, dim2=2), min=1e-9)
        lim_dofs = [j for j in range(m.nv) if m.limited[j]]
    lam_n, lam_t, lam_l = [zero] * m.ncon, [zero] * m.ncon, [zero] * m.nv
    for _ in range(n_iter):
        for c in range(m.ncon):
            # normal: v_n >= v_push, lam_n >= 0
            vn = torch.sum(Jn[:, c] * v, -1)
            new = torch.clamp(lam_n[c] + (v_push[:, c] - vn) / wn[:, c], min=0.0)
            new = torch.where(active[:, c], new, zero)
            v = v + MJn[:, c] * (new - lam_n[c])[:, None]
            lam_n[c] = new
            # friction: drive v_t -> 0, |lam_t| <= mu * lam_n
            vt = torch.sum(Jt[:, c] * v, -1)
            bound = mu[c] * new
            new_t = torch.clamp(lam_t[c] - vt / wt[:, c], min=-bound, max=bound)
            v = v + MJt[:, c] * (new_t - lam_t[c])[:, None]
            lam_t[c] = new_t
        if has_limits:
            for j in lim_dofs:
                s = lim_sign[:, j]
                vj = s * v[:, j]
                new = torch.clamp(lam_l[j] + (lim_push[:, j] - vj) / w_dof[:, j], min=0.0)
                new = torch.where(s != 0, new, zero)
                v = v + M_inv[:, :, j] * (s * (new - lam_l[j]))[:, None]
                lam_l[j] = new
    return v


# ---------------------------------------------------------------------------
# Forces
# ---------------------------------------------------------------------------


def passive_spring_forces(m: PlanarModel, q: Tensor) -> Tensor:
    return -m.tensor("stiffness", q) * (q - m.tensor("springref", q))


def fluid_forces(m: PlanarModel, q: Tensor, qd: Tensor, fkd: FK | None = None) -> Tensor:
    """Generalized quadratic fluid drag (MuJoCo's inertia-box model, density
    term; the swimmer's swimming forces), plus the linear viscous terms
    where the model has them: per body −c·|v|·v in body axes at the COM and
    −c_ω·|ω|·ω, mapped through the COM Jacobians and the angular Jacobian."""
    fkd = fk_dofs(m, q) if fkd is None else fkd
    _, Jv, _, ang = point_jacobians(m, q, m.tensor("com", q), np.arange(m.nb), fkd=fkd)
    Jw = m.tensor("angular_jacobian", q, lambda: (  # (nb, nv): ω = Jw @ qd
        _ancestor_dof_mask(m).astype(np.float32) * _hinge_sign(m).astype(np.float32)[None]))
    v_com = torch.einsum("nbcv,nv->nbc", Jv, qd)
    w = qd @ Jw.T  # (B, nb)
    v_body = _rot(-ang, v_com)
    f_body = -m.tensor("fluid_lin", q) * torch.abs(v_body) * v_body
    torque = -m.tensor("fluid_ang", q) * torch.abs(w) * w
    if m.fluid_visc_lin is not None:  # linear (Stokes) viscosity terms
        f_body = f_body - m.tensor("fluid_visc_lin", q)[:, None] * v_body
        torque = torque - m.tensor("fluid_visc_ang", q) * w
    f_world = _rot(ang, f_body)
    return torch.einsum("nbcv,nbc->nv", Jv, f_world) + torque @ Jw


def actuation(m: PlanarModel, ctrl: Tensor) -> Tensor:
    """Generalized forces from motor actuators (ctrl clipped to [-1, 1]);
    fixed-tendon transmissions through the moment matrix."""
    ctrl = torch.clamp(ctrl, -1.0, 1.0)
    if m.act_moment is not None:
        return ctrl @ m.tensor("act_moment", ctrl)
    idx = torch.as_tensor(m.act_dof, device=ctrl.device)
    tau = ctrl.new_zeros(ctrl.shape[0], m.nv)
    return tau.index_add(1, idx, m.tensor("gear", ctrl) * ctrl)


# ---------------------------------------------------------------------------
# Forward dynamics + integrators
# ---------------------------------------------------------------------------


def smooth_forces(m: PlanarModel, q, qd, ctrl, fkd=None, fkd_dot=None) -> Tensor:
    """Actuation + joint springs + fluid drag − bias."""
    if fkd is None or fkd_dot is None:
        fkd, fkd_dot = fk_dofs_dot(m, q, qd)
    f = (actuation(m, ctrl) + passive_spring_forces(m, q)
         - bias_forces(m, q, qd, fkd=fkd, fkd_dot=fkd_dot))
    if m.has_fluid:
        f = f + fluid_forces(m, q, qd, fkd=fkd)
    return f


def forward_explicit(m: PlanarModel, q: Tensor, qd: Tensor, ctrl: Tensor) -> Tensor:
    """qacc of the smooth dynamics with explicit joint damping (an RK4 stage)."""
    fkd, fkd_dot = fk_dofs_dot(m, q, qd)
    M = mass_matrix(m, q, fkd=fkd)
    f = smooth_forces(m, q, qd, ctrl, fkd=fkd, fkd_dot=fkd_dot) - m.tensor("damping", q) * qd
    return solve_spd(M, f)


def step_euler(m: PlanarModel, q: Tensor, qd: Tensor, ctrl: Tensor, h: float | None = None,
               return_impulses: bool = False):
    """Semi-implicit Euler with implicitly integrated joint damping,
    (M + hD) v̇ = f − D v, then constraint projection of the candidate
    velocity, then q += h v. With `implicit_impulse` the impulses act
    through (M + hD)⁻¹ (MuJoCo's Euler semantics), else through M⁻¹. With
    `return_impulses`, also returns the normal contact impulses."""
    h = m.dt if h is None else h
    ctrl = ctrl.to(q.dtype)
    D = m.tensor("damping", q)
    fkd, fkd_dot = fk_dofs_dot(m, q, qd)
    M = mass_matrix(m, q, fkd=fkd)
    f = smooth_forces(m, q, qd, ctrl, fkd=fkd, fkd_dot=fkd_dot) - D * qd
    if m.implicit_impulse:
        M_inv = inv_spd(M + h * torch.diag(D))
        qacc = (M_inv @ f[..., None])[..., 0]
    else:
        M_inv = inv_spd(M)
        qacc = solve_spd(M + h * torch.diag(D), f)
    v_star = qd + h * qacc
    if return_impulses:
        qd_new, imp = constraint_project_impulses(m, q, v_star, M_inv, h, fkd=fkd)
        return q + h * qd_new, qd_new, imp
    qd_new = constraint_project(m, q, v_star, M_inv, h, fkd=fkd)
    return q + h * qd_new, qd_new


def step_rk4(m: PlanarModel, q: Tensor, qd: Tensor, ctrl: Tensor, h: float | None = None):
    """Classic RK4 on the smooth dynamics, then constraint projection."""
    h = m.dt if h is None else h
    ctrl = ctrl.to(q.dtype)

    def deriv(qq, vv):
        return vv, forward_explicit(m, qq, vv, ctrl)

    k1 = deriv(q, qd)
    k2 = deriv(q + 0.5 * h * k1[0], qd + 0.5 * h * k1[1])
    k3 = deriv(q + 0.5 * h * k2[0], qd + 0.5 * h * k2[1])
    k4 = deriv(q + h * k3[0], qd + h * k3[1])
    q_new = q + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
    qd_new = qd + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
    if has_constraints(m):
        fkd = fk_dofs(m, q_new)
        M_inv = inv_spd(mass_matrix(m, q_new, fkd=fkd))
        qd_new = constraint_project(m, q_new, qd_new, M_inv, h, fkd=fkd)
    return q_new, qd_new


def make_stepper(m: PlanarModel, n_substeps: int = 1,
                 return_impulses: bool = False) -> Callable:
    """Returns step(q, qd, ctrl) -> (q, qd) advancing n_substeps physics
    steps of size m.dt with ctrl held constant. With `return_impulses`
    (Euler only), returns (q, qd, imp) with the normal contact impulses
    summed over the substeps."""
    if return_impulses:
        assert m.integrator != "rk4", "impulse outputs require the Euler path"

        def step_imp(q, qd, ctrl):
            acc = _no_impulses(m, q)
            for _ in range(n_substeps):
                q, qd, imp = step_euler(m, q, qd, ctrl, return_impulses=True)
                acc = {k: acc[k] + imp[k] for k in acc}
            return q, qd, acc

        return step_imp

    one = step_rk4 if m.integrator == "rk4" else step_euler

    def step(q, qd, ctrl):
        for _ in range(n_substeps):
            q, qd = one(m, q, qd, ctrl)
        return q, qd

    return step
