"""Planar rigid-body dynamics, batched over envs (port of the cheetah subset
of surreal_tpu/envs/physics/engine.py).

Every function takes a batch of states: q, qd (B, nv), ctrl (B, nu). The
reference writes one env and `vmap`s it; here the batch dimension is
written out. The per-body and per-dof loops are unrolled in Python as in
the reference, so an env step is many small launches on the card (the
rollout is launch-bound; CUDA graphs are the planned remedy).

Physics runs in full float32: `device.resolve` turns TF32 off, the
counterpart of the reference's `_highest_precision`.

Only what cheetah uses is ported: ground contacts and joint limits in the
constraint solver, the Euler integrator without implicit impulses, and no
fluid. The other branches raise NotImplementedError (see ROADMAP.md,
Queue A).
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


def _unsupported(m: PlanarModel) -> None:
    if m.npair or m.nrope or m.has_dof_friction or m.neq or m.nwall:
        raise NotImplementedError(
            "pair, wall, rope, equality and dof-friction constraint rows are "
            "not ported yet (ROADMAP.md, Queue A)"
        )
    if m.has_fluid or m.integrator != "euler" or m.implicit_impulse:
        raise NotImplementedError(
            "fluid drag, RK4 and implicit impulses are not ported yet "
            "(ROADMAP.md, Queue A)"
        )
    if m.act_moment is not None or m.body_angle is not None or m.dof_ref is not None:
        raise NotImplementedError(
            "tendon actuation, rotated body frames and joint refs are not "
            "ported yet (ROADMAP.md, Queue A)"
        )


def _fk(m: PlanarModel, q: Tensor, qd: Tensor | None):
    """Forward kinematics and, when qd is given, its time derivative along
    qd (the reference takes it with `jax.jvp`; here it is written out:
    d/dt _rot(a, v) = ȧ·_perp(_rot(a, v)) for a body-fixed v)."""
    B = q.shape[0]
    pos, ang, danchor, daxis = [None] * m.nb, [None] * m.nb, [None] * m.nv, [None] * m.nv
    dpos, dang, ddanchor, ddaxis = [None] * m.nb, [None] * m.nb, [None] * m.nv, [None] * m.nv
    zero2 = q.new_zeros(B, 2)
    zero1 = q.new_zeros(B)
    body_pos = m.tensor("body_pos", q)
    axis = m.tensor("dof_axis", q)
    anchor = m.tensor("dof_anchor", q)
    tangent = qd is not None
    for b in range(m.nb):
        par = m.parent[b]
        if par < 0:
            p, a = body_pos[b].expand(B, 2), zero1
            dp, da = zero2, zero1
        else:
            r = _rot(ang[par], body_pos[b])
            p, a = pos[par] + r, ang[par]
            if tangent:
                dp, da = dpos[par] + dang[par][:, None] * _perp(r), dang[par]
        for j in m.body_dofs[b]:
            qj = q[:, j]
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


def mass_matrix(m: PlanarModel, q: Tensor, fkd: FK | None = None) -> Tensor:
    """Joint-space inertia M(q) = Σ_b m_b J_vᵀJ_v + I_b J_ωᵀJ_ω + armature."""
    nb = m.nb
    _, Jv, _, _ = point_jacobians(m, q, m.tensor("com", q), np.arange(nb), fkd=fkd)
    mass = m.tensor("mass", q)
    M = torch.einsum("b,nbcj,nbck->njk", mass, Jv, Jv)

    def rot_inertia():  # q-independent: Σ_b I_b J_ωᵀJ_ω + diag(armature), in f32
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
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
                     lambda: np.stack([np.zeros(m.nb), np.full(m.nb, np.float32(m.gravity))], -1))
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


def _project_jacobi(m: PlanarModel, q: Tensor, v: Tensor, M_inv: Tensor, h: float,
                    n_iter: int = 20, relax: float = 0.7, fkd: FK | None = None):
    """Projected Jacobi on ground-contact and joint-limit rows. Row layout:
    [normals | tangents (boxed by μ·λn) | limits (λ ≥ 0)], one limit row
    per dof (zero when inactive), as in the reference."""
    _unsupported(m)
    nc = m.ncon
    has_limits = bool(np.any(m.limited))
    if not (nc or has_limits):
        return v
    rows, targets = [], []
    if nc:
        J, depth = _contact_kinematics(m, q, fkd=fkd)
        active = (depth > 0).to(q.dtype)
        n_rows = J[:, :, 1, :] * active[..., None]
        t_rows = J[:, :, 0, :] * active[..., None]
        n_tgt = torch.clamp(torch.clamp(depth, min=0.0) / m.contact_timeconst, max=_PUSH_CAP)
        rows += [n_rows, t_rows]
        targets += [n_tgt, torch.zeros_like(n_tgt)]
        mu = m.tensor("con_friction", q)
    if has_limits:
        lo = m.tensor("joint_range", q)[:, 0]
        hi = m.tensor("joint_range", q)[:, 1]
        viol_lo = torch.clamp(lo - q, min=0.0)
        viol_hi = torch.clamp(q - hi, min=0.0)
        lim_sign = torch.sign(viol_lo - viol_hi) * m.tensor("limited", q)
        rows.append(torch.diag_embed(lim_sign))
        targets.append(torch.clamp((viol_lo + viol_hi) / m.limit_timeconst, max=_PUSH_CAP))

    J_all = torch.cat(rows, 1)  # (B, C, nv)
    target = torch.cat(targets, 1)  # (B, C)
    MJ = J_all @ M_inv
    W = MJ @ J_all.transpose(1, 2)  # (B, C, C) Delassus
    # Row-sum (mass-splitting) scaling; see the reference for why.
    diagW = torch.clamp(torch.sum(torch.abs(W), dim=2), min=1e-9)
    if nc:
        shared = torch.maximum(diagW[:, :nc], diagW[:, nc : 2 * nc])
        diagW = torch.cat([shared, shared, diagW[:, 2 * nc :]], 1)
    b = (J_all @ v[..., None])[..., 0] - target

    def project(lam):
        parts = []
        if nc:
            ln_box = torch.clamp(lam[:, :nc], min=0.0)
            bound = mu * ln_box
            parts += [ln_box, torch.clamp(lam[:, nc : 2 * nc], min=-bound, max=bound)]
        if has_limits:
            parts.append(torch.clamp(lam[:, 2 * nc :], min=0.0))
        return torch.cat(parts, 1) if len(parts) > 1 else parts[0]

    lam = torch.zeros_like(target)
    for _ in range(n_iter):
        resid = (W @ lam[..., None])[..., 0] + b
        lam = project(lam - relax * resid / diagW)
    return v + (MJ.transpose(1, 2) @ lam[..., None])[..., 0]


def passive_spring_forces(m: PlanarModel, q: Tensor) -> Tensor:
    return -m.tensor("stiffness", q) * (q - m.tensor("springref", q))


def actuation(m: PlanarModel, ctrl: Tensor) -> Tensor:
    """Generalized forces from motor actuators (ctrl clipped to [-1, 1])."""
    _unsupported(m)
    ctrl = torch.clamp(ctrl, -1.0, 1.0)
    idx = torch.as_tensor(m.act_dof, device=ctrl.device)
    tau = ctrl.new_zeros(ctrl.shape[0], m.nv)
    return tau.index_add(1, idx, m.tensor("gear", ctrl) * ctrl)


def smooth_forces(m: PlanarModel, q, qd, ctrl, fkd=None, fkd_dot=None) -> Tensor:
    """Actuation + joint springs − bias (cheetah has no fluid)."""
    _unsupported(m)
    if fkd is None or fkd_dot is None:
        fkd, fkd_dot = fk_dofs_dot(m, q, qd)
    return (actuation(m, ctrl) + passive_spring_forces(m, q)
            - bias_forces(m, q, qd, fkd=fkd, fkd_dot=fkd_dot))


def step_euler(m: PlanarModel, q: Tensor, qd: Tensor, ctrl: Tensor, h: float | None = None):
    """Semi-implicit Euler with implicitly integrated joint damping,
    (M + hD) v̇ = f − D v, then constraint projection of the candidate
    velocity with M⁻¹, then q += h v."""
    _unsupported(m)
    h = m.dt if h is None else h
    ctrl = ctrl.to(q.dtype)
    D = m.tensor("damping", q)
    fkd, fkd_dot = fk_dofs_dot(m, q, qd)
    M = mass_matrix(m, q, fkd=fkd)
    f = smooth_forces(m, q, qd, ctrl, fkd=fkd, fkd_dot=fkd_dot) - D * qd
    M_inv = inv_spd(M)
    qacc = solve_spd(M + h * torch.diag(D), f)
    v_star = qd + h * qacc
    qd_new = _project_jacobi(m, q, v_star, M_inv, h, fkd=fkd)
    return q + h * qd_new, qd_new


def make_stepper(m: PlanarModel, n_substeps: int = 1) -> Callable:
    """Returns step(q, qd, ctrl) -> (q, qd) advancing n_substeps physics
    steps of size m.dt with ctrl held constant."""
    _unsupported(m)

    def step(q, qd, ctrl):
        for _ in range(n_substeps):
            q, qd = step_euler(m, q, qd, ctrl)
        return q, qd

    return step
