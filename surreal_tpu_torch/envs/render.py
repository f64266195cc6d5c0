"""Rasteriser for planar scenes, the pixel observations (port of
surreal_tpu/envs/render.py).

A 2-D signed-distance rasteriser over the model's capsule geoms: per pixel
and per geom, the distance from the pixel's centre to the capsule's core
segment, and a smooth coverage of (radius - distance). The geoms composite
with max(); a striped ground fills z < 0. Contact models draw their capsule
geoms; models without contacts (cartpole, pendulum, acrobot) draw a stick
figure of their body tree.

The reference renders one env and `vmap`s it; `make_renderer` here returns
a function of a batch of states, q (B, nq) -> (B, H, W, 3) uint8, on q's
device. Its (B, H, W, G, 2) intermediates take B·H·W·G·8 bytes each (58 MB
at B = 128, 84 x 84 and cheetah's G = 8).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from surreal_tpu_torch.envs.physics import engine
from surreal_tpu_torch.envs.physics.model import SLIDE, PlanarModel

Tensor = torch.Tensor


def _geom_segments(m: PlanarModel):
    """(body (G,), p0 (G, 2), p1 (G, 2), radius (G,)) in body frames. The
    contact candidates hold two consecutive entries per capsule (same body,
    same radius); a lone entry is a point geom. Without contacts, the stick
    figure of `_skeleton_segments`."""
    if m.ncon == 0:
        return _skeleton_segments(m)
    pts, bodies, radii = m.con_pos, np.asarray(m.con_body), m.con_radius
    segs = []
    i = 0
    while i < len(bodies):
        if i + 1 < len(bodies) and bodies[i + 1] == bodies[i] and radii[i + 1] == radii[i]:
            segs.append((bodies[i], pts[i], pts[i + 1], radii[i]))
            i += 2
        else:
            segs.append((bodies[i], pts[i], pts[i], radii[i]))
            i += 1
    return (np.array([s[0] for s in segs]), np.array([s[1] for s in segs]),
            np.array([s[2] for s in segs]), np.array([s[3] for s in segs]))


def _skeleton_segments(m: PlanarModel):
    """Each body draws origin -> 2·COM (a uniform link's far end), or a short
    bar for a point body (the cart), plus a connector to every child's frame
    origin."""
    segs = []
    for b in range(m.nb):
        end = 2.0 * np.asarray(m.com[b], float)
        if np.linalg.norm(end) < 1e-6:  # point body
            segs.append((b, np.array([-0.1, 0.0]), np.array([0.1, 0.0]), 0.05))
        else:
            segs.append((b, np.zeros(2), end, 0.045))
        for c in range(m.nb):
            if m.parent[c] == b and np.linalg.norm(m.body_pos[c]) > 1e-6:
                segs.append((b, np.zeros(2), np.asarray(m.body_pos[c], float), 0.04))
    return (np.array([s[0] for s in segs]), np.array([s[1] for s in segs]),
            np.array([s[2] for s in segs]), np.array([s[3] for s in segs]))


def _linspace32(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num, dtype=float32)` as JAX computes it:
    start·(1 − s) + stop·s with s = i / (num − 1) in float32, the last
    point exactly `stop`."""
    lo, hi = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([lo], np.float32)
    div = np.float32(num - 1)
    s = np.arange(num - 1, dtype=np.float32) / div
    return np.append(lo * (np.float32(1) - s) + hi * s, hi).astype(np.float32)


def root_floats(m: PlanarModel) -> bool:
    """A free-floating locomotion root (a z-slide dof on body 0: cheetah,
    walker, hopper) gets a fixed camera height; fixed-base models are framed
    on the root body."""
    return any(m.dof_body[j] == 0 and m.dof_type[j] == SLIDE and abs(m.dof_axis[j][1]) > 1e-8
               for j in range(m.nv))


def make_renderer(m: PlanarModel, height: int = 84, width: int = 84,
                  half_extent: float = 1.2):
    """Returns `render(q) -> (B, H, W, 3) uint8` for a batch of states q
    (B, nq), on q's device. The camera follows the root body's x."""
    gb, gp0, gp1, gr = _geom_segments(m)
    floats = root_floats(m)
    xs = _linspace32(-half_extent, half_extent, width)
    zs = _linspace32(half_extent, -half_extent, height)
    shades = np.linspace(0.55, 1.0, len(gb)).astype(np.float32)
    pitch = 2 * half_extent / width
    width_s = 0.7 * pitch  # sigmoid width of the anti-aliased edges
    consts: dict = {}

    def const(like: Tensor):
        key = like.device
        if key not in consts:
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=like.device)
            consts[key] = (torch.as_tensor(gb, device=like.device), f32(gp0), f32(gp1), f32(gr),
                           f32(xs), f32(zs), f32(shades))
        return consts[key]

    def render(q: Tensor) -> Tensor:
        b_idx, p0, p1, R, xs_t, zs_t, shades_t = const(q)
        B = q.shape[0]
        pos, ang = engine.fk(m, q)  # (B, nb, 2), (B, nb)
        P0 = pos[:, b_idx] + engine._rot(ang[:, b_idx], p0)  # (B, G, 2)
        P1 = pos[:, b_idx] + engine._rot(ang[:, b_idx], p1)
        cx = pos[:, 0, 0]
        cz = q.new_full((B,), float(np.float32(0.6 * half_extent))) if floats else pos[:, 0, 1]
        px = (cx[:, None] + xs_t)[:, None, :].expand(B, height, width)  # (B, H, W)
        pz = (cz[:, None] + zs_t)[:, :, None].expand(B, height, width)
        pix = torch.stack([px, pz], -1)  # (B, H, W, 2)

        # point-to-segment distance for every geom
        d = P1 - P0  # (B, G, 2)
        len2 = torch.clamp((d * d).sum(-1), min=1e-12)  # (B, G)
        rel = pix[:, :, :, None, :] - P0[:, None, None]  # (B, H, W, G, 2)
        dn = d[:, None, None]
        t = torch.clamp((rel[..., 0] * dn[..., 0] + rel[..., 1] * dn[..., 1])
                        / len2[:, None, None], 0.0, 1.0)  # (B, H, W, G)
        closest = P0[:, None, None] + t[..., None] * dn
        dist = torch.sqrt(((pix[:, :, :, None] - closest) ** 2).sum(-1) + 1e-12)

        cover = torch.sigmoid((R - dist) / width_s)  # (B, H, W, G)
        body_mask = cover.amax(-1)
        body_shade = (cover * shades_t).amax(-1)
        ground = torch.sigmoid((0.0 - pz) / width_s)
        # world-fixed stripes on the ground: the optical-flow cue for speed
        stripes = 0.5 + 0.5 * torch.sin(px * (2 * math.pi / 0.5))
        ground_shade = 0.38 + 0.14 * stripes
        img = 0.2 + (ground_shade - 0.2) * ground
        img = img * (1 - body_mask) + body_shade * body_mask
        rgb = torch.stack([img, img * (1 - 0.3 * body_mask), img * (1 - 0.6 * body_mask)], -1)
        return (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8)  # truncated, as astype

    return render
