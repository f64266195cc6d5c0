"""Frozen copy of surreal_tpu_torch/envs/physics/model.py as of the benchmark's
first version, kept so that the yardstick does not move with the program.
It imports nothing of the program. Its own docstring follows.

Planar articulated rigid-body model description (port of
surreal_tpu/envs/physics/model.py): the dataclass and the baked-asset `load`
(`from_mujoco` and `save` are left out of this copy).

The model holds small NumPy constants. Engine functions need them as
tensors on the state's device; `PlanarModel.tensor` converts each field
once per (device, dtype) and keeps it on the instance.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

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
               make: Callable[[], np.ndarray] | None = None) -> torch.Tensor:
        """Field `name` (or the array `make()` derives from the model) as a
        tensor on `like`'s device and dtype, converted once and cached."""
        key = (name, like.device, like.dtype)
        t = self._tensors.get(key)
        if t is None:
            arr = make() if make is not None else getattr(self, name)
            t = torch.as_tensor(np.asarray(arr), device=like.device).to(like.dtype)
            self._tensors[key] = t
        return t


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
