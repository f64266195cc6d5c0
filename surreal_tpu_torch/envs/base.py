"""Batched environment API (port of surreal_tpu/envs/base.py).

The reference writes one env as pure functions and `vmap`s it; here an
`Environment` steps a whole batch of envs held in one `EnvState` of
(B, ...) tensors. Conventions are the reference's:
- episodes are fixed-length; `discount` stays 1.0 at the time limit;
- `Timestep.done` marks the step after which the env auto-reset: `obs` is
  the terminal observation (the bootstrap target) and `carry_obs` the
  observation of the returned, already reset state (the next policy input).

Every env draws the random part of a new episode's start state with
`draw_reset(batch, generator)`: a dict of named (batch, ...) tensors holding
the sampled values, in the reference's ranges. `_init(draw)` builds
(q, qd) from them (any rejection step runs there). `reset` and `step` take
an injected `reset_draw` in place of a fresh one (tests inject the
reference's draws, recomputed from its keys, that way).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Mapping

import torch

from surreal_tpu_torch.envs.physics.model import HINGE, PlanarModel
from surreal_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

# The baked assets are data files of the reference package, read in place.
ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "surreal_tpu", "envs", "assets",
)


@dataclasses.dataclass(frozen=True)
class EnvState:
    q: Tensor  # (B, nq)
    qd: Tensor  # (B, nv)
    t: Tensor  # (B,) int32 steps taken this episode

    def to_dict(self) -> dict:
        """The tensors by field name, for a checkpoint's full state."""
        return {"q": self.q, "qd": self.qd, "t": self.t}

    @classmethod
    def from_dict(cls, d: dict) -> EnvState:
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Timestep:
    obs: Mapping[str, Tensor]
    carry_obs: Mapping[str, Tensor]
    reward: Tensor  # (B,)
    discount: Tensor  # (B,)
    done: Tensor  # (B,) bool


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    shape: tuple[int, ...]
    dtype: Any
    minimum: float | None = None
    maximum: float | None = None


class Environment:
    """Subclasses implement `draw_reset`, `_init`, `_physics_step`, `_obs`,
    `_reward`, each over a batch."""

    episode_steps: int = 1000
    model: PlanarModel
    device: torch.device  # where the env batch lives
    dtype: torch.dtype

    def obs_spec(self) -> Mapping[str, ArraySpec]:
        raise NotImplementedError

    def action_spec(self) -> ArraySpec:
        raise NotImplementedError

    @property
    def action_dim(self) -> int:
        return self.action_spec().shape[0]

    def draw_reset(self, batch: int, generator: torch.Generator) -> dict[str, Tensor]:
        """The random values that `_init` turns into start states."""
        raise NotImplementedError

    def _init(self, draw: Mapping[str, Tensor]) -> tuple[Tensor, Tensor]:
        """Start state (q, qd) of new episodes from a reset draw."""
        raise NotImplementedError

    def _physics_step(self, q: Tensor, qd: Tensor, action: Tensor) -> tuple[Tensor, Tensor]:
        raise NotImplementedError

    def _obs(self, q: Tensor, qd: Tensor) -> Mapping[str, Tensor]:
        raise NotImplementedError

    def _reward(self, q: Tensor, qd: Tensor, action: Tensor) -> Tensor:
        raise NotImplementedError

    def _joint_range(self) -> Tensor:
        """The model's joint ranges (nv, 2) on the env's device and dtype."""
        return self.model.tensor("joint_range", torch.empty(0, device=self.device,
                                                            dtype=self.dtype))

    def _uniform(self, shape, generator: torch.Generator, lo=0.0, hi=1.0) -> Tensor:
        """U(lo, hi) of `shape` on the env's device; lo and hi broadcast."""
        u = torch.rand(shape, generator=generator, device=self.device, dtype=self.dtype)
        return lo + u * (hi - lo)

    def _normal(self, shape, generator: torch.Generator) -> Tensor:
        return torch.randn(shape, generator=generator, device=self.device, dtype=self.dtype)

    def reset(self, batch: int, generator: torch.Generator | None = None,
              reset_draw: Mapping[str, Tensor] | None = None) -> tuple[EnvState, Timestep]:
        if reset_draw is None:
            reset_draw = self.draw_reset(batch, generator)
        q, qd = self._init(reset_draw)
        state = EnvState(q=q, qd=qd, t=torch.zeros(batch, dtype=torch.int32, device=q.device))
        obs = self._obs(q, qd)
        ts = Timestep(obs=obs, carry_obs=obs, reward=q.new_zeros(batch),
                      discount=q.new_ones(batch),
                      done=torch.zeros(batch, dtype=torch.bool, device=q.device))
        return state, ts

    def step(self, state: EnvState, action: Tensor, generator: torch.Generator | None = None,
             reset_draw: Mapping[str, Tensor] | None = None) -> tuple[EnvState, Timestep]:
        """Steps physics; auto-resets the envs whose episode ended (the
        returned Timestep carries their terminal obs and reward)."""
        with span("env.step"):
            with span("env.physics"):
                q, qd = self._physics_step(state.q, state.qd, action)
            with span("env.reward_obs"):
                t = state.t + 1
                # Divergence guard: a diverged env (non-finite or |x| >= 1e8)
                # scores reward 0, ends its episode and exposes the fresh
                # episode's obs.
                def finite(x):
                    return torch.isfinite(x).all(-1) & (torch.amax(torch.abs(x), -1) < 1e8)

                diverged = ~(finite(q) & finite(qd))
                q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
                qd = torch.where(torch.isfinite(qd), qd, torch.zeros_like(qd))
                reward = self._reward(q, qd, action)
                obs = self._obs(q, qd)
                done = (t >= self.episode_steps) | diverged
                reward = torch.where(diverged, torch.zeros_like(reward), reward)
            # Auto-reset: the fresh state is computed for every env and
            # selected by `done`, as in the reference.
            with span("env.reset"):
                if reset_draw is None:
                    reset_draw = self.draw_reset(q.shape[0], generator)
                q0, qd0 = self._init(reset_draw)
                new_state = EnvState(q=_pick(done, q0, q), qd=_pick(done, qd0, qd),
                                     t=torch.where(done, torch.zeros_like(t), t))
                obs0 = self._obs(q0, qd0)
                carry_obs = {k: _pick(done, obs0[k], obs[k]) for k in obs}
                obs = {k: _pick(diverged, obs0[k], obs[k]) for k in obs}
            return new_state, Timestep(obs=obs, carry_obs=carry_obs, reward=reward,
                                       discount=torch.ones_like(reward), done=done)


def _pick(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """Per env: a where mask (B,) is set, else b; a and b are (B, ...)."""
    return torch.where(mask.view(-1, *[1] * (a.ndim - 1)), a, b)


def flatten_obs(obs: Mapping[str, Tensor]) -> Tensor:
    """Concatenates the low-dim obs entries in sorted key order; a (B,)
    entry counts as one feature."""
    parts = [v for k, v in sorted(obs.items()) if k != "pixel"]
    max_rank = max(p.ndim for p in parts)
    parts = [p[..., None] if p.ndim < max_rank else p for p in parts]
    return torch.cat(parts, dim=-1)


def obs_flat_dim(env: Environment) -> int:
    spec = env.obs_spec()
    total = 0
    for k in sorted(spec.keys()):
        if k == "pixel":
            continue
        shape = spec[k].shape
        total += shape[0] if shape else 1
    return total


def draw_limited_and_rotational(env: Environment, batch: int,
                                generator: torch.Generator) -> dict[str, Tensor]:
    """dm_control's `randomize_limited_and_rotational_joints` draw (walker,
    hopper): every dof's U(joint range) and U(−π, π); `init_limited_and_
    rotational` keeps the first on limited joints, the second on unlimited
    hinges and 0 on unlimited slides."""
    rng, nv = env._joint_range(), env.model.nv
    return {"u_lim": env._uniform((batch, nv), generator, rng[:, 0], rng[:, 1]),
            "u_rot": env._uniform((batch, nv), generator, -math.pi, math.pi)}


def init_limited_and_rotational(env: Environment, draw: Mapping[str, Tensor]):
    m = env.model
    like = draw["u_lim"]
    limited = m.tensor("limited", like).bool()
    is_hinge = m.tensor("is_hinge_dof", like, lambda: [t == HINGE for t in m.dof_type]).bool()
    q = torch.where(limited, draw["u_lim"],
                    torch.where(is_hinge, draw["u_rot"], torch.zeros_like(like)))
    return q, torch.zeros_like(q)


def first_free(candidates, depths, *others):
    """Per env, the first of K candidates (B, K, ...) whose penetration depth
    (B, K) is ≤ 0, else the shallowest one; `others` (B, K, ...) are
    gathered at the same index. The reference's rejection step."""
    free = depths <= 0.0
    idx = torch.where(free.any(1), torch.argmax(free.to(torch.int32), 1),
                      torch.argmin(depths, 1))
    rows = torch.arange(depths.shape[0], device=depths.device)
    picked = [x[rows, idx] for x in (candidates, *others)]
    return picked[0] if not others else picked
