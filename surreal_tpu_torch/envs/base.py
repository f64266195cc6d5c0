"""Batched environment API (port of surreal_tpu/envs/base.py).

The reference writes one env as pure functions and `vmap`s it; here an
`Environment` steps a whole batch of envs held in one `EnvState` of
(B, ...) tensors. Conventions are the reference's:
- episodes are fixed-length; `discount` stays 1.0 at the time limit;
- `Timestep.done` marks the step after which the env auto-reset: `obs` is
  the terminal observation (the bootstrap target) and `carry_obs` the
  observation of the returned, already reset state (the next policy input).

Auto-reset rows are drawn from an explicit `torch.Generator`, or passed in
as `reset_rows` (tests inject the reference's draw that way).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EnvState:
    q: Tensor  # (B, nq)
    qd: Tensor  # (B, nv)
    t: Tensor  # (B,) int32 steps taken this episode


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
    """Subclasses implement `_init`, `_physics_step`, `_obs`, `_reward`,
    each over a batch."""

    episode_steps: int = 1000
    num_reset_rows: int  # size of the pool `_init` draws from
    device: torch.device  # where the env batch lives

    def obs_spec(self) -> Mapping[str, ArraySpec]:
        raise NotImplementedError

    def action_spec(self) -> ArraySpec:
        raise NotImplementedError

    @property
    def action_dim(self) -> int:
        return self.action_spec().shape[0]

    def _init(self, rows: Tensor) -> tuple[Tensor, Tensor]:
        """Start state (q, qd) of new episodes from reset-pool rows (B,)."""
        raise NotImplementedError

    def _physics_step(self, q: Tensor, qd: Tensor, action: Tensor) -> tuple[Tensor, Tensor]:
        raise NotImplementedError

    def _obs(self, q: Tensor, qd: Tensor) -> Mapping[str, Tensor]:
        raise NotImplementedError

    def _reward(self, q: Tensor, qd: Tensor, action: Tensor) -> Tensor:
        raise NotImplementedError

    def draw_reset_rows(self, batch: int, generator: torch.Generator) -> Tensor:
        return torch.randint(0, self.num_reset_rows, (batch,), generator=generator,
                             device=generator.device)

    def reset(self, batch: int, generator: torch.Generator | None = None,
              reset_rows: Tensor | None = None) -> tuple[EnvState, Timestep]:
        if reset_rows is None:
            reset_rows = self.draw_reset_rows(batch, generator)
        q, qd = self._init(reset_rows)
        state = EnvState(q=q, qd=qd, t=torch.zeros(batch, dtype=torch.int32, device=q.device))
        obs = self._obs(q, qd)
        ts = Timestep(obs=obs, carry_obs=obs, reward=q.new_zeros(batch),
                      discount=q.new_ones(batch),
                      done=torch.zeros(batch, dtype=torch.bool, device=q.device))
        return state, ts

    def step(self, state: EnvState, action: Tensor, generator: torch.Generator | None = None,
             reset_rows: Tensor | None = None) -> tuple[EnvState, Timestep]:
        """Steps physics; auto-resets the envs whose episode ended (the
        returned Timestep carries their terminal obs and reward)."""
        q, qd = self._physics_step(state.q, state.qd, action)
        t = state.t + 1
        # Divergence guard: a diverged env (non-finite or |x| >= 1e8) scores
        # reward 0, ends its episode and exposes the fresh episode's obs.
        def finite(x):
            return torch.isfinite(x).all(-1) & (torch.amax(torch.abs(x), -1) < 1e8)

        diverged = ~(finite(q) & finite(qd))
        q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
        qd = torch.where(torch.isfinite(qd), qd, torch.zeros_like(qd))
        reward = self._reward(q, qd, action)
        obs = self._obs(q, qd)
        done = (t >= self.episode_steps) | diverged
        reward = torch.where(diverged, torch.zeros_like(reward), reward)
        # Auto-reset: the fresh state is computed for every env and selected
        # by `done`, as in the reference.
        if reset_rows is None:
            reset_rows = self.draw_reset_rows(q.shape[0], generator)
        q0, qd0 = self._init(reset_rows)
        d = done[:, None]
        new_state = EnvState(q=torch.where(d, q0, q), qd=torch.where(d, qd0, qd),
                             t=torch.where(done, torch.zeros_like(t), t))
        obs0 = self._obs(q0, qd0)
        carry_obs = {k: torch.where(d, obs0[k], obs[k]) for k in obs}
        obs = {k: torch.where(diverged[:, None], obs0[k], obs[k]) for k in obs}
        ts = Timestep(obs=obs, carry_obs=carry_obs, reward=reward,
                      discount=torch.ones_like(reward), done=done)
        return new_state, ts


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
