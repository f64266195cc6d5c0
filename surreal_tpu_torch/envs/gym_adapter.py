"""Gymnasium adapter: a batch of host-loop envs behind the port's batched
`Environment` surface (port of surreal_tpu/envs/gym_adapter.py), so the
same trainers run on them unchanged.

Every step is a host round trip: the actions come to the host once, the
gymnasium envs step there, and the observations, rewards, discounts and
dones go to the env's device in one copy. The policy, the trajectory and
the update stay on the trainer's device. The env state lives in
gymnasium; the `EnvState` this env returns has zero width and is never
read. gymnasium is imported when the env is built.

The reference's semantics are kept as they are: `reset` reseeds every env
with `seed` on every call; an action in [-1, 1] is rescaled to the action
space's bounds and not clipped; `discount` is 1 − terminated, so a
truncation keeps 1; `obs` holds the terminal observation where gymnasium
reports one in `info["final_observation"]`, `carry_obs` what gymnasium
returned. Under gymnasium's default next-step auto-reset (1.x), no such key
exists: the step that ends an episode returns its last observation, and
the next step is the reset itself, with reward 0 and the action ignored.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.envs import base


class GymEnv(base.Environment):
    """`num_envs` gymnasium envs of `env_id` in a `SyncVectorEnv`; `reset`
    and `step` take batches of exactly `num_envs`."""

    def __init__(self, env_id: str, num_envs: int, seed: int = 0,
                 episode_steps: int | None = None,
                 device: torch.device | str | None = None, dtype=torch.float32,
                 **gym_kwargs):
        import gymnasium as gym

        self.device = resolve_device(device)
        self.dtype = dtype
        self._envs = gym.vector.SyncVectorEnv(
            [lambda: gym.make(env_id, **gym_kwargs) for _ in range(num_envs)])
        self.env_id = env_id
        self.num_envs = num_envs
        self._seed = seed
        self._gym_kwargs = gym_kwargs
        space = self._envs.single_action_space
        obs_space = self._envs.single_observation_space
        if len(space.shape) != 1 or len(obs_space.shape) != 1:
            raise ValueError(f"{env_id}: flat observation and action spaces only")
        self._action_dim = space.shape[0]
        self._obs_dim = obs_space.shape[0]
        self._lo = np.asarray(space.low, np.float32)
        self._hi = np.asarray(space.high, np.float32)
        spec = getattr(self._envs.envs[0], "spec", None)
        self.episode_steps = episode_steps or (
            spec.max_episode_steps if spec and spec.max_episode_steps else 1000)

    def spawn(self, num_envs: int) -> GymEnv:
        """A new batch of `num_envs` envs of the same id, seed, episode
        length, device and dtype, with episodes of its own."""
        return GymEnv(self.env_id, num_envs, self._seed, self.episode_steps, self.device,
                      self.dtype, **self._gym_kwargs)

    def close(self) -> None:
        self._envs.close()

    # ---- specs ----
    def obs_spec(self) -> Mapping[str, base.ArraySpec]:
        return {"observations": base.ArraySpec((self._obs_dim,), self.dtype)}

    def action_spec(self) -> base.ArraySpec:
        return base.ArraySpec((self._action_dim,), self.dtype, -1.0, 1.0)

    # ---- the host side ----
    def _check_batch(self, batch: int) -> None:
        if batch != self.num_envs:
            raise ValueError(f"{self.env_id}: a batch of {batch} envs was asked for, but this "
                             f"GymEnv holds num_envs={self.num_envs}")

    def _to_host(self, action: torch.Tensor) -> np.ndarray:
        return action.detach().to("cpu", torch.float32).numpy()

    def _host_step(self, action: np.ndarray) -> np.ndarray:
        """Steps the gymnasium envs; returns (B, 2·obs_dim + 3) float32: the
        carried obs, the terminal obs, reward, discount and done."""
        a = self._lo + (action * 0.5 + 0.5) * (self._hi - self._lo)
        obs, reward, terminated, truncated, info = self._envs.step(a)
        done = np.logical_or(terminated, truncated)
        term_obs = obs.copy()
        if "final_observation" in info:
            for i, fo in enumerate(info["final_observation"]):
                if fo is not None:
                    term_obs[i] = fo
        return np.concatenate(
            [obs.astype(np.float32), term_obs.astype(np.float32),
             reward.astype(np.float32)[:, None],
             (1.0 - terminated.astype(np.float32))[:, None],
             done.astype(np.float32)[:, None]], axis=1)

    def _to_device(self, packed: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(packed).to(self.device)

    def _zero_state(self) -> base.EnvState:
        z = torch.zeros(self.num_envs, 0, dtype=self.dtype, device=self.device)
        return base.EnvState(q=z, qd=z, t=torch.zeros(self.num_envs, dtype=torch.int32,
                                                      device=self.device))

    # ---- the batched surface ----
    def reset(self, batch: int, generator: torch.Generator | None = None,
              reset_draw=None) -> tuple[base.EnvState, base.Timestep]:
        self._check_batch(batch)
        obs, _ = self._envs.reset(seed=self._seed)
        o = {"observations": self._to_device(obs.astype(np.float32)).to(self.dtype)}
        ts = base.Timestep(
            obs=o, carry_obs=o, reward=torch.zeros(batch, dtype=self.dtype, device=self.device),
            discount=torch.ones(batch, dtype=self.dtype, device=self.device),
            done=torch.zeros(batch, dtype=torch.bool, device=self.device))
        return self._zero_state(), ts

    def step(self, state: base.EnvState, action: torch.Tensor,
             generator: torch.Generator | None = None,
             reset_draw=None) -> tuple[base.EnvState, base.Timestep]:
        self._check_batch(action.shape[0])
        out = self._to_device(self._host_step(self._to_host(action)))
        d = self._obs_dim
        vals = out.to(self.dtype)
        ts = base.Timestep(obs={"observations": vals[:, d:2 * d]},
                           carry_obs={"observations": vals[:, :d]},
                           reward=vals[:, 2 * d], discount=vals[:, 2 * d + 1],
                           done=out[:, 2 * d + 2] > 0)
        return state, ts
