"""Pixel observations over a batched env (port of surreal_tpu/envs/wrappers.py).

`PixelWrapper` adds a 'pixel' modality: rasterised (H, W, 1 or 3) frames,
stacked over the last `frame_stack` control steps (channel-concatenated,
newest last), uint8. The low-dim modalities are dropped from the obs dict
unless `keep_low_dim`. The reference's semantics are kept as they are:
- grayscale is the float32 mean of the three channels, truncated to uint8;
- a reset stack is the first frame tiled;
- with `action_repeat`, the action is repeated, the rewards summed, and
  the last inner step's `done`, `discount` and observations kept;
- the terminal-side obs (`Timestep.obs`, the bootstrap input) is the stack
  as it was before the step; the carry stack starts again from the fresh
  frame at a done step.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from surreal_tpu_torch.envs import base
from surreal_tpu_torch.envs.render import make_renderer

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PixelState:
    inner: base.EnvState
    stack: Tensor  # (B, H, W, C·k) uint8, the current episode's frame stack

    def to_dict(self) -> dict:
        return {"inner": self.inner.to_dict(), "stack": self.stack}

    @classmethod
    def from_dict(cls, d: dict) -> PixelState:
        return cls(inner=base.EnvState.from_dict(d["inner"]), stack=d["stack"])


class PixelWrapper:
    def __init__(self, env: base.Environment, height: int = 84, width: int = 84,
                 frame_stack: int = 3, grayscale: bool = True, keep_low_dim: bool = False,
                 action_repeat: int = 1):
        assert env.episode_steps % action_repeat == 0
        self.env = env
        self.episode_steps = env.episode_steps // action_repeat
        self.frame_stack = frame_stack
        self.grayscale = grayscale
        self.keep_low_dim = keep_low_dim
        self.action_repeat = action_repeat
        self._render = make_renderer(env.model, height, width)
        self._channels = (1 if grayscale else 3) * frame_stack
        self._hw = (height, width)

    @property
    def device(self) -> torch.device:
        return self.env.device

    def action_spec(self):
        return self.env.action_spec()

    @property
    def action_dim(self) -> int:
        return self.env.action_dim

    def obs_spec(self):
        spec = dict(self.env.obs_spec()) if self.keep_low_dim else {}
        spec["pixel"] = base.ArraySpec(self._hw + (self._channels,), torch.uint8)
        return spec

    def _frame(self, q: Tensor) -> Tensor:
        img = self._render(q)
        if self.grayscale:
            img = img.to(torch.float32).mean(-1, keepdim=True).to(torch.uint8)
        return img

    def _wrap_obs(self, low_dim_obs: Mapping[str, Tensor], stack: Tensor) -> dict:
        obs = dict(low_dim_obs) if self.keep_low_dim else {}
        obs["pixel"] = stack
        return obs

    def reset(self, batch: int, generator: torch.Generator | None = None,
              reset_draw: Mapping[str, Tensor] | None = None):
        inner, ts = self.env.reset(batch, generator, reset_draw=reset_draw)
        stack = torch.cat([self._frame(inner.q)] * self.frame_stack, -1)
        obs = self._wrap_obs(ts.obs, stack)
        wts = base.Timestep(obs=obs, carry_obs=obs, reward=ts.reward, discount=ts.discount,
                            done=ts.done)
        return PixelState(inner=inner, stack=stack), wts

    def step(self, state: PixelState, action: Tensor, generator: torch.Generator | None = None,
             reset_draw: Sequence[Mapping[str, Tensor]] | None = None):
        """`reset_draw`, if given, holds one reset draw per repeated inner
        step."""
        inner, total = state.inner, None
        for i in range(self.action_repeat):
            inner, ts = self.env.step(inner, action, generator,
                                      reset_draw=None if reset_draw is None else reset_draw[i])
            total = ts.reward if total is None else total + ts.reward
        C = self._channels // self.frame_stack
        # One render a step, from the post-reset state: at a done step the
        # bootstrap input is the stack as of the step before (one frame
        # stale), as in the reference.
        f_new = self._frame(inner.q)
        shifted = torch.cat([state.stack[..., C:], f_new], -1)
        fresh = torch.cat([f_new] * self.frame_stack, -1)
        stack_next = base._pick(ts.done, fresh, shifted)
        wts = base.Timestep(obs=self._wrap_obs(ts.obs, state.stack),
                            carry_obs=self._wrap_obs(ts.carry_obs, stack_next),
                            reward=total, discount=ts.discount, done=ts.done)
        return PixelState(inner=inner, stack=stack_next), wts


def pixel_flatten_obs(obs: Mapping[str, Tensor]) -> Tensor:
    """The policy input of pixel observations: the frame stack."""
    return obs["pixel"]
