"""DDPG actor and critic networks (port of surreal_tpu/models/ddpg_nets.py):
a tanh-squashed deterministic actor and a critic over [obs, action], each a
relu MLP torso with LayerNorm after its first layer and a small-uniform
last layer. With `pixel_obs` each net has its own conv stem in front
(`obs_dim` is then the frame stack's shape (H, W, C)); the actor's
`detach_stem` (shared-encoder mode) stops the actor loss's gradient at its
stem, which moves only by copies of the critic's (`algos.ddpg.sync_encoder`).
In a `compute_dtype` below float32 the actor's tanh is taken in float32 and
Q is cast to float32, as in the reference; the critic's `torch.cat`
promotes a bfloat16 stem output beside a float32 action to float32, as
`jnp.concatenate` does, and its torso casts the result down."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from surreal_tpu_torch.models.blocks import MLP, ConvStem, linear


def _head(in_dim: int, out_dim: int, generator: torch.Generator | None) -> nn.Linear:
    """flax's variance_scaling(1e-3, "fan_in", "uniform") kernel: uniform on
    ±sqrt(3 · 1e-3 / fan_in); zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    limit = math.sqrt(3.0 * 1e-3 / in_dim)
    with torch.no_grad():
        layer.weight.uniform_(-limit, limit, generator=generator)
        layer.bias.zero_()
    return layer


def _stem(obs_dim, pixel_obs: bool, generator: torch.Generator | None,
          compute_dtype: torch.dtype):
    """(the conv stem or None, the torso's input size)."""
    if not pixel_obs:
        return None, obs_dim
    stem = ConvStem(obs_dim, generator=generator, compute_dtype=compute_dtype)
    return stem, stem.out_dim


class DDPGActor(nn.Module):
    flax_stem_key = "ConvStem_0"  # the compact flax nets' stem (models.convert)

    def __init__(self, obs_dim: int | Sequence[int], action_dim: int,
                 hidden: Sequence[int] = (300, 200), layer_norm: bool = True,
                 pixel_obs: bool = False, detach_stem: bool = False,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem, in_dim = _stem(obs_dim, pixel_obs, generator, compute_dtype)
        self.detach_stem = detach_stem
        self.torso = MLP(in_dim, hidden, "relu", layer_norm, generator, compute_dtype)
        self.head = _head(self.torso.out_dim, action_dim, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """obs (..., D) or (..., H, W, C) -> action (..., A) in (-1, 1)."""
        x = obs
        if self.stem is not None:
            x = self.stem(obs)
            if self.detach_stem:
                x = x.detach()
        return torch.tanh(linear(self.head, self.torso(x)).to(torch.float32))


class DDPGCritic(nn.Module):
    flax_stem_key = "ConvStem_0"  # the compact flax nets' stem (models.convert)

    def __init__(self, obs_dim: int | Sequence[int], action_dim: int,
                 hidden: Sequence[int] = (400, 300), layer_norm: bool = True,
                 pixel_obs: bool = False, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem, in_dim = _stem(obs_dim, pixel_obs, generator, compute_dtype)
        self.torso = MLP(in_dim + action_dim, hidden, "relu", layer_norm, generator,
                         compute_dtype)
        self.head = _head(self.torso.out_dim, 1, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """(obs (..., D) or (..., H, W, C), action (..., A)) -> Q (...)."""
        x = obs if self.stem is None else self.stem(obs)
        q = linear(self.head, self.torso(torch.cat([x, action], dim=-1)))
        return q.to(torch.float32)[..., 0]
