"""DDPG actor and critic networks (port of surreal_tpu/models/ddpg_nets.py,
vector observations): a tanh-squashed deterministic actor and a critic over
[obs, action], each a relu MLP torso with LayerNorm after its first layer
and a small-uniform last layer."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from surreal_tpu_torch.models.blocks import MLP


def _head(in_dim: int, out_dim: int, generator: torch.Generator | None) -> nn.Linear:
    """flax's variance_scaling(1e-3, "fan_in", "uniform") kernel: uniform on
    ±sqrt(3 · 1e-3 / fan_in); zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    limit = math.sqrt(3.0 * 1e-3 / in_dim)
    with torch.no_grad():
        layer.weight.uniform_(-limit, limit, generator=generator)
        layer.bias.zero_()
    return layer


def _refuse_pixels(pixel_obs: bool) -> None:
    if pixel_obs:
        raise NotImplementedError(
            "pixel observations (the conv stem) are not ported yet (ROADMAP.md, Queue A)")


class DDPGActor(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (300, 200),
                 layer_norm: bool = True, pixel_obs: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        _refuse_pixels(pixel_obs)
        self.torso = MLP(obs_dim, hidden, "relu", layer_norm, generator)
        self.head = _head(self.torso.out_dim, action_dim, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """obs (..., D) -> action (..., A) in (-1, 1)."""
        return torch.tanh(self.head(self.torso(obs)))


class DDPGCritic(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (400, 300),
                 layer_norm: bool = True, pixel_obs: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        _refuse_pixels(pixel_obs)
        self.torso = MLP(obs_dim + action_dim, hidden, "relu", layer_norm, generator)
        self.head = _head(self.torso.out_dim, 1, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """(obs (..., D), action (..., A)) -> Q (...)."""
        return self.head(self.torso(torch.cat([obs, action], dim=-1)))[..., 0]
