"""Network blocks (port of surreal_tpu/models/blocks.py: the MLP torso)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's default Dense kernel init: truncated normal on [-2σ, 2σ] with
    variance 1/fan_in after truncation. `weight` is (out, in)."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class MLP(nn.Module):
    """Hidden layers `dense_i`, each followed by the activation (the flax
    parameter names, so `convert.params_from_flax` maps one to one)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], activation: str = "tanh",
                 generator: torch.Generator | None = None):
        super().__init__()
        if activation != "tanh":
            raise NotImplementedError(f"activation {activation!r} is not ported yet")
        self.num_layers = len(hidden)
        for i, h in enumerate(hidden):
            layer = nn.Linear(in_dim, h)
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
            self.add_module(f"dense_{i}", layer)
            in_dim = h
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = torch.tanh(getattr(self, f"dense_{i}")(x))
        return x
