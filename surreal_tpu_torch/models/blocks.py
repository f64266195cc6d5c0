"""Network blocks (port of surreal_tpu/models/blocks.py: the MLP torso;
and the LSTM cell the reference takes from flax)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


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
    parameter names, so `convert.params_from_flax` maps one to one). With
    `layer_norm`, the output of the first dense layer, and of no other, is
    normalised before its activation."""

    def __init__(self, in_dim: int, hidden: Sequence[int], activation: str = "tanh",
                 layer_norm: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise NotImplementedError(f"activation {activation!r} is not ported yet")
        self.activation = _ACTIVATIONS[activation]
        self.num_layers = len(hidden)
        for i, h in enumerate(hidden):
            layer = nn.Linear(in_dim, h)
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
            self.add_module(f"dense_{i}", layer)
            in_dim = h
        # flax's LayerNorm: epsilon 1e-6 (torch's default is 1e-5)
        self.layer_norm = nn.LayerNorm(hidden[0], eps=1e-6) if layer_norm else None
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i == 0 and self.layer_norm is not None:
                x = self.layer_norm(x)
            x = self.activation(x)
        return x


class LSTMCell(nn.Module):
    """flax's `OptimizedLSTMCell`: gates i, f, g, o stacked in that order
    along the first axis of `weight_ih` (4H, in), `weight_hh` (4H, H) and the
    one bias (4H,), which belongs to the hidden projection; the carry is
    `(c, h)`, in the reference's order (torch.nn.LSTMCell takes `(h, c)` and
    has two biases)."""

    def __init__(self, in_dim: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.features = features
        self.weight_ih = nn.Parameter(torch.empty(4 * features, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features))
        self.bias = nn.Parameter(torch.zeros(4 * features))
        with torch.no_grad():
            # per gate: lecun-normal input kernels, orthogonal recurrent ones
            for w_ih, w_hh in zip(self.weight_ih.chunk(4), self.weight_hh.chunk(4)):
                lecun_normal_(w_ih, generator)
                nn.init.orthogonal_(w_hh, generator=generator)

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """The input's share of the four gates, (..., 4H): it does not depend
        on the carry, so a whole sequence takes one matmul."""
        return x @ self.weight_ih.T

    def step(self, input_gates: torch.Tensor, carry):
        c, h = carry
        i, f, g, o = (input_gates + (h @ self.weight_hh.T + self.bias)).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h

    def forward(self, carry, x: torch.Tensor):
        """(carry, x) -> (new carry, output h'), as the flax cell."""
        return self.step(self.input_gates(x), carry)
