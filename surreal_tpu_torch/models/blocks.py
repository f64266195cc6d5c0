"""Network blocks (port of surreal_tpu/models/blocks.py: the MLP torso and
the conv stem; and the LSTM cell the reference takes from flax).

Each block takes a `compute_dtype` (float32 by default), flax's `dtype`:
the parameters stay float32 (flax's `param_dtype`), and the forward casts
the input, the weights and the biases to the compute dtype, as flax's
`promote_dtype` does. Autograd's cast backward then hands float32
gradients to the float32 parameters, so Adam, the Z-filter and the
checkpoints keep float32 masters. The module itself is never `.to()`-ed
to the compute dtype."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

# flax.linen's elementwise activations by name (the reference's MLP takes
# `getattr(nn, activation)`), with flax's arguments: gelu is the tanh
# approximation, leaky_relu's slope 0.01, celu's and elu's alpha 1.
_ACTIVATIONS = {
    "celu": F.celu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "hard_sigmoid": F.hardsigmoid,
    "hard_silu": F.hardswish,
    "hard_swish": F.hardswish,
    "hard_tanh": F.hardtanh,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "log_sigmoid": F.logsigmoid,
    "relu": torch.relu,
    "relu6": F.relu6,
    "selu": F.selu,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "soft_sign": F.softsign,
    "softplus": F.softplus,
    "swish": F.silu,
    "tanh": torch.tanh,
}


def resolve_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """A compute dtype from its torch dtype or its name ("bfloat16", the
    CLI's `learner.compute_dtype`)."""
    out = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if not (isinstance(out, torch.dtype) and out.is_floating_point):
        raise ValueError(f"unknown compute dtype {dtype!r}")
    return out


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax's Dense at x's dtype. Below float32 the kernel and the bias are
    cast to it and the bias is added after the product has been rounded
    (flax: `y = dot(x, k); y += b`, two roundings); F.linear would add it
    before the rounding (cuBLAS's epilogue, oneDNN's post-op) and differs
    in ~30% of bfloat16 outputs. Float32 keeps F.linear. A layer that is
    not an nn.Linear (a tensor-parallel shard, `parallel.tp`) applies its
    own forward, which keeps this arithmetic."""
    if x.dtype == torch.float32 or not isinstance(layer, nn.Linear):
        return layer(x)
    y = x @ layer.weight.to(x.dtype).T
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's LayerNorm at x's dtype: the statistics, the scale and the
    shift in float32, one rounding back to x's dtype at the end."""
    return ln(x.to(torch.float32)).to(x.dtype)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's default Dense and Conv kernel init: truncated normal on
    [-2σ, 2σ] with variance 1/fan_in after truncation. `weight` is (out, in)
    or (out, in, kh, kw)."""
    fan_in = weight[0].numel()
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
                 layer_norm: bool = False, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r} is not an elementwise activation "
                             f"of flax.linen ({', '.join(sorted(_ACTIVATIONS))})")
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
        x = x.to(self.compute_dtype)
        for i in range(self.num_layers):
            x = linear(getattr(self, f"dense_{i}"), x)
            if i == 0 and self.layer_norm is not None:
                x = layer_norm(self.layer_norm, x)
            x = self.activation(x)
        return x


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's 'SAME' padding of one spatial axis (flax's nn.Conv default):
    the output has ceil(size / stride) positions, and the low side takes
    the smaller half of the padding, so an odd total is asymmetric."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvStem(nn.Module):
    """Conv encoder for pixel observations (..., H, W, C), uint8 (scaled by
    1/255 in the compute dtype, as the reference does) or float: convs
    `conv_i` with 'SAME' padding and relu, then the NHWC-flattened features
    through `dense` and relu (flax's `Conv_i` and `Dense_0`). Each conv
    pads explicitly with XLA's pads, which `Conv2d(padding=...)` cannot
    express when they are asymmetric (84 x 84: (2, 2), then (1, 2), then
    (1, 1))."""

    def __init__(self, obs_shape: Sequence[int], features: Sequence[int] = (32, 64, 64),
                 kernels: Sequence[int] = (8, 4, 3), strides: Sequence[int] = (4, 2, 1),
                 out_dim: int = 256, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        h, w, c = obs_shape
        self.pads, self.strides = [], list(strides)
        for i, (f, k, s) in enumerate(zip(features, kernels, strides)):
            conv = nn.Conv2d(c, f, k, stride=s)
            lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
            self.add_module(f"conv_{i}", conv)
            (hl, hh), (wl, wh) = same_pads(h, k, s), same_pads(w, k, s)
            self.pads.append((wl, wh, hl, hh))  # F.pad's order: last axis first
            h, w, c = -(-h // s), -(-w // s), f
        self.num_convs = len(self.pads)
        self.dense = nn.Linear(h * w * c, out_dim)
        lecun_normal_(self.dense.weight, generator)
        nn.init.zeros_(self.dense.bias)
        self.out_dim = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        dt = self.compute_dtype
        x = x.to(dt) / 255.0 if x.dtype == torch.uint8 else x.to(dt)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i in range(self.num_convs):
            conv = getattr(self, f"conv_{i}")
            x = F.pad(x, self.pads[i])
            if dt == torch.float32:
                x = F.conv2d(x, conv.weight, conv.bias, self.strides[i])
            else:  # flax's nn.Conv adds the bias after the conv's output is rounded
                x = (F.conv2d(x, conv.weight.to(dt), None, self.strides[i])
                     + conv.bias.to(dt)[:, None, None])
            x = torch.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)  # flattened in NHWC order, as flax
        return torch.relu(linear(self.dense, x))


class LSTMCell(nn.Module):
    """flax's `OptimizedLSTMCell`: gates i, f, g, o stacked in that order
    along the first axis of `weight_ih` (4H, in), `weight_hh` (4H, H) and the
    one bias (4H,), which belongs to the hidden projection; the carry is
    `(c, h)`, in the reference's order (torch.nn.LSTMCell takes `(h, c)` and
    has two biases). In the compute dtype, as flax's `dtype=`: the input
    and the hidden projections are each rounded, the hidden one's bias added
    after its product, and the carry is kept in it."""

    def __init__(self, in_dim: int, features: int, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.compute_dtype = compute_dtype
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
        dt = self.compute_dtype
        return x.to(dt) @ self.weight_ih.to(dt).T

    def step(self, input_gates: torch.Tensor, carry):
        # the weights are cast at every step, as flax casts them in every
        # call of the cell: their gradients then sum over steps in float32
        dt = self.compute_dtype
        c, h = carry
        hidden = h.to(dt) @ self.weight_hh.to(dt).T + self.bias.to(dt)
        i, f, g, o = (input_gates + hidden).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h

    def forward(self, carry, x: torch.Tensor):
        """(carry, x) -> (new carry, output h'), as the flax cell."""
        return self.step(self.input_gates(x), carry)
