"""Frozen copy of surreal_tpu_torch/envs/rewards.py as of the benchmark's
first version, kept so that the yardstick does not move with the program.
It imports nothing of the program. Its own docstring follows.

dm_control's soft-indicator reward primitive (port of
surreal_tpu/envs/rewards.py). Shape parameters are Python floats; only
`x` is a tensor."""

from __future__ import annotations

import math

import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _sigmoids(x: torch.Tensor, value_at_1: float, sigmoid: str) -> torch.Tensor:
    """Returns 1 when `x` == 0, falling off per the named sigmoid shape."""
    if sigmoid in ("cosine", "linear", "quadratic"):
        if not 0 <= value_at_1 < 1:
            raise ValueError(f"`value_at_1` must be in [0, 1), got {value_at_1}.")
    else:
        if not 0 < value_at_1 < 1:
            raise ValueError(f"`value_at_1` must be in (0, 1), got {value_at_1}.")
    zero = torch.zeros_like(x)
    if sigmoid == "gaussian":
        scale = math.sqrt(-2 * math.log(value_at_1))
        return torch.exp(-0.5 * (x * scale) ** 2)
    if sigmoid == "hyperbolic":
        scale = math.acosh(1 / value_at_1)
        return 1 / torch.cosh(x * scale)
    if sigmoid == "long_tail":
        scale = math.sqrt(1 / value_at_1 - 1)
        return 1 / ((x * scale) ** 2 + 1)
    if sigmoid == "reciprocal":
        scale = 1 / value_at_1 - 1
        return 1 / (torch.abs(x) * scale + 1)
    if sigmoid == "cosine":
        scaled_x = x * (math.acos(2 * value_at_1 - 1) / math.pi)
        return torch.where(torch.abs(scaled_x) < 1, (1 + torch.cos(math.pi * scaled_x)) / 2, zero)
    if sigmoid == "linear":
        scaled_x = x * (1 - value_at_1)
        return torch.where(torch.abs(scaled_x) < 1, 1 - scaled_x, zero)
    if sigmoid == "quadratic":
        scaled_x = x * math.sqrt(1 - value_at_1)
        return torch.where(torch.abs(scaled_x) < 1, 1 - scaled_x**2, zero)
    if sigmoid == "tanh_squared":
        scale = math.atanh(math.sqrt(1 - value_at_1))
        return 1 - torch.tanh(x * scale) ** 2
    raise ValueError(f"Unknown sigmoid type {sigmoid!r}.")


def tolerance(
    x: torch.Tensor,
    bounds: tuple[float, float] = (0.0, 0.0),
    margin: float = 0.0,
    sigmoid: str = "gaussian",
    value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN,
) -> torch.Tensor:
    """Returns 1 inside `bounds`, decaying sigmoidally outside over `margin`."""
    lower, upper = bounds
    if lower > upper:
        raise ValueError("Lower bound must be <= upper bound.")
    if margin < 0:
        raise ValueError("`margin` must be non-negative.")
    in_bounds = (lower <= x) & (x <= upper)
    one = torch.ones_like(x)
    if margin == 0:
        return torch.where(in_bounds, one, torch.zeros_like(x))
    d = torch.where(x < lower, lower - x, x - upper) / margin
    return torch.where(in_bounds, one, _sigmoids(d, value_at_margin, sigmoid))
