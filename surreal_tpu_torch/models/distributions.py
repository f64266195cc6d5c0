"""Diagonal Gaussian policy distribution (port of
surreal_tpu/models/distributions.py)."""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)

Tensor = torch.Tensor


class DiagGauss:
    """Stateless namespace. `mean` is (..., A); `log_std` is (..., A) or (A,)."""

    @staticmethod
    def sample(mean: Tensor, log_std: Tensor, noise: Tensor | None = None,
               generator: torch.Generator | None = None) -> Tensor:
        """mean + exp(log_std)·noise, with standard-normal `noise` drawn from
        `generator` unless given (tests feed the reference's noise)."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def log_prob(mean: Tensor, log_std: Tensor, x: Tensor) -> Tensor:
        z = (x - mean) * torch.exp(-log_std)
        return -0.5 * torch.sum(z * z + _LOG_2PI, dim=-1) - torch.sum(
            log_std.expand_as(mean), dim=-1
        )

    @staticmethod
    def entropy(mean: Tensor, log_std: Tensor) -> Tensor:
        return torch.sum(log_std.expand_as(mean) + 0.5 * (_LOG_2PI + 1.0), dim=-1)

    @staticmethod
    def kl(mean_a: Tensor, log_std_a: Tensor, mean_b: Tensor, log_std_b: Tensor) -> Tensor:
        """KL(a || b), one value per example."""
        log_std_a = log_std_a.expand_as(mean_a)
        log_std_b = log_std_b.expand_as(mean_b)
        var_a = torch.exp(2 * log_std_a)
        var_b = torch.exp(2 * log_std_b)
        return torch.sum(
            log_std_b - log_std_a + (var_a + (mean_a - mean_b) ** 2) / (2 * var_b) - 0.5,
            dim=-1,
        )
