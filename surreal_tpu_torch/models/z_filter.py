"""Running mean/std observation normalization (port of
surreal_tpu/models/z_filter.py; Chan et al. parallel merge)."""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ZFilterState:
    count: Tensor  # () f32
    mean: Tensor  # (D,)
    m2: Tensor  # (D,) sum of squared deviations


def zfilter_init(dim: int, device: torch.device | str, dtype=torch.float32) -> ZFilterState:
    return ZFilterState(
        count=torch.tensor(1e-4, dtype=dtype, device=device),  # prior avoids 0/0
        mean=torch.zeros(dim, dtype=dtype, device=device),
        m2=torch.zeros(dim, dtype=dtype, device=device),
    )


def zfilter_update(state: ZFilterState, batch: Tensor) -> ZFilterState:
    """Merges a batch (..., D) into the running stats."""
    x = batch.reshape(-1, batch.shape[-1]).to(state.mean.dtype)
    n = torch.tensor(float(x.shape[0]), dtype=state.count.dtype, device=x.device)
    mean_b = torch.mean(x, 0)
    m2_b = torch.sum((x - mean_b) ** 2, 0)
    delta = mean_b - state.mean
    tot = state.count + n
    return ZFilterState(
        count=tot,
        mean=state.mean + delta * (n / tot),
        m2=state.m2 + m2_b + delta**2 * state.count * n / tot,
    )


def zfilter_std(state: ZFilterState, eps: float = 1e-6) -> Tensor:
    return torch.sqrt(state.m2 / torch.clamp(state.count, min=1.0) + eps)


def zfilter_normalize(state: ZFilterState, obs: Tensor, clip: float = 5.0) -> Tensor:
    z = (obs - state.mean) / zfilter_std(state)
    return torch.clamp(z, -clip, clip)
