"""Device-resident uniform replay buffer (port of surreal_tpu/data/replay.py).

The buffer is a dict of tensors laid out time-major per env,
(capacity_t, num_envs, ...), on the device. Insert is an indexed write of
the fresh rollout chunk at the ring cursor; sampling is a gather of random
(time, env) coordinates, n_step + 1 steps long, so the n-step aggregation
and the next-obs come from the same gather and an observation is stored
once.

The buffers are written in place. `total` is a Python int (the host knows
how many steps it inserted), so neither insert nor sample waits for the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ReplayState:
    """Ring buffer over absolute time steps (per lockstep env batch)."""

    data: Mapping[str, Tensor]  # (capacity_t, B, ...) each
    total: int  # monotonic count of inserted time steps

    @property
    def capacity_t(self) -> int:
        return next(iter(self.data.values())).shape[0]

    @property
    def num_envs(self) -> int:
        return next(iter(self.data.values())).shape[1]


def replay_init(example_step: Mapping[str, Tensor], capacity_t: int) -> ReplayState:
    """`example_step`: (B, ...) tensors for one time step; their dtypes and
    device are the buffer's."""
    data = {k: torch.zeros((capacity_t,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            for k, x in example_step.items()}
    return ReplayState(data=data, total=0)


def replay_insert(state: ReplayState, chunk: Mapping[str, Tensor]) -> ReplayState:
    """Writes a (T, B, ...) rollout chunk at the ring cursor, wrapping at the
    ring's edge. T must not exceed capacity_t: the wrapped indices are then
    unique and the write has one outcome."""
    T = next(iter(chunk.values())).shape[0]
    cap = state.capacity_t
    if T > cap:
        raise ValueError(f"a chunk of {T} steps does not fit a ring of {cap}")
    device = next(iter(state.data.values())).device
    idx = (state.total % cap + torch.arange(T, device=device)) % cap
    for k, buf in state.data.items():
        buf.index_copy_(0, idx, chunk[k].to(buf.dtype))
    return ReplayState(data=state.data, total=state.total + T)


def replay_sampleable(state: ReplayState, window: int = 1) -> int:
    """Number of valid window start positions (absolute indices)."""
    oldest = max(state.total - state.capacity_t, 0)
    return max(state.total - window + 1 - oldest, 0)


def replay_sample_nstep(state: ReplayState, generator: torch.Generator | None,
                        batch_size: int, n_step: int = 1,
                        index: tuple[Tensor, Tensor] | None = None) -> dict[str, Tensor]:
    """Uniformly samples `batch_size` (time, env) windows of n_step + 1
    steps. Returns the gathered tensors with leading axes
    (n_step + 1, batch_size, ...): window[0] is the transition's start,
    window[-1] supplies the bootstrap next-obs.

    `index` = (a, b), if given, replaces the draw from `generator`: absolute
    start steps a (batch_size,) and env columns b (batch_size,), integer
    tensors on the buffer's device. The caller ensures
    `replay_sampleable(state, n_step + 1) > 0`."""
    window = n_step + 1
    cap = state.capacity_t
    device = next(iter(state.data.values())).device
    if index is None:
        oldest = max(state.total - cap, 0)
        num_valid = max(state.total - window + 1 - oldest, 1)
        a = oldest + torch.randint(0, num_valid, (batch_size,), generator=generator,
                                   device=device)
        b = torch.randint(0, state.num_envs, (batch_size,), generator=generator, device=device)
    else:
        a, b = index
    t_idx = (a[None, :] + torch.arange(window, device=device)[:, None]) % cap  # (w, batch)
    return {k: buf[t_idx, b[None, :]] for k, buf in state.data.items()}
