"""ZeRO-1 Adam: the optimizer's moments split over the data axis (port of
surreal_tpu/parallel/zero.py).

The parameters stay replicated (they are small and every rollout step reads
them); the Adam moments, learner-side state only, are split 1/K over the K
data ranks. After the gradients' data-axis mean (equal on every rank), each
rank flattens them, takes its own chunk, moves its chunk of the moments
and computes its chunk of the Adam direction, and an `all_gather` over the
data group puts the whole direction back together on every rank: one
extra collective of the parameters' size a step.

The flat vector is laid out in the reference's order, `ravel_pytree`'s over
the flax tree (`models.convert.flax_leaves`), so rank r's chunk is, element
for element, the reference's `mu[r]` / `nu[r]`; the last chunk is padded
with K·chunk − n zeros. The arithmetic is the replicated `scale_by_adam`'s,
element by element, so a ZeRO learner equals the replicated one bit for
bit on the same device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from surreal_tpu_torch.models.convert import flax_leaves
from surreal_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, all_gather

Tensor = torch.Tensor


@dataclasses.dataclass
class FlatLayout:
    """The port's parameters in the reference's flat order: `perm` maps
    reference positions to positions in the concatenation of the port's
    flattened parameters (named_parameters' order), `inverse` back."""

    names: list[str]
    shapes: list[torch.Size]
    perm: Tensor
    inverse: Tensor

    @property
    def size(self) -> int:
        return self.perm.numel()

    def flatten(self, tensors: dict[str, Tensor]) -> Tensor:
        """The reference's flat vector of a name -> tensor dict."""
        return torch.cat([tensors[n].reshape(-1) for n in self.names])[self.perm]

    def unflatten(self, flat: Tensor) -> dict[str, Tensor]:
        """Inverse of `flatten`."""
        ours = flat[self.inverse]
        return {n: x.view(s) for n, s, x in
                zip(self.names, self.shapes, ours.split([s.numel() for s in self.shapes]))}


def flat_layout(module: torch.nn.Module) -> FlatLayout:
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    leaves = flax_leaves({n: tuple(p.shape) for n, p in params.items()},
                         getattr(module, "flax_stem_key", "stem"))
    perm = torch.as_tensor(np.concatenate([idx for _, _, idx in leaves]), device=device)
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.arange(perm.numel(), device=device)
    return FlatLayout(list(params), [p.shape for p in params.values()], perm, inverse)


@dataclasses.dataclass
class ZeroAdamState:
    """A data rank's Adam state: the step count and its (chunk,) chunks of
    the moments, the chunk of its data index."""

    count: int
    mu: Tensor
    nu: Tensor
    num_shards: int
    layout: FlatLayout


def uses_zero(cfg) -> bool:
    """The reference's gate: ZeRO only with more than one shard; otherwise
    `zero_optimizer` is plain Adam."""
    return bool(cfg.zero_optimizer) and cfg.zero_shards > 1


def chunk_size(n: int, num_shards: int) -> int:
    return -(-n // num_shards)  # ceil


def zero_adam_init(module: torch.nn.Module, num_shards: int) -> ZeroAdamState:
    layout = flat_layout(module)
    c = chunk_size(layout.size, num_shards)
    device = layout.perm.device
    return ZeroAdamState(count=0, mu=torch.zeros(c, device=device),
                         nu=torch.zeros(c, device=device), num_shards=num_shards,
                         layout=layout)


def shard_index(mesh: Mesh | None) -> int:
    return 0 if mesh is None else mesh.index[DATA_AXIS]


def scale_by_zero_adam(grads: dict[str, Tensor], state: ZeroAdamState, mesh: Mesh,
                       b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-5) -> dict[str, Tensor]:
    """`ppo.scale_by_adam` with the moments split over `mesh`'s data axis:
    the gradients must be equal on every data rank (averaged); returns the
    whole Adam direction, equal on every rank, and advances this rank's
    chunk of `state` in place."""
    K = state.num_shards
    assert mesh.shape[DATA_AXIS] == K, (mesh.shape, K)
    g = state.layout.flatten(grads)
    c = state.mu.numel()
    g = torch.nn.functional.pad(g, (0, K * c - g.numel()))
    r = shard_index(mesh)
    my_g = g[r * c:(r + 1) * c]
    state.count += 1
    # optax's bias corrections 1 - decay**count, evaluated in float32
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(state.count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(state.count))
    state.mu = (1 - b1) * my_g + b1 * state.mu
    state.nu = (1 - b2) * (my_g * my_g) + b2 * state.nu
    my_u = (state.mu / bc1) / (torch.sqrt(state.nu / bc2) + eps)
    u = all_gather(my_u, mesh, DATA_AXIS)[: state.layout.size]
    return state.layout.unflatten(u)


def gather_moments(state: ZeroAdamState, mesh: Mesh) -> tuple[dict, dict]:
    """The whole moments (name -> tensor, the replicated AdamState's layout)
    from every data rank's chunk: collective over the data axis."""
    n = state.layout.size
    return tuple(state.layout.unflatten(all_gather(m, mesh, DATA_AXIS)[:n])
                 for m in (state.mu, state.nu))


def load_moments(state: ZeroAdamState, mesh: Mesh | None, count: int, mu: dict,
                 nu: dict) -> None:
    """Sets `state` to this rank's chunk of the whole moments `mu`, `nu`
    (name -> tensor)."""
    c, r = state.mu.numel(), shard_index(mesh)
    pad = state.num_shards * c - state.layout.size

    def chunk(m):
        flat = torch.nn.functional.pad(state.layout.flatten(m), (0, pad))
        return flat[r * c:(r + 1) * c].to(state.mu.device).clone()

    state.count, state.mu, state.nu = int(count), chunk(mu), chunk(nu)
