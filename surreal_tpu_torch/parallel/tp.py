"""Tensor parallelism over the mesh's `model` axis (port of
surreal_tpu/parallel/tp.py).

The reference places the Dense kernels column- and row-parallel in
alternation (`tp_kernel_specs`, in flatten order, skipping a layer whose
dimension does not divide) and lets GSPMD insert the collectives into the
one-device train step, jitted on global arrays. For nets of this size it
says itself that this is a correctness feature, not a speedup. Here each
model rank holds its shard of those kernels in `ShardedLinear`s, which
place the collectives by hand as Megatron-LM does, each an autograd
function so that the backward is the reference's gradient:

- a column layer (flax `P(None, 'model')`: the rows of the torch weight)
  takes a replicated input and gives its slice of the output features; its
  output stays a slice where a row layer consumes it next, and is
  all-gathered otherwise (the mean head's, so the loss never sees a slice);
- a row layer (`P('model', None)`: the weight's columns) takes its slice of
  the input features (slicing a replicated input itself) and all-reduces
  the product; its bias is added after.

Biases, `log_std` and every other non-matrix parameter stay replicated, as
in the reference. A column layer adds its slice of its bias, so the bias's
gradient is completed over the model group after the backward
(`TPSharding.complete_grads`), and the global norm counts every element
once: the sharded leaves' squares are summed over the model group, the
replicated ones are not. The Adam moments of a sharded kernel are sharded
with it.

The step (`make_tp_ppo_step`) computes the reference's function: the
one-device `ppo.train_step` on the whole batch. Every rank keeps the
trainer's generator unfolded; a data rank steps its slice of the envs with
its slice of draws taken for the whole batch (`draw_whole_batch`), the
trajectory is all-gathered over the data group, and every rank then runs
the one-device update on all T·B rows, the model axis splitting only the
matmuls. So the data axis splits the rollout only.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F

from surreal_tpu_torch.models.convert import flax_leaves
from surreal_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather, psum

Tensor = torch.Tensor
COLUMN, ROW = "column", "row"


def tp_kernel_specs(module: nn.Module, axis_size: int) -> dict[str, str]:
    """{port weight name: COLUMN or ROW} for the module's 2-D Dense kernels,
    alternating column- and row-parallel over the model axis in the
    reference's flatten order (the flax paths sorted), a kernel whose
    dimension does not divide `axis_size` left replicated (and out of the
    map), as the reference's `tp_kernel_specs`."""
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    specs, col = {}, True
    for path, name, _ in flax_leaves(shapes, getattr(module, "flax_stem_key", "stem")):
        if path[-1] != "kernel" or len(shapes[name]) != 2 or axis_size <= 1:
            continue
        d_in, d_out = shapes[name][1], shapes[name][0]  # the flax kernel is (in, out)
        if col and d_out % axis_size == 0:
            specs[name], col = COLUMN, False
        elif not col and d_in % axis_size == 0:
            specs[name], col = ROW, True
    return specs


# ---------------------------------------------------------------------------
# The model group's collectives as autograd functions. They run in float32
# (a bfloat16 tensor is cast for the collective and back).
# ---------------------------------------------------------------------------


def _reduce(x: Tensor, mesh: Mesh) -> Tensor:
    return psum(x.to(torch.float32), mesh, MODEL_AXIS).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group
    (each rank holds the part of it that its shard produced)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the last axis forward; the backward keeps this rank's
    slice (the loss, and so its gradient, is equal on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        # contiguous, as the fused loss kernel takes the mean
        return all_gather(x.to(torch.float32), mesh, MODEL_AXIS, -1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.index[MODEL_AXIS] * ctx.width
        return g[..., lo:lo + ctx.width], None


def _copy(x: Tensor, mesh: Mesh) -> Tensor:
    return _CopyToModel.apply(x, mesh) if x.requires_grad else x


def _dense(x: Tensor, weight: Tensor, bias: Tensor | None) -> Tensor:
    """flax's Dense at x's dtype (`blocks.linear`'s arithmetic)."""
    if x.dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = x @ weight.to(x.dtype).T
    return y if bias is None else y + bias.to(x.dtype)


class ShardedLinear(nn.Module):
    """This model rank's shard of a Dense layer: `weight` is the shard of the
    (out, in) weight (rows for COLUMN, columns for ROW), `bias` the whole
    bias. `in_sharded`: the input is already this rank's feature slice (a
    column layer's kept output); `keep_sharded` (COLUMN): leave the output
    sliced for the row layer after it."""

    def __init__(self, layer: nn.Linear, mode: str, mesh: Mesh, in_sharded: bool = False,
                 keep_sharded: bool = False):
        super().__init__()
        k, m = mesh.shape[MODEL_AXIS], mesh.index[MODEL_AXIS]
        self.mode, self.mesh = mode, mesh
        self.in_sharded, self.keep_sharded = in_sharded, keep_sharded
        w = layer.weight.detach()
        width = (w.shape[0] if mode == COLUMN else w.shape[1]) // k
        self.lo, self.hi = m * width, (m + 1) * width
        shard = w[self.lo:self.hi] if mode == COLUMN else w[:, self.lo:self.hi]
        self.weight = nn.Parameter(shard.clone())
        self.bias = nn.Parameter(layer.bias.detach().clone())
        self.in_features, self.out_features = layer.in_features, layer.out_features

    def forward(self, x: Tensor) -> Tensor:
        if self.mode == COLUMN:
            y = _dense(_copy(x, self.mesh), self.weight, self.bias[self.lo:self.hi])
            return y if self.keep_sharded else _GatherFromModel.apply(y, self.mesh)
        if not self.in_sharded:
            x = _copy(x, self.mesh)[..., self.lo:self.hi]
        y = _ReduceFromModel.apply(_dense(x, self.weight, None), self.mesh)
        return y + self.bias.to(y.dtype)


@dataclasses.dataclass
class TPSharding:
    """How a module is sharded over the model axis: `specs` (tp_kernel_specs'
    map) and the mesh. Held by the module (`sharding_of`)."""

    specs: dict[str, str]
    mesh: Mesh

    def _dim(self, name: str) -> int:
        return 0 if self.specs[name] == COLUMN else 1

    def column_biases(self) -> list[str]:
        return [n[: -len("weight")] + "bias" for n, s in self.specs.items() if s == COLUMN]

    def complete_grads(self, grads: dict[str, Tensor]) -> dict[str, Tensor]:
        """The gradients with each column layer's bias gradient (this rank's
        slice of it, zero elsewhere) summed over the model group, in one
        flat all-reduce."""
        names = self.column_biases()
        if not names:
            return grads
        flat = psum(torch.cat([grads[n] for n in names]), self.mesh, MODEL_AXIS)
        out = dict(grads)
        for n, g in zip(names, flat.split([grads[n].numel() for n in names])):
            out[n] = g.view_as(grads[n])
        return out

    def global_norm(self, grads: dict[str, Tensor]) -> Tensor:
        """sqrt of the sum of squares over every element of the whole
        network: the sharded leaves' local sums summed over the model
        group, the replicated leaves' counted once."""
        zero = torch.zeros((), device=next(iter(grads.values())).device)
        sharded = sum((torch.sum(g * g) for n, g in grads.items() if n in self.specs), zero)
        replicated = sum((torch.sum(g * g) for n, g in grads.items() if n not in self.specs),
                         zero)
        return torch.sqrt(replicated + psum(sharded, self.mesh, MODEL_AXIS))

    def gather(self, tensors: dict[str, Tensor]) -> dict[str, Tensor]:
        """The whole tensors of a name -> tensor dict (parameters, Adam
        moments): the sharded ones all-gathered over the model group."""
        return {n: all_gather(t, self.mesh, MODEL_AXIS, self._dim(n)) if n in self.specs
                else t for n, t in tensors.items()}

    def shard(self, tensors: dict[str, Tensor]) -> dict[str, Tensor]:
        """This rank's shards of a dict of whole tensors (inverse of `gather`)."""
        k, m = self.mesh.shape[MODEL_AXIS], self.mesh.index[MODEL_AXIS]
        out = {}
        for n, t in tensors.items():
            if n in self.specs:
                t = t.chunk(k, self._dim(n))[m].clone()
            out[n] = t
        return out


def sharding_of(module: nn.Module) -> TPSharding | None:
    return getattr(module, "tp_sharding", None)


def _mlp_layers(module: nn.Module) -> dict[str, tuple[nn.Module, str, str | None]]:
    """Each Linear's (parent, attribute, the attribute of the Linear that
    consumes its output next in the same MLP, or None)."""
    out = {}
    for pname, parent in module.named_modules():
        prefix = f"{pname}." if pname else ""
        for attr, child in parent.named_children():
            if not isinstance(child, nn.Linear):
                continue
            nxt = None
            if attr.startswith("dense_"):
                i = int(attr.split("_")[1])
                if getattr(parent, "num_layers", 0) > i + 1 and not (
                        i == 0 and getattr(parent, "layer_norm", None) is not None):
                    nxt = f"dense_{i + 1}"
            out[f"{prefix}{attr}.weight"] = (parent, attr, nxt)
    return out


def shard_module(module: nn.Module, mesh: Mesh) -> TPSharding:
    """Replaces the module's sharded Linears (tp_kernel_specs at the mesh's
    model size) by this rank's `ShardedLinear`s, in place; the module must be
    equal on every rank (made from one seed). Returns the sharding, which
    the module then holds."""
    specs = tp_kernel_specs(module, mesh.shape[MODEL_AXIS])
    layers = _mlp_layers(module)
    chained = {}  # a column layer -> the row layer after it, which takes its slice
    for name, mode in specs.items():
        _, attr, nxt = layers[name]
        row = f"{name[: -len(f'{attr}.weight')]}{nxt}.weight"
        if mode == COLUMN and nxt is not None and specs.get(row) == ROW:
            chained[name] = row
    for name, mode in specs.items():
        parent, attr, _ = layers[name]
        setattr(parent, attr, ShardedLinear(getattr(parent, attr), mode, mesh,
                                            in_sharded=name in chained.values(),
                                            keep_sharded=name in chained))
    sharding = TPSharding(specs, mesh)
    module.tp_sharding = sharding
    return sharding


# ---------------------------------------------------------------------------
# The tensor-parallel PPO step
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def draw_whole_batch(env, mesh: Mesh, num_envs: int):
    """Within it, the env's reset draws are those of the whole batch of
    `num_envs`, of which it keeps this data index's rows: so the data ranks
    together draw what one device draws. Outside it (evaluations) the env
    draws as it always does."""
    inner = env
    while hasattr(inner, "env"):
        inner = inner.env  # through the wrappers, to the env that draws
    own = vars(inner).get("draw_reset")
    draw, d = inner.draw_reset, mesh.index[DATA_AXIS]

    def whole(batch, generator):
        return {k: v[d * batch:(d + 1) * batch] for k, v in draw(num_envs, generator).items()}

    inner.draw_reset = whole
    try:
        yield
    finally:
        if own is None:
            del inner.draw_reset
        else:
            inner.draw_reset = own


def gather_envs(tree, mesh: Mesh):
    """A time-major (T, B/S, ...) dataclass of tensors gathered over the data
    group into (T, B, ...)."""
    return type(tree)(**{f.name: all_gather(getattr(tree, f.name), mesh, DATA_AXIS, 1)
                         for f in dataclasses.fields(tree)})


def make_tp_ppo_step(cfg, env, flatten_obs: Callable, mesh: Mesh):
    """The tensor-parallel PPO step: step(state, env_state, obs, ep_ret,
    generator, noise=None, perms=None) -> (state, env_state, obs, ep_ret,
    metrics), the state's network sharded by `shard_module`, the envs this
    data index's slice. `noise` (T, B, A) is the whole batch's action noise
    and `perms` the whole batch's permutations (the reference's one-device
    draws); the metrics are equal on every rank."""
    from surreal_tpu_torch.algos import ppo

    def step(state, env_state, obs, ep_ret, generator, noise=None, perms=None):
        b, d = obs.shape[0], mesh.index[DATA_AXIS]
        rows = (d * b, (d + 1) * b, b * mesh.shape[DATA_AXIS])
        local_noise = None if noise is None else noise[:, rows[0]:rows[1]]
        with draw_whole_batch(env, mesh, rows[2]):
            traj, env_state, obs, ep_ret, ep_stats = ppo.rollout(
                cfg, env, flatten_obs, state, env_state, obs, ep_ret, generator, local_noise,
                rows)
        traj = gather_envs(traj, mesh)
        state, metrics = ppo.update(cfg, state, traj, generator, perms)
        metrics.update({k: psum(v, mesh, DATA_AXIS) for k, v in ep_stats.items()})
        metrics["reward_per_step"] = torch.mean(traj.reward)
        return state, env_state, obs, ep_ret, metrics

    return step
