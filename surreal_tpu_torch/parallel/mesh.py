"""The data x model x time mesh, distributed initialization and the
collectives (port of surreal_tpu/parallel/mesh.py).

In JAX one process holds every device of its host and a `Mesh` names them.
In torch's idiom one process is one rank, and a rank holds one mesh device.
A `Mesh` here is that rank's view of the mesh: the axis sizes, its rank and
the world size, its index on each axis, its device, the group of every rank
and one group per axis. The ranks are laid out as the reference's devices,
`reshape(data, model, time)`: rank = d·model·time + m·time + t. An axis's
group holds the ranks that share the other two indices. `psum`, `pmean`
and `all_gather` mirror `jax.lax`'s over one axis, the data axis unless
named; over a size-1 axis, or with `axis=None`, they are the identity, so
the algorithms' one-device path computes what it always did.

The backend is chosen by topology, once, and printed by rank 0: NCCL when
every rank of a host has its own card; gloo when ranks share a card (NCCL
refuses two ranks on one device) or run on the CPU. A failed NCCL init is
never retried with gloo. Gloo stages a CUDA tensor through the host, so
the callers reduce one flat buffer where they can (`pmean_flat`).

`spawn` starts the ranks of one host as child processes and fails when
any of them fails or outlives its time.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import time
from typing import Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from surreal_tpu_torch.device import resolve as resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIME_AXIS = "time"
# A rank that dies leaves its peers blocked in a collective: the process
# group's timeout bounds how long.
TIMEOUT_S = 600
AXES = (DATA_AXIS, MODEL_AXIS, TIME_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data x model x time mesh."""

    shape: Mapping[str, int]  # axis name -> size
    rank: int
    world_size: int
    device: torch.device  # the rank's device
    group: object | None  # the group of every rank; None for one rank without one
    # axis name -> this rank's index on it (default: from `rank`, as laid out)
    index: Mapping[str, int] | None = None
    # axis name -> the group of this rank and the ranks that share its other
    # two indices; None for an axis of size 1 (default: None for every axis)
    groups: Mapping[str, object | None] | None = None

    def __post_init__(self):
        m, t = self.shape[MODEL_AXIS], self.shape[TIME_AXIS]
        if self.index is None:
            object.__setattr__(self, "index", {DATA_AXIS: self.rank // (m * t),
                                               MODEL_AXIS: (self.rank // t) % m,
                                               TIME_AXIS: self.rank % t})
        if self.groups is None:
            object.__setattr__(self, "groups", dict.fromkeys(AXES))

    @property
    def primary(self) -> bool:
        """The rank that does the single-writer IO."""
        return self.rank == 0

    def layout(self) -> dict[str, int]:
        """The axis sizes, in the mesh's order."""
        return {ax: self.shape[ax] for ax in AXES}


def local_rank() -> int:
    """This rank's index among its host's ranks: LOCAL_RANK, which `spawn`
    sets; 0 without it (a rank alone on its host)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def host_slots(local: int) -> tuple[int, int]:
    """For a launched process that runs `local` ranks: (the host index of
    its first rank, the ranks on its host). A launcher that starts several
    processes on one host gives each LOCAL_RANK, its index among them, and
    LOCAL_WORLD_SIZE, their count, as torchrun does; a process without them
    is alone on its host."""
    index = int(os.environ.get("LOCAL_RANK", 0))
    processes = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return index * local, processes * local


def rank_device(device: str | torch.device, local: int) -> torch.device:
    """cuda:{local % device_count} for a card; the CPU as it is."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", local % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, ranks_per_host: int) -> tuple[str, str]:
    """(backend, why) for ranks on `device`, `ranks_per_host` of them on a host."""
    if device.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    cards = torch.cuda.device_count()
    if ranks_per_host > cards:
        return "gloo", (f"{ranks_per_host} ranks share {cards} card(s) and NCCL refuses "
                        "two ranks on one device")
    return "nccl", f"each of the host's {ranks_per_host} ranks has its own card"


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, device: str | torch.device = "cuda",
                     ranks_per_host: int | None = None,
                     timeout_s: float = TIMEOUT_S) -> str | None:
    """Opens the default process group: rank `process_id` of
    `num_processes` ranks (a process is a rank here), meeting at
    `coordinator`, "host:port" (tcp://) or a URL such as "file:///path".
    With neither `coordinator` nor `num_processes` set this is a no-op, as
    in the reference. `ranks_per_host` (default: LOCAL_WORLD_SIZE, else 1)
    picks the backend. Returns the backend, or None."""
    if coordinator is None and num_processes is None:
        return None
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("distributed_init needs coordinator, num_processes and process_id "
                         f"together (got {coordinator!r}, {num_processes!r}, {process_id!r})")
    if ranks_per_host is None:
        ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    dev = rank_device(device, local_rank())
    backend, why = choose_backend(dev, ranks_per_host)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if process_id == 0:
        print(f"surreal_tpu_torch.parallel: {num_processes} ranks over {backend} ({why})",
              flush=True)
    dist.init_process_group(
        backend, init_method=coordinator if "://" in coordinator else f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def axis_members(shape: Mapping[str, int], axis: str) -> list[list[int]]:
    """The global ranks of each group of `axis`, in the order every rank
    creates them: groups by the other two indices in row-major order, each
    group's ranks by their index on `axis`."""
    sizes = [shape[ax] for ax in AXES]
    k = AXES.index(axis)
    strides = [sizes[1] * sizes[2], sizes[2], 1]
    others = [i for i in range(3) if i != k]
    groups = []
    for a in range(sizes[others[0]]):
        for b in range(sizes[others[1]]):
            base = a * strides[others[0]] + b * strides[others[1]]
            groups.append([base + i * strides[k] for i in range(sizes[k])])
    return groups


def make_mesh(data: int | None = None, model: int = 1, time: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """This rank's mesh over every rank of the process group (one rank
    without one): data x model x time. `data=None` uses every remaining
    rank for the data axis. Every rank must call it, in the same order as
    its peers: it creates the axes' groups, which is collective."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    if data is None:
        assert world % (model * time) == 0, (
            f"{world} ranks do not divide into model {model} x time {time}")
        data = world // (model * time)
    assert data * model * time == world, f"{data}x{model}x{time} != {world} ranks"
    shape = {DATA_AXIS: data, MODEL_AXIS: model, TIME_AXIS: time}
    groups: dict[str, object | None] = {}
    for ax in AXES:
        groups[ax] = None
        if shape[ax] == 1:
            continue  # a size-1 axis: its collectives are the identity
        if shape[ax] == world:
            groups[ax] = dist.group.WORLD
            continue
        for members in axis_members(shape, ax):  # every rank creates every group
            g = dist.new_group(members)
            if rank in members:
                groups[ax] = g
    return Mesh(shape=shape, rank=rank, world_size=world,
                device=rank_device(device, local_rank()),
                group=dist.group.WORLD if init else None, groups=groups)


def data_axis_size(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


# ---------------------------------------------------------------------------
# Collectives over one axis (`axis` is a Mesh, or None: the identity; `name`
# the axis, the data axis by default)
# ---------------------------------------------------------------------------


def _group(axis: Mesh | None, name: str):
    return None if axis is None else axis.groups[name]


def psum(x: torch.Tensor, axis: Mesh | None, name: str = DATA_AXIS) -> torch.Tensor:
    """The sum of `x` over the axis's ranks (jax.lax.psum)."""
    group = _group(axis, name)
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def pmean(x: torch.Tensor, axis: Mesh | None, name: str = DATA_AXIS) -> torch.Tensor:
    """The mean of `x` over the axis's ranks: psum / n, as jax.lax.pmean does."""
    if _group(axis, name) is None:
        return x
    return psum(x, axis, name) / axis.shape[name]


def pmean_flat(tensors: Sequence[torch.Tensor], axis: Mesh | None,
               name: str = DATA_AXIS) -> list[torch.Tensor]:
    """`pmean` of each tensor, through one all-reduce of one flat buffer."""
    group = _group(axis, name)
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat = flat / axis.shape[name]
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather(x: torch.Tensor, axis: Mesh | None, name: str = DATA_AXIS,
               dim: int = 0) -> torch.Tensor:
    """The axis's ranks' `x`, concatenated along `dim` in the order of
    their index on the axis (jax.lax.all_gather(..., tiled=True))."""
    group = _group(axis, name)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.shape[name])]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_metrics(metrics: dict, axis: Mesh | None, name: str = DATA_AXIS) -> dict:
    """The sharded steps' metric reduction (reference parallel/dp.py):
    `psum` of the episode counts and return sums, `pmean` of the rest,
    through one all-reduce; then every rank holds the same values."""
    group = _group(axis, name)
    if group is None:
        return metrics
    summed = ("episodes_done", "episode_return_sum")
    keys = list(metrics)
    flat = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=axis.device)
                        .reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    n = axis.shape[name]
    return {k: flat[i] if k in summed else flat[i] / n for i, k in enumerate(keys)}


def barrier(mesh: Mesh | None) -> None:
    """Returns once every rank of the mesh has reached it (an all-reduce on
    the mesh's device, which both backends take)."""
    if mesh is not None and mesh.group is not None:
        flag = torch.zeros(1, device=mesh.device)
        dist.all_reduce(flag, group=mesh.group)
        float(flag)


# ---------------------------------------------------------------------------
# Starting the ranks of one host
# ---------------------------------------------------------------------------


def _rank_main(fn: Callable, i: int, slot: int, on_host: int, threads: int | None,
               args: tuple):
    os.environ["LOCAL_RANK"] = str(slot)
    os.environ["LOCAL_WORLD_SIZE"] = str(on_host)
    if threads:
        torch.set_num_threads(threads)
    fn(i, *args)


def spawn(fn: Callable, nranks: int, args: tuple = (), timeout_s: float | None = None,
          threads: int | None = None, first_slot: int = 0,
          on_host: int | None = None) -> None:
    """Runs `fn(i, *args)` for i < `nranks` in fresh processes ("spawn":
    no CUDA state is inherited), with LOCAL_RANK = `first_slot` + i and
    LOCAL_WORLD_SIZE = `on_host` (default `nranks`: the host's only ranks;
    see `host_slots`), and `threads` torch threads each, if given. Raises
    RuntimeError as soon as one exits non-zero, and TimeoutError when
    `timeout_s` passes; either way the other ranks, blocked in a collective
    with the failed one, are killed first. `fn` must be importable by
    name."""
    on_host = nranks if on_host is None else on_host
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, i, first_slot + i, on_host, threads, args),
                         name=f"rank-{i}") for i in range(nranks)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while any(p.exitcode is None for p in procs):
            failed = [p.name for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"{', '.join(failed)} failed "
                                   f"(exit codes {[p.exitcode for p in procs]})")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
            time.sleep(0.05)
        failed = [p.name for p in procs if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"{', '.join(failed)} failed "
                               f"(exit codes {[p.exitcode for p in procs]})")
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
            p.join()
