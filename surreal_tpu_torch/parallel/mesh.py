"""The data mesh, distributed initialization and the collectives (port of
surreal_tpu/parallel/mesh.py, data axis).

In JAX one process holds every device of its host and a `Mesh` names them.
In torch's idiom one process is one rank, and a rank holds one mesh device.
A `Mesh` here is that rank's view of the mesh: the axis sizes, its rank and
the world size, its device and the process group. `pmean` and `psum`
mirror `jax.lax.pmean` and `psum` over the data axis; with `axis=None` they
are the identity, so the algorithms' one-device path computes what it
always did.

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
A15B = "not ported yet (ROADMAP.md, Queue A: A15b, the model and time axes and ZeRO)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data x model x time mesh."""

    shape: Mapping[str, int]  # axis name -> size
    rank: int
    world_size: int
    device: torch.device  # the rank's device
    group: object | None  # the process group; None for one rank without one

    @property
    def primary(self) -> bool:
        """The rank that does the single-writer IO."""
        return self.rank == 0


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


def make_mesh(data: int | None = None, model: int = 1, time: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """This rank's mesh over every rank of the process group (one rank
    without one): data x model x time. `data=None` uses every remaining
    rank for the data axis."""
    if model != 1 or time != 1:
        raise NotImplementedError(f"mesh model and time axes > 1: {A15B}")
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    if data is None:
        data = world // (model * time)
    assert data * model * time == world, f"{data}x{model}x{time} != {world} ranks"
    return Mesh(shape={DATA_AXIS: data, MODEL_AXIS: model, TIME_AXIS: time}, rank=rank,
                world_size=world, device=rank_device(device, local_rank()),
                group=dist.group.WORLD if init else None)


def data_axis_size(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


# ---------------------------------------------------------------------------
# Collectives over the data axis (`axis` is a Mesh, or None: the identity)
# ---------------------------------------------------------------------------


def psum(x: torch.Tensor, axis: Mesh | None) -> torch.Tensor:
    """The sum of `x` over the ranks (jax.lax.psum)."""
    if axis is None or axis.group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=axis.group)
    return y


def pmean(x: torch.Tensor, axis: Mesh | None) -> torch.Tensor:
    """The mean of `x` over the ranks: psum / n, as jax.lax.pmean does."""
    if axis is None or axis.group is None:
        return x
    return psum(x, axis) / data_axis_size(axis)


def pmean_flat(tensors: Sequence[torch.Tensor], axis: Mesh | None) -> list[torch.Tensor]:
    """`pmean` of each tensor, through one all-reduce of one flat buffer."""
    if axis is None or axis.group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=axis.group)
    flat = flat / data_axis_size(axis)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def reduce_metrics(metrics: dict, axis: Mesh | None) -> dict:
    """The sharded steps' metric reduction (reference parallel/dp.py):
    `psum` of the episode counts and return sums, `pmean` of the rest,
    through one all-reduce; then every rank holds the same values."""
    if axis is None or axis.group is None:
        return metrics
    summed = ("episodes_done", "episode_return_sum")
    keys = list(metrics)
    flat = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=axis.device)
                        .reshape(()) for k in keys])
    dist.all_reduce(flat, group=axis.group)
    n = data_axis_size(axis)
    return {k: flat[i] if k in summed else flat[i] / n for i, k in enumerate(keys)}


def barrier(mesh: Mesh | None) -> None:
    """Returns once every rank has reached it (an all-reduce on the mesh's
    device, which both backends take)."""
    if mesh is not None and mesh.group is not None:
        float(psum(torch.zeros(1, device=mesh.device), mesh))


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
