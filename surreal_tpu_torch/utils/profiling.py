"""Profiling (port of surreal_tpu/utils/profiling.py): a torch.profiler
trace of a block written into a log directory as a Chrome trace, the
program's named spans inside it, and the card's memory use.

Spans mark the program's layers (`ppo.rollout.step`, `env.physics`,
`ppo.update.optimizer`, ...) in a profile. Names are dotted, lower case and
stable; a span nests inside whichever span is open when it starts."""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch._C._profiler import _RecordFunctionFast


def span(name: str) -> _RecordFunctionFast:
    """A named span over a `with` block. While a profiler runs it records
    one host event (a `cpu_op`) under `name`, on the profiler's clock, and
    no device event: `torch.profiler.record_function` would add a
    `gpu_user_annotation` on the card, from the block's first kernel to its
    last, which a reader of the device's events would take for work. With
    no profiler running it records nothing, allocates nothing and never
    synchronises; entering and leaving it costs about half a microsecond on
    the host. There is no other switch."""
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the enclosed block, the card's kernels too where there is
    one, and writes `trace-<unix ms>.json` (chrome://tracing, Perfetto)
    into `logdir`:

        with profiling.trace("results/exp/tb"):
            trainer.run(2)

    In Perfetto (ui.perfetto.dev) each span is a host slice on the thread
    that opened it, above the aten ops and kernel launches it holds, on the
    clock of the card's kernels. The card is synchronised before the
    profiler stops, so the block's last kernels are in the file.
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{int(time.time() * 1e3)}.json"))


def device_memory_stats() -> dict:
    """Per card: bytes in use, their peak and the card's size; {} without a
    card."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
