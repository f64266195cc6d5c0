"""Profiling (port of surreal_tpu/utils/profiling.py): a torch.profiler
trace of a block written into a log directory as a Chrome trace, and the
card's memory use."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the enclosed block, the card's kernels too where there is
    one, and writes `trace-<unix ms>.json` (chrome://tracing, Perfetto)
    into `logdir`:

        with profiling.trace("results/exp/tb"):
            trainer.run(20)
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
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
