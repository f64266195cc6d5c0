"""Device-trace reading and roofline arithmetic of the benchmark.

Frozen copies, with their origin, so that a later change to the program
cannot move the yardstick:
- `device_events` is chip_smoke.py's `device_events`: torch.profiler's raw
  kineto events, never its FunctionEvent tree (tens of µs of host time an
  event; a whole PPO iteration records ~10^6 of them), a profile that saw
  no device event taken again up to three times. This copy also keeps each
  event's start, and the host's events for the idle gaps.
- `bound` is chip_smoke.py's `bound`: the larger of the bytes moved over
  the memory rate and the float32 operations over the float32 peak.

`busy_seconds` is the union of the device events' intervals, so that
overlapping kernels on two streams count once (chip_smoke.py summed them).
"""

from __future__ import annotations

import bisect

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (TF32 is off)


def bound(moved: int, ops: int) -> float:
    """Least seconds: bytes over the memory rate or operations over the
    float32 peak, whichever is larger."""
    return max(moved / MEM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def device_events(fn, sync) -> tuple[list[tuple[str, int, int]], list[tuple[str, int, int]]]:
    """(device events, host events) of one call of `fn` under torch.profiler,
    each (name, start ns, duration ns), from the profiler's raw events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            item = (e.name(), e.start_ns(), e.duration_ns())
            (dev if e.device_type() == DeviceType.CUDA else host).append(item)
        if dev:
            return dev, host
    return [], []


def busy_seconds(events: list[tuple[str, int, int]]) -> float:
    """The union of the events' intervals, in seconds."""
    total, end = 0, None
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if end is None or s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total * 1e-9


def top_ops(events: list[tuple[str, int, int]], n: int = 10) -> list[list]:
    """The `n` device operations with the most device seconds, by name."""
    by = {}
    for name, _, d in events:
        key = name[:120]
        by[key] = by.get(key, 0) + d
    return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev: list[tuple[str, int, int]], host: list[tuple[str, int, int]],
              n: int = 10) -> list[list]:
    """The device's idle time between kernels, summed by the innermost host
    operation under way at each gap's midpoint: the `n` largest sums."""
    spans = sorted((s, s + d) for _, s, d in dev)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    hosts = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in hosts]
    by = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "(between host ops)"
        for j in range(i, max(i - 200, -1), -1):
            hname, hs, hd = hosts[j]
            if hs + hd >= mid:
                name = hname[:120]
                break
        by[name] = by.get(name, 0) + (b - a)
    return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
