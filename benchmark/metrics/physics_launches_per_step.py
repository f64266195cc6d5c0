"""Launches inside the profiled rollout's `env.physics` spans, per rollout
step (the number of `ppo.rollout.step` spans). None where the program
records no such span (a program without spans, or a run without a card,
whose profile holds no event).

A span is a host event of the program's own (`surreal_tpu_torch.utils.
profiling.span`), on the clock of the device's events; an event is inside
a span when it starts inside one of that name. A launch is a host runtime
call that queues device work: its name starts with one of LAUNCH_PREFIXES.
On the H100 (torch 2.11, CUDA 12.8) the profiled rollout and update show
`cudaLaunchKernel`, `cudaLaunchKernelExC`, `cuLaunchKernel`,
`cudaMemcpyAsync` and `cudaMemsetAsync`, and no graph launch.

The other span readers share the functions below."""

from __future__ import annotations

import bisect

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


def spans(events, name: str) -> list[tuple[int, int]]:
    """The union of the intervals of the events called `name`, sorted."""
    out: list[tuple[int, int]] = []
    for s, e in sorted((s, s + d) for n, s, d in events if n == name):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def count(events, name: str) -> int:
    return sum(n == name for n, _, _ in events)


def inside(t: int, intervals: list[tuple[int, int]]) -> bool:
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and t <= intervals[i][1]


def launches_per(ctx, part: str, within: str, per: str, outside: str | None = None):
    """Launches of the profile's `part` ("rollout" or "update") inside
    `within` spans and outside `outside` spans, over the number of `per`
    spans; None where either span is missing."""
    p = ctx.get("profile")
    if not p:
        return None
    host = p[part]["host"]
    n, inner = count(host, per), spans(host, within)
    if not n or not inner:
        return None
    outer = spans(host, outside) if outside else []
    hits = sum(1 for name, s, _ in host if name.startswith(LAUNCH_PREFIXES)
               and inside(s, inner) and not inside(s, outer))
    return hits / n


def read(ctx):
    return launches_per(ctx, "rollout", "env.physics", "ppo.rollout.step")
