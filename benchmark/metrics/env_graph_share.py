"""The share, in %, of the profiled rollout's `env.step` spans that hold at
least one CUDA graph launch (a host runtime call whose name starts with
`cudaGraphLaunch`): 100 where the env step replays its CUDA graphs, 0 where
it launches op by op. None where the program records no `env.step` span.
Spans and launches as in physics_launches_per_step.py."""

from __future__ import annotations

import bisect

from benchmark.metrics.physics_launches_per_step import LAUNCH_PREFIXES, inside, spans

GRAPH_LAUNCH = next(p for p in LAUNCH_PREFIXES if p.startswith("cudaGraph"))


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    host = p["rollout"]["host"]
    steps = spans(host, "env.step")
    if not steps:
        return None
    graphed = {bisect.bisect_right(steps, (s, float("inf"))) - 1 for name, s, _ in host
               if name.startswith(GRAPH_LAUNCH) and inside(s, steps)}
    return 100.0 * len(graphed) / len(steps)
