"""Host-device copies in the profiled rollout, per rollout step: the
device's `Memcpy HtoD ...` and `Memcpy DtoH ...` events that start inside a
`ppo.rollout.step` span, over the number of those spans. Copies within the
device (`Memcpy DtoD`) are left out. Each such copy from or to pageable
host memory makes the host wait for the stream. None where the program
records no such span. Spans as in physics_launches_per_step.py."""

from benchmark.metrics.physics_launches_per_step import count, inside, spans

TRANSFERS = ("Memcpy HtoD", "Memcpy DtoH")


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    host = p["rollout"]["host"]
    n, steps = count(host, "ppo.rollout.step"), spans(host, "ppo.rollout.step")
    if not n:
        return None
    return sum(1 for name, s, _ in p["rollout"]["device"]
               if name.startswith(TRANSFERS) and inside(s, steps)) / n
