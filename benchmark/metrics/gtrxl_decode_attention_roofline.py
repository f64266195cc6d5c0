"""The decode attention's share of its roofline, in %: over the profiled
rollout steps, the summed least times of every layer's one-query attention
over the cache (bytes and operations counted from the shapes by
benchmark/gtrxl_flops.py: the cache's keys and values read, the step's own
key, value and output) over the device time of the events launched inside
`gtrxl.attention` spans within `gtrxl.decode` within `ppo.rollout.policy`.
Whatever implements the attention, it reads the same work. None where the
program records no such span."""

from benchmark import gtrxl_flops, profile
from benchmark.launched import device_ns_within
from benchmark.metrics.physics_launches_per_step import count


def read(ctx):
    p, net = ctx.get("profile"), ctx.get("net")
    if not p or not net or "layers" not in net:
        return None
    part = p["rollout"]
    got = device_ns_within(part, ("ppo.rollout.policy", "gtrxl.decode", "gtrxl.attention"))
    steps = count(part["host"], "ppo.rollout.step")
    if got is None or not got[0] or not steps:
        return None
    least = profile.bound(*gtrxl_flops.decode_attention_cost(net, p["num_envs"]))
    return 100.0 * least * net["layers"] * steps / (got[0] * 1e-9)
