"""Device ms of the GTrXL decode per rollout step: the device events
launched inside the profiled rollout's `gtrxl.decode` spans that lie inside
`ppo.rollout.policy` (the policy's step; the terminal-value probes and the
bootstrap after the chunk are left out), over the number of
`ppo.rollout.step` spans. None where the program records no such span."""

from benchmark.launched import per_span


def read(ctx):
    return per_span(ctx, "rollout", ("ppo.rollout.policy", "gtrxl.decode"), "ppo.rollout.step")
