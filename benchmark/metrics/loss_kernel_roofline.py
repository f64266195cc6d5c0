"""The fused clipped loss's share of its roofline in the profiled update:
the summed least times of its forward and backward launches (bytes and
operations counted from the minibatch's shape by benchmark/flops.py) over
their summed device time, in %. None where no device kernel of the update
is named for the loss."""

from benchmark import flops, profile


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    n, a = p["minibatch_rows"], p["action_dim"]
    least = {"fwd": profile.bound(*flops.loss_fwd_cost(n, a)),
             "bwd": profile.bound(*flops.loss_bwd_cost(n, a))}
    bound_s = spent_ns = 0.0
    for name, _, dur in p["update"]["device"]:
        if "ppo_loss" not in name:
            continue
        kind = "bwd" if "bwd" in name else "fwd"
        bound_s += least[kind]
        spent_ns += dur
    if not spent_ns:
        return None
    return 100.0 * bound_s / (spent_ns * 1e-9)
