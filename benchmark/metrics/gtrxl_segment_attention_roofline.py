"""The segment pass's attention's share of its roofline, in %: over the
profiled update, the summed least times of every layer's relative-position
attention forward and backward over the chunk (`segment_attention_cost`,
counted from the shapes whatever implements it) over the device time of the
events launched inside `gtrxl.attention` spans within `gtrxl.segment` and
inside `gtrxl.attention_backward` spans. None where the program records no
`gtrxl.attention_backward` span (its backward is autograd's, whose device
time no span holds)."""

from __future__ import annotations

from benchmark import profile
from benchmark.launched import device_ns_within
from benchmark.metrics.physics_launches_per_step import count


def segment_attention_cost(net: dict, sequences: int, horizon: int) -> tuple[int, int, int, int]:
    """(forward bytes, forward operations, backward bytes, backward
    operations) of one layer's attention for `sequences` chunks of `horizon`
    steps over the memory: B, T, m, H, d_head, J = m + T keys, of which a
    query sees the m + 1 of its window (query i the keys i..m + i).
    Operations (a multiply-add 2) over each query's window: the forward's
    content, relative term and weighted values, 2 B H T d_head 3 (m + 1); the
    backward's six products (dP, dv, dk, dq from the content, dqv and dpos
    from the relative term), 2 B H T d_head 6 (m + 1). Bytes, float32 4 each, read or written once: qu, qv, k, v,
    pos, the output and the log-sum-exp (B, H, T), and the index inputs (the
    episodes (B, T) int32, the slots' validity (B, m) bytes); the backward
    also dout, dqu, dqv, dk, dv and dpos."""
    B, T, m, H = sequences, horizon, net["memory"], net["heads"]
    d = net["width"]
    dh, J = d // H, m + T
    moved = 4 * (2 * B * T * d + 2 * B * J * d + (m + 1) * d + B * T * d + B * H * T) \
        + 4 * B * T + B * m
    fwd_ops = 2 * B * H * T * dh * 3 * (m + 1)
    bwd_moved = moved + 4 * (B * T * d + 2 * B * T * d + 2 * B * J * d + (m + 1) * d)
    bwd_ops = 2 * B * H * T * dh * 6 * (m + 1)
    return moved, fwd_ops, bwd_moved, bwd_ops


def read(ctx):
    p, net, cfg = ctx.get("profile"), ctx.get("net"), ctx.get("cfg")
    if not p or not net or "layers" not in net or not cfg or "update" not in p:
        return None
    part = p["update"]
    fwd = device_ns_within(part, ("gtrxl.segment", "gtrxl.attention"))
    bwd = device_ns_within(part, ("gtrxl.attention_backward",))
    segments = count(part["host"], "gtrxl.segment")
    if fwd is None or bwd is None or not fwd[1] or not bwd[1] or not segments:
        return None
    f_moved, f_ops, b_moved, b_ops = segment_attention_cost(
        net, ctx["num_envs"] // cfg["num_minibatches"], cfg["horizon"])
    least = (profile.bound(f_moved, f_ops) + profile.bound(b_moved, b_ops)) * net["layers"]
    return 100.0 * least * segments / ((fwd[0] + bwd[0]) * 1e-9)
