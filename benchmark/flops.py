"""Operations and bytes counted from shapes: the networks' floating-point
operations of a PPO iteration (for `mfu`) and the fused clipped loss's
bytes and operations (for its roofline share). Whatever implements them,
the counts are these.

Networks: a multiply-add is 2 operations; only the matrix products count (activations, biases and the loss's elementwise work
are left out). A forward costs F per row, a backward F for the weights'
gradients plus F less the first layers' share for the inputs' gradients
(no gradient flows into the observations). The rollout runs a forward for
each of its horizon steps and one for the bootstrap of its last
observation; the forwards for the bootstrap of a finished episode's
terminal observation (one in a thousand steps here) are left out.

The loss kernels' operation counts per row are chip_smoke.py's, counted
from the kernels' source (a transcendental, a compare or a select counts
as one); their bytes count each input read once and each output written
once, 4 bytes a float32.
"""

from __future__ import annotations

LOSS_FWD_OPS_PER_ROW = (23, 29)  # 23·A + 29
LOSS_BWD_OPS_PER_ROW = (22, 40)  # 22·A + 40, the shared log-std's row sum included


def layers(net: dict) -> list[tuple[str, int]]:
    """(torso, multiply-adds a row) of every product of the actor-critic;
    the torso is 'actor' or 'critic'."""
    out = []
    for torso, head in (("actor", net["action_dim"]), ("critic", 1)):
        d = net["obs_dim"]
        for h in net["hidden"]:
            out.append((torso, d * h))
            d = h
        out.append((torso, d * head))
    return out


def forward_flops(net: dict) -> int:
    """Operations of one forward of one row."""
    return 2 * sum(m for _, m in layers(net))


def backward_flops(net: dict) -> int:
    """Operations of one backward of one row: every layer's weight gradient,
    and the input gradient of every layer but the torsos' first, which read
    the observations."""
    ls = layers(net)
    first, seen = set(), set()
    for i, (torso, _) in enumerate(ls):
        if torso not in seen:
            first.add(i)
            seen.add(torso)
    weights = 2 * sum(m for _, m in ls)
    inputs = 2 * sum(m for i, (_, m) in enumerate(ls) if i not in first)
    return weights + inputs


def ppo_iteration_flops(net: dict, horizon: int, num_envs: int, epochs: int) -> int:
    rows = horizon * num_envs
    rollout = (horizon + 1) * num_envs * forward_flops(net)
    update = epochs * rows * (forward_flops(net) + backward_flops(net))
    return rollout + update


def loss_fwd_cost(n: int, a: int, per_row_log_std_old: bool = True) -> tuple[int, int]:
    """(bytes, operations) of the loss forward over n rows of a actions:
    mean, action, mean_old (n, a), log_std (a,), log_std_old (n, a) or (a,),
    value, logp_old, adv, vtarg, v_old (n,) in; the loss and 5 metrics out."""
    lso = n * a if per_row_log_std_old else a
    moved = 4 * (3 * n * a + a + lso + 5 * n + 1 + 5)
    return moved, (LOSS_FWD_OPS_PER_ROW[0] * a + LOSS_FWD_OPS_PER_ROW[1]) * n


def loss_bwd_cost(n: int, a: int) -> tuple[int, int]:
    """(bytes, operations) of the loss backward: mean, action (n, a),
    log_std (a,), value, logp_old, adv, vtarg, v_old (n,) and the loss's
    cotangent in; the gradients of mean (n, a), log_std (a,) and value (n,)
    out."""
    moved = 4 * (2 * n * a + a + 5 * n + 1 + n * a + a + n)
    return moved, (LOSS_BWD_OPS_PER_ROW[0] * a + LOSS_BWD_OPS_PER_ROW[1]) * n
