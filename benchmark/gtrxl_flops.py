"""Operations and bytes of the GTrXL PPO counted from shapes: a whole
iteration's operations (for `mfu_gtrxl`) and the decode attention's bytes
and operations (for its roofline share). Whatever implements them, the
counts are these.

`net` holds obs_dim, action_dim, layers (L), width (d), heads (H), memory
(m), mlp_width (f). A multiply-add is 2 operations and only matrix products
count, as in flops.py (layer norms, gates' elementwise work, softmax, the
loss and the optimizer are left out).

A position's forward through one layer (`position_flops`): its query,
output, gates (W's 3d x d on y, U's 2d x d on x and U_g's d x d, twice) and
MLP products, its own key and value, and its attention over `keys` keys
(the content and position scores and the weighted values). The rollout
runs, per step, one position a env over m + 1 keys, and once per rollout
the prefill: keys and values of the m slots and each layer's projected
positions W_R R_r, r = 0..m. Its bootstrap after the chunk is one more
position a env; the terminal values' probes (a few a chunk) are left out.
The update recomputes each env's chunk (T positions, their keys and values
and those of the m memory slots, each query over m + T keys, the masked
ones included: they are computed) once per epoch, with each minibatch's
projected positions; its backward is twice the forward but for the
memory's keys and values and the embedding, whose inputs take no gradient
(the weights' gradient only: once).
"""

from __future__ import annotations


def position_flops(net: dict, keys: int) -> int:
    """One position through every layer, its own key and value included,
    attending over `keys` keys (embedding and heads not included)."""
    d, f = net["width"], net["mlp_width"]
    dense = 2 * (d * d + 2 * d * d + d * d + 2 * 6 * d * d + 2 * d * f)  # q, kv, o, gates, mlp
    attention = 2 * keys * d * 3  # content, position, weighted values
    return net["layers"] * (dense + attention)


def embed_heads_flops(net: dict) -> int:
    return 2 * (net["obs_dim"] * net["width"] + net["width"] * (net["action_dim"] + 1))


def prefill_flops(net: dict, num_envs: int) -> int:
    d, m, L = net["width"], net["memory"], net["layers"]
    return L * (num_envs * m * 2 * d * 2 * d + (m + 1) * 2 * d * d)


def rollout_flops(net: dict, horizon: int, num_envs: int) -> int:
    m = net["memory"]
    step = position_flops(net, m + 1) + embed_heads_flops(net)
    return prefill_flops(net, num_envs) + (horizon + 1) * num_envs * step


def segment_forward_flops(net: dict, horizon: int) -> tuple[int, int]:
    """(forward, the share of it whose inputs take no gradient) of one env's
    chunk: T positions over m + T keys, the m memory slots' keys and values,
    and the embedding."""
    d, m, L = net["width"], net["memory"], net["layers"]
    memory_kv = L * m * 2 * d * 2 * d
    embed = 2 * net["obs_dim"] * d
    fwd = horizon * (position_flops(net, m + horizon) + embed_heads_flops(net)) + memory_kv
    return fwd, memory_kv + horizon * embed


def update_flops(net: dict, horizon: int, num_envs: int, epochs: int, minibatches: int) -> int:
    fwd, weights_only = segment_forward_flops(net, horizon)
    per_env = fwd + 2 * fwd - weights_only  # forward, weights' and inputs' gradients
    d, m, L = net["width"], net["memory"], net["layers"]
    positions = L * (m + 1) * 2 * d * d  # a minibatch's W_R R, forward and weights' gradient
    return epochs * (num_envs * per_env + minibatches * 2 * positions)


def iteration_flops(net: dict, horizon: int, num_envs: int, epochs: int,
                    minibatches: int) -> int:
    return (rollout_flops(net, horizon, num_envs)
            + update_flops(net, horizon, num_envs, epochs, minibatches))


def decode_attention_cost(net: dict, num_envs: int) -> tuple[int, int]:
    """(bytes, operations) of one layer's one-query attention for every env
    at least: the cache's keys and values (B, H, m, d_head) read, the
    step's query, key and value read, the projected positions (m + 1, H,
    d_head) read, the slots' validity (B, m) bytes read, the heads' output
    (B, H, d_head) written, 4 bytes a float32; operations: the content and
    position scores and the weighted values over m + 1 keys (a
    multiply-add 2), 5 a score for the softmax (max, subtract, exp, sum,
    divide)."""
    B, d, m = num_envs, net["width"], net["memory"]
    moved = 4 * (2 * B * m * d + 3 * B * d + (m + 1) * d + B * d) + B * m
    ops = B * (2 * (m + 1) * d * 3 + 5 * net["heads"] * (m + 1))
    return moved, ops
