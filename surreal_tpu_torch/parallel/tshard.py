"""Time-sharded scans: the GAE recurrence split over the mesh's time axis
(port of surreal_tpu/parallel/tshard.py).

The recurrence y_t = x_t + c_t·y_{t+1} decomposes per block b of T/K steps
as y_t = local_t + P_t·carry_b, where local is the block's own scan from a
zero carry, P_t the product of c over [t, block end], and carry_b the y at
the first element of block b + 1 (0 for the last block). Each time rank
scans its block, the ranks all-gather the block summaries (P and local at
the block's first element: two values per batch element), and each folds
the blocks after its own into its carry: exact, one round of communication.
The block scan and its products are the reference's associative scans, in
their association (`ops.returns.reverse_scan_and_products`).
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.ops.returns import reverse_scan_and_products
from surreal_tpu_torch.parallel.mesh import TIME_AXIS, Mesh, all_gather

Tensor = torch.Tensor


def _carry(local: Tensor, products: Tensor, mesh: Mesh, axis_name: str) -> Tensor:
    """This block's carry: the later blocks' summaries folded from the
    last block backwards, as the reference's `fori_loop`."""
    K, my = mesh.shape[axis_name], mesh.index[axis_name]
    A_all = all_gather(products[:1], mesh, axis_name)  # (K, ...)
    B_all = all_gather(local[:1], mesh, axis_name)
    carry = torch.zeros_like(local[0])
    for i in range(K - 1, my, -1):  # only the blocks strictly after mine
        carry = B_all[i] + A_all[i] * carry
    return carry


def replicated_reverse_scan(x: Tensor, c: Tensor, mesh: Mesh,
                            axis_name: str = TIME_AXIS) -> Tensor:
    """The trainers' form: x, c (T, ...) are equal on every time rank (the
    rollout ran on each); each scans its T/K block, the summaries are
    exchanged, and the whole (T, ...) result is gathered back, equal on
    every time rank."""
    K, my = mesh.shape[axis_name], mesh.index[axis_name]
    T = x.shape[0]
    assert T % K == 0, f"horizon {T} not divisible by time axis {K}"
    blk = T // K
    local, products = reverse_scan_and_products(x[my * blk:(my + 1) * blk], c[my * blk:(my + 1) * blk])
    y_blk = local + products * _carry(local, products, mesh, axis_name)
    return all_gather(y_blk, mesh, axis_name)


def time_sharded_reverse_scan(mesh: Mesh, x: Tensor, c: Tensor,
                              axis_name: str = TIME_AXIS) -> Tensor:
    """y_t = x_t + c_t·y_{t+1} with the T axis sharded over `axis_name`:
    x, c are this time rank's block (T/K, ...), and so is the result."""
    local, products = reverse_scan_and_products(x, c)
    return local + products * _carry(local, products, mesh, axis_name)
