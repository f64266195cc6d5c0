"""Frozen copy of surreal_tpu_torch/envs/physics/linalg.py as of the benchmark's
first version, kept so that the yardstick does not move with the program.
It imports nothing of the program. Its own docstring follows.

Small-matrix SPD linear algebra (port of surreal_tpu/envs/physics/linalg.py).

The same unrolled Cholesky-Crout with the trace-scaled Tikhonov term and
the relative pivot clamp as the reference (see its `chol_small` docstring
for why both exist). `torch.linalg.cholesky` is not used: it has neither.

All functions take (B, n, n) / (B, n) batched tensors. The loops run over
the static dimension n; each step is batched over the envs AND over the
independent row or column index, so a step costs a few launches instead of
one per matrix element. Every element still sees the reference's sequence
of operations (the sums run in the same order), except the back
substitution of `solve_tri_upper_t`, whose per-row sums run in reverse order.
"""

from __future__ import annotations

import torch


def chol_small(M: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor of SPD M (B, n, n)."""
    n = M.shape[-1]
    eps = 1e-6 if M.dtype == torch.float32 else 1e-14
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    reg = eps * torch.amax(torch.abs(diag), dim=-1)  # (B,)
    L = torch.zeros_like(M)
    for j in range(n):
        col = M[:, j:, j].clone()  # rows i >= j of column j
        col[:, 0] = M[:, j, j] + reg
        for k in range(j):
            col = col - L[:, j:, k] * L[:, j, k : k + 1]
        d = torch.sqrt(torch.maximum(col[:, 0], eps * (M[:, j, j] + reg)))
        L[:, j, j] = d
        L[:, j + 1 :, j] = col[:, 1:] * (1.0 / d)[:, None]
    return L


def solve_tri_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L x = b (forward substitution, column by column)."""
    n = L.shape[-1]
    r = b.clone()
    x = torch.empty_like(b)
    for i in range(n):
        x[:, i] = r[:, i] / L[:, i, i]
        r[:, i + 1 :] = r[:, i + 1 :] - L[:, i + 1 :, i] * x[:, i : i + 1]
    return x


def solve_tri_upper_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with Lᵀ x = b (back substitution with the same lower L)."""
    n = L.shape[-1]
    r = b.clone()
    x = torch.empty_like(b)
    for i in reversed(range(n)):
        x[:, i] = r[:, i] / L[:, i, i]
        r[:, :i] = r[:, :i] - L[:, i, :i] * x[:, i : i + 1]
    return x


def solve_spd(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves M x = b for SPD M via the unrolled Cholesky."""
    L = chol_small(M)
    return solve_tri_upper_t(L, solve_tri_lower(L, b))


def inv_spd(M: torch.Tensor) -> torch.Tensor:
    """M⁻¹ = L⁻ᵀ L⁻¹, with L⁻¹ by forward substitution on all columns."""
    n = M.shape[-1]
    L = chol_small(M)
    Linv = torch.zeros_like(M)
    acc = torch.zeros_like(M)  # acc[i, j] = Σ_{k<i} L[i,k]·Linv[k,j]
    for k in range(n):
        row = -acc[:, k, :] / L[:, k, k : k + 1]
        row[:, k] = 1.0 / L[:, k, k]
        row[:, k + 1 :] = 0.0
        Linv[:, k, :] = row
        acc[:, k + 1 :, :] = acc[:, k + 1 :, :] + L[:, k + 1 :, k : k + 1] * row[:, None, :]
    # M⁻¹[i, j] = Σ_k Linv[k, i]·Linv[k, j]; rows k < max(i, j) add zeros.
    out = torch.zeros_like(M)
    for k in range(n):
        out = out + Linv[:, k, :, None] * Linv[:, k, None, :]
    return out
