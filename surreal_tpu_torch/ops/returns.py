"""Return / advantage computations along the time axis (port of
surreal_tpu/ops/returns.py). All arrays are time-major (T, ...)."""

from __future__ import annotations

import torch

from surreal_tpu_torch.ops import gae_kernel

Tensor = torch.Tensor


def discounted_reverse_scan(x: Tensor, coef: Tensor) -> Tensor:
    """Solves y_t = x_t + coef_t·y_{t+1} with y_T = 0, sequentially along
    axis 0 (the reference's `associative=False` form)."""
    ys = torch.empty_like(x)
    carry = torch.zeros_like(x[-1])
    for t in reversed(range(x.shape[0])):
        carry = x[t] + coef[t] * carry
        ys[t] = carry
    return ys


def gae_plain(rewards: Tensor, values: Tensor, next_values: Tensor, discounts: Tensor,
              dones: Tensor, gamma: float, lam: float) -> tuple[Tensor, Tensor]:
    """delta = r + γ·disc·V' − V; A_t = delta_t + γλ·disc_t·(1 − done_t)·A_{t+1};
    returns (A, A + V). The plain version of the kernel in `gae_kernel`."""
    dones_f = dones.to(values.dtype)
    delta = rewards + gamma * discounts * next_values - values
    coef = gamma * lam * discounts * (1.0 - dones_f)
    adv = discounted_reverse_scan(delta, coef)
    return adv, adv + values


def gae_chunked_plain(rewards: Tensor, values: Tensor, next_values: Tensor,
                      discounts: Tensor, dones: Tensor, gamma: float, lam: float,
                      chunks: int) -> tuple[Tensor, Tensor]:
    """`gae_plain` in the kernel's order of operations, for the tests: T is
    cut into `chunks` chunks of ceil(T / chunks) steps (the last may be
    shorter). Each chunk is scanned backwards from a carry of 0, keeping the
    local value y_t and the product p_t of the coefficients from t to the
    chunk's end; the carries are then composed from the last chunk down and
    A_t = y_t + p_t·carry. With one chunk it is `gae_plain` itself."""
    T = rewards.shape[0]
    delta = rewards + gamma * discounts * next_values - values
    coef = gamma * lam * discounts * (1.0 - dones.to(values.dtype))
    L = -(-T // chunks)
    bounds = [(lo, min(lo + L, T)) for lo in range(0, T, L)]
    y, p = torch.empty_like(delta), torch.empty_like(delta)
    for lo, hi in bounds:
        yc, pc = torch.zeros_like(delta[0]), torch.ones_like(delta[0])
        for t in reversed(range(lo, hi)):
            yc = delta[t] + coef[t] * yc
            pc = coef[t] * pc
            y[t], p[t] = yc, pc
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for lo, hi in reversed(bounds):
        adv[lo:hi] = y[lo:hi] + p[lo:hi] * carry
        carry = adv[lo]
    return adv, adv + values


def gae(rewards: Tensor, values: Tensor, next_values: Tensor, discounts: Tensor,
        dones: Tensor, gamma: float, lam: float) -> tuple[Tensor, Tensor]:
    """Generalized Advantage Estimation with the truncation bootstrap:
    next_values at `done` is the terminal obs value, discounts are 0 only on
    true termination. Returns (advantages, value_targets = A + V).

    CUDA tensors go through the fused kernel (`gae_kernel.gae_cuda`), CPU
    tensors through `gae_plain`."""
    if rewards.device.type == "cpu":
        return gae_plain(rewards, values, next_values, discounts, dones, gamma, lam)
    return gae_kernel.gae_cuda(rewards, values, next_values, discounts, dones, gamma, lam)


def nstep_returns(rewards: Tensor, dones: Tensor, gamma: float) -> tuple[Tensor, Tensor]:
    """Accumulated n-step reward over a window (n, ...) of rewards and done
    flags, truncated at episode boundaries. Returns (G, cont) where
      G    = Σ_{k<n} γ^k r_{t+k} · Π_{j<k} (1 − done_{t+j})
      cont = γ^n · Π_{k<n} (1 − done_{t+k}), the bootstrap coefficient of
             Q'(s_{t+n}); zero if the episode ended inside the window."""
    alive = torch.ones_like(rewards[0])
    G = torch.zeros_like(rewards[0])
    scale = 1.0  # a Python float, as in the reference: γ^k in double precision
    for k in range(rewards.shape[0]):
        G = G + scale * alive * rewards[k]
        alive = alive * (1.0 - dones[k].to(rewards.dtype))
        scale = scale * gamma
    return G, scale * alive
