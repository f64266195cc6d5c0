"""Return / advantage computations along the time axis (port of
surreal_tpu/ops/returns.py). All arrays are time-major (T, ...)."""

from __future__ import annotations

import torch

from surreal_tpu_torch.ops import gae_kernel
from surreal_tpu_torch.utils import guards

Tensor = torch.Tensor


def discounted_reverse_scan(x: Tensor, coef: Tensor, associative: bool = True) -> Tensor:
    """Solves y_t = x_t + coef_t·y_{t+1} with y_T = 0 along axis 0.

    `associative=True` is the reference's `jax.lax.associative_scan` of the
    maps y -> x + c·y, composed by its `combine` in its order (log depth:
    a handful of launches per level instead of one per step).
    `associative=False` is the sequential form, each step one fused
    multiply-add as in the reference's `lax.scan`."""
    if associative:
        # jax.lax.associative_scan(combine, (coef, x), reverse=True, axis=0)
        return _odd_even_scan((coef.flip(0), x.flip(0)))[1].flip(0)
    ys = torch.empty_like(x)
    carry = torch.zeros_like(x[-1])
    for t in reversed(range(x.shape[0])):
        carry = torch.addcmul(x[t], coef[t], carry)
        ys[t] = carry
    return ys


def reverse_scan_and_products(x: Tensor, coef: Tensor) -> tuple[Tensor, Tensor]:
    """(y, P): the associative `discounted_reverse_scan` of x and coef, and
    the suffix products P_t = coef_t·coef_{t+1}·…·coef_{T−1} that the same
    scan composes. The products are the reference's `jax.lax.associative_
    scan(jnp.multiply, coef, reverse=True)`: its recursion multiplies in
    the same association."""
    c, y = _odd_even_scan((coef.flip(0), x.flip(0)))
    return y.flip(0), c.flip(0)


def _combine(a: tuple[Tensor, Tensor], b: tuple[Tensor, Tensor]) -> tuple[Tensor, Tensor]:
    """The map (c_a, x_a) followed by (c_b, x_b), as the reference's `combine`."""
    (c_a, x_a), (c_b, x_b) = a, b
    return c_a * c_b, x_b + c_b * x_a


def _odd_even_scan(elems: tuple[Tensor, Tensor]) -> tuple[Tensor, Tensor]:
    """Inclusive scan along axis 0 by JAX's recursion: combine the pairs,
    scan the half, then fill in the even positions."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _odd_even_scan(_combine(tuple(e[0:-1:2] for e in elems),
                                  tuple(e[1::2] for e in elems)))
    prev = odd if n % 2 else tuple(o[:-1] for o in odd)
    even = _combine(prev, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        full[0] = e[0]
        full[2::2] = ev
        full[1::2] = od
        out.append(full)
    return out[0], out[1]


def gae_plain(rewards: Tensor, values: Tensor, next_values: Tensor, discounts: Tensor,
              dones: Tensor, gamma: float, lam: float) -> tuple[Tensor, Tensor]:
    """delta = r + γ·disc·V' − V; A_t = delta_t + γλ·disc_t·(1 − done_t)·A_{t+1};
    returns (A, A + V). The plain version of the kernel in `gae_kernel`:
    the sequential scan."""
    adv = discounted_reverse_scan(*gae_delta_coef(rewards, values, next_values, discounts,
                                                  dones, gamma, lam), associative=False)
    return adv, adv + values


def gae_delta_coef(rewards, values, next_values, discounts, dones, gamma, lam):
    """(delta, coef) of GAE's recurrence A_t = delta_t + coef_t·A_{t+1}."""
    delta = rewards + gamma * discounts * next_values - values
    coef = gamma * lam * discounts * (1.0 - dones.to(values.dtype))
    return delta, coef


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
    delta, coef = gae_delta_coef(rewards, values, next_values, discounts, dones, gamma, lam)
    L = -(-T // chunks)
    bounds = [(lo, min(lo + L, T)) for lo in range(0, T, L)]
    y, p = torch.empty_like(delta), torch.empty_like(delta)
    for lo, hi in bounds:
        yc, pc = torch.zeros_like(delta[0]), torch.ones_like(delta[0])
        for t in reversed(range(lo, hi)):
            yc = torch.addcmul(delta[t], coef[t], yc)
            pc = coef[t] * pc
            y[t], p[t] = yc, pc
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for lo, hi in reversed(bounds):
        adv[lo:hi] = torch.addcmul(y[lo:hi], p[lo:hi], carry)
        carry = adv[lo]
    return adv, adv + values


def gae(rewards: Tensor, values: Tensor, next_values: Tensor, discounts: Tensor,
        dones: Tensor, gamma: float, lam: float, associative: bool = True,
        backend: str = "xla") -> tuple[Tensor, Tensor]:
    """Generalized Advantage Estimation with the truncation bootstrap:
    next_values at `done` is the terminal obs value, discounts are 0 only on
    true termination. Returns (advantages, value_targets = A + V).

    The reference's arguments and defaults: backend "xla" is the torch scan
    (`associative` picks its form, as in `discounted_reverse_scan`);
    "pallas" is the fused kernel (`gae_kernel.gae_cuda`) for CUDA tensors
    and its plain version `gae_plain` for CPU tensors."""
    if backend == "pallas":
        args = (rewards, values, next_values, discounts, dones, gamma, lam)
        adv, vtarg = (gae_plain(*args) if rewards.device.type == "cpu"
                      else gae_kernel.gae_cuda(*args))
        guards.assert_finite(adv, "ops.gae[pallas].advantages")
        return adv, vtarg
    if backend != "xla":
        raise ValueError(f"unknown gae backend {backend!r} (expected 'xla' or 'pallas')")
    delta, coef = gae_delta_coef(rewards, values, next_values, discounts, dones, gamma, lam)
    adv = discounted_reverse_scan(delta, coef, associative=associative)
    guards.assert_finite(adv, "ops.gae.advantages")
    return adv, adv + values


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
