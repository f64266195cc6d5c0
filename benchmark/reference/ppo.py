"""Plain PyTorch reference of the PPO arithmetic that one training iteration
runs: the actor-critic forward (MLP torsos), the
diagonal Gaussian, the running-mean/std observation filter, GAE, the
clipped surrogate loss, the global-norm clip and Adam.

Written from the algorithm's definitions (Schulman et al. 2017, PPO; the
Surreal stack's defaults), in float32, one operation after another, with
no kernel, no fusion and nothing of the measured program. Parameters are
a dict of tensors under the names the measured network uses, so the
benchmark can hand the same weights to both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

LOG_2PI = math.log(2.0 * math.pi)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5
ZF_PRIOR, ZF_EPS, ZF_CLIP = 1e-4, 1e-6, 5.0


def param_shapes(spec: dict) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter, in the network's order."""
    shapes: dict[str, tuple[int, ...]] = {}
    torso_in = spec["obs_dim"]
    for torso in ("actor_torso", "critic_torso"):
        d = torso_in
        for i, h in enumerate(spec["hidden"]):
            shapes[f"{torso}.dense_{i}.weight"] = (h, d)
            shapes[f"{torso}.dense_{i}.bias"] = (h,)
            d = h
    A = spec["action_dim"]
    shapes["mean_head.weight"] = (A, d)
    shapes["mean_head.bias"] = (A,)
    shapes["value_head.weight"] = (1, d)
    shapes["value_head.bias"] = (1,)
    shapes["log_std"] = (A,)
    return shapes


def make_weights(spec: dict, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Seeded weights, drawn on `device` in one call: kernels normal with
    variance gain^2 / fan_in (gain 0.01 on the mean head), biases and the
    log-std zero."""
    shapes = param_shapes(spec)
    kernels = {n: s for n, s in shapes.items() if n.endswith("weight")}
    draw = torch.randn(sum(math.prod(s) for s in kernels.values()), generator=generator,
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            n = math.prod(shape)
            gain = 0.01 if name.startswith("mean_head") else 1.0
            out[name] = draw[at:at + n].view(shape) * (gain / math.sqrt(math.prod(shape[1:])))
            at += n
        else:
            out[name] = torch.zeros(shape, device=device, dtype=torch.float32)
    return out


def forward(p: dict, obs: torch.Tensor, spec: dict):
    """obs (..., D) normalised -> (mean (..., A), log_std (A,), value (...))."""
    heads = {}
    for torso in ("actor_torso", "critic_torso"):
        h = obs
        for i in range(len(spec["hidden"])):
            h = torch.tanh(F.linear(h, p[f"{torso}.dense_{i}.weight"], p[f"{torso}.dense_{i}.bias"]))
        heads[torso] = h
    mean = F.linear(heads["actor_torso"], p["mean_head.weight"], p["mean_head.bias"])
    value = F.linear(heads["critic_torso"], p["value_head.weight"], p["value_head.bias"])[..., 0]
    return mean, torch.clamp(p["log_std"], -8.0, 2.0), value


def forward_rows(p: dict, obs: torch.Tensor, spec: dict, block: int):
    """`forward` over the leading axis in blocks of `block` rows."""
    outs = [forward(p, obs[i:i + block], spec) for i in range(0, obs.shape[0], block)]
    return (torch.cat([o[0] for o in outs]), outs[0][1], torch.cat([o[2] for o in outs]))


def log_prob(mean: torch.Tensor, log_std: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    z = (x - mean) * torch.exp(-log_std)
    return -0.5 * torch.sum(z * z + LOG_2PI, -1) - torch.sum(log_std.expand_as(mean), -1)


# ---- the running observation filter (Chan et al.'s parallel merge) ----

def zfilter_init(dim: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (torch.tensor(ZF_PRIOR, device=device), torch.zeros(dim, device=device),
            torch.zeros(dim, device=device))


def zfilter_normalize(zf, obs: torch.Tensor) -> torch.Tensor:
    count, mean, m2 = zf
    std = torch.sqrt(m2 / torch.clamp(count, min=1.0) + ZF_EPS)
    return torch.clamp((obs - mean) / std, -ZF_CLIP, ZF_CLIP)


def zfilter_update(zf, batch: torch.Tensor):
    count, mean, m2 = zf
    x = batch.reshape(-1, batch.shape[-1]).to(torch.float32)
    n = float(x.shape[0])
    mean_b = x.mean(0)
    m2_b = ((x - mean_b) ** 2).sum(0)
    delta = mean_b - mean
    tot = count + n
    return tot, mean + delta * (n / tot), m2 + m2_b + delta ** 2 * count * n / tot


# ---- GAE, the loss, the optimizer ----

def gae(reward, value, next_value, discount, done, gamma: float, lam: float):
    """A_t = delta_t + gamma lam discount_t (1 - done_t) A_{t+1}, backwards
    over time; returns (advantages, value targets = A + V)."""
    adv = torch.zeros_like(value)
    carry = torch.zeros_like(value[0])
    for t in reversed(range(value.shape[0])):
        delta = reward[t] + gamma * discount[t] * next_value[t] - value[t]
        carry = delta + gamma * lam * discount[t] * (1.0 - done[t].float()) * carry
        adv[t] = carry
    return adv, adv + value


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    m = adv.mean()
    return (adv - m) / torch.sqrt(((adv - m) ** 2).mean() + 1e-8)


def clip_loss(cfg: dict, mean, log_std, value, action, logp_old, adv, vtarg, v_old):
    """The clipped surrogate, the clipped value loss and the entropy bonus."""
    logp = log_prob(mean, log_std, action)
    ratio = torch.exp(torch.clamp(logp - logp_old, -20.0, 20.0))
    eps = cfg["clip_eps"]
    policy = -torch.mean(torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv))
    v_clipped = v_old + torch.clamp(value - v_old, -eps, eps)
    vloss = 0.5 * torch.mean(torch.maximum((value - vtarg) ** 2, (v_clipped - vtarg) ** 2))
    entropy = torch.mean(torch.sum(log_std.expand_as(mean) + 0.5 * (LOG_2PI + 1.0), -1))
    return policy + cfg["value_coef"] * vloss - cfg["entropy_coef"] * entropy


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return {n: g * scale for n, g in grads.items()}


class Adam:
    """Adam with bias correction, epsilon outside the square root; the bias
    corrections 1 - b**count evaluated in float32, as optax (the Surreal
    stack's optimizer) evaluates them."""

    def __init__(self, mu: dict, nu: dict, count: int = 0):
        self.count = count
        self.mu, self.nu = dict(mu), dict(nu)

    def direction(self, grads: dict) -> dict:
        self.count += 1
        one, n = np.float32(1), np.float32(self.count)
        bc1 = float(one - np.float32(ADAM_B1) ** n)
        bc2 = float(one - np.float32(ADAM_B2) ** n)
        out = {}
        for n, g in grads.items():
            self.mu[n] = ADAM_B1 * self.mu[n] + (1 - ADAM_B1) * g
            self.nu[n] = ADAM_B2 * self.nu[n] + (1 - ADAM_B2) * g * g
            out[n] = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + ADAM_EPS)
        return out
