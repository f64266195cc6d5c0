"""Fused clipped-surrogate PPO loss: the CUDA kernels `csrc/ppo_loss.cu`
(forward and closed-form backward) behind a `torch.autograd.Function`,
and their plain PyTorch versions.

Replaces surreal_tpu/ops/pallas_ppo_loss.py::fused_clip_loss (_fwd_kernel,
_bwd_kernel and the custom VJP). CUDA tensors launch the kernels; CPU
tensors run the plain versions. The 'clip' objective only, with a static
entropy coefficient (the caller's gate, `algos/ppo._loss_fn`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from surreal_tpu_torch.ops import build

Tensor = torch.Tensor
_LOG_2PI = math.log(2.0 * math.pi)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = build.Kernel("ppo_loss.cu", "ppo_loss_fwd", [_P] * 10 + [_I] * 4 + [_F, _P, _P])
BWD = build.Kernel("ppo_loss.cu", "ppo_loss_bwd", [_P] * 10 + [_I] * 4 + [_F] * 4 + [_P] * 3)


def _logp_terms(mean, log_std, action):
    inv_std = torch.exp(-log_std)
    z = (action - mean) * inv_std
    logp = -0.5 * torch.sum(z * z + 2.0 * log_std + _LOG_2PI, -1)
    return z, inv_std, logp


def loss_fwd_plain(mean, log_std, value, action, logp_old, mean_old, log_std_old,
                   adv, vtarg, v_old, clip_eps: float) -> Tensor:
    """Channel means [surr, vloss, entropy, kl, clip_frac] (5,)."""
    log_std = log_std.expand_as(mean)
    _, _, logp = _logp_terms(mean, log_std, action)
    ratio = torch.exp(torch.clamp(logp - logp_old, -20.0, 20.0))
    r_clip = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    surr = torch.minimum(ratio * adv, r_clip * adv)
    v_cl = v_old + torch.clamp(value - v_old, -clip_eps, clip_eps)
    vloss = 0.5 * torch.maximum((value - vtarg) ** 2, (v_cl - vtarg) ** 2)
    ent = torch.sum(log_std + 0.5 * (_LOG_2PI + 1.0), -1)
    lso = log_std_old.expand_as(mean)
    var_ratio = torch.exp(2.0 * (lso - log_std))
    dmu = (mean_old - mean) * torch.exp(-log_std)
    kl = torch.sum(log_std - lso + 0.5 * (var_ratio + dmu * dmu - 1.0), -1)
    clip_frac = (torch.abs(ratio - 1.0) > clip_eps).to(surr.dtype)
    sums = torch.stack([x.sum() for x in (surr, vloss, ent, kl, clip_frac)])
    return sums / mean.shape[0]


def loss_bwd_plain(mean, log_std, value, action, logp_old, mean_old, log_std_old,
                   adv, vtarg, v_old, clip_eps: float, value_coef: float,
                   entropy_coef: float) -> tuple[Tensor, Tensor, Tensor]:
    """Closed-form d loss / d (mean (N, A), log_std per row (N, A), value (N,))
    for loss = −mean(surr) + value_coef·mean(vloss) − entropy_coef·mean(ent)."""
    inv_n = 1.0 / mean.shape[0]
    log_std = log_std.expand_as(mean)
    z, inv_std, logp = _logp_terms(mean, log_std, action)
    x = logp - logp_old
    ratio = torch.exp(torch.clamp(x, -20.0, 20.0))
    in_band_lr = (torch.abs(x) < 20.0).to(mean.dtype)  # clamp passes no gradient
    r_clip = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    # the minimum takes the unclipped branch at ties
    use_unclipped = (ratio * adv <= r_clip * adv).to(mean.dtype)
    g_logp = (-inv_n * (use_unclipped * ratio * adv * in_band_lr))[:, None]
    dmean = g_logp * z * inv_std
    dls = g_logp * (z * z - 1.0) - entropy_coef * inv_n
    dvv = value - v_old
    v_cl = v_old + torch.clamp(dvv, -clip_eps, clip_eps)
    e1 = (value - vtarg) ** 2
    e2 = (v_cl - vtarg) ** 2
    use_raw = (e1 >= e2).to(value.dtype)  # the maximum takes the raw error at ties
    in_band = (torch.abs(dvv) < clip_eps).to(value.dtype)
    dvloss = use_raw * (value - vtarg) + (1.0 - use_raw) * (v_cl - vtarg) * in_band
    return dmean, dls, (value_coef * inv_n) * dvloss


def _kernel_args(mean, log_std, value, action, logp_old, mean_old, log_std_old,
                 adv, vtarg, v_old):
    N, A = mean.shape
    ins = dict(mean=mean, log_std=log_std, value=value, action=action, logp_old=logp_old,
               mean_old=mean_old, log_std_old=log_std_old, adv=adv, vtarg=vtarg,
               v_old=v_old)
    for name in ("action", "mean_old"):
        if ins[name].shape != (N, A):
            raise ValueError(f"{name}: expected ({N}, {A}), got {tuple(ins[name].shape)}")
    for name in ("value", "logp_old", "adv", "vtarg", "v_old"):
        if ins[name].shape != (N,):
            raise ValueError(f"{name}: expected ({N},), got {tuple(ins[name].shape)}")
    strides = []
    for name in ("log_std", "log_std_old"):  # (A,) shared by all rows, or (N, A)
        shape = tuple(ins[name].shape)
        if shape not in ((A,), (N, A)):
            raise ValueError(f"{name}: expected ({A},) or ({N}, {A}), got {shape}")
        strides.append(0 if len(shape) == 1 else A)
    build.check_cuda_tensors(**ins)
    return [t.data_ptr() for t in ins.values()] + [N, A, *strides]


def loss_fwd(mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg,
             v_old, clip_eps: float) -> Tensor:
    args = (mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg, v_old)
    if mean.device.type == "cpu":
        return loss_fwd_plain(*args, clip_eps)
    blocks = (mean.shape[0] + 255) // 256  # the source's 256 threads per block
    partial = torch.empty(blocks, 5, device=mean.device, dtype=torch.float32)
    out = torch.empty(5, device=mean.device, dtype=torch.float32)
    FWD.launch(*_kernel_args(*args), clip_eps, partial.data_ptr(), out.data_ptr(),
               device=mean.device)
    return out


def loss_bwd(mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg,
             v_old, clip_eps: float, value_coef: float,
             entropy_coef: float) -> tuple[Tensor, Tensor, Tensor]:
    args = (mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg, v_old)
    if mean.device.type == "cpu":
        return loss_bwd_plain(*args, clip_eps, value_coef, entropy_coef)
    N = mean.shape[0]
    dmean = torch.empty_like(mean)
    dls = torch.empty_like(mean)
    dv = torch.empty_like(value)
    BWD.launch(*_kernel_args(*args), clip_eps, value_coef, entropy_coef, 1.0 / N,
               dmean.data_ptr(), dls.data_ptr(), dv.data_ptr(), device=mean.device)
    return dmean, dls, dv


class _FusedClipLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean, log_std, value, action, logp_old, mean_old, log_std_old,
                adv, vtarg, v_old, clip_eps, value_coef, entropy_coef):
        args = (mean, log_std, value, action, logp_old, mean_old, log_std_old, adv,
                vtarg, v_old)
        means = loss_fwd(*args, clip_eps)
        loss = -means[0] + value_coef * means[1] - entropy_coef * means[2]
        ctx.save_for_backward(*args)
        ctx.coefs = (clip_eps, value_coef, entropy_coef)
        ctx.mark_non_differentiable(means)
        return loss, means

    @staticmethod
    def backward(ctx, g_loss, g_means):  # metric cotangents are unused, as in the reference
        args = ctx.saved_tensors
        dmean, dls, dv = loss_bwd(*args, *ctx.coefs)
        if args[1].dim() == 1:  # log_std (A,) was shared by all rows
            dls = dls.sum(0)
        return (g_loss * dmean, g_loss * dls, g_loss * dv) + (None,) * 10


def fused_clip_loss(mean, log_std, value, action, logp_old, mean_old, log_std_old,
                    adv, vtarg, v_old, *, clip_eps: float, value_coef: float,
                    entropy_coef: float):
    """Fused PPO 'clip' loss. mean/action/mean_old (N, A); log_std and
    log_std_old (A,) or (N, A); value/logp_old/adv/vtarg/v_old (N,).
    Returns (loss, metrics) like `algos.ppo._loss_fn`; the metrics carry no
    gradient."""
    loss, means = _FusedClipLoss.apply(
        mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg, v_old,
        float(clip_eps), float(value_coef), float(entropy_coef))
    return loss, {
        "policy_loss": -means[0],
        "value_loss": means[1],
        "entropy": means[2],
        "kl": means[3],
        "clip_frac": means[4],
    }
