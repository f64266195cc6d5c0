"""Fused clipped-surrogate PPO loss: the CUDA kernels `csrc/ppo_loss.cu`
(forward and closed-form backward, one launch each) behind a
`torch.autograd.Function`, and their plain PyTorch versions.

Replaces surreal_tpu/ops/pallas_ppo_loss.py::fused_clip_loss (_fwd_kernel,
_bwd_kernel and the custom VJP). CUDA tensors launch the kernels; CPU
tensors run the plain versions. On the card the forward is one kernel that
writes the loss and the metrics, and the backward one kernel that applies
the loss's cotangent and sums the shared log-std's gradient over rows: no
torch op runs around either. The 'clip' objective only, with a static
entropy coefficient (the caller's gate, `algos/ppo._loss_fn`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from surreal_tpu_torch.ops import build

Tensor = torch.Tensor
_LOG_2PI = math.log(2.0 * math.pi)
METRICS = ("policy_loss", "value_loss", "entropy", "kl", "clip_frac")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = build.Kernel("ppo_loss.cu", "ppo_loss_fwd", [_P] * 10 + [_I] * 4 + [_F] * 3 + [_P] * 2)
BWD = build.Kernel("ppo_loss.cu", "ppo_loss_bwd", [_P] * 9 + [_I] * 3 + [_F] * 4 + [_P] * 3)


def _logp_terms(mean, log_std, action):
    inv_std = torch.exp(-log_std)
    z = (action - mean) * inv_std
    logp = -0.5 * torch.sum(z * z + 2.0 * log_std + _LOG_2PI, -1)
    return z, inv_std, logp


def loss_fwd_plain(mean, log_std, value, action, logp_old, mean_old, log_std_old,
                   adv, vtarg, v_old, clip_eps: float, value_coef: float,
                   entropy_coef: float) -> tuple[Tensor, Tensor]:
    """(loss (), metrics (5,)): with s the channel means [surr, vloss,
    entropy, kl, clip_frac], loss = −s0 + value_coef·s1 − entropy_coef·s2
    and metrics = [−s0, s1, s2, s3, s4], in the order of METRICS."""
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
    s = torch.stack([x.sum() for x in (surr, vloss, ent, kl, clip_frac)]) / mean.shape[0]
    loss = -s[0] + value_coef * s[1] - entropy_coef * s[2]
    return loss, torch.cat([-s[:1], s[1:]])


def loss_bwd_plain(mean, log_std, value, action, logp_old, mean_old, log_std_old,
                   adv, vtarg, v_old, g_loss: Tensor, clip_eps: float, value_coef: float,
                   entropy_coef: float) -> tuple[Tensor, Tensor, Tensor]:
    """Closed-form g_loss · d loss / d (mean (N, A), log_std, value (N,))
    for loss = −mean(surr) + value_coef·mean(vloss) − entropy_coef·mean(ent);
    the log_std gradient has log_std's shape, (A,) summed over rows or (N, A)."""
    inv_n = 1.0 / mean.shape[0]
    shared_log_std = log_std.dim() == 1
    log_std = log_std.expand_as(mean)
    z, inv_std, logp = _logp_terms(mean, log_std, action)
    x = logp - logp_old
    ratio = torch.exp(torch.clamp(x, -20.0, 20.0))
    in_band_lr = (torch.abs(x) < 20.0).to(mean.dtype)  # clamp passes no gradient
    r_clip = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    # the minimum takes the unclipped branch at ties
    use_unclipped = (ratio * adv <= r_clip * adv).to(mean.dtype)
    g_logp = (-inv_n * (use_unclipped * ratio * adv * in_band_lr))[:, None]
    dmean = g_loss * (g_logp * z * inv_std)
    dls = g_loss * (g_logp * (z * z - 1.0) - entropy_coef * inv_n)
    if shared_log_std:
        dls = dls.sum(0)
    dvv = value - v_old
    v_cl = v_old + torch.clamp(dvv, -clip_eps, clip_eps)
    e1 = (value - vtarg) ** 2
    e2 = (v_cl - vtarg) ** 2
    use_raw = (e1 >= e2).to(value.dtype)  # the maximum takes the raw error at ties
    in_band = (torch.abs(dvv) < clip_eps).to(value.dtype)
    dvloss = use_raw * (value - vtarg) + (1.0 - use_raw) * (v_cl - vtarg) * in_band
    return dmean, dls, g_loss * ((value_coef * inv_n) * dvloss)


def _kernel_args(mean, log_std, value, action, logp_old, mean_old, log_std_old,
                 adv, vtarg, v_old) -> tuple[dict[str, int], int, int, int, int]:
    """Checks the inputs; returns (device pointers by name, N, A, log_std's
    row stride, log_std_old's row stride), a stride of 0 for an (A,) vector
    shared by all rows."""
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
    if len({t.device for t in ins.values()}) != 1:
        raise ValueError("the kernel takes tensors on one device")
    return {k: t.data_ptr() for k, t in ins.items()}, N, A, *strides


def loss_fwd(mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg,
             v_old, clip_eps: float, value_coef: float,
             entropy_coef: float) -> tuple[Tensor, Tensor]:
    """(loss, metrics) as `loss_fwd_plain`; one kernel launch on the card."""
    args = (mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg, v_old)
    if mean.device.type == "cpu":
        return loss_fwd_plain(*args, clip_eps, value_coef, entropy_coef)
    ptr, N, A, ls_stride, lso_stride = _kernel_args(*args)
    loss = torch.empty((), device=mean.device, dtype=torch.float32)
    metrics = torch.empty(5, device=mean.device, dtype=torch.float32)
    FWD.launch(*ptr.values(), N, A, ls_stride, lso_stride, clip_eps, value_coef,
               entropy_coef, loss.data_ptr(), metrics.data_ptr(), device=mean.device)
    return loss, metrics


def loss_bwd(mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg,
             v_old, g_loss: Tensor, clip_eps: float, value_coef: float,
             entropy_coef: float) -> tuple[Tensor, Tensor, Tensor]:
    """(dmean, dlog_std, dvalue) as `loss_bwd_plain`; one kernel launch on
    the card, which reads g_loss (one float) from the device."""
    args = (mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg, v_old)
    if mean.device.type == "cpu":
        return loss_bwd_plain(*args, g_loss, clip_eps, value_coef, entropy_coef)
    ptr, N, A, ls_stride, _ = _kernel_args(*args)
    build.check_cuda_tensors(g_loss=g_loss)
    if g_loss.numel() != 1 or g_loss.device != mean.device:
        raise ValueError(f"g_loss: expected one float on {mean.device}, got "
                         f"{tuple(g_loss.shape)} on {g_loss.device}")
    dmean = torch.empty_like(mean)
    dls = torch.empty_like(log_std)
    dv = torch.empty_like(value)
    BWD.launch(*(ptr[k] for k in ("mean", "log_std", "value", "action", "logp_old", "adv",
                                  "vtarg", "v_old")),
               g_loss.data_ptr(), N, A, ls_stride, clip_eps, value_coef, entropy_coef,
               1.0 / N, dmean.data_ptr(), dls.data_ptr(), dv.data_ptr(), device=mean.device)
    return dmean, dls, dv


class _FusedClipLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean, log_std, value, action, logp_old, mean_old, log_std_old,
                adv, vtarg, v_old, clip_eps, value_coef, entropy_coef):
        args = (mean, log_std, value, action, logp_old, mean_old, log_std_old, adv,
                vtarg, v_old)
        loss, metrics = loss_fwd(*args, clip_eps, value_coef, entropy_coef)
        ctx.save_for_backward(*args)
        ctx.coefs = (clip_eps, value_coef, entropy_coef)
        ctx.mark_non_differentiable(metrics)
        ctx.set_materialize_grads(False)  # no zero-fill launch for the metrics' cotangent
        return loss, metrics

    @staticmethod
    def backward(ctx, g_loss, g_metrics):  # metric cotangents are unused, as in the reference
        if g_loss is None:
            return (None,) * 13
        return loss_bwd(*ctx.saved_tensors, g_loss, *ctx.coefs) + (None,) * 10


def fused_clip_loss(mean, log_std, value, action, logp_old, mean_old, log_std_old,
                    adv, vtarg, v_old, *, clip_eps: float, value_coef: float,
                    entropy_coef: float):
    """Fused PPO 'clip' loss. mean/action/mean_old (N, A); log_std and
    log_std_old (A,) or (N, A); value/logp_old/adv/vtarg/v_old (N,).
    Returns (loss, metrics) like `algos.ppo._loss_fn`; the metrics are views
    of one (5,) tensor and carry no gradient."""
    loss, metrics = _FusedClipLoss.apply(
        mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, vtarg, v_old,
        float(clip_eps), float(value_coef), float(entropy_coef))
    return loss, dict(zip(METRICS, metrics.unbind()))
