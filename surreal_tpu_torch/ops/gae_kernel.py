"""Fused GAE: the launcher of the CUDA kernel `csrc/gae.cu`.

Replaces surreal_tpu/ops/pallas_gae.py::gae_pallas. `ops/returns.gae`
dispatches here for CUDA tensors; its plain version is `returns.gae_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from surreal_tpu_torch.ops import build

Tensor = torch.Tensor

GAE = build.Kernel("gae.cu", "gae_fused",
                   [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_float])


def gae_cuda(rewards: Tensor, values: Tensor, next_values: Tensor, discounts: Tensor,
             dones: Tensor, gamma: float, lam: float) -> tuple[Tensor, Tensor]:
    """Launches the kernel on time-major (T, B) tensors on one CUDA device
    (any T and B; the kernel masks the edges): four float32 arrays and bool
    dones, read as bytes in place. Contiguous views at any storage offset
    are taken as they are. One device kernel and one allocation: the two
    outputs are the halves of one (2, T, B) tensor."""
    if rewards.dim() != 2 or rewards.numel() == 0:
        raise ValueError(f"gae kernel takes non-empty (T, B) arrays, got {tuple(rewards.shape)}")
    T, B = rewards.shape
    floats = dict(rewards=rewards, values=values, next_values=next_values,
                  discounts=discounts)
    ins = dict(**floats, dones=dones)
    for name, t in ins.items():
        if t.shape != (T, B) or t.device != rewards.device:
            raise ValueError(f"{name}: expected ({T}, {B}) on {rewards.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    build.check_cuda_tensors(**floats)
    build.check_cuda_tensors(torch.bool, dones=dones)
    adv, vtarg = torch.empty((2, T, B), dtype=torch.float32, device=rewards.device)
    # gamma*lam is rounded to float32 once, from the double product, as torch
    # rounds the scalar in the plain version
    GAE.launch(*(t.data_ptr() for t in ins.values()), adv.data_ptr(), vtarg.data_ptr(),
               T, B, gamma, gamma * lam, device=rewards.device)
    return adv, vtarg
