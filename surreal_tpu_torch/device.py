"""Device resolution: "cuda" by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """Returns the torch device to run on. Defaults to "cuda" and raises if
    no card is present: there is no fallback to the CPU.

    Also turns TF32 off for matmuls and cuDNN. The physics assembly must run
    in full float32: at reduced precision the reference measured an
    indefinite mass matrix (surreal_tpu/envs/physics/engine.py,
    `_highest_precision`), which detonates the SPD Cholesky solves.

    And turns off cuBLAS's reduced-precision reduction for bfloat16 GEMMs.
    Allowed, it may sum a split-K GEMM's partial products in bfloat16,
    while XLA accumulates a bfloat16 dot in float32 and rounds once (the
    networks' compute dtype, A13)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
