"""Device resolution: "cuda" by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """Returns the torch device to run on. Defaults to "cuda" and raises if
    no card is present: there is no fallback to the CPU.

    Also turns TF32 off for matmuls and cuDNN. The physics assembly must run
    in full float32: at reduced precision the reference measured an
    indefinite mass matrix (surreal_tpu/envs/physics/engine.py,
    `_highest_precision`), which detonates the SPD Cholesky solves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
