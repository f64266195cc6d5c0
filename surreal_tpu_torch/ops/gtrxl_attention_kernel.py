"""The GTrXL segment pass's relative-position attention: the CUDA kernels
`csrc/gtrxl_attention.cu` (forward and backward, one launch each) behind a
`torch.autograd.Function`, and the plain torch ops they replace.

Replaces no TPU kernel (the JAX package has no GTrXL): `GTrXL.segment`
(`models/gtrxl.py`) ran `attention_plain`, whose scores (B, H, T, m + T) are
written and read about fourteen times each way. `attention` takes what the
projections give: qu = q + u, qv = q + v (B, T, H, d_head), the keys and
values of the m memory slots then the T chunk steps (B, m + T, H, d_head),
the projected positions W_R R_r (m + 1, H, d_head), and small index inputs
(`kernel_index`) from which the kernel rebuilds each pair's distance and
mask itself. `fused` is the dispatch: CUDA float32 at a head width the
kernel is built for; every other input (the CPU, bf16, other widths) runs
`attention_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from surreal_tpu_torch.ops import build
from surreal_tpu_torch.utils.profiling import span

Tensor = torch.Tensor
HEAD_DIMS = (32,)  # csrc/gtrxl_attention.cu's kD

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
FWD = build.Kernel("gtrxl_attention.cu", "gtrxl_attention_fwd",
                   [_P] * 9 + [_I] * 5 + [_L] * 2 + [_F])
BWD = build.Kernel("gtrxl_attention.cu", "gtrxl_attention_bwd",
                   [_P] * 19 + [_I] * 5 + [_L] * 2 + [_F])


def _groups(B: int) -> int:
    """The backward's first-level dpos groups for B sequences (the
    kernel's own count, which sizes its workspace and counters)."""
    fn = build.library("gtrxl_attention.cu").gtrxl_attention_groups
    fn.argtypes, fn.restype = [_I], _I
    return fn(B)


def fused(x: Tensor, head_dim: int) -> bool:
    """Whether the attention over `x`'s device and dtype at `head_dim` runs
    the kernels."""
    return x.device.type == "cuda" and x.dtype == torch.float32 and head_dim in HEAD_DIMS


def attention_plain(qu: Tensor, qv: Tensor, k: Tensor, v: Tensor, pos: Tensor, dist: Tensor,
                    mask: Tensor) -> Tensor:
    """The heads' outputs (B, T, H, d_head) in torch ops: scores (B, H, T, m +
    T) of content and relative terms, masked softmax in float32, weighted
    values."""
    content = torch.einsum("bthd,bjhd->bhtj", qu, k)
    rel = torch.einsum("bthd,rhd->bhtr", qv, pos)
    rel = torch.gather(rel, -1, dist.expand(*rel.shape[:2], *dist.shape))
    scores = (content + rel).to(torch.float32) / math.sqrt(qu.shape[-1])
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, -1).to(qu.dtype)
    return torch.einsum("bhtj,bjhd->bthd", probs, v)


def kernel_index(episode: Tensor, valid: Tensor, t0: int, m: int) -> tuple[Tensor, Tensor, int]:
    """The kernels' index inputs: the queries' episodes (B, T) int32, the
    slots' validity (B, m) bool, and p = t0 mod m, the ring slot of the
    farthest memory key. The kernel takes the memory's keys in distance
    order (key n < m is slot (p + n) mod m, key n >= m the chunk's step n -
    m), so that a query i and a key n lie m + i - n apart: query i sees key n
    iff i <= n <= m + i and the key's episode (0 for a valid slot, -1 for an
    empty one, the chunk step's own) is the query's."""
    return episode.T.to(torch.int32).contiguous(), valid.contiguous(), t0 % m


def _check(qu, qv, k, v, pos, episode, valid) -> None:
    B, T, H, D = qu.shape
    m = pos.shape[0] - 1
    shapes = dict(qv=(qv, (B, T, H, D)), k=(k, (B, m + T, H, D)), v=(v, (B, m + T, H, D)),
                  pos=(pos, (m + 1, H, D)), episode=(episode, (B, T)), valid=(valid, (B, m)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != qu.device:
            raise ValueError(f"{name}: expected {shape} on {qu.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head widths {HEAD_DIMS}, got {D}")
    build.check_cuda_tensors(qu=qu, qv=qv, pos=pos)
    # k and v: rows of H * d_head floats, 16-byte aligned, at one batch and row
    # stride (the segment's are views of one projection)
    if (k.dtype != torch.float32 or v.dtype != torch.float32 or k.stride() != v.stride()
            or k.stride()[2:] != (D, 1) or any(s % 4 for s in k.stride()[:2])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(f"k, v: the kernel takes float32 rows of H * d_head floats at one "
                         f"16-byte aligned stride, got {k.dtype} {k.stride()}, {v.dtype} "
                         f"{v.stride()}")
    build.check_cuda_tensors(torch.int32, episode=episode)
    build.check_cuda_tensors(torch.bool, valid=valid)


class _RelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qu, qv, k, v, pos, episode, valid, p):
        B, T, H, D = qu.shape
        m = pos.shape[0] - 1
        _check(qu, qv, k, v, pos, episode, valid)
        out = torch.empty_like(qu)
        lse = torch.empty(B, H, T, dtype=torch.float32, device=qu.device)
        FWD.launch(qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                   episode.data_ptr(), valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
                   B, T, H, m, p, k.stride(0), k.stride(1), 1.0 / math.sqrt(D),
                   device=qu.device)
        ctx.save_for_backward(qu, qv, k, v, pos, episode, valid, out, lse)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, dout):
        with span("gtrxl.attention_backward"):
            qu, qv, k, v, pos, episode, valid, out, lse = ctx.saved_tensors
            B, T, H, D = qu.shape
            m = pos.shape[0] - 1
            dout = dout.contiguous()
            dqu, dqv = torch.empty_like(qu), torch.empty_like(qv)
            dk = torch.empty(B, m + T, H, D, dtype=qu.dtype, device=qu.device)
            dv = torch.empty_like(dk)
            dpos = torch.empty_like(pos)
            groups = _groups(B)
            ws = torch.empty(B + groups, H, m + 1, D, dtype=torch.float32, device=qu.device)
            dd = torch.empty(B, H, T, dtype=torch.float32, device=qu.device)
            count = torch.zeros(H * groups + H, dtype=torch.int32, device=qu.device)
            BWD.launch(qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                       episode.data_ptr(), valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
                       dout.data_ptr(), dqu.data_ptr(), dqv.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), dd.data_ptr(), ws.data_ptr(), ws[B:].data_ptr(),
                       count.data_ptr(),
                       dpos.data_ptr(), B, T, H, m, ctx.p, k.stride(0), k.stride(1),
                       1.0 / math.sqrt(D), device=qu.device)
        return dqu, dqv, dk, dv, dpos, None, None, None


def attention(qu: Tensor, qv: Tensor, k: Tensor, v: Tensor, pos: Tensor, episode: Tensor,
              valid: Tensor, p: int) -> Tensor:
    """The heads' outputs (B, T, H, d_head) as `attention_plain` computes
    them, with gradients into qu, qv, k, v and pos; one kernel launch each
    way. `episode`, `valid`, `p`: `kernel_index`'s."""
    return _RelAttention.apply(qu, qv, k, v, pos, episode, valid, p)
