"""The GTrXL segment attention's kernels (`ops/gtrxl_attention_kernel.py`,
`ops/csrc/gtrxl_attention.cu`).

On the CPU: the kernels' index inputs, expanded by the kernel's rule, equal
`models/gtrxl.segment_mask`'s distances and mask exactly; the kernels'
arithmetic (keys in distance order, probabilities from the log-sum-exp,
the gradients' closed forms, dpos by diagonals) written in torch ops agrees
with autograd through `attention_plain` (to 1e-6 of each output's largest
element, the float32 rounding of the plain version's softmax); the tiles
the kernels skip hold no visible pair; the CPU, bf16 and other head widths
run the torch ops and never the launcher.

Marked `cuda` (skip without a card; on the card `python -m pytest
--noconftest -m cuda tests/test_torch_gtrxl_attention.py`): the kernels
against `attention_plain` at the cell's shape (B, H, T, m + T) = (128, 8,
128, 640), d_head 32, and at odd shapes; two launches bit for bit; one
launch each way a layer. Tolerances, as max |kernel - plain| over max
|plain| of each output: 1e-5 (float32 sums of up to 640 terms, and dpos's
of 128 x 128 x 640, in another order; measured on the H100 at the cell's
shape: out 5.6e-7, dqu 5.7e-7, dqv 4.6e-7, dk 4.7e-7, dv 3.4e-7, dpos
3.2e-6; at the odd shapes at most 6.1e-7).
"""

import math
import types

import pytest
import torch

from surreal_tpu_torch.models.gtrxl import GTrXL, segment_mask
from surreal_tpu_torch.ops import gtrxl_attention_kernel as ra

TOL = 1e-5
TQ = TK = 64  # csrc/gtrxl_attention.cu's tiles


def expand(episode, valid, p, m):
    """The kernels' index inputs expanded by the kernel's rule, back in
    storage order: (dist (T, m + T), mask (B, T, m + T)). A key at distance
    order n (ring slot (p + n) mod m, or chunk step n - m) has episode 0 (a
    valid slot), -1 (an empty one) or the step's; query i sees it iff i <= n
    <= m + i and the episodes agree; dist = clamp(m + i - n, 0, m)."""
    B, T = episode.shape
    j = torch.arange(m + T)
    n = torch.where(j < m, torch.remainder(j - p, m), j)  # distance order of storage key j
    i = torch.arange(T)[:, None]
    dist = (m + i - n[None, :]).clamp(0, m)
    window = (n[None, :] >= i) & (n[None, :] <= m + i)
    key_ep = torch.cat([torch.where(valid, 0, -1).to(episode.dtype), episode], -1)
    mask = (key_ep[:, None, :] == episode[:, :, None]) & window[None]
    return dist, mask


def _episode(done: torch.Tensor) -> torch.Tensor:
    d = done.to(torch.int64)
    return torch.cumsum(d, 0) - d


def _case(B, T, m, t0, seed, done_at=(), p_done=0.1, p_empty=0.3):
    """(episode (T, B), valid (B, m)) of a chunk at t0: random dones plus
    those at `done_at`, random empty slots."""
    g = torch.Generator().manual_seed(seed)
    done = torch.rand(T, B, generator=g) < p_done
    for s in done_at:
        done[s] = True
    valid = torch.rand(B, m, generator=g) >= p_empty
    return _episode(done), valid


CASES = {
    "ragged": dict(B=5, T=12, m=8, t0=5, seed=1, p_done=0.2),
    "done_at_0": dict(B=3, T=9, m=6, t0=20, seed=2, done_at=(0,)),
    "done_at_last": dict(B=3, T=9, m=6, t0=20, seed=3, done_at=(8,)),
    "before_wrap": dict(B=4, T=7, m=16, t0=3, seed=4),
    "after_wrap": dict(B=4, T=7, m=16, t0=37, seed=5),
    "wrap_at_zero": dict(B=4, T=7, m=16, t0=32, seed=6),
    "empty_slots": dict(B=4, T=10, m=8, t0=11, seed=7, p_empty=1.0),
    "t_above_m": dict(B=3, T=20, m=5, t0=9, seed=8, p_done=0.05),
    "t_below_m": dict(B=2, T=3, m=70, t0=100, seed=9),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_index_expands_to_segment_mask(name):
    c = CASES[name]
    episode, valid = _case(**c)
    dist, mask = segment_mask(episode, valid, c["t0"], c["m"])
    ep32, valid_k, p = ra.kernel_index(episode, valid, c["t0"], c["m"])
    assert ep32.dtype == torch.int32 and ep32.shape == (c["B"], c["T"])
    got_dist, got_mask = expand(ep32, valid_k, p, c["m"])
    assert torch.equal(got_dist, dist)
    assert torch.equal(got_mask, mask)
    assert bool(mask[:, torch.arange(c["T"]), c["m"] + torch.arange(c["T"])].all())


def _inputs(B, T, m, H, D, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    return f(B, T, H, D), f(B, T, H, D), f(B, m + T, H, D), f(B, m + T, H, D), f(m + 1, H, D)


def _kernel_math(qu, qv, k, v, pos, ep32, valid, p, dout):
    """The kernels' arithmetic in torch ops: keys in distance order, scores
    with the Toeplitz relative term, the row's log-sum-exp; the backward's
    P from it, D = dout . out, G = P (dP - D) scale, dk, dv, dqu from G,
    dqv and dpos by diagonals i - n; dk and dv back in storage order."""
    B, T, H, D = qu.shape
    m = pos.shape[0] - 1
    J = m + T
    n = torch.arange(J)
    row = torch.where(n < m, torch.remainder(p + n, m), n)  # storage row of key n
    kd, vd = k[:, row], v[:, row]
    i = torch.arange(T)[:, None]
    dist = m + i - n[None, :]  # (T, J)
    window = (dist >= 0) & (dist <= m)
    key_ep = torch.cat([torch.where(valid[:, row[:m]], 0, -1), ep32.to(torch.int64)], -1)
    vis = window[None] & (key_ep[:, None, :] == ep32.to(torch.int64)[:, :, None])  # (B, T, J)
    scale = 1.0 / math.sqrt(D)
    posd = pos[dist.clamp(0, m)]  # (T, J, H, D)
    s = torch.einsum("bihd,bnhd->bhin", qu, kd) + torch.einsum("bihd,inhd->bhin", qv, posd)
    s = (s * scale).masked_fill(~vis[:, None], float("-inf"))
    lse = torch.logsumexp(s, -1)  # (B, H, T)
    P = torch.exp(s - lse[..., None])
    out = torch.einsum("bhin,bnhd->bihd", P, vd)
    Dr = (dout * out).sum(-1).permute(0, 2, 1)  # (B, H, T)
    dP = torch.einsum("bihd,bnhd->bhin", dout, vd)
    G = P * (dP - Dr[..., None]) * scale
    dv_d = torch.einsum("bhin,bihd->bnhd", P, dout)
    dk_d = torch.einsum("bhin,bihd->bnhd", G, qu)
    dqu = torch.einsum("bhin,bnhd->bihd", G, kd)
    dqv = torch.einsum("bhin,inhd->bihd", G, posd)
    dpos = torch.zeros_like(pos)
    for r in range(m + 1):  # diagonal n = m + i - r
        on = (dist == r)  # (T, J)
        dpos[r] = torch.einsum("bhi,bihd->hd", (G * on).sum(-1), qv)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dk[:, row], dv[:, row] = dk_d, dv_d
    return out, (dqu, dqv, dk, dv, dpos), vis


@pytest.mark.parametrize("name", ["ragged", "after_wrap", "t_above_m", "empty_slots"])
def test_kernel_math_matches_autograd(name):
    c = CASES[name]
    episode, valid = _case(**c)
    B, T, m = c["B"], c["T"], c["m"]
    qu, qv, k, v, pos = _inputs(B, T, m, 2, 4, seed=c["seed"])
    dout = torch.randn(B, T, 2, 4, generator=torch.Generator().manual_seed(99),
                       dtype=torch.float64)
    ep32, valid_k, p = ra.kernel_index(episode, valid, c["t0"], m)
    out, grads, _ = _kernel_math(qu, qv, k, v, pos, ep32, valid_k, p, dout)
    leaves = [x.clone().requires_grad_(True) for x in (qu, qv, k, v, pos)]
    dist, mask = segment_mask(episode, valid, c["t0"], m)
    ref = ra.attention_plain(*leaves, dist, mask)
    ref_grads = torch.autograd.grad(ref, leaves, dout)
    # attention_plain's softmax runs in float32: agreement to float32 rounding
    assert _rel(out, ref.detach()) <= 1e-6
    for got, want in zip(grads, ref_grads):
        assert _rel(got, want) <= 1e-6


def _tile_live(ep, valid, p, m, T, i0, n0):
    """csrc/gtrxl_attention.cu's tile_live for one sequence."""
    J = m + T
    i1, n1 = min(i0 + TQ, T) - 1, min(n0 + TK, J) - 1
    if n1 < i0 or n0 > m + i1:
        return False
    first = int(ep[i0])
    if n0 >= m:
        return int(ep[n1 - m]) >= first
    if n1 >= m:
        return True
    if first != 0:
        return False
    return any(bool(valid[(p + n) % m]) for n in range(n0, n1 + 1))


@pytest.mark.parametrize("seed", range(4))
def test_skipped_tiles_hold_no_visible_pair(seed):
    g = torch.Generator().manual_seed(seed)
    B, T, m = 6, 150, 100
    done = torch.rand(T, B, generator=g) < 0.02
    done[70, 0] = True
    valid = torch.rand(B, m, generator=g) < 0.4
    valid[1] = False
    valid[2, :30] = False
    episode = _episode(done)
    ep32, valid_k, p = ra.kernel_index(episode, valid, 173, m)
    z = torch.zeros(B, T, 1, 1, dtype=torch.float64)
    pos0 = torch.zeros(m + 1, 1, 1, dtype=torch.float64)
    kz = torch.zeros(B, m + T, 1, 1, dtype=torch.float64)
    vis = _kernel_math(z, z, kz, kz, pos0, ep32, valid_k, p, z)[2]  # (B, T, J) distance order
    skipped = 0
    for b in range(B):
        for i0 in range(0, T, TQ):
            for n0 in range(0, m + T, TK):
                if not _tile_live(ep32[b], valid_k[b], p, m, T, i0, n0):
                    skipped += 1
                    assert not bool(vis[b, i0:i0 + TQ, n0:n0 + TK].any())
    assert skipped > 0


def test_fused_dispatch_reads_device_dtype_and_width():
    def x(device, dtype):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert ra.fused(x("cuda", torch.float32), 32)
    assert not ra.fused(x("cpu", torch.float32), 32)
    assert not ra.fused(x("cuda", torch.bfloat16), 32)
    assert not ra.fused(x("cuda", torch.float32), 16)


@pytest.mark.parametrize("dtype,width,heads", [(torch.float32, 64, 2), (torch.bfloat16, 64, 2),
                                               (torch.float32, 32, 2)])
def test_segment_runs_torch_ops_off_the_kernel(monkeypatch, dtype, width, heads):
    """The CPU (head width 32 and 16) and bf16 never reach the launcher."""
    def refuse(*args, **kwargs):
        raise AssertionError("the launcher was called")
    monkeypatch.setattr(ra._RelAttention, "apply", refuse)
    monkeypatch.setattr(ra.FWD, "launch", refuse)
    net = GTrXL(5, layers=2, width=width, heads=heads, memory=6, mlp_width=32,
                generator=torch.Generator().manual_seed(0), compute_dtype=dtype)
    T, B = 8, 3
    x = torch.randn(T, B, 5)
    done = torch.zeros(T, B, dtype=torch.bool)
    done[3, 1] = True
    out = net.segment(x, net.empty_memory(B), torch.ones(B, 6, dtype=torch.bool), done, 4)
    out.float().sum().backward()
    assert out.shape == (T, B, width) and bool(torch.isfinite(out.float()).all())


# ---- on the card ----

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from surreal_tpu_torch.device import resolve

    return resolve("cuda")


def _card_case(B, T, m, H, t0, seed, device, p_done=0.02, p_empty=0.3):
    episode, valid = _case(B, T, m, t0, seed, p_done=p_done, p_empty=p_empty)
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g).to(device)  # noqa: E731
    kv = f(B, m + T, 2 * H * 32)  # k and v as the segment's chunks of one projection
    k, v = (x.reshape(B, m + T, H, 32) for x in kv.chunk(2, -1))
    return dict(qu=f(B, T, H, 32), qv=f(B, T, H, 32), k=k, v=v, pos=f(m + 1, H, 32),
                episode=episode.to(device), valid=valid.to(device), t0=t0, m=m,
                dout=f(B, T, H, 32))


def _both(c):
    """(out, grads) of the kernels and of the torch ops on the same inputs."""
    res = []
    for kernel in (True, False):
        leaves = [c[n].detach().clone().requires_grad_(True)
                  for n in ("qu", "qv", "k", "v", "pos")]
        if kernel:
            out = ra.attention(*leaves, *ra.kernel_index(c["episode"], c["valid"], c["t0"],
                                                         c["m"]))
        else:
            out = ra.attention_plain(*leaves, *segment_mask(c["episode"], c["valid"],
                                                               c["t0"], c["m"]))
        grads = torch.autograd.grad(out, leaves, c["dout"])
        torch.cuda.synchronize()
        res.append((out.detach(), grads))
    return res


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [dict(B=128, T=128, m=512, H=8, t0=1000),
                                   dict(B=3, T=7, m=5, H=2, t0=3),
                                   dict(B=3, T=7, m=5, H=2, t0=13),
                                   dict(B=5, T=130, m=70, H=3, t0=71)])
def test_kernels_match_torch_ops(cuda_device, shape):
    c = _card_case(**shape, seed=7, device=cuda_device)
    (out, grads), (ref, ref_grads) = _both(c)
    errs = [_rel(out, ref)] + [_rel(g, r) for g, r in zip(grads, ref_grads)]
    print("gtrxl attention relative errors (out, dqu, dqv, dk, dv, dpos):", errs)
    assert max(errs) <= TOL


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(cuda_device):
    c = _card_case(B=40, T=128, m=512, H=8, t0=700, seed=3, device=cuda_device)
    first, second = _both(c)[0], _both(c)[0]
    assert torch.equal(first[0], second[0])
    for a, b in zip(first[1], second[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_one_launch_each_way_a_layer(cuda_device):
    net = GTrXL(17, layers=3, width=256, heads=8, memory=64, mlp_width=64,
                generator=torch.Generator().manual_seed(0)).to(cuda_device)
    T, B = 16, 4
    x = torch.randn(T, B, 17, device=cuda_device)
    done = torch.zeros(T, B, dtype=torch.bool, device=cuda_device)
    fwd, bwd = ra.FWD.launches, ra.BWD.launches
    out = net.segment(x, net.empty_memory(B, cuda_device),
                      torch.ones(B, 64, dtype=torch.bool, device=cuda_device), done, 70)
    assert ra.FWD.launches - fwd == 3 and ra.BWD.launches == bwd
    out.sum().backward()
    torch.cuda.synchronize()
    assert ra.FWD.launches - fwd == 3 and ra.BWD.launches - bwd == 3


@pytest.mark.cuda
def test_whole_window_and_own_key_only_rows(cuda_device):
    """Env 0's first query sees every slot and its own key (the window's
    full m + 1); env 1's query after a done sees only its own key."""
    B, T, m, H = 2, 10, 8, 2
    c = _card_case(B, T, m, H, t0=40, seed=11, device=cuda_device, p_done=0.0, p_empty=0.0)
    done = torch.zeros(T, B, dtype=torch.bool)
    done[4, 1] = True  # env 1: step 5 starts an episode
    c["episode"] = _episode(done).to(cuda_device)
    _, mask = segment_mask(c["episode"], c["valid"], c["t0"], m)
    assert int(mask[0, 0].sum()) == m + 1  # slots 1..m away and its own key
    assert int(mask[1, 5].sum()) == 1  # its own key alone
    (out, grads), (ref, ref_grads) = _both(c)
    assert _rel(out[0, 0], ref[0, 0]) <= TOL
    assert _rel(out[1, 5], c["v"][1, m + 5]) <= TOL  # the own value, weight 1
    assert _rel(out[1, 5], ref[1, 5]) <= TOL
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= TOL
