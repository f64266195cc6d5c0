"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: on a machine without a card each test skips (decided in the
`cuda_device` fixture, never at import). On the card:
    python -m pytest -m cuda tests/test_torch_kernels.py
Tolerances: GAE 1e-4 abs (a 128-step float32 scan; the kernel contracts
multiply-adds and rounds γλ once in float32), the loss and its metrics
1e-5 abs (sums of N rows in another order), loss gradients 1e-6 abs
(per-row values of size ~1/N, and their fixed-order row sum for a shared
log_std against torch's sum(0)).
"""

import numpy as np
import pytest
import torch

from surreal_tpu_torch.ops import gae_kernel, returns
from surreal_tpu_torch.ops import ppo_loss_kernel as plk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from surreal_tpu_torch.device import resolve

    return resolve("cuda")


COEFS = (0.2, 0.5, 0.01)  # clip_eps, value_coef, entropy_coef


def _loss_batch(N, A, dev, shared_log_std_old, log_std_rows=False):
    """log_std (A,) shared by all rows, or (N, A) with log_std_rows."""
    g = torch.Generator().manual_seed(N + A)
    f = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    mean, value, action = f(N, A), f(N), f(N, A)
    log_std = 0.3 * f(A)
    if log_std_rows:  # the old policy's log_std stays close to each row's
        log_std = log_std + 0.1 * f(N, A)
    mean_old = mean + 0.1 * f(N, A)
    log_std_old = log_std + 0.05
    if not shared_log_std_old:
        log_std_old = log_std_old.expand(N, A).contiguous()
    z = (action - mean_old) * torch.exp(-log_std_old)
    logp_old = -0.5 * (z * z + np.log(2 * np.pi)).sum(-1) - log_std_old.expand(N, A).sum(-1)
    adv = f(N)
    adv[::7] = 0.0  # ties between the clipped and unclipped surrogate
    return (mean, log_std, value, action, logp_old, mean_old, log_std_old, adv, f(N),
            value + 0.1 * f(N))


def _at_offset(x):
    """A contiguous copy of x that starts one row (one element for an (A,)
    vector) into its storage: not 16-byte aligned."""
    buf = torch.empty((x.shape[0] + 1,) + x.shape[1:], device=x.device, dtype=x.dtype)
    buf[1:] = x
    return buf[1:]


def _check_loss_kernels(batch, g_loss):
    """Kernel against plain, forward (loss, metrics) within 1e-5 and
    backward (every output, the (A,) row sum included) within 1e-6."""
    k_fwd = plk.loss_fwd(*batch, *COEFS)
    p_fwd = plk.loss_fwd_plain(*batch, *COEFS)
    k_bwd = plk.loss_bwd(*batch, g_loss, *COEFS)
    p_bwd = plk.loss_bwd_plain(*batch, g_loss, *COEFS)
    torch.cuda.synchronize()
    for a, b in zip(k_fwd, p_fwd):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5
    for a, b in zip(k_bwd, p_bwd):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-6


@pytest.mark.parametrize("B", [256, 100])
def test_gae_kernel_matches_plain(cuda_device, B):
    g = torch.Generator().manual_seed(B)
    T = 128
    r, v, nv = (torch.randn(T, B, generator=g).to(cuda_device) for _ in range(3))
    disc = (torch.rand(T, B, generator=g) > 0.02).float().to(cuda_device)
    done = (torch.rand(T, B, generator=g) < 0.05).to(cuda_device)
    before = gae_kernel.GAE.launches
    k = returns.gae(r, v, nv, disc, done, 0.99, 0.95)
    assert gae_kernel.GAE.launches == before + 1
    p = returns.gae_plain(r, v, nv, disc, done, 0.99, 0.95)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert (a - b).abs().max().item() <= 1e-4


def test_gae_kernel_takes_bool_dones_only(cuda_device):
    """The kernel reads dones as bytes, as the rollout stores them."""
    x = torch.zeros(8, 128, device=cuda_device)
    with pytest.raises(ValueError, match="bool"):
        gae_kernel.gae_cuda(x, x, x, x, x, 0.99, 0.95)


@pytest.mark.parametrize("shared_log_std_old", [False, True])
def test_loss_kernels_match_plain(cuda_device, shared_log_std_old):
    batch = _loss_batch(4096, 6, cuda_device, shared_log_std_old)
    _check_loss_kernels(batch, torch.ones((), device=cuda_device))


@pytest.mark.parametrize("log_std_rows", [False, True], ids=["log_std_A", "log_std_NA"])
@pytest.mark.parametrize("N", [256, 4096, 4100, 16384])
def test_loss_kernels_match_plain_at_sizes(cuda_device, N, log_std_rows):
    """A ragged tail (4100) and a row loop (4100, 16384 > the cluster's 4096
    threads), both log_std forms, and a cotangent g_loss other than 1."""
    batch = _loss_batch(N, 6, cuda_device, False, log_std_rows)
    _check_loss_kernels(batch, torch.tensor(2.5, device=cuda_device))


@pytest.mark.parametrize("log_std_rows", [False, True], ids=["log_std_A", "log_std_NA"])
def test_loss_kernels_take_misaligned_views(cuda_device, log_std_rows):
    """Views one row into their storage: the 16-byte copies leave a head
    and a tail to scalar loads and stores."""
    batch = [_at_offset(x) for x in _loss_batch(4100, 6, cuda_device, False, log_std_rows)]
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in batch)
    _check_loss_kernels(batch, _at_offset(torch.full((1,), 2.5, device=cuda_device))[0])


@pytest.mark.parametrize("log_std_rows", [False, True], ids=["log_std_A", "log_std_NA"])
def test_loss_kernels_are_deterministic(cuda_device, log_std_rows):
    """A fixed reduction order and no atomics: two calls are bitwise equal."""
    batch = _loss_batch(16384, 6, cuda_device, False, log_std_rows)
    g = torch.tensor(2.5, device=cuda_device)
    first = (*plk.loss_fwd(*batch, *COEFS), *plk.loss_bwd(*batch, g, *COEFS))
    second = (*plk.loss_fwd(*batch, *COEFS), *plk.loss_bwd(*batch, g, *COEFS))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_loss_kernel_propagates_nan_like_plain(cuda_device):
    batch = list(_loss_batch(256, 6, cuda_device, False))
    batch[0] = batch[0].clone()
    batch[0][3, 2] = float("nan")
    k_loss, k_metrics = plk.loss_fwd(*batch, *COEFS)
    p_loss, p_metrics = plk.loss_fwd_plain(*batch, *COEFS)
    assert torch.equal(torch.isnan(k_metrics), torch.isnan(p_metrics))
    assert torch.isnan(k_metrics[0]) and torch.isnan(k_loss) and torch.isnan(p_loss)
    g = torch.ones((), device=cuda_device)
    for a, b in zip(plk.loss_bwd(*batch, g, *COEFS), plk.loss_bwd_plain(*batch, g, *COEFS)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))


def test_fused_autograd_on_card_matches_cpu(cuda_device):
    batch = _loss_batch(512, 6, "cpu", False)

    def run(dev):
        t = [x.to(dev) for x in batch]
        leaves = [x.requires_grad_() for x in t[:3]]
        loss, metrics = plk.fused_clip_loss(*leaves, *t[3:], clip_eps=0.2, value_coef=0.5,
                                            entropy_coef=0.01)
        grads = torch.autograd.grad(loss, leaves)
        return [loss.cpu(), *(m.cpu() for m in metrics.values()), *(g.cpu() for g in grads)]

    before = (plk.FWD.launches, plk.BWD.launches)
    on_card = run(cuda_device)
    assert (plk.FWD.launches, plk.BWD.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(on_card, run("cpu")):
        assert (a - b).abs().max().item() <= 1e-5


def test_fused_loss_is_one_kernel_each_way(cuda_device):
    """torch.profiler sees exactly one device kernel in a forward of
    fused_clip_loss and one in its backward: no torch op runs around them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = _loss_batch(4096, 6, cuda_device, False)
    leaves = [x.requires_grad_() for x in batch[:3]]
    g = torch.ones((), device=cuda_device)

    def forward():
        return plk.fused_clip_loss(*leaves, *batch[3:], clip_eps=0.2, value_coef=0.5,
                                   entropy_coef=0.01)

    torch.autograd.grad(forward()[0], leaves, g)  # warm-up: build and load
    torch.cuda.synchronize()
    counts = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss, metrics = forward()
        torch.cuda.synchronize()
    counts.append([e.name for e in prof.events() if e.device_type == DeviceType.CUDA])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(loss, leaves, g)
        torch.cuda.synchronize()
    counts.append([e.name for e in prof.events() if e.device_type == DeviceType.CUDA])
    assert len(counts[0]) == 1 and "ppo_loss_fwd" in counts[0][0], counts
    assert len(counts[1]) == 1 and "ppo_loss_bwd" in counts[1][0], counts


def test_kernel_rejects_mixed_devices(cuda_device):
    batch = list(_loss_batch(256, 6, cuda_device, False))
    batch[3] = batch[3].cpu()
    with pytest.raises(ValueError):
        plk.loss_fwd(*batch, *COEFS)
