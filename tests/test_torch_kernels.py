"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: on a machine without a card each test skips (decided in the
`cuda_device` fixture, never at import). On the card:
    python -m pytest -m cuda tests/test_torch_kernels.py
Tolerances: GAE 1e-4 abs (a 128-step float32 scan; the kernel contracts
multiply-adds and rounds γλ once in float32), loss means 1e-5 abs (sums
of 4096 rows in another order), loss gradients 1e-6 abs (per-row values
of size ~1/N).
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


def _loss_batch(N, A, dev, shared_log_std_old):
    g = torch.Generator().manual_seed(N + A)
    f = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    mean, value, action = f(N, A), f(N), f(N, A)
    log_std = 0.3 * f(A)
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
    k_means = plk.loss_fwd(*batch, 0.2)
    p_means = plk.loss_fwd_plain(*batch, 0.2)
    k_grads = plk.loss_bwd(*batch, 0.2, 0.5, 0.01)
    p_grads = plk.loss_bwd_plain(*batch, 0.2, 0.5, 0.01)
    torch.cuda.synchronize()
    assert (k_means - p_means).abs().max().item() <= 1e-5
    for a, b in zip(k_grads, p_grads):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-6


def test_loss_kernel_propagates_nan_like_plain(cuda_device):
    batch = list(_loss_batch(256, 6, cuda_device, False))
    batch[0] = batch[0].clone()
    batch[0][3, 2] = float("nan")
    k_means = plk.loss_fwd(*batch, 0.2)
    p_means = plk.loss_fwd_plain(*batch, 0.2)
    assert torch.equal(torch.isnan(k_means), torch.isnan(p_means))
    assert torch.isnan(k_means[0])


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


def test_kernel_rejects_mixed_devices(cuda_device):
    batch = list(_loss_batch(256, 6, cuda_device, False))
    batch[3] = batch[3].cpu()
    with pytest.raises(ValueError):
        plk.loss_fwd(*batch, 0.2)
