"""Port GAE against the JAX reference: `returns.gae` with both scan forms
and the Pallas kernel `gae_pallas` in interpret mode, at T=16, B=128 with
dones and zero discounts. Tolerance 1e-5 abs: float32 scans over 16
steps whose association order differs (associative scan) and whose
γλ product is rounded differently (the Pallas kernel)."""

import numpy as np
import pytest
import torch

from surreal_tpu.ops import returns as jret
from surreal_tpu.ops.pallas_gae import gae_pallas
from surreal_tpu_torch.ops import gae_kernel, returns

TOL = 1e-5
GAMMA, LAM = 0.99, 0.95


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    T, B = 16, 128
    f = lambda: rs.randn(T, B).astype(np.float32)  # noqa: E731
    disc = (rs.rand(T, B) > 0.1).astype(np.float32)  # zero discount: true termination
    dones = rs.rand(T, B) < 0.15
    dones |= disc == 0
    return f(), f(), f(), disc, dones


def _port(batch):
    return returns.gae(*(torch.tensor(x) for x in batch), GAMMA, LAM)


@pytest.mark.parametrize("associative", [True, False])
def test_gae_matches_reference_scan(batch, associative):
    adv_j, vt_j = jret.gae(*batch, GAMMA, LAM, associative=associative)
    adv_t, vt_t = _port(batch)
    np.testing.assert_allclose(np.asarray(adv_j), adv_t.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.asarray(vt_j), vt_t.numpy(), rtol=0, atol=TOL)


def test_gae_matches_pallas_kernel_interpret(batch):
    adv_j, vt_j = gae_pallas(*batch, GAMMA, LAM, interpret=True)
    adv_t, vt_t = _port(batch)
    np.testing.assert_allclose(np.asarray(adv_j), adv_t.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.asarray(vt_j), vt_t.numpy(), rtol=0, atol=TOL)


def test_discounted_reverse_scan_matches_reference(batch):
    x, coef = batch[0], 0.9 * batch[3]
    y_j = jret.discounted_reverse_scan(x, coef, associative=False)
    y_t = returns.discounted_reverse_scan(torch.tensor(x), torch.tensor(coef))
    np.testing.assert_allclose(np.asarray(y_j), y_t.numpy(), rtol=0, atol=TOL)


def test_done_cuts_the_scan():
    """adv at a done step is its own delta: nothing flows back across it."""
    T, B = 5, 3
    r = torch.ones(T, B)
    v = torch.zeros(T, B)
    dones = torch.zeros(T, B, dtype=torch.bool)
    dones[2] = True
    adv, vt = returns.gae(r, v, v, torch.ones(T, B), dones, GAMMA, LAM)
    assert torch.allclose(adv[2], torch.ones(B))
    assert torch.allclose(adv[1], 1 + GAMMA * LAM * adv[2])
    assert torch.equal(vt, adv)


def test_cpu_tensors_take_the_plain_version(batch):
    before = gae_kernel.GAE.launches
    _port(batch)
    assert gae_kernel.GAE.launches == before


def test_kernel_wrapper_rejects_cpu_tensors(batch):
    """The CUDA entry launches or raises; it never falls back."""
    with pytest.raises(ValueError, match="CUDA"):
        gae_kernel.gae_cuda(*(torch.tensor(x) for x in batch), GAMMA, LAM)
