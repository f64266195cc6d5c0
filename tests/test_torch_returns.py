"""Port GAE against the JAX reference: `returns.gae` with both scan forms
and the Pallas kernel `gae_pallas` in interpret mode, at T=16, B=128 with
dones and zero discounts. Tolerance 1e-5 abs: float32 scans over 16
steps whose association order differs (associative scan) and whose
γλ product is rounded differently (the Pallas kernel).

The CUDA kernel splits T into chunks and recombines them; its order of
operations is `returns.gae_chunked_plain`, held here against the same
references at the recipes' (T, B) = (128, 256) and (256, 128) too. There
the tolerance is 2e-5 abs: advantages of N(0, 1) inputs reach |A| ~ 16-20,
where one float32 spacing is 1.9e-6, each scan order is within ~4 spacings
of a float64 evaluation, and two orders were measured at most 6.7e-6 apart
(3.5 spacings; with rare dones, the longest scans)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.ops import returns as jret
from surreal_tpu.ops.pallas_gae import gae_pallas
from surreal_tpu_torch.ops import gae_kernel, returns
import torch_helpers  # noqa: F401  (one torch thread a test process)

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


# --- the CUDA kernel's chunked order of operations ---

TOL_LONG = 2e-5  # T = 128 and 256: see the module docstring
SHAPES = [(128, 256), (256, 128), (16, 128)]
CHUNKS = [1, 8, 32]


def _make(T, B, p_term=0.1, p_done=0.15):
    """The fixture's recipe at any (T, B); numpy arrays for both sides."""
    rs = np.random.RandomState(1000 * T + B)
    f = lambda: rs.randn(T, B).astype(np.float32)  # noqa: E731
    disc = (rs.rand(T, B) > p_term).astype(np.float32)
    dones = rs.rand(T, B) < p_done
    dones |= disc == 0
    return f(), f(), f(), disc, dones


def _chunked(b, chunks):
    return returns.gae_chunked_plain(*(torch.tensor(x) for x in b), GAMMA, LAM, chunks)


def _assert_close(ref, port, T):
    tol = TOL if T <= 16 else TOL_LONG
    for a_j, a_t in zip(ref, port):
        np.testing.assert_allclose(np.asarray(a_j), a_t.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("associative", [True, False])
@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("T,B", SHAPES)
def test_chunked_gae_matches_reference_scan(T, B, chunks, associative):
    b = _make(T, B)
    _assert_close(jret.gae(*b, GAMMA, LAM, associative=associative), _chunked(b, chunks), T)


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("T,B", SHAPES)
def test_chunked_gae_matches_pallas_kernel_interpret(T, B, chunks):
    b = _make(T, B)
    _assert_close(gae_pallas(*b, GAMMA, LAM, interpret=True), _chunked(b, chunks), T)


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("T,B", [(100, 100), (1, 7)])
def test_chunked_gae_ragged_shapes(T, B, chunks):
    """A last chunk shorter than the rest (100 = 7*13 + 9 = 25*4), more
    chunks than steps (T = 1), and B off the Pallas kernel's 128 lanes."""
    b = _make(T, B)
    for associative in (True, False):
        _assert_close(jret.gae(*b, GAMMA, LAM, associative=associative), _chunked(b, chunks), T)


@pytest.mark.parametrize("associative", [True, False])
def test_chunked_gae_long_scans(associative):
    """Rare dones: the carry crosses many chunks before anything cuts it."""
    b = _make(128, 256, p_term=0.002, p_done=0.005)
    _assert_close(jret.gae(*b, GAMMA, LAM, associative=associative), _chunked(b, 32), 128)


@pytest.mark.parametrize("T,B", SHAPES + [(100, 100), (1, 7)])
def test_one_chunk_is_the_plain_version_bitwise(T, B):
    t = [torch.tensor(x) for x in _make(T, B)]
    for a, p in zip(returns.gae_chunked_plain(*t, GAMMA, LAM, 1),
                    returns.gae_plain(*t, GAMMA, LAM)):
        assert torch.equal(a, p)


def test_chunked_gae_done_cuts_the_scan_across_chunks():
    """A done row at a chunk's first step: nothing crosses into the chunk
    below, whatever the carry above."""
    T, B = 8, 3
    r, v = torch.ones(T, B), torch.zeros(T, B)
    dones = torch.zeros(T, B, dtype=torch.bool)
    dones[4] = True
    adv, _ = returns.gae_chunked_plain(r, v, v, torch.ones(T, B), dones, GAMMA, LAM, 2)
    assert torch.equal(adv[4], torch.ones(B))
    assert torch.allclose(adv[3], 1 + GAMMA * LAM * adv[4])


@pytest.mark.parametrize("n", [1, 3, 5])
def test_nstep_returns_match_reference(n):
    """Windows with dones inside (a third of the flags set). Tolerance 1e-6:
    the same float32 operations in the same order on both sides."""
    rs = np.random.RandomState(n)
    rewards = rs.randn(n, 64).astype(np.float32)
    dones = rs.rand(n, 64) < 0.33
    G_j, cont_j = jret.nstep_returns(jnp.asarray(rewards), jnp.asarray(dones), 0.99)
    G_t, cont_t = returns.nstep_returns(torch.tensor(rewards), torch.tensor(dones), 0.99)
    np.testing.assert_allclose(np.asarray(G_j), G_t.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(cont_j), cont_t.numpy(), rtol=0, atol=1e-6)
    assert (cont_t.numpy() == 0).any() and (cont_t.numpy() > 0).any()
    # the reward of the step that ends the episode still counts; nothing after it does
    first_done = np.where(dones.any(0), dones.argmax(0), n)
    want = sum(0.99 ** k * rewards[k] * (k <= first_done) for k in range(n))
    np.testing.assert_allclose(want, G_t.numpy(), rtol=0, atol=1e-5)


# --- the reference's `associative` and `backend` arguments ---

TOL_FORM = 1e-6  # each torch form does the matching reference path's float32 operations in order


def _truncated_batch(T, B=16):
    """(T, B) N(0, 1) rewards and values; 5% true terminations (discount 0)
    and 5% truncations (time limits: done with discount 1)."""
    rs = np.random.RandomState(17 + T)
    f = lambda: rs.randn(T, B).astype(np.float32)  # noqa: E731
    term = rs.rand(T, B) < 0.05
    trunc = rs.rand(T, B) < 0.05
    disc = (~term).astype(np.float32)
    return f(), f(), f(), disc, term | trunc


@pytest.mark.parametrize("associative", [True, False])
@pytest.mark.parametrize("T", [128, 5, 1])
def test_gae_forms_match_the_reference_form(T, associative):
    """associative=True against the reference's associative_scan, False
    against its lax.scan, at T = 128, 5 (not a power of two) and 1."""
    b = _truncated_batch(T)
    ref = jret.gae(*b, GAMMA, LAM, associative=associative)
    port = returns.gae(*(torch.tensor(x) for x in b), GAMMA, LAM, associative=associative)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(np.asarray(r), p.numpy(), rtol=0, atol=TOL_FORM)


def test_gae_defaults_are_the_reference_defaults():
    import inspect

    for fn in (jret.gae, returns.gae):
        params = inspect.signature(fn).parameters
        assert (params["associative"].default, params["backend"].default) == (True, "xla")


def test_gae_pallas_backend_on_the_cpu_is_the_plain_version():
    t = [torch.tensor(x) for x in _truncated_batch(128)]
    before = gae_kernel.GAE.launches
    for a, p in zip(returns.gae(*t, GAMMA, LAM, backend="pallas"),
                    returns.gae_plain(*t, GAMMA, LAM)):
        assert torch.equal(a, p)
    assert gae_kernel.GAE.launches == before


def test_gae_unknown_backend_raises():
    t = [torch.tensor(x) for x in _truncated_batch(5)]
    with pytest.raises(ValueError, match="backend"):
        returns.gae(*t, GAMMA, LAM, backend="triton")
