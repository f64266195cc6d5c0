"""Port models against the JAX reference: actor-critic forward from carried
flax params, DiagGauss, the Z-filter; plus the port's own init and device
rule. Tolerance 1e-6 abs: the same float32 arithmetic in both, up to
matmul summation order and transcendental implementations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.models import z_filter as jz
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu.models.distributions import DiagGauss as JGauss
from surreal_tpu_torch.device import resolve
from surreal_tpu_torch.models import z_filter as tz
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.models.distributions import DiagGauss

TOL = 1e-6
OBS_DIM, ACT_DIM, HIDDEN = 17, 6, (32, 32)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def flax_net():
    net = FlaxAC(action_dim=ACT_DIM, hidden=HIDDEN)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)))
    return net, jax.device_get(params)


@pytest.mark.parametrize("log_std_fill", [None, -9.0, 3.0])
def test_actor_critic_forward_matches_flax(flax_net, log_std_fill):
    """log_std_fill pushes the raw log-std past the [-8, 2] clip."""
    net, params = flax_net
    if log_std_fill is not None:
        params = jax.tree.map(lambda x: x, params)
        params["params"]["log_std"] = np.full((ACT_DIM,), log_std_fill, np.float32)
    obs = np.random.RandomState(1).randn(64, OBS_DIM).astype(np.float32)
    mean_j, ls_j, v_j = net.apply(params, obs)
    port = PPOActorCritic(OBS_DIM, ACT_DIM, HIDDEN)
    port.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        mean_t, ls_t, v_t = port(_t(obs))
    for a, b in ((mean_j, mean_t), (ls_j, ls_t), (v_j, v_t)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=TOL)


def test_params_round_trip(flax_net):
    _, params = flax_net
    back = params_to_flax(params_from_flax(params))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)


def test_port_init_mirrors_flax_inits():
    net = PPOActorCritic(OBS_DIM, ACT_DIM, (256, 256), generator=torch.Generator().manual_seed(0))
    w = net.actor_torso.dense_1.weight.detach()
    assert abs(w.std().item() - (1 / 256) ** 0.5) < 0.05 * (1 / 256) ** 0.5  # lecun normal
    assert w.abs().max().item() <= 2 * (1 / 256) ** 0.5 / 0.87962566103423978 + 1e-6
    mh = net.mean_head.weight.detach()  # (6, 256): rows orthogonal with gain 0.01
    np.testing.assert_allclose((mh @ mh.T).numpy(), 1e-4 * np.eye(ACT_DIM), atol=1e-9)
    vh = net.value_head.weight.detach()
    assert abs(vh.norm().item() - 1.0) < 1e-5
    assert all(float(b.abs().max()) == 0 for n, b in net.named_parameters() if n.endswith("bias"))
    assert float(net.log_std.abs().max()) == 0


def test_diag_gauss_matches_reference(rng):
    N, A = 128, ACT_DIM
    mean, x, mean_b = (rng.randn(N, A).astype(np.float32) for _ in range(3))
    ls, ls_b = (0.3 * rng.randn(A).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (N, A), jnp.float32))
    pairs = [
        (JGauss.sample(key, mean, ls), DiagGauss.sample(_t(mean), _t(ls), noise=_t(noise))),
        (JGauss.log_prob(mean, ls, x), DiagGauss.log_prob(_t(mean), _t(ls), _t(x))),
        (JGauss.entropy(mean, ls), DiagGauss.entropy(_t(mean), _t(ls))),
        (JGauss.kl(mean, ls, mean_b, ls_b), DiagGauss.kl(_t(mean), _t(ls), _t(mean_b), _t(ls_b))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(a).max())))


def test_diag_gauss_sample_from_generator():
    mean = torch.zeros(4096, ACT_DIM)
    a = DiagGauss.sample(mean, torch.full((ACT_DIM,), np.log(2.0)),
                         generator=torch.Generator().manual_seed(0))
    b = DiagGauss.sample(mean, torch.full((ACT_DIM,), np.log(2.0)),
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert abs(a.std().item() - 2.0) < 0.05


def test_zfilter_matches_reference(rng):
    b1 = rng.randn(8, 16, OBS_DIM).astype(np.float32) * 3 + 1
    b2 = rng.randn(8, 16, OBS_DIM).astype(np.float32)
    js = jz.zfilter_update(jz.zfilter_update(jz.zfilter_init(OBS_DIM), b1), b2)
    ts = tz.zfilter_update(tz.zfilter_update(tz.zfilter_init(OBS_DIM, "cpu"), _t(b1)), _t(b2))
    for f in ("count", "mean", "m2"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    obs = rng.randn(32, OBS_DIM).astype(np.float32) * 10
    np.testing.assert_allclose(np.asarray(jz.zfilter_normalize(js, obs)),
                               tz.zfilter_normalize(ts, _t(obs)).numpy(), rtol=0, atol=TOL)


def test_device_resolution_has_no_cpu_fallback():
    assert resolve("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve()


def test_pixel_and_lstm_forms_raise():
    for kw in ({"pixel_obs": True}, {"use_lstm": True}):
        with pytest.raises(NotImplementedError):
            PPOActorCritic(OBS_DIM, ACT_DIM, HIDDEN, **kw)
