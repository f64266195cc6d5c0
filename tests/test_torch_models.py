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
    """The pixel forms are refused; the LSTM form, once refused, is built."""
    from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic

    for build in (lambda: PPOActorCritic(OBS_DIM, ACT_DIM, HIDDEN, pixel_obs=True),
                  lambda: DDPGActor(OBS_DIM, ACT_DIM, pixel_obs=True),
                  lambda: DDPGCritic(OBS_DIM, ACT_DIM, pixel_obs=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build()
    net = PPOActorCritic(OBS_DIM, ACT_DIM, HIDDEN, use_lstm=True, lstm_size=8)
    c, h = net.initial_carry((3,))
    assert c.shape == h.shape == (3, 8) and PPOActorCritic(OBS_DIM, ACT_DIM).initial_carry() is None


# --- the DDPG nets, relu + LayerNorm and the LSTM form. Tolerance 1e-5:
# flax's LayerNorm takes the variance as E[x²] − E[x]², torch in two passes,
# and the LSTM compounds its rounding over the steps. ---

TOL_NEW = 1e-5


def _leaves_equal(a, b):
    for (pa, x), (pb, y) in zip(jax.tree_util.tree_leaves_with_path(a),
                                jax.tree_util.tree_leaves_with_path(b), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("layer_norm", [False, True])
def test_mlp_relu_layer_norm_matches_flax(layer_norm):
    from surreal_tpu.models.blocks import MLP as FlaxMLP
    from surreal_tpu_torch.models.blocks import MLP

    net = FlaxMLP((32, 24, 16), "relu", layer_norm)
    x = (3 * np.random.RandomState(2).randn(64, OBS_DIM) + 1).astype(np.float32)
    params = jax.device_get(net.init(jax.random.PRNGKey(0), x))
    if layer_norm:  # away from flax's init of scale 1, bias 0
        ln = params["params"]["LayerNorm_0"]
        ln["scale"] = (1 + 0.3 * np.random.RandomState(3).randn(32)).astype(np.float32)
        ln["bias"] = (0.3 * np.random.RandomState(4).randn(32)).astype(np.float32)
    port = MLP(OBS_DIM, (32, 24, 16), "relu", layer_norm)
    port.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        out = port(_t(x))
    np.testing.assert_allclose(np.asarray(net.apply(params, x)), out.numpy(), rtol=0, atol=TOL_NEW)
    _leaves_equal(params, params_to_flax(port.state_dict()))


@pytest.mark.parametrize("which", ["actor", "critic"])
def test_ddpg_nets_match_flax(which):
    from surreal_tpu.models import ddpg_nets as jnets
    from surreal_tpu_torch.models import ddpg_nets as tnets

    rs = np.random.RandomState(5)
    obs = rs.randn(64, OBS_DIM).astype(np.float32)
    act = rs.uniform(-1, 1, (64, ACT_DIM)).astype(np.float32)
    if which == "actor":
        jnet, args = jnets.DDPGActor(ACT_DIM, (48, 32)), (obs,)
        port = tnets.DDPGActor(OBS_DIM, ACT_DIM, (48, 32))
    else:
        jnet, args = jnets.DDPGCritic((48, 32)), (obs, act)
        port = tnets.DDPGCritic(OBS_DIM, ACT_DIM, (48, 32))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(1), *args))
    # flax's last layer is ±sqrt(3e-3 / fan_in): scale it up so that the
    # comparison sees the torso
    params["params"]["Dense_0"]["kernel"] = params["params"]["Dense_0"]["kernel"] * 300
    port.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        out = port(*map(_t, args))
    ref = np.asarray(jnet.apply(params, *args))
    assert out.shape == ref.shape and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(ref, out.numpy(), rtol=0, atol=TOL_NEW)
    _leaves_equal(params, params_to_flax(port.state_dict()))


def test_ddpg_head_init_is_small_uniform():
    from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic

    gen = torch.Generator().manual_seed(0)
    for net in (DDPGActor(OBS_DIM, ACT_DIM, generator=gen),
                DDPGCritic(OBS_DIM, ACT_DIM, generator=gen)):
        w = net.head.weight.detach()
        limit = (3e-3 / w.shape[1]) ** 0.5
        assert w.abs().max().item() <= limit and w.abs().max().item() > 0.8 * limit
        assert float(net.head.bias.abs().max()) == 0
        assert net.torso.layer_norm.eps == 1e-6
        assert [n for n, _ in net.torso.named_children()] == ["dense_0", "dense_1", "layer_norm"]


def test_lstm_actor_critic_matches_flax():
    """Five steps with the carry threaded through and zeroed for two of the
    envs after the second step; outputs and carry, in the order (c, h)."""
    B, H = 6, 16
    jnet = FlaxAC(action_dim=ACT_DIM, hidden=HIDDEN, use_lstm=True, lstm_size=H)
    rs = np.random.RandomState(6)
    obs = rs.randn(5, B, OBS_DIM).astype(np.float32)
    carry_j = jnet.initial_carry((B,))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(2), obs[0], carry_j))
    for g in "ifgo":  # flax's biases start at zero
        params["params"]["lstm"][f"h{g}"]["bias"] = (0.2 * rs.randn(H)).astype(np.float32)
    port = PPOActorCritic(OBS_DIM, ACT_DIM, HIDDEN, use_lstm=True, lstm_size=H)
    port.load_state_dict(params_from_flax(params))
    _leaves_equal(params, params_to_flax(port.state_dict()))
    carry_t = port.initial_carry((B,))
    keep = np.ones((B, 1), np.float32)
    keep[[1, 4]] = 0
    for t in range(5):
        mean_j, ls_j, v_j, carry_j = jnet.apply(params, obs[t], carry_j)
        with torch.no_grad():
            mean_t, ls_t, v_t, carry_t = port(_t(obs[t]), carry_t)
        for a, b in ((mean_j, mean_t), (ls_j, ls_t), (v_j, v_t), (carry_j[0], carry_t[0]),
                     (carry_j[1], carry_t[1])):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=TOL_NEW)
        if t == 1:
            carry_j = tuple(c * keep for c in carry_j)
            carry_t = tuple(c * _t(keep) for c in carry_t)
    assert np.abs(np.asarray(carry_j[0]) - np.asarray(carry_j[1])).max() > 1e-2  # c is not h


def test_lstm_cell_init_mirrors_flax():
    from surreal_tpu_torch.models.blocks import LSTMCell

    cell = LSTMCell(64, 32, generator=torch.Generator().manual_seed(0))
    for w in cell.weight_hh.detach().chunk(4):  # orthogonal per gate
        np.testing.assert_allclose((w @ w.T).numpy(), np.eye(32), atol=1e-5)
    w = cell.weight_ih.detach()
    assert abs(w.std().item() - (1 / 64) ** 0.5) < 0.05 * (1 / 64) ** 0.5  # lecun normal
    assert float(cell.bias.abs().max()) == 0
