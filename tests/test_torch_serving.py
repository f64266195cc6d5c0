"""The port's PolicyService: the cases of tests/test_serving.py (shapes,
determinism, stochastic mode, hot swap, TCP round trip), its `act` against
the JAX PolicyService on the same parameters and Z-filter (1e-6 abs: one
forward of the same float32 arithmetic), and `evaluate_policy`."""

import socket
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.models import z_filter as jz
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu.train import serving as jserving
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax
from surreal_tpu_torch.models.ddpg_nets import DDPGActor
from surreal_tpu_torch.models.z_filter import ZFilterState
from surreal_tpu_torch.train.evaluator import evaluate_policy
from surreal_tpu_torch.train.serving import PolicyService, request_actions
import torch_helpers  # noqa: F401  (one torch thread a test process)

OBS, ACT = 5, 3


def _net(seed=0):
    return PPOActorCritic(OBS, ACT, (16, 16), generator=torch.Generator().manual_seed(seed))


def _service(**kw):
    return PolicyService(_net(), device="cpu", **kw)


def test_act_shapes_and_determinism():
    svc = _service()
    obs = np.random.RandomState(0).randn(7, OBS).astype(np.float32)
    a1, a2 = svc.act(obs), svc.act(obs)
    assert a1.shape == (7, ACT) and a1.dtype == np.float32
    np.testing.assert_array_equal(a1, a2)  # deterministic mode


def test_stochastic_mode_varies():
    obs = np.zeros((4, OBS), np.float32)
    svc = _service(stochastic=True, seed=3)
    first = svc.act(obs)
    assert not np.allclose(first, svc.act(obs))
    np.testing.assert_array_equal(first, _service(stochastic=True, seed=3).act(obs))  # seeded


def test_param_hot_swap():
    net = _net()
    svc = PolicyService(net, device="cpu")
    obs = np.ones((2, OBS), np.float32)
    a1 = svc.act(obs)
    with torch.no_grad():  # the service holds its own copy: the caller's updates stay out
        for p in net.parameters():
            p.add_(0.1)
    np.testing.assert_array_equal(a1, svc.act(obs))
    svc.update_params(net.state_dict())
    a2 = svc.act(obs)
    assert not np.allclose(a1, a2)
    with torch.no_grad():
        np.testing.assert_allclose(a2, net(torch.tensor(obs))[0].numpy(), atol=1e-6)


def test_tcp_round_trip():
    svc = _service()
    server, addr = svc.serve()
    try:
        obs = np.random.RandomState(1).randn(4, OBS).astype(np.float32)
        for _ in range(2):  # a connection per request
            np.testing.assert_allclose(request_actions(addr, obs), svc.act(obs), atol=1e-6)
        # several requests on one connection, then a client that goes away mid-header
        with socket.create_connection(addr) as s:
            for n in (1, 3):
                payload = ('{"obs": %s}' % obs[:n].tolist()).encode()
                s.sendall(struct.pack(">I", len(payload)) + payload)
                (size,) = struct.unpack(">I", s.recv(4))
                assert size > 0 and len(s.recv(size)) == size
            s.sendall(b"\x00\x00")
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("with_zfilter", [False, True])
def test_act_matches_reference_service(with_zfilter):
    rs = np.random.RandomState(2)
    jnet = FlaxAC(action_dim=ACT, hidden=(16, 16))
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    jzf = tzf = None
    if with_zfilter:
        jzf = jz.zfilter_update(jz.zfilter_init(OBS), 2 * rs.randn(64, OBS).astype(np.float32) + 1)
        tzf = ZFilterState(*(torch.tensor(np.asarray(getattr(jzf, f)))
                             for f in ("count", "mean", "m2")))
    net = PPOActorCritic(OBS, ACT, (16, 16))
    net.load_state_dict(params_from_flax(jax.device_get(params)))
    obs = (3 * rs.randn(9, OBS)).astype(np.float32)
    ref = jserving.PolicyService(jnet.apply, params, zfilter=jzf).act(obs)
    got = PolicyService(net, zfilter=tzf, device="cpu").act(obs)
    np.testing.assert_allclose(ref, got, rtol=0, atol=1e-6)


def test_serves_a_ddpg_actor_and_refuses_to_sample_from_it():
    actor = DDPGActor(OBS, ACT, (16, 16), generator=torch.Generator().manual_seed(0))
    obs = np.random.RandomState(3).randn(6, OBS).astype(np.float32)
    with torch.no_grad():
        want = actor(torch.tensor(obs)).numpy()
    np.testing.assert_allclose(PolicyService(actor, device="cpu").act(obs), want, atol=1e-6)
    with pytest.raises(ValueError, match="stochastic"):
        PolicyService(actor, stochastic=True, device="cpu").act(obs)


def test_service_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        assert PolicyService(_net())._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PolicyService(_net())


class ShortEpisodes:
    """A 2-feature env whose reward is the action's first component and whose
    episodes last 5 steps: the return of a constant policy is known."""

    episode_steps = 5
    device = torch.device("cpu")

    def reset(self, batch, generator):
        from surreal_tpu_torch.envs.base import EnvState, Timestep

        obs = {"x": torch.rand(batch, 2, generator=generator)}
        z = torch.zeros(batch)
        return (EnvState(z, z, torch.zeros(batch, dtype=torch.int32)),
                Timestep(obs, obs, z, z + 1, z.bool()))

    def step(self, state, action, generator):
        from surreal_tpu_torch.envs.base import EnvState, Timestep

        t = state.t + 1
        obs = {"x": torch.rand(action.shape[0], 2, generator=generator)}
        done = t >= self.episode_steps
        return (EnvState(state.q, state.qd, torch.where(done, torch.zeros_like(t), t)),
                Timestep(obs, obs, action[:, 0], torch.ones(action.shape[0]), done))


def test_evaluate_policy_returns_the_episode_statistics():
    scale = torch.tensor([1.0, 2.0, 3.0])
    out = evaluate_policy(ShortEpisodes(), lambda obs, gen: scale[:, None].expand(3, 2),
                          episodes=3)
    assert out == {"return_mean": 10.0, "return_std": pytest.approx(np.std([5, 10, 15])),
                   "return_min": 5.0, "return_max": 15.0, "episodes": 3}


def test_evaluate_policy_threads_the_policy_state_and_normalises():
    """A stateful policy whose action is its step count: 0 + 1 + 2 + 3 + 4;
    with a Z-filter the policy sees normalised observations."""
    seen = []

    def policy(obs, gen, count):
        seen.append(obs)
        return count[:, None].expand(-1, 2), count + 1

    zf = ZFilterState(torch.tensor(100.0), torch.full((2,), 0.5), torch.full((2,), 100 / 12))
    out = evaluate_policy(ShortEpisodes(), policy, zf, episodes=4,
                          init_policy_state=torch.zeros(4))
    assert out["return_mean"] == 10.0 and out["return_std"] == 0.0 and len(seen) == 5
    z = torch.stack(seen)
    assert float(z.min()) < -1.0 and float(z.max()) > 1.0  # uniform(0, 1) standardised
