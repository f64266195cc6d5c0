"""ZeRO-1 Adam (surreal_tpu_torch/parallel/zero.py) against the reference's
(surreal_tpu/parallel/zero.py) on the CPU: 2 gloo ranks of the port, each a
process that imports nothing of JAX (tests/torch_dp_ranks.py), against the
reference's `scale_by_zero_adam` and its ZeRO sharded steps over 2 of the
8 virtual CPU devices.

Held: rank r's chunk of the moments is the reference's mu[r] / nu[r]
(rtol 1e-6: the same float32 operations on the same elements, in the
reference's flat order), on a flat size that divides by 2 and one that
does not (the last chunk padded); the ZeRO PPO and DDPG sharded steps
match the reference's ZeRO steps at tests/test_torch_dp.py's and
tests/test_torch_dp_ddpg.py's bars, two chained steps; the port's ZeRO
learner equals its replicated data-parallel learner bit for bit (the same
elementwise Adam, split); and `zero_optimizer` without a mesh is plain
Adam, as in the reference (its gate is `zero_shards > 1`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

import test_torch_dp as tdp
import test_torch_dp_ddpg as tdd
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu.parallel import zero as jzero
from surreal_tpu_torch.algos import ddpg as tddpg
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.parallel import zero
from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer
from test_torch_mesh import run_jobs

K = 2
# flat sizes: (32, 32) gives 3,501 floats (odd: one pad), (32, 31) 3,428
CASES = {"odd": (32, 32), "even": (32, 31)}
STEPS = 3


def close(want, got, tol, msg):
    """Within tol of the chunk's largest element: the reference's XLA fuses
    mu·b1 + g·(1 − b1) into one multiply-add, so where the two terms cancel
    an element keeps a rounding of the terms' size."""
    np.testing.assert_allclose(want, got, rtol=tol, atol=tol * np.abs(want).max(), err_msg=msg)


def test_flat_layout_is_ravel_pytrees_and_the_flagship_chunk():
    """The port's flat order is the reference's ravel_pytree's; the
    flagship's 142,605 floats make chunks of 71,303 at K = 2 (one pad)."""
    net = FlaxAC(action_dim=6, hidden=(256, 256))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 17)))
    port = PPOActorCritic(17, 6, (256, 256))
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    state = zero.zero_adam_init(port, K)
    flat = state.layout.flatten(dict(port.named_parameters()))
    assert torch.equal(flat, torch.tensor(np.asarray(ravel_pytree(params)[0])))
    assert state.layout.size == 142_605 and state.mu.shape == (71_303,)
    back = state.layout.unflatten(flat)
    assert all(torch.equal(back[n], p) for n, p in port.named_parameters())


# The trainer jobs of this file's ranks (test_zero_composes_with_lstm_and_overlap,
# test_zero_ddpg_trainer_resumes_bit_for_bit)
TWINS = {mode: {"kind": "zero_twins", "cfg": dict(horizon=8, epochs=2, num_minibatches=2),
                "kw": kw}
         for mode, kw in (("lstm", {"use_lstm": True, "lstm_size": 8}),
                          ("overlap", {"overlap": True}))}
DDPG_RESUME = {"kind": "ddpg_zero_resume",
               "cfg": dict(rollout_steps=4, updates_per_iteration=2, batch_size=8, min_replay=8,
                           replay_capacity=256, zero_optimizer=True)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job of this file's 2 gloo ranks in one group: the references'
    (ZeRO Adam's chunks, the ZeRO PPO and DDPG steps) and the trainers'.
    {name: (the reference's outputs or None, the ranks' outputs)}."""
    refs = {"zero_adam": zero_adam_reference(), "ppo": tdp.reference_case("ppo", zero=True)[1:],
            "ddpg": tdd.reference_ddpg_case(zero=True),
            **{f"twins_{m}": (None, job) for m, job in TWINS.items()},
            "ddpg_resume": (None, DDPG_RESUME)}
    out = run_jobs(tmp_path_factory.mktemp("zero"), {k: job for k, (_, job) in refs.items()})
    return {k: (ref, out[k]) for k, (ref, _) in refs.items()}


def zero_adam_reference():
    mesh = tdp.ref_mesh()
    job = {"kind": "zero_adam", "cases": {}}
    ref = {}
    rs = np.random.RandomState(0)
    for name, hidden in CASES.items():
        params = FlaxAC(action_dim=6, hidden=hidden).init(jax.random.PRNGKey(1),
                                                           jnp.zeros((1, 17)))
        opt = jzero.scale_by_zero_adam(K, "data", eps=1e-5)
        spec = jzero.zero_state_spec("data")
        update = jax.jit(shard_map(lambda g, s: opt.update(g, s), mesh=mesh,
                                   in_specs=(P(), spec), out_specs=(P(), spec),
                                   check_rep=False))
        state = opt.init(params)
        grads, steps = [], []
        for scale in (1.0, 30.0, 1e-3):
            g = jax.tree.map(lambda x: jnp.asarray(scale * rs.randn(*x.shape), jnp.float32),
                             params)
            u, state = update(g, state)
            grads.append(params_from_flax(jax.device_get(g)))
            steps.append({"mu": np.asarray(state.mu), "nu": np.asarray(state.nu),
                          "updates": jax.device_get(u)})
        job["cases"][name] = {"hidden": hidden, "grads": grads}
        ref[name] = steps
    return ref, job


@pytest.fixture(scope="module")
def zero_adam_case(ranks):
    return ranks["zero_adam"]


@pytest.mark.parametrize("case", list(CASES))
def test_zero_adam_chunks_and_directions_match_the_reference(zero_adam_case, case):
    ref, out = zero_adam_case
    n = ravel_pytree(ref[case][0]["updates"])[0].size
    assert (n % K == 0) == (case == "even")
    for r, o in enumerate(out):
        for i, (want, got) in enumerate(zip(ref[case], o[case], strict=True)):
            assert want["mu"].shape == (K, got["mu"].numel())
            for m in ("mu", "nu"):
                close(want[m][r], got[m].numpy(), 1e-6, f"step {i}: {m}")
            got_u = params_to_flax(got["updates"])
            for a, b in zip(jax.tree.leaves(want["updates"]), jax.tree.leaves(got_u),
                            strict=True):
                np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-7)
    # the padding of the odd case's last chunk stays zero
    if case == "odd":
        assert float(out[1][case][-1]["mu"][-1]) == 0.0


@pytest.fixture(scope="module")
def ppo_zero_case(ranks):
    ref, out = ranks["ppo"]
    return "ppo", ref, out


def test_zero_ppo_steps_match_the_reference(ppo_zero_case):
    tdp.check_matches_reference(ppo_zero_case)
    _, ref, out = ppo_zero_case
    adam = ref["state"].opt_state[1]
    assert isinstance(adam, jzero.ZeroAdamState)
    for r, o in enumerate(out):
        m = o["moments"]
        assert m["count"] == int(adam.count) == tdp.STEPS * 2 * 2  # epochs x minibatches
        for k in ("mu", "nu"):
            close(np.asarray(getattr(adam, k))[r], m[k].numpy(), 1e-4, k)


def test_zero_ppo_learner_is_the_replicated_one_bit_for_bit(ppo_zero_case):
    tdp.check_bitwise_equal_learners(ppo_zero_case)
    for o in ppo_zero_case[2]:
        for n, p in o["params"].items():
            assert torch.equal(p, o["twin"][n]), n


@pytest.fixture(scope="module")
def ddpg_zero_case(ranks):
    return ranks["ddpg"]


def test_zero_ddpg_steps_match_the_reference(ddpg_zero_case):
    tdd.test_sharded_ddpg_step_matches_the_reference(ddpg_zero_case)
    ref, out = ddpg_zero_case
    for r, o in enumerate(out):
        for name in ("actor_opt", "critic_opt"):
            adam = getattr(ref["state"], name)[1]
            m = o["moments"][name]
            assert isinstance(adam, jzero.ZeroAdamState) and m["count"] == int(adam.count)
            for k in ("mu", "nu"):
                close(np.asarray(getattr(adam, k))[r], m[k].numpy(), 1e-4, f"{name} {k}")


def test_zero_ddpg_learner_is_the_replicated_one_bit_for_bit(ddpg_zero_case):
    tdd.test_ddpg_learner_is_bitwise_equal_across_ranks(ddpg_zero_case)
    for o in ddpg_zero_case[1]:
        for name, params in o["nets"].items():
            assert all(torch.equal(p, o["twin"][name][k]) for k, p in params.items()), name


@pytest.mark.parametrize("algo", ["ppo", "ddpg"])
def test_zero_optimizer_without_a_mesh_is_plain_adam(algo):
    """As the reference's gate `zero_optimizer and zero_shards > 1`: the
    config trains, bit for bit, as the plain Adam one."""
    learners = []
    for zero_optimizer in (False, True):
        if algo == "ppo":
            cfg = tppo.PPOConfig(horizon=8, epochs=2, num_minibatches=2,
                                 zero_optimizer=zero_optimizer)
            t = PPOTrainer("cheetah-run", cfg, num_envs=4, hidden=(16, 16), device="cpu")
            nets = [t.state.net]
        else:
            cfg = tddpg.DDPGConfig(rollout_steps=4, updates_per_iteration=2, batch_size=8,
                                   min_replay=8, replay_capacity=256,
                                   zero_optimizer=zero_optimizer)
            t = DDPGTrainer("cheetah-run", cfg, num_envs=4, actor_hidden=(16, 16),
                            critic_hidden=(16, 16), device="cpu")
            nets = [t.state.actor, t.state.critic]
        assert isinstance(t.state.opt_state if algo == "ppo" else t.state.actor_opt,
                          tppo.AdamState)
        t.run(2, log_every=1)
        learners.append([p.detach().clone() for net in nets for p in net.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*learners, strict=True))


@pytest.mark.parametrize("mode", ["lstm", "overlap"])
def test_zero_composes_with_lstm_and_overlap(ranks, mode):
    """LSTM-PPO and the overlapped step with ZeRO on 2 ranks: bit for bit
    their replicated data-parallel twins from the same seed."""
    for o in ranks[f"twins_{mode}"][1]:
        assert o["chunk"] == (-(-sum(p.numel() for p in o[True].values()) // K),)
        assert all(torch.equal(o[True][n], o[False][n]) for n in o[False])


def test_zero_ddpg_trainer_resumes_bit_for_bit(ranks):
    """The trainer's full state holds the moments whole (the one-device
    layout); loaded into a fresh ZeRO trainer, each rank takes its chunk
    back, and both go on alike."""
    for o in ranks["ddpg_resume"][1]:
        assert o["updates"] == 6 and all(o["chunks_equal"])
        assert all(o["nets_equal_after_one_more"])
        assert o["whole_mu"]["head.weight"] == (6, 16)  # gathered whole
        assert o["chunk"] == -(-sum(int(np.prod(s)) for s in o["whole_mu"].values()) // K)


def test_replicate_leaves_each_ranks_zero_chunks(monkeypatch):
    """Placing a ZeRO train state broadcasts the network and the rest of
    the state from rank 0 but not the moments' chunks: each data rank's is
    its own (the reference's zero_state_spec, here by the state's type)."""
    import torch.distributed as dist

    from surreal_tpu_torch.parallel import dp, mesh as pmesh

    sent = []
    monkeypatch.setattr(dist, "broadcast", lambda t, src, group: sent.append(t.data_ptr()))
    cfg = tppo.PPOConfig(zero_optimizer=True, zero_shards=K)
    state = tppo.init_state(cfg, PPOActorCritic(17, 6, (8, 8)), 17)
    assert isinstance(state.opt_state, zero.ZeroAdamState)
    mesh = pmesh.Mesh(shape={"data": K, "model": 1, "time": 1}, rank=1, world_size=K,
                      device=torch.device("cpu"), group=object())
    assert dp.replicate(mesh, state) is state
    assert all(p.data_ptr() in sent for p in state.net.parameters())
    assert state.opt_state.mu.data_ptr() not in sent
    assert state.opt_state.nu.data_ptr() not in sent
