"""The port's data-parallel DDPG step against the reference's
`make_sharded_ddpg_step` on 2 of the 8 virtual CPU devices (as
tests/test_torch_dp.py does for PPO), and the trainers on a mesh: a 1-rank
mesh is the one-device trainer bit for bit, 2 ranks keep the learner
bitwise equal, a one-device checkpoint resumes on 2 ranks, each with its
slice, the ring's depth and the noise ladder come from the global
num_envs, and the options a mesh refuses raise with their reasons.

DDPG on cheetah-run, 4 envs a rank, 4 env steps and 2 updates an
iteration, two chained iterations, the Z-filter on; a quarter of the envs
end their episodes inside the first chunk. The warm-up gate counts a
shard's own transitions (4 steps x 4 envs = min_replay 16), as the
reference's does, so both iterations update. Each rank gets its shard's
draws: the exploration noise and the replay indices from its folded keys,
the resets from its envs' keys. Bars: tests/test_torch_ddpg.py's (the four
networks 1e-5 abs, metrics rtol 1e-4, the trajectory 1e-4 · max(1, |ref|))
and the Z-filter rtol 1e-5; the learner bitwise equal across ranks.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from surreal_tpu.algos import ddpg as jddpg
from surreal_tpu.data.replay import ReplayState as JReplay
from surreal_tpu.envs import base as jbase
from surreal_tpu.envs import make_env as jmake_env
from surreal_tpu.models import ddpg_nets as jnets
from surreal_tpu.parallel import dp as jdp
from surreal_tpu_torch.algos import ddpg as tddpg
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from surreal_tpu_torch.parallel import mesh as pmesh
from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer
from surreal_tpu_torch.train.checkpoint import Checkpointer
from test_torch_dp import PER, S, env_tensors, ref_mesh, shard
from test_torch_mesh import run_ranks
from torch_helpers import assert_close, fast_jit, reference_reset_rows, to_torch

B, STEPS = S * PER, 2
A_HID, C_HID = (24, 16), (32, 24)
CFG = dict(rollout_steps=4, updates_per_iteration=2, batch_size=16, min_replay=16,
           replay_capacity=64 * B, n_step=3, use_zfilter=True)
ATOL_PARAM, RTOL_METRIC, RTOL_ZF, TOL_TRAJ = 1e-5, 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module")
def ddpg_case(tmp_path_factory):
    return build_ddpg_case(tmp_path_factory)


def build_ddpg_case(tmp_path_factory, zero=False):
    """The reference's sharded DDPG steps and the port's ranks on the same
    inputs and per-shard draws. With `zero`, both sides' Adam is ZeRO's
    (tests/test_torch_zero.py), and the ranks run the replicated Adam after
    it on the same inputs (their "twin" networks)."""
    cfg_kw = {**CFG, **(dict(zero_optimizer=True, zero_shards=S) if zero else {})}
    cfg = jddpg.DDPGConfig(**cfg_kw)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    flat = jbase.flatten_obs
    env_state, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    env_state = dataclasses.replace(
        env_state, t=jnp.where(jnp.arange(B) % 4 == 0, 997, 0).astype(jnp.int32))
    obs = flat(ts0.obs)
    actor, critic = jnets.DDPGActor(6, A_HID), jnets.DDPGCritic(C_HID)
    ap = actor.init(jax.random.PRNGKey(0), jnp.zeros((1, 17)))
    cp = critic.init(jax.random.PRNGKey(1), jnp.zeros((1, 17)), jnp.zeros((1, 6)))
    state = jddpg.init_state(cfg, ap, cp, 17)
    replay = jddpg.init_replay(cfg, B, 17, 6)
    sigma = jnp.asarray(jddpg.noise_ladder(cfg, B))
    ou, ep_ret = jnp.zeros((B, 6)), jnp.zeros((B,))
    job = {"kind": "ddpg", "cfg": cfg_kw, "a_hid": A_HID, "c_hid": C_HID, "num_envs": B,
           "twin": zero,
           "ap": params_from_flax(jax.device_get(ap)), "cp": params_from_flax(jax.device_get(cp)),
           "env": [env_tensors(shard(env_state, r)) for r in range(S)],
           "obs": [to_torch(shard(obs, r)) for r in range(S)],
           **{k: [[] for _ in range(S)] for k in ("rows", "eps", "indices", "target_eps")}}
    mesh = ref_mesh()
    roll = fast_jit(lambda s, es, o, u, sg, r, k, rp: jddpg.rollout(
        cfg, actor.apply, step_fn, flat, s, es, o, u, sg, r, k, rp))
    spec = jdp.train_state_spec(state)
    state = jdp.place_by_spec(mesh, state, spec)
    step = jdp.make_sharded_ddpg_step(cfg, actor.apply, critic.apply, step_fn, flat, mesh,
                                      state_spec=spec)(replay)
    replay = JReplay(data=jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(None, "data"))), replay.data),
        total=replay.total)
    metrics = []
    for key in jax.random.split(jax.random.PRNGKey(3), STEPS):
        for r in range(S):
            k_roll, k_up = jax.random.split(jax.random.fold_in(key, r))
            es_r = shard(env_state, r)
            rep_r = JReplay(data=jax.tree.map(lambda x: x[:, r * PER:(r + 1) * PER],
                                              replay.data), total=replay.total)
            # on the host: the compiled rollout takes uncommitted inputs
            out = roll(*jax.device_get((state, es_r, shard(obs, r), shard(ou, r),
                                        shard(sigma, r), shard(ep_ret, r))), k_roll,
                       jax.device_get(rep_r))
            job["rows"][r] += reference_reset_rows(env, es_r, out[5]["done"])
            job["eps"][r].append(torch.stack([
                to_torch(jax.random.normal(k, (PER, 6)))
                for k in jax.random.split(k_roll, cfg.rollout_steps)]))
            total = int(replay.total) + cfg.rollout_steps
            oldest = max(total - rep_r.capacity_t, 0)
            num_valid = total - (cfg.n_step + 1) + 1 - oldest
            idx, teps = [], []
            for key_u in jax.random.split(k_up, cfg.updates_per_iteration):
                k_sample, k_tnoise, _, _ = jax.random.split(key_u, 4)
                k_t, k_b = jax.random.split(k_sample)
                idx.append((to_torch(oldest + jax.random.randint(
                    k_t, (cfg.batch_size,), 0, num_valid)),
                    to_torch(jax.random.randint(k_b, (cfg.batch_size,), 0, PER))))
                teps.append(to_torch(jax.random.normal(k_tnoise, (cfg.batch_size, 6))))
            job["indices"][r].append(idx)
            job["target_eps"][r].append(torch.stack(teps))
        state, replay, env_state, obs, ou, ep_ret, m = step(
            state, replay, env_state, obs, ou, sigma, ep_ret, key)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    assert any(np.asarray(d).any() for d in job["rows"][0])
    ref = {"state": jax.device_get(state), "metrics": metrics,
           "replay": jax.device_get(replay.data), "total": int(replay.total),
           "ou": np.asarray(ou)}
    return ref, run_ranks(tmp_path_factory.mktemp("dp_ddpg"), job)


def test_sharded_ddpg_step_matches_the_reference(ddpg_case):
    ref, out = ddpg_case
    state = ref["state"]
    assert state.update_step == STEPS * CFG["updates_per_iteration"]
    for r, o in enumerate(out):
        for name in ("actor", "critic", "target_actor", "target_critic"):
            got = params_to_flax(o["nets"][name])
            for a, b in zip(jax.tree.leaves(getattr(state, f"{name}_params")),
                            jax.tree.leaves(got), strict=True):
                assert np.abs(np.asarray(a) - np.asarray(b)).max() <= ATOL_PARAM, name
        for f, got_f in zip(("count", "mean", "m2"), o["zfilter"]):
            np.testing.assert_allclose(np.asarray(getattr(state.zfilter, f)), got_f.numpy(),
                                       rtol=RTOL_ZF, atol=1e-6)
        for i, (want, got_m) in enumerate(zip(ref["metrics"], o["metrics"], strict=True)):
            assert set(want) == set(got_m)
            for k, v in want.items():
                np.testing.assert_allclose(v, float(got_m[k]), rtol=RTOL_METRIC, atol=1e-7,
                                           err_msg=f"step {i}: {k}")
        assert o["update_step"] == int(state.update_step)
        # this rank's ring: the global ring's depth, its own envs' columns
        assert o["ring_shape"] == (CFG["replay_capacity"] // B, PER, 17)
        assert o["total"] == ref["total"] == STEPS * CFG["rollout_steps"]
        for k, buf in o["replay"].items():
            want = np.asarray(ref["replay"][k])[:, r * PER:(r + 1) * PER]
            assert_close(want.astype(np.float32), buf.to(torch.float32), TOL_TRAJ, f"replay {k}")
        assert_close(ref["ou"][r * PER:(r + 1) * PER], o["ou"], TOL_TRAJ, "ou state")


def test_ddpg_learner_is_bitwise_equal_across_ranks(ddpg_case):
    _, (a, b) = ddpg_case
    for name, params in a["nets"].items():
        assert all(torch.equal(p, b["nets"][name][k]) for k, p in params.items()), name
    assert all(torch.equal(x, y) for x, y in zip(a["zfilter"], b["zfilter"]))
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert not torch.equal(a["replay"]["obs"], b["replay"]["obs"])  # each rank its own envs


PPO_SMALL = dict(horizon=8, epochs=2, num_minibatches=2)
DDPG_SMALL = dict(rollout_steps=4, updates_per_iteration=2, batch_size=16, min_replay=32,
                  replay_capacity=512, use_zfilter=True)
NETS = {"ppo": dict(hidden=(16, 16)), "ddpg": dict(actor_hidden=(16, 16),
                                                   critic_hidden=(16, 16))}


def _trainer(algo, mesh=None, num_envs=8, **kw):
    if algo == "ppo":
        return PPOTrainer("cheetah-run", tppo.PPOConfig(**PPO_SMALL), num_envs=num_envs,
                          seed=3, device="cpu", mesh=mesh, **NETS["ppo"], **kw)
    return DDPGTrainer("cheetah-run", tddpg.DDPGConfig(**DDPG_SMALL), num_envs=num_envs, seed=3,
                       device="cpu", mesh=mesh, **NETS["ddpg"], **kw)


def _equal(a, b, path="fs"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("algo,kw", [("ppo", {}), ("ppo", {"use_lstm": True, "lstm_size": 8}),
                                     ("ppo", {"overlap": True}), ("ddpg", {})],
                         ids=["ppo", "lstm", "overlap", "ddpg"])
def test_one_rank_mesh_is_the_one_device_trainer(algo, kw):
    one, meshed = _trainer(algo, **kw), _trainer(algo, pmesh.make_mesh(1, device="cpu"), **kw)
    logs = [[_timeless(m) for m in t.run(3, log_every=1)] for t in (one, meshed)]
    assert logs[0] == logs[1]
    _equal(one.full_state, meshed.full_state)


def _timeless(m):
    return {k: v for k, v in m.items() if "per_s" not in k}


@pytest.mark.parametrize("algo", ["ppo", "ddpg"])
def test_two_rank_trainers_keep_the_learner_equal(tmp_path, algo):
    job = {"kind": "trainer", "algo": algo, "iterations": 3,
           "cfg": PPO_SMALL if algo == "ppo" else DDPG_SMALL,
           "kw": {"num_envs": 8, "seed": 3, "device": "cpu", **NETS[algo]}}
    a, b = run_ranks(tmp_path, job)
    _equal(a["learner"], b["learner"])
    assert [m["iteration"] for m in a["logs"]] == [1, 2, 3]
    assert [_timeless(m) for m in a["logs"]] == [_timeless(m) for m in b["logs"]]
    assert a["own"]["obs"].shape[0] == b["own"]["obs"].shape[0] == 4
    assert not torch.equal(a["own"]["obs"], b["own"]["obs"])
    assert not torch.equal(a["own"]["generator"], b["own"]["generator"])
    if algo == "ddpg":  # a shard's warm-up (16 transitions a rank, 32 in all) ended
        assert a["learner"]["update_step"] == 2 * DDPG_SMALL["updates_per_iteration"]


def test_one_device_ddpg_checkpoint_resumes_on_two_ranks(tmp_path):
    """A one-device DDPG checkpoint after one warm-up iteration, resumed on
    a data mesh of 2 (the reference resumes it): each rank's replay ring
    (64 steps deep, cut along its env axis), OU noise and env rows are its
    half of the checkpoint's, its learner the checkpoint's bit for bit; rank
    0 takes the checkpoint's generator, rank 1 keeps a fresh start's
    (fold_in of the seed and its index). The next save writes the mesh's
    files into a step directory of its own."""
    one = _trainer("ddpg")
    one.run(1, log_every=1)
    saved = one.full_state
    root = tmp_path / "ck"
    Checkpointer(str(root)).save(32, saved)
    (tmp_path / "ranks").mkdir()
    job = {"kind": "ddpg_relayout", "root": str(root), "cfg": DDPG_SMALL, "step": 64,
           "kw": {"num_envs": 8, "seed": 3, "device": "cpu", **NETS["ddpg"]}}
    ranks = run_ranks(tmp_path / "ranks", job)
    assert saved["replay"]["total"] == 4 and saved["replay"]["data"]["obs"].shape[:2] == (64, 8)
    word = np.random.SeedSequence([3, 1]).generate_state(1, np.uint64)[0]
    generators = [saved["generator"], torch.Generator().manual_seed(int(word)).get_state()]
    for d, out in enumerate(ranks):
        fs, rows = out["fs"], slice(4 * d, 4 * d + 4)
        _equal({k: v for k, v in fs.items() if k not in DDPGTrainer.rank_keys},
               {k: v for k, v in saved.items() if k not in DDPGTrainer.rank_keys})
        _equal(fs["env_state"], {k: v[rows] for k, v in saved["env_state"].items()})
        for key in ("obs", "ep_ret", "ou_state"):
            assert torch.equal(fs[key], saved[key][rows]), key
        _equal(fs["replay"], {"data": {k: v[:, rows] for k, v in
                                       saved["replay"]["data"].items()}, "total": 4})
        assert torch.equal(fs["generator"], generators[d]), d
    assert torch.equal(ranks[1]["fresh_generator"], generators[1])
    assert sorted(os.listdir(root / "latest" / "32")) == ["state.pt"]
    assert sorted(os.listdir(root / "latest" / "64")) == ["mesh.json", "rank0.pt", "rank1.pt",
                                                          "state.pt"]


def test_ring_depth_and_noise_ladder_come_from_the_global_batch():
    mesh = pmesh.Mesh(shape={"data": 2, "model": 1, "time": 1}, rank=1, world_size=2,
                      device=torch.device("cpu"), group=None)
    t = _trainer("ddpg", mesh)
    one = _trainer("ddpg")
    assert t.replay.capacity_t == one.replay.capacity_t == 512 // 8
    assert t.replay.num_envs == 4 and one.replay.num_envs == 8
    assert torch.equal(t.sigma, one.sigma[4:])  # rank 1's half of the global ladder
    assert torch.equal(t.obs, one.obs[4:])  # reset all, then shard
    assert t.local_envs == 4 and t.steps_per_iteration == one.steps_per_iteration


# the reference trainers' own refusals, with their messages
@pytest.mark.parametrize("case,err,match", [
    ("indivisible", ValueError, "not divisible by data axis 2"),
    ("model_and_time", ValueError, "mesh.model and mesh.time cannot both be > 1"),
    ("model_with_zero", ValueError, "does not compose with use_lstm / zero_optimizer"),
    ("debug", ValueError, "debug_checks is single-device only"),
    ("ddpg_time", ValueError, "supports the data axis only"),
    ("gym", ValueError, "gym"),
])
def test_mesh_refusals(case, err, match):
    shape = {"data": 2, "model": 2 if case.startswith("model") else 1,
             "time": 2 if case in ("ddpg_time", "model_and_time") else 1}
    mesh = pmesh.Mesh(shape=shape, rank=0, world_size=2, device=torch.device("cpu"), group=None)
    with pytest.raises(err, match=match):
        if case == "indivisible":
            _trainer("ppo", mesh, num_envs=7)
        elif case == "model_with_zero":
            PPOTrainer("cheetah-run", tppo.PPOConfig(zero_optimizer=True), num_envs=8,
                       device="cpu", mesh=mesh)
        elif case == "debug":
            _trainer("ddpg", mesh, debug_checks=True)
        elif case == "ddpg_time":
            _trainer("ddpg", mesh)
        elif case == "gym":
            pytest.importorskip("gymnasium")
            PPOTrainer("gym:Pendulum-v1", tppo.PPOConfig(**PPO_SMALL), num_envs=8,
                       device="cpu", mesh=mesh, hidden=(16, 16))
        else:
            _trainer("ppo", mesh)
