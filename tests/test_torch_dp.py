"""The port's data-parallel steps (surreal_tpu_torch/parallel/dp.py) against
the reference's own sharded steps (surreal_tpu/parallel/dp.py) on the CPU:
S = 2 gloo ranks of the port, each a process that imports nothing of JAX
(tests/torch_dp_ranks.py), against `make_sharded_*_step` over a mesh of the
first 2 of the 8 virtual CPU devices, on cheetah-run with 4 envs a rank,
two chained steps (the overlapped step: tests/test_torch_dp_overlap.py).

Each rank gets the reference's draws for its shard: the action noise
recovered from the shard's own rollout (the rollout has no collective, so
it is recomputed alone with the shard's folded key), the permutations from
the shard's folded keys, and the auto-reset draws from the shard's env
keys; a quarter of the envs start at t = 995, so episodes end inside the
first rollout.

The bars are the one-device files' (tests/test_torch_ppo.py,
test_torch_ppo_lstm.py, test_torch_overlap.py, test_torch_ddpg.py):
parameters 4e-6 abs (1e-5 for LSTM-PPO and DDPG), metrics rtol 1e-4 (with
the overlap file's floor of 1e-6 abs: its policy loss, a mean of
normalised advantages, cancels to ~3e-3), the Z-filter rtol 1e-5,
lr_scale exact. Every learner value, and every
reduced metric, is bitwise equal across the ranks. The KL target is set so
that the two shards' local KLs of the first step fall on different sides
of the adaptation's lower threshold: the global KL decides, and the
reference's decision is the port's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from surreal_tpu.algos import ddpg as jddpg
from surreal_tpu.algos import ppo as jppo
from surreal_tpu.algos import ppo_lstm as jlstm
from surreal_tpu.data.replay import ReplayState as JReplay
from surreal_tpu.envs import base as jbase
from surreal_tpu.envs import make_env as jmake_env
from surreal_tpu.models import ddpg_nets as jnets
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu.parallel import dp as jdp
from surreal_tpu_torch.models.convert import params_from_flax, params_to_flax
from test_torch_mesh import run_jobs, run_ranks
from torch_helpers import fast_jit, reference_reset_rows, to_torch

S, PER, T, STEPS = 2, 4, 8, 2
B = S * PER
HIDDEN, LSTM = (32, 32), 16
RTOL_METRIC, RTOL_ZF = 1e-4, 1e-5
ATOL = {"ppo": 4e-6, "lstm": 1e-5, "overlap": 4e-6}
# the metrics' absolute floor, each mode's file's (test_torch_overlap.py: 1e-6)
ATOL_METRIC = {"ppo": 1e-7, "lstm": 1e-7, "overlap": 1e-6}
# lo = KL_TARGET / 2 lies between the two shards' local KLs of the first
# step (see test_local_kls_straddle_the_threshold)
KL_TARGET = {"ppo": 1.4e-4, "lstm": 4.06e-5, "overlap": 1.266e-4}


def ref_mesh(time=1):
    return Mesh(np.asarray(jax.devices()[:S * time]).reshape(S, 1, time),
                ("data", "model", "time"))


def shard(tree, r):
    return jax.tree.map(lambda x: x[r * PER:(r + 1) * PER], tree)


def noise_of(traj):
    return to_torch((np.asarray(traj.action) - np.asarray(traj.mean))
                    / np.exp(np.asarray(traj.log_std)))


def env_tensors(es):
    return tuple(to_torch(x) for x in (es.q, es.qd, es.t))


def metrics_np(m):
    return {k: float(v) for k, v in jax.device_get(m).items()}


def build_case(mode, tmp_path_factory, zero=False, time=1):
    """The reference's sharded PPO steps, and the port's ranks on the same
    inputs and per-shard draws (`reference_case`)."""
    mode, ref, job = reference_case(mode, zero, time)
    return mode, ref, run_ranks(tmp_path_factory.mktemp(f"dp_{mode}"), job, world=S * time)


def reference_case(mode, zero=False, time=1):
    """The reference's sharded PPO steps, and the job that runs the port's
    ranks on the same inputs and per-shard draws; `mode` is "ppo", "lstm"
    or "overlap" (tests/test_torch_dp_overlap.py). With `zero`, both sides'
    Adam is ZeRO's (tests/test_torch_zero.py), and the ranks run the
    replicated Adam after it on the same inputs (their "twin" learner).
    With `time` > 1, both meshes are S x 1 x time and the GAE scan is split
    over time (tests/test_torch_tshard.py): the port's ranks are S·time,
    each with its data index's draws."""
    lstm = mode == "lstm"
    cfg_kw = dict(horizon=T, epochs=2, num_minibatches=2, kl_target=KL_TARGET[mode],
                  **(dict(zero_optimizer=True, zero_shards=S) if zero else {}),
                  **(dict(time_shards=time) if time > 1 else {}))
    cfg = jppo.PPOConfig(**cfg_kw)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    flat = jbase.flatten_obs
    env_state, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    env_state = dataclasses.replace(
        env_state, t=jnp.where(jnp.arange(B) % 4 == 0, 995, 0).astype(jnp.int32))
    obs = flat(ts0.obs)
    net = FlaxAC(action_dim=6, hidden=HIDDEN, use_lstm=lstm, lstm_size=LSTM)
    carry = None
    if lstm:
        rs = np.random.RandomState(0)
        carry = tuple(jnp.asarray(0.3 * rs.randn(B, LSTM), jnp.float32) for _ in range(2))
        params = net.init(jax.random.PRNGKey(0), obs[:1], jax.tree.map(lambda c: c[:1], carry))
    else:
        params = net.init(jax.random.PRNGKey(0), obs[:1])
    state = jppo.init_state(cfg, params, 17)
    ep_ret = jnp.zeros((B,), jnp.float32)
    job = {"kind": "ppo", "mode": mode, "cfg": cfg_kw, "hidden": HIDDEN, "twin": zero,
           "shape": (S, 1, time),
           "lstm": LSTM if lstm else 0,
           "params": params_from_flax(jax.device_get(params)),
           "env": [env_tensors(shard(env_state, r)) for r in range(S)],
           "obs": [to_torch(shard(obs, r)) for r in range(S)],
           "carry": [tuple(to_torch(c) for c in shard(carry, r)) for r in range(S)] if lstm
           else None,
           "noise": [[] for _ in range(S)], "perms": [[] for _ in range(S)],
           "rows": [[] for _ in range(S)]}
    mesh = ref_mesh(time)
    spec = jdp.train_state_spec(state)
    state = jdp.place_by_spec(mesh, state, spec)
    # the batch on the mesh as the step returns it: the step's second call
    # then reuses the first's compiled program
    env_state, obs, ep_ret, carry = jdp.shard_env_batch(mesh, (env_state, obs, ep_ret, carry))
    n_perm = PER if lstm else T * PER
    if lstm:
        roll = fast_jit(lambda s, es, o, c, r, k: jlstm.rollout(cfg, net.apply, step_fn, flat,
                                                                s, es, o, c, r, k))
        step = jdp.make_sharded_ppo_lstm_step(cfg, net.apply, step_fn, flat, mesh,
                                              state_spec=spec)
    else:
        roll = fast_jit(lambda s, es, o, r, k: jppo.rollout(cfg, net.apply, step_fn, flat,
                                                            s, es, o, r, k))
        if mode == "overlap":
            step, prime = jdp.make_sharded_ppo_overlap_step(cfg, net.apply, step_fn, flat, mesh,
                                                            state_spec=spec)
        else:
            step = jdp.make_sharded_ppo_step(cfg, net.apply, step_fn, flat, mesh,
                                             state_spec=spec)

    def shard_rollout(r, key):
        # on the host: the compiled rollout takes uncommitted inputs
        st, es_r, o_r, ep_r, c_r = jax.device_get((state, shard(env_state, r), shard(obs, r),
                                                   shard(ep_ret, r), shard(carry, r)))
        traj = (roll(st, es_r, o_r, c_r, ep_r, key) if lstm
                else roll(st, es_r, o_r, ep_r, key))[0]
        job["noise"][r].append(noise_of(traj))
        job["rows"][r] += reference_reset_rows(env, es_r, traj.done)

    if mode == "overlap":
        pkey = jax.random.PRNGKey(9)
        for r in range(S):
            shard_rollout(r, jax.random.fold_in(pkey, r))
        pending, env_state, obs, ep_ret = prime(state, env_state, obs, ep_ret, pkey)
    metrics, lr_scales = [], []
    for key in jax.random.split(jax.random.PRNGKey(3), STEPS):
        for r in range(S):
            k_roll, k_up = jax.random.split(jax.random.fold_in(key, r))
            shard_rollout(r, k_roll)
            job["perms"][r].append(torch.stack([
                to_torch(jax.random.permutation(k, n_perm))
                for k in jax.random.split(k_up, cfg.epochs)]))
        if lstm:
            state, env_state, obs, carry, ep_ret, m = step(state, env_state, obs, carry,
                                                           ep_ret, key)
        elif mode == "overlap":
            state, env_state, obs, ep_ret, pending, m = step(state, env_state, obs, ep_ret,
                                                             pending, key)
        else:
            state, env_state, obs, ep_ret, m = step(state, env_state, obs, ep_ret, key)
        metrics.append(metrics_np(m))
        lr_scales.append(float(state.lr_scale))
    ref = {"state": jax.device_get(state), "metrics": metrics, "lr_scales": lr_scales,
           "obs": np.asarray(obs)}
    return mode, ref, job


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Both modes' references, and their ranks in one group."""
    refs = {mode: reference_case(mode) for mode in ("ppo", "lstm")}
    out = run_jobs(tmp_path_factory.mktemp("dp"), {m: job for m, (_, _, job) in refs.items()})
    return {m: (m, ref, out[m]) for m, (_, ref, _) in refs.items()}


@pytest.fixture(params=["ppo", "lstm"])
def ppo_case(request, cases):
    return cases[request.param]


def test_sharded_ppo_steps_match_the_reference(ppo_case):
    check_matches_reference(ppo_case)


def test_local_kls_straddle_the_threshold(ppo_case):
    check_local_kls_straddle(ppo_case)


def test_learner_is_bitwise_equal_across_ranks(ppo_case):
    check_bitwise_equal_learners(ppo_case)


def check_matches_reference(case):
    mode, ref, out = case
    state = ref["state"]
    for o in out:
        got = params_to_flax(o["params"])
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(state.params),
                                     jax.tree_util.tree_leaves_with_path(got), strict=True):
            err = np.abs(np.asarray(a) - np.asarray(b)).max()
            assert err <= ATOL[mode], (jax.tree_util.keystr(path), err)
        for f, got_f in zip(("count", "mean", "m2"), o["zfilter"]):
            np.testing.assert_allclose(np.asarray(getattr(state.zfilter, f)), got_f.numpy(),
                                       rtol=RTOL_ZF, atol=1e-6)
        for i, (want, got_m) in enumerate(zip(ref["metrics"], o["metrics"], strict=True)):
            assert set(want) == set(got_m)
            for k, v in want.items():
                np.testing.assert_allclose(v, float(got_m[k]), rtol=RTOL_METRIC,
                                           atol=ATOL_METRIC[mode], err_msg=f"step {i}: {k}")
        assert [float(x) for x in o["lr_scale"]] == ref["lr_scales"]
        assert float(o["kl_beta"]) == float(state.kl_beta)
        assert o["update_step"] == int(state.update_step) == STEPS
        assert o["adam_count"] == int(state.opt_state[1].count)


def check_local_kls_straddle(case):
    """The first step's local KLs alone would take different decisions; the
    global KL (the pmean) takes the reference's."""
    mode, ref, out = case
    lo, hi = KL_TARGET[mode] / 2, 2 * KL_TARGET[mode]

    def decision(kl):
        return "down" if kl > hi else "up" if kl < lo else "keep"

    local = [decision(o["local_kl"][0]) for o in out]
    assert local[0] != local[1], [o["local_kl"][0] for o in out]
    assert decision(ref["metrics"][0]["kl"]) == decision(float(out[0]["metrics"][0]["kl"]))
    assert float(out[0]["lr_scale"][0]) == {"keep": 1.0, "up": 1.5, "down": 1 / 1.5}[
        decision(ref["metrics"][0]["kl"])] == ref["lr_scales"][0]


def check_bitwise_equal_learners(case):
    _, _, (a, b) = case
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for x, y in zip(a["zfilter"], b["zfilter"]):
        assert torch.equal(x, y)
    assert [torch.equal(x, y) for x, y in zip(a["lr_scale"], b["lr_scale"])] == [True] * STEPS
    assert torch.equal(a["kl_beta"], b["kl_beta"]) and a["update_step"] == b["update_step"]
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
