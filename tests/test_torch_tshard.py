"""The time-sharded scans (surreal_tpu_torch/parallel/tshard.py) and the
PPO step over a data x time mesh, against the reference's
(surreal_tpu/parallel/tshard.py, its sharded step with `time_shards`) on
the CPU: 4 gloo ranks of the port, each a process that imports nothing of
JAX (tests/torch_dp_ranks.py), against the reference on 4 of the 8
virtual CPU devices.

Held: `replicated_reverse_scan` (the trainers' form) and
`time_sharded_reverse_scan` (each rank its T/K block) at T = 64, K = 2
(the time groups of a 2 x 1 x 2 mesh) and K = 4, against the reference's
functions (rtol 1e-6: the same block decomposition and associative scans)
and against the plain sequential scan (the reference's own bar, 1e-4,
tests/test_parallel.py); the data 2 x time 2 PPO step against the
reference's, two chained steps, at tests/test_torch_dp.py's bars, its
time ranks' learners bitwise equal; LSTM-PPO under time 2, whose GAE is
the plain scan in the reference (ppo_lstm.py:144): its time ranks are
replicas, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import test_torch_dp as tdp
from surreal_tpu.ops.returns import discounted_reverse_scan as jscan
from surreal_tpu.parallel import tshard as jts
from surreal_tpu_torch.ops.returns import discounted_reverse_scan
from test_torch_mesh import run_jobs

T, B, WORLD = 64, 4, 4


def time_mesh(K):
    return Mesh(np.asarray(jax.devices()[:K]).reshape(1, 1, K), ("data", "model", "time"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The scans' and the data x time step's references, and both jobs in
    one group of the port's WORLD ranks."""
    scans, job = scans_reference()
    mode, ref, step_job = tdp.reference_case("ppo", time=2)
    out = run_jobs(tmp_path_factory.mktemp("tshard"), {"scans": job, "step": step_job},
                   world=WORLD)
    return (*scans, out["scans"]), (mode, ref, out["step"])


@pytest.fixture(scope="module")
def scans(ranks):
    return ranks[0]


def scans_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(T, B).astype(np.float32)
    c = rs.uniform(0.8, 1.0, (T, B)).astype(np.float32)
    ref = {}
    for K in (2, 4):
        mesh = time_mesh(K)
        replicated = jax.jit(shard_map(lambda a, b: jts.replicated_reverse_scan(a, b, "time"),
                                       mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                                       check_rep=False))
        ref[K] = {"replicated": np.asarray(replicated(x, c)),
                  "sharded": np.asarray(jts.time_sharded_reverse_scan(mesh, x, c))}
    job = {"kind": "tshard", "shape": (2, 1, 2), "x": torch.tensor(x), "c": torch.tensor(c),
           "lstm_cfg": dict(horizon=8, epochs=1, num_minibatches=1)}
    return (x, c, ref), job


@pytest.mark.parametrize("K", [2, 4])
def test_time_sharded_scans_match_the_reference(scans, K):
    x, c, ref, out = scans
    plain = np.asarray(jscan(jnp.asarray(x), jnp.asarray(c), associative=False))
    assert np.abs(discounted_reverse_scan(torch.tensor(x), torch.tensor(c), False).numpy()
                  - plain).max() <= 1e-5
    blk = T // K
    for r, o in enumerate(out):
        t = r % 2 if K == 2 else r  # the rank's time index on that mesh
        got = o[K]
        np.testing.assert_allclose(got["replicated"].numpy(), ref[K]["replicated"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["sharded"].numpy(),
                                   ref[K]["sharded"][t * blk:(t + 1) * blk], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["replicated"].numpy(), plain, rtol=1e-4, atol=1e-4)
        assert torch.equal(got["sharded"], got["replicated"][t * blk:(t + 1) * blk])


def test_lstm_time_ranks_are_replicas(scans):
    out = scans[3]
    for d in (0, 1):  # ranks 2d and 2d + 1 share data index d
        a, b = out[2 * d]["lstm"], out[2 * d + 1]["lstm"]
        assert a["time_shards"] == b["time_shards"] == 2
        assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
        assert all(torch.equal(x, y) for x, y in zip(a["carry"], b["carry"]))
        assert torch.equal(a["obs"], b["obs"])
    assert not torch.equal(out[0]["lstm"]["obs"], out[2]["lstm"]["obs"])  # its own envs


@pytest.fixture(scope="module")
def time_case(ranks):
    return ranks[1]


def test_data_by_time_steps_match_the_reference(time_case):
    tdp.check_matches_reference(time_case)


def test_data_by_time_learners_are_bitwise_equal(time_case):
    out = time_case[2]
    for o in out[1:]:
        assert all(torch.equal(o["params"][n], out[0]["params"][n]) for n in o["params"])
        assert all(torch.equal(x, y) for x, y in zip(o["zfilter"], out[0]["zfilter"]))
        assert [float(x) for x in o["lr_scale"]] == [float(x) for x in out[0]["lr_scale"]]
    # a time rank holds its data index's envs: ranks 0, 1 one half, 2, 3 the other
    assert torch.equal(out[0]["obs"], out[1]["obs"]) and torch.equal(out[2]["obs"], out[3]["obs"])
    assert not torch.equal(out[0]["obs"], out[2]["obs"])
