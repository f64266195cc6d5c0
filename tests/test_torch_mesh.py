"""The port's data mesh (surreal_tpu_torch/parallel/mesh.py) and the
Z-filter's cross-rank reduction: two gloo ranks on the CPU, each a process
of its own that imports nothing of JAX (tests/torch_dp_ranks.py), meeting
at a file store under tmp_path.

The collectives are held exactly: a sum of two float32 values is the same
in any order. The Z-filter's statistics over two ranks are held against
the reference's `zfilter_update(..., axis_name)` over two shards of a
`vmap` (rtol 1e-6: the same float32 operations), and against one update
on the whole batch (rtol 1e-5: the global mean of local means and the
summed deviations about it are another order of the same sums)."""

import os

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks
from surreal_tpu.models import z_filter as jz
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.models import z_filter as tz
from surreal_tpu_torch.parallel import dp, mesh as pmesh
import torch_helpers  # noqa: F401  (one torch thread a test process)

S = 2


def run_ranks(tmp_path, job, world=S, timeout_s=90):
    """Runs `job` in `world` gloo ranks; returns their outputs by rank."""
    folder = str(tmp_path)
    torch.save(job, os.path.join(folder, "job.pt"))
    pmesh.spawn(torch_dp_ranks.run, world, (folder, world), timeout_s=timeout_s, threads=1)
    return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_jobs(tmp_path, jobs, world=S, timeout_s=90):
    """Runs each job of `jobs` ({name: job}), in order, in one group of
    `world` gloo ranks; returns {name: its outputs by rank}."""
    out = run_ranks(tmp_path, {"kind": "jobs", "jobs": jobs}, world, timeout_s * len(jobs))
    return {name: [o[name] for o in out] for name in jobs}


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    rs = np.random.RandomState(0)
    job = {"kind": "collectives",
           "x": [torch.tensor(rs.randn(5).astype(np.float32)) for _ in range(S)],
           "zf0": (torch.tensor(7.0), torch.tensor(rs.randn(3).astype(np.float32)),
                   torch.tensor(rs.rand(3).astype(np.float32) * 5)),
           "batch": [torch.tensor(rs.randn(4, 6, 3).astype(np.float32) + r)
                     for r in range(S)],
           "env": (torch.arange(8.0)[:, None].repeat(1, 9), torch.zeros(8, 9),
                   torch.arange(8, dtype=torch.int32))}
    return job, run_ranks(tmp_path_factory.mktemp("collectives"), job)


def test_psum_pmean_and_the_flat_buffer(collectives):
    job, out = collectives
    x0, x1 = job["x"]
    for o in out:
        assert torch.equal(o["psum"], x0 + x1)
        assert torch.equal(o["pmean"], (x0 + x1) / 2)
        want = [(x0 + x1) / 2, (2 * x0[:3] + 2 * x1[:3]) / 2, ((x0 + x1) / 2)[None]]
        for got, w in zip(o["flat"], want, strict=True):
            assert torch.equal(got, w)
        m = o["metrics"]  # the episode counts and return sums summed, the rest averaged
        assert float(m["episodes_done"]) == float(x0[0] + x1[0])
        assert float(m["episode_return_sum"]) == float(x0[2] + x1[2])
        assert float(m["kl"]) == float((x0[1] + x1[1]) / 2)
        assert torch.equal(o["replicated"]["a"], torch.zeros(3))  # rank 0's


def test_shard_env_batch_keeps_the_ranks_rows(collectives):
    job, out = collectives
    for r, o in enumerate(out):
        es = o["shard"]
        assert isinstance(es, EnvState)
        assert torch.equal(es.q, job["env"][0][4 * r:4 * (r + 1)])
        assert torch.equal(es.t, job["env"][2][4 * r:4 * (r + 1)])


def test_zfilter_axis_reduction_matches_the_reference(collectives):
    job, out = collectives
    zf0 = jz.ZFilterState(*(np.asarray(t) for t in job["zf0"]))
    batches = np.stack([b.numpy() for b in job["batch"]])
    ref = jax.vmap(lambda b: jz.zfilter_update(zf0, b, axis_name="data"),
                   axis_name="data")(batches)
    whole = tz.zfilter_update(tz.ZFilterState(*job["zf0"]),
                              torch.tensor(batches.reshape(-1, 3)))
    for o in out:
        got = o["zfilter"]
        for f in ("count", "mean", "m2"):
            np.testing.assert_allclose(np.asarray(getattr(ref, f))[0],
                                       getattr(got, f).numpy(), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(getattr(whole, f).numpy(), getattr(got, f).numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert all(torch.equal(getattr(got, f), getattr(out[0]["zfilter"], f))
                   for f in ("count", "mean", "m2"))


def test_zfilter_stats_and_merge_match_the_reference():
    rs = np.random.RandomState(1)
    a = [rs.rand(), rs.randn(4), rs.rand(4) * 3]
    b = [rs.rand() * 10, rs.randn(4), rs.rand(4)]
    a, b = ([np.float32(x) if np.isscalar(x) else x.astype(np.float32) for x in s]
            for s in (a, b))
    ja, jb = jz.ZFilterState(*a), jz.ZFilterState(*b)
    ta, tb = (tz.ZFilterState(*(torch.tensor(x) for x in s)) for s in (a, b))
    for ref, got in ((jz.zfilter_merge(ja, jb), tz.zfilter_merge(ta, tb)),
                     (jz.zfilter_update_stats(ja, *b),
                      tz.zfilter_update_stats(ta, tb.count, tb.mean, tb.m2))):
        for f in ("count", "mean", "m2"):
            np.testing.assert_allclose(np.asarray(getattr(ref, f)), getattr(got, f).numpy(),
                                       rtol=1e-6)
    # zfilter_update is the stats' merge: one batch two ways
    x = torch.tensor(rs.randn(10, 4).astype(np.float32))
    one = tz.zfilter_update(ta, x)
    two = tz.zfilter_update_stats(ta, torch.tensor(10.0), x.mean(0),
                                  ((x - x.mean(0)) ** 2).sum(0))
    for f in ("count", "mean", "m2"):
        assert torch.equal(getattr(one, f), getattr(two, f))


def test_one_rank_mesh_without_a_group_is_the_identity():
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1, "time": 1} and mesh.group is None
    assert pmesh.data_axis_size(mesh) == 1 and mesh.primary and mesh.world_size == 1
    x = torch.randn(4)
    assert pmesh.psum(x, mesh) is x and pmesh.pmean(x, None) is x
    m = {"kl": x[0]}
    assert pmesh.reduce_metrics(m, mesh) is m
    pmesh.barrier(mesh)
    assert pmesh.distributed_init() is None  # neither coordinator nor processes: a no-op


# a mesh must cover the ranks exactly, as the reference's make_mesh asserts
@pytest.mark.parametrize("kw,match", [
    ({"model": 2}, "1 ranks do not divide into model 2 x time 1"),
    ({"time": 2}, "1 ranks do not divide into model 1 x time 2"),
    ({"data": 2}, "2x1x1 != 1 ranks")], ids=["model", "time", "data"])
def test_make_mesh_refuses(kw, match):
    with pytest.raises(AssertionError, match=match):
        pmesh.make_mesh(device="cpu", **kw)


# The reference's layout: devices.reshape(data, model, time), so rank =
# d·model·time + m·time + t; an axis's group holds the ranks that share the
# other two indices.
LAYOUTS = {
    (2, 1, 2): {"data": [[0, 2], [1, 3]], "model": [[0], [1], [2], [3]],
                "time": [[0, 1], [2, 3]]},
    (2, 2, 1): {"data": [[0, 2], [1, 3]], "model": [[0, 1], [2, 3]],
                "time": [[0], [1], [2], [3]]},
    (1, 2, 1): {"data": [[0], [1]], "model": [[0, 1]], "time": [[0], [1]]},
}


@pytest.mark.parametrize("shape", list(LAYOUTS), ids=lambda s: "x".join(map(str, s)))
def test_rank_layout_and_axis_groups(shape):
    sizes = dict(zip(pmesh.AXES, shape))
    ref = np.arange(np.prod(shape)).reshape(shape)  # the reference's device grid
    for ax in pmesh.AXES:
        assert pmesh.axis_members(sizes, ax) == LAYOUTS[shape][ax]
    for rank in range(ref.size):
        index = pmesh.Mesh(shape=sizes, rank=rank, world_size=ref.size,
                           device=torch.device("cpu"), group=None).index
        assert ref[index["data"], index["model"], index["time"]] == rank


@pytest.fixture(scope="module")
def axes(tmp_path_factory):
    rs = np.random.RandomState(2)
    shapes = [(2, 1, 2), (2, 2, 1)]
    job = {"kind": "axes", "shapes": shapes,
           "x": [torch.tensor(rs.randn(3).astype(np.float32)) for _ in range(4)]}
    return job, run_ranks(tmp_path_factory.mktemp("axes"), job, world=4)


@pytest.mark.parametrize("shape", [(2, 1, 2), (2, 2, 1)], ids=["2x1x2", "2x2x1"])
def test_collectives_over_each_axis_on_4_ranks(axes, shape):
    job, out = axes
    for rank, o in enumerate(out):
        got = o[shape]
        index = got["index"]
        assert rank == index["data"] * shape[1] * shape[2] + index["model"] * shape[2] \
            + index["time"]
        for ax in pmesh.AXES:
            members = next(g for g in LAYOUTS[shape][ax] if rank in g)
            by = got["by_axis"][ax]
            assert by["members"] == members  # the group, in its axis order
            xs = [job["x"][r] for r in members]
            assert torch.equal(by["psum"], sum(xs[1:], xs[0]))
            assert torch.equal(by["pmean"], sum(xs[1:], xs[0]) / len(xs))
            assert torch.equal(by["gather"], torch.stack(xs))


def test_distributed_init_needs_all_three():
    with pytest.raises(ValueError, match="together"):
        pmesh.distributed_init("127.0.0.1:1", 2)


def test_backend_by_topology(monkeypatch):
    assert pmesh.choose_backend(torch.device("cpu"), 4)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pmesh.choose_backend(torch.device("cuda", 0), 2)[0] == "gloo"  # a shared card
    assert pmesh.choose_backend(torch.device("cuda", 0), 1)[0] == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pmesh.choose_backend(torch.device("cuda", 0), 4)[0] == "nccl"


@pytest.mark.parametrize("cards,backend", [(8, "nccl"), (4, "gloo")])
def test_two_processes_sharing_a_host_take_distinct_cards(monkeypatch, cards, backend):
    """The reference's tests/test_multihost.py layout: 2 launched processes
    of 4 ranks each on one host, each process given LOCAL_RANK and
    LOCAL_WORLD_SIZE as torchrun gives them. On 8 cards every rank has its
    own and NCCL is chosen; on 4 they share, and gloo is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    devices = []
    for process in (0, 1):
        monkeypatch.setenv("LOCAL_RANK", str(process))
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        first, on_host = pmesh.host_slots(4)
        assert (first, on_host) == (4 * process, 8)
        for i in range(4):  # what spawn sets in each rank
            monkeypatch.setenv("LOCAL_RANK", str(first + i))
            monkeypatch.setenv("LOCAL_WORLD_SIZE", str(on_host))
            dev = pmesh.rank_device("cuda", pmesh.local_rank())
            assert pmesh.choose_backend(dev, int(os.environ["LOCAL_WORLD_SIZE"]))[0] == backend
            devices.append(dev)
    assert devices == [torch.device("cuda", r % cards) for r in range(8)]
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert pmesh.host_slots(4) == (0, 4) and pmesh.local_rank() == 0  # alone on its host


def test_fold_in_keeps_rank_zeros_stream():
    g = torch.Generator().manual_seed(5)
    assert dp.fold_in(g, 3, 0) is g and torch.equal(
        torch.randn(3, generator=g), torch.randn(3, generator=torch.Generator().manual_seed(5)))
    draws = [torch.randn(3, generator=dp.fold_in(torch.Generator().manual_seed(5), 3, r))
             for r in (1, 2)]
    assert not torch.equal(draws[0], draws[1])
    again = torch.randn(3, generator=dp.fold_in(torch.Generator().manual_seed(99), 3, 1))
    assert torch.equal(draws[0], again)  # from (seed, rank) alone


def test_spawn_fails_fast_and_kills_the_other_ranks(tmp_path):
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank-1 failed"):
        pmesh.spawn(torch_dp_ranks.fail_one, 2, timeout_s=50)
    with pytest.raises(TimeoutError, match="after 1"):
        pmesh.spawn(torch_dp_ranks.hang, 2, timeout_s=1)
    assert time.monotonic() - t0 < 30
