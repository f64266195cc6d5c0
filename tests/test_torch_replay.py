"""The port's replay ring against the JAX reference: the same chunks are
inserted into both, and sampling is fed the reference's own (a, b) draws,
recomputed from its key as `replay_sample_nstep` makes them. Insert and
gather move data and do no arithmetic, so everything here is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.data import replay as jreplay
from surreal_tpu_torch.data import replay as treplay
import torch_helpers  # noqa: F401  (one torch thread a test process)

B, OBS = 4, 3


def _chunk(rs, T, t0):
    """A (T, B, ...) chunk whose `t` field is the absolute step t0 + i."""
    return {
        "obs": rs.randn(T, B, OBS).astype(np.float32),
        "t": np.broadcast_to((t0 + np.arange(T, dtype=np.int32))[:, None], (T, B)).copy(),
        "done": rs.rand(T, B) < 0.2,
    }


def _both(capacity_t, chunk_lens, seed=0):
    rs = np.random.RandomState(seed)
    example = {"obs": np.zeros((B, OBS), np.float32), "t": np.zeros((B,), np.int32),
               "done": np.zeros((B,), bool)}
    js = jreplay.replay_init(jax.tree.map(jnp.asarray, example), capacity_t)
    ts = treplay.replay_init({k: torch.tensor(v) for k, v in example.items()}, capacity_t)
    t0 = 0
    for T in chunk_lens:
        chunk = _chunk(rs, T, t0)
        js = jreplay.replay_insert(js, jax.tree.map(jnp.asarray, chunk))
        ts = treplay.replay_insert(ts, {k: torch.tensor(v) for k, v in chunk.items()})
        t0 += T
    return js, ts


def _reference_draws(js, key, batch_size, n_step):
    """(a, b) as the reference's replay_sample_nstep draws them from `key`."""
    window = n_step + 1
    k_t, k_b = jax.random.split(key)
    oldest = jnp.maximum(js.total - js.capacity_t, 0)
    num_valid = jnp.maximum(js.total - window + 1 - oldest, 1)
    a = oldest + jax.random.randint(k_t, (batch_size,), 0, num_valid)
    b = jax.random.randint(k_b, (batch_size,), 0, js.num_envs)
    return np.asarray(a), np.asarray(b)


# (capacity_t, chunk lengths): not yet full; filled to the edge; wrapped
# inside a chunk (5 + 5 into 8); wrapped several times; one chunk as long
# as the ring, starting off its origin
CASES = [(16, [4, 4]), (8, [4, 4]), (8, [5, 5]), (8, [3] * 7), (6, [2, 6])]


@pytest.mark.parametrize("capacity_t,chunk_lens", CASES)
def test_insert_matches_reference(capacity_t, chunk_lens):
    js, ts = _both(capacity_t, chunk_lens)
    assert ts.total == int(js.total) == sum(chunk_lens)
    assert (ts.capacity_t, ts.num_envs) == (js.capacity_t, js.num_envs) == (capacity_t, B)
    for k in js.data:
        assert ts.data[k].dtype == torch.tensor(np.asarray(js.data[k])).dtype
        np.testing.assert_array_equal(np.asarray(js.data[k]), ts.data[k].numpy())


@pytest.mark.parametrize("capacity_t,chunk_lens", CASES)
@pytest.mark.parametrize("window", [1, 4])
def test_sampleable_matches_reference(capacity_t, chunk_lens, window):
    js, ts = _both(capacity_t, chunk_lens)
    assert treplay.replay_sampleable(ts, window) == int(jreplay.replay_sampleable(js, window))


def test_sampleable_counts():
    ts = treplay.replay_init({"x": torch.zeros(1)}, capacity_t=8)
    assert treplay.replay_sampleable(ts, 4) == 0
    ts = treplay.replay_insert(ts, {"x": torch.zeros(4, 1)})
    assert treplay.replay_sampleable(ts, 4) == 1  # only the window starting at 0


@pytest.mark.parametrize("capacity_t,chunk_lens", CASES)
@pytest.mark.parametrize("n_step", [1, 3])
def test_sample_nstep_matches_reference_on_its_draws(capacity_t, chunk_lens, n_step):
    js, ts = _both(capacity_t, chunk_lens)
    key = jax.random.PRNGKey(capacity_t + n_step)
    a, b = _reference_draws(js, key, 64, n_step)
    wj = jreplay.replay_sample_nstep(js, key, 64, n_step)
    wt = treplay.replay_sample_nstep(ts, None, 64, n_step,
                                     index=(torch.tensor(a), torch.tensor(b)))
    for k in wj:
        assert wt[k].shape == wj[k].shape == (n_step + 1, 64) + js.data[k].shape[2:]
        np.testing.assert_array_equal(np.asarray(wj[k]), wt[k].numpy())
    # windows are consecutive in time and made of live steps only
    steps = wt["t"].numpy()
    np.testing.assert_array_equal(np.diff(steps, axis=0), np.ones_like(steps[1:]))
    assert steps.min() >= max(ts.total - capacity_t, 0) and steps.max() < ts.total


def test_own_draws_stay_inside_the_live_window():
    _, ts = _both(16, [4] * 6)  # total 24, capacity 16: live absolute steps 8..23
    gen = torch.Generator().manual_seed(0)
    w = treplay.replay_sample_nstep(ts, gen, 512, n_step=3)
    steps = w["t"].numpy()
    assert steps.shape == (4, 512) and steps.min() == 8 and steps.max() == 23
    np.testing.assert_array_equal(np.diff(steps, axis=0), np.ones_like(steps[1:]))
    again = treplay.replay_sample_nstep(ts, torch.Generator().manual_seed(0), 512, n_step=3)
    assert all(torch.equal(w[k], again[k]) for k in w)
    # every env column is drawn
    cols = {tuple(r) for r in w["obs"][0].numpy().round(4).tolist()}
    assert len(cols) > 20


def test_ring_overwrites_oldest():
    ts = treplay.replay_init({"x": torch.zeros(4)}, capacity_t=8)
    for i in range(5):
        ts = treplay.replay_insert(ts, {"x": torch.full((3, 4), float(i))})
    assert ts.total == 15
    # capacity 8 keeps the last 8 steps: chunk 2 in part, chunks 3 and 4
    assert set(ts.data["x"].numpy().ravel().tolist()) == {2.0, 3.0, 4.0}


def test_chunk_longer_than_the_ring_is_refused():
    ts = treplay.replay_init({"x": torch.zeros(2)}, capacity_t=4)
    with pytest.raises(ValueError, match="does not fit"):
        treplay.replay_insert(ts, {"x": torch.zeros(5, 2)})
