"""Tensor parallelism over the model axis (surreal_tpu_torch/parallel/tp.py)
against the reference (surreal_tpu/parallel/tp.py and its GSPMD trainer
path) on the CPU: gloo ranks of the port, each a process that imports
nothing of JAX (tests/torch_dp_ranks.py).

Held:
- `tp_kernel_specs` is the reference's map on the flagship net at model 2
  and 4, action dims 1, 2 and 6, and on the pixel net;
- on 2 ranks (data 1 x model 2): the sharded forward and its completed,
  gathered gradient against the unsharded module (tests/test_tp.py's bars,
  rtol 2e-5, atol 1e-5), and the global norm, which counts every element
  once (summing the replicated leaves over the model group as well would
  miss it by far more than the bar); a rank holds its shards' shapes;
- one tensor-parallel PPO step against the reference's one-device
  train_step on its draws, at tests/test_torch_ppo.py's bars (parameters
  4e-6 abs, within the 1e-5 asked of it; metrics rtol 1e-4);
- a bfloat16 update under TP against the reference's bfloat16 update at
  tests/test_torch_bf16_updates.py's share-and-reach bars;
- on 4 ranks (data 2 x model 2): three chained steps against the
  reference's GSPMD trainer on 4 virtual devices, at the reference's own
  bar for GSPMD against unsharded (rtol 5e-4, atol 5e-5,
  tests/test_tp.py:58-75);
- the reference's refusals, with its messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_bf16_updates as tbu
from surreal_tpu.algos import ppo as jppo
from surreal_tpu.envs import base as jbase
from surreal_tpu.envs import make_env as jmake_env
from surreal_tpu.models.actor_critic import PPOActorCritic as FlaxAC
from surreal_tpu.parallel.tp import tp_kernel_specs as ref_specs
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.convert import flax_leaves, params_from_flax, params_to_flax
from surreal_tpu_torch.parallel import mesh as pmesh
from surreal_tpu_torch.parallel.tp import COLUMN, ROW, tp_kernel_specs
from surreal_tpu_torch.train import PPOTrainer
from test_torch_mesh import run_ranks
from torch_helpers import fast_jit, reference_reset_rows, to_torch

HIDDEN, B, T = (32, 32), 8, 8
ATOL_PARAM, RTOL_METRIC = 4e-6, 1e-4


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("net", ["A1", "A2", "A6", "pixel"])
def test_kernel_specs_are_the_references(net, model):
    pixel = net == "pixel"
    action = 6 if pixel else int(net[1:])
    obs = jnp.zeros((1, 84, 84, 3), jnp.uint8) if pixel else jnp.zeros((1, 17))
    flax = FlaxAC(action_dim=action, hidden=(256, 256), pixel_obs=pixel)
    shapes = jax.eval_shape(flax.init, jax.random.PRNGKey(0), obs)
    port = PPOActorCritic((84, 84, 3) if pixel else 17, action, (256, 256), pixel_obs=pixel)
    names = {path: name for path, name, _ in
             flax_leaves({n: tuple(p.shape) for n, p in port.named_parameters()})}
    want = {names[path]: COLUMN if spec[1] == "model" else ROW
            for path, spec in ref_specs(shapes, model).items()}
    assert tp_kernel_specs(port, model) == want and want
    if net == "A6" and model == 2:  # every kernel of the flagship is split
        assert list(want.values()) == [COLUMN, ROW] * 3
    if net == "A6" and model == 4:  # both heads stay replicated
        assert "mean_head.weight" not in want and "value_head.weight" not in want


def _one_device_reference():
    """The reference's one-device rollout and update (train_step) on
    cheetah-run, a quarter of the envs ending their episodes inside it."""
    cfg = jppo.PPOConfig(horizon=T, epochs=2, num_minibatches=2)
    env = jmake_env("cheetah-run")
    reset_fn, step_fn = jbase.vectorize(env)
    env_state, ts0 = jax.jit(reset_fn)(jax.random.split(jax.random.PRNGKey(1), B))
    env_state = dataclasses.replace(
        env_state, t=jnp.where(jnp.arange(B) % 4 == 0, 995, 0).astype(jnp.int32))
    obs = jbase.flatten_obs(ts0.obs)
    net = FlaxAC(action_dim=6, hidden=HIDDEN)
    params = net.init(jax.random.PRNGKey(0), obs[:1])
    state = jppo.init_state(cfg, params, 17)
    k_roll, k_up = jax.random.split(jax.random.PRNGKey(7))
    traj, _, _, _, stats = fast_jit(lambda s, es, o, r, k: jppo.rollout(
        cfg, net.apply, step_fn, jbase.flatten_obs, s, es, o, r, k))(
        state, env_state, obs, jnp.zeros((B,)), k_roll)
    new, metrics = fast_jit(lambda s, tr, k: jppo.update(cfg, net.apply, s, tr, k))(
        state, traj, k_up)
    metrics.update(stats)
    metrics["reward_per_step"] = jnp.mean(traj.reward)
    perms = np.stack([np.asarray(jax.random.permutation(k, B * T))
                      for k in jax.random.split(k_up, cfg.epochs)])
    noise = (np.asarray(traj.action) - np.asarray(traj.mean)) / np.exp(np.asarray(traj.log_std))
    assert np.asarray(traj.done).any()
    job = {"cfg": dict(horizon=T, epochs=2, num_minibatches=2),
           "env": tuple(to_torch(x) for x in (env_state.q, env_state.qd, env_state.t)),
           "obs": to_torch(obs), "rows": reference_reset_rows(env, env_state, traj.done),
           "noise": [to_torch(noise)], "perms": [to_torch(perms)]}
    return jax.device_get(params), job, {"state": jax.device_get(new),
                                         "metrics": jax.device_get(metrics)}


def _bf16_reference(params):
    """The reference's bfloat16 update of a synthetic trajectory (512 rows,
    2 x 2 minibatches of 256)."""
    Tb, Bb = 16, 32
    cfg = jppo.PPOConfig(horizon=Tb, epochs=2, num_minibatches=2)
    tr = tbu._trajectory(Tb, Bb, np.random.RandomState(7))
    fnet = FlaxAC(action_dim=6, hidden=HIDDEN, compute_dtype=jnp.bfloat16)
    key = jax.random.PRNGKey(3)
    new, m = fast_jit(lambda s, t, k: jppo.update(cfg, fnet.apply, s, t, k))(
        jppo.init_state(cfg, params, 17), jppo.Trajectory(**tr), key)
    perms = np.stack([np.asarray(jax.random.permutation(k, Tb * Bb))
                      for k in jax.random.split(key, cfg.epochs)])
    job = {"cfg": dict(horizon=Tb, epochs=2, num_minibatches=2),
           "traj": {k: to_torch(v) for k, v in tr.items()}, "perms": to_torch(perms)}
    return job, {"params": jax.device_get(new.params), "metrics": jax.device_get(m),
                 "lr_scale": float(new.lr_scale)}


@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    params, steps_job, ref = _one_device_reference()
    bf16_job, bf16_ref = _bf16_reference(params)
    probe = torch.tensor(np.random.RandomState(5).randn(16, 17).astype(np.float32))
    job = {"kind": "tp", "shape": (1, 2, 1), "hidden": HIDDEN,
           "params": params_from_flax(params), "probe": probe, "bf16_update": bf16_job,
           "steps": True, **steps_job}
    return job, ref, bf16_ref, run_ranks(tmp_path_factory.mktemp("tp2"), job)


def _unsharded(job, dtype):
    net = PPOActorCritic(17, 6, HIDDEN, compute_dtype=dtype)
    net.load_state_dict(job["params"])
    mean, _, value = net(job["probe"])
    loss = torch.sum(mean ** 2) + torch.sum(value ** 2)
    names, params = zip(*net.named_parameters())
    return mean, value, dict(zip(names, torch.autograd.grad(
        loss, params, allow_unused=True, materialize_grads=True)))


def test_forward_and_gradient_match_the_unsharded_module(model2):
    job, _, _, out = model2
    mean, value, grads = _unsharded(job, torch.float32)
    for o in out:
        got = o["float32"]
        assert got["contiguous"]  # the fused loss kernel takes contiguous heads' outputs
        np.testing.assert_allclose(got["mean"].numpy(), mean.detach().numpy(), rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["value"].numpy(), value.detach().numpy(), rtol=2e-5,
                                   atol=1e-5)
        for n, g in grads.items():
            np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(), rtol=2e-5,
                                       atol=1e-5, err_msg=n)
    # each rank holds its shard of the six kernels, every other leaf whole
    shapes = out[1]["float32"]["shapes"]
    assert shapes["actor_torso.dense_0.weight"] == (16, 17)  # column: half the rows
    assert shapes["actor_torso.dense_1.weight"] == (32, 16)  # row: half the columns
    assert shapes["mean_head.weight"] == (3, 32) and shapes["value_head.weight"] == (1, 16)
    assert shapes["actor_torso.dense_0.bias"] == (32,) and shapes["log_std"] == (6,)
    full = sum(g.numel() for g in grads.values())
    kernels = sum(grads[n].numel() for n in ("actor_torso.dense_0.weight",
                                             "actor_torso.dense_1.weight",
                                             "critic_torso.dense_0.weight",
                                             "critic_torso.dense_1.weight",
                                             "mean_head.weight", "value_head.weight"))
    assert out[0]["float32"]["local_floats"] == full - kernels // 2


def test_global_norm_counts_each_element_once(model2):
    job, _, _, out = model2
    _, _, grads = _unsharded(job, torch.float32)
    specs = tp_kernel_specs(PPOActorCritic(17, 6, HIDDEN), 2)
    want = float(torch.sqrt(sum(torch.sum(g * g) for g in grads.values())))
    replicated = float(sum(torch.sum(g * g) for n, g in grads.items() if n not in specs))
    twice = (want ** 2 + replicated) ** 0.5  # the replicated leaves summed over both ranks
    for o in out:
        got = float(o["float32"]["norm"])
        assert abs(got - want) <= 1e-5 * want
        assert abs(twice - want) > 100 * 1e-5 * want  # what the bar would catch


def test_one_step_matches_the_references_one_device_step(model2):
    _, ref, _, out = model2
    state = ref["state"]
    for o in out:
        s = o["steps"]
        got = params_to_flax(s["params"])
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(state.params),
                                     jax.tree_util.tree_leaves_with_path(got), strict=True):
            err = np.abs(np.asarray(a) - b).max()
            assert err <= ATOL_PARAM, (jax.tree_util.keystr(path), err)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(float(v), float(s["metrics"][0][k]), rtol=RTOL_METRIC,
                                       atol=1e-7, err_msg=k)
        assert set(s["metrics"][0]) == set(ref["metrics"])
        for f, got_f in zip(("count", "mean", "m2"), s["zfilter"]):
            np.testing.assert_allclose(np.asarray(getattr(state.zfilter, f)), got_f.numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert s["lr_scale"] == float(state.lr_scale)
        assert s["opt_count"] == int(state.opt_state[1].count) and s["update_step"] == 1
        assert s["mu_shapes"]["critic_torso.dense_1.weight"] == (32, 16)  # sharded moments
    a, b = (o["steps"]["params"] for o in out)
    assert all(torch.equal(a[n], b[n]) for n in a)  # the model ranks agree bit for bit


def test_bf16_under_tp_matches_the_references_bf16_update(model2):
    job, _, ref, out = model2
    for o in out:
        got = o["bf16_update"]
        net = PPOActorCritic(17, 6, HIDDEN)
        net.load_state_dict(got["params"])
        tbu._hold(ref["params"], params_to_flax(job["params"])["params"], net,
                  reach=tbu._reach(4, 3e-4))
        tbu._metrics_close(ref["metrics"], got["metrics"])
        assert float(got["lr_scale"]) == ref["lr_scale"]
    # the probe's bfloat16 forward: a sharded product rounds per shard
    mean, value, _ = _unsharded(job, torch.bfloat16)
    for o in out:
        np.testing.assert_allclose(o["bfloat16"]["mean"].numpy(), mean.detach().numpy(),
                                   rtol=2 ** -6, atol=2 ** -6)
        np.testing.assert_allclose(o["bfloat16"]["value"].numpy(), value.detach().numpy(),
                                   rtol=2 ** -6, atol=2 ** -6)


@pytest.fixture(scope="module")
def gspmd(tmp_path_factory):
    """The reference's GSPMD trainer (data 2 x model 2 on 4 virtual
    devices), three iterations, each one's draws recovered for the port."""
    from surreal_tpu.train import PPOTrainer as JTrainer

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2, 1), ("data", "model", "time"))
    cfg_kw = dict(horizon=16, epochs=2, num_minibatches=2, lr=1e-3)
    cfg = jppo.PPOConfig(**cfg_kw)
    tr = JTrainer("cheetah-run", cfg, num_envs=B, seed=0, hidden=HIDDEN, mesh=mesh)
    _, step_fn = jbase.vectorize(tr.env)
    roll = fast_jit(lambda s, es, o, r, k: jppo.rollout(cfg, tr.net.apply, step_fn,
                                                       jbase.flatten_obs, s, es, o, r, k))
    es = jax.device_get(tr.env_state)
    job = {"kind": "tp", "shape": (2, 2, 1), "hidden": HIDDEN, "cfg": cfg_kw, "steps": True,
           "params": params_from_flax(jax.device_get(tr.state.params)),
           "env": tuple(to_torch(x) for x in (es.q, es.qd, es.t)),
           "obs": to_torch(jax.device_get(tr.obs)), "rows": [], "noise": [], "perms": []}
    for _ in range(3):
        tr.key, sub = jax.random.split(tr.key)
        k_roll, k_up = jax.random.split(sub)
        es_now = jax.device_get(tr.env_state)
        traj = roll(*jax.device_get((tr.state, es_now, tr.obs, tr.ep_ret)), k_roll)[0]
        job["rows"] += reference_reset_rows(tr.env, es_now, traj.done)
        job["noise"].append(to_torch((np.asarray(traj.action) - np.asarray(traj.mean))
                                     / np.exp(np.asarray(traj.log_std))))
        job["perms"].append(torch.stack([to_torch(jax.random.permutation(k, B * 16))
                                         for k in jax.random.split(k_up, cfg.epochs)]))
        tr.state, tr.env_state, tr.obs, tr.ep_ret, _ = tr._train_step(
            tr.state, tr.env_state, tr.obs, tr.ep_ret, sub)
    k0 = tr.state.params["params"]["actor_torso"]["dense_0"]["kernel"]
    assert not k0.sharding.is_fully_replicated  # the reference really split it
    return jax.device_get(tr.state.params), run_ranks(tmp_path_factory.mktemp("tp4"), job,
                                                      world=4)


def test_data_by_model_matches_the_references_gspmd_trainer(gspmd):
    ref, out = gspmd
    for o in out:
        got = params_to_flax(o["steps"]["params"])
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got), strict=True):
            np.testing.assert_allclose(np.asarray(a), b, rtol=5e-4, atol=5e-5)
        assert all(torch.equal(o["steps"]["params"][n], out[0]["steps"]["params"][n])
                   for n in o["steps"]["params"])


@pytest.mark.parametrize("kw,match", [
    ({"use_lstm": True}, "does not compose with use_lstm"),
    ({"overlap": True}, "does not compose with use_lstm"),
    ({"cfg": {"publish_every": 2}}, "does not compose with use_lstm"),
    ({"cfg": {"zero_optimizer": True}}, "does not compose with use_lstm"),
    ({"time": 2}, "mesh.model and mesh.time cannot both be > 1"),
    ({"debug_checks": True}, "debug_checks is single-device only"),
], ids=["use_lstm", "overlap", "publish_every", "zero_optimizer", "time", "debug_checks"])
def test_the_references_refusals(kw, match):
    kw = dict(kw)
    shape = {"data": 1, "model": 2, "time": kw.pop("time", 1)}
    mesh = pmesh.Mesh(shape=shape, rank=0, world_size=2, device=torch.device("cpu"), group=None)
    cfg = tppo.PPOConfig(horizon=8, **kw.pop("cfg", {}))
    with pytest.raises(ValueError, match=match):
        PPOTrainer("cheetah-run", cfg, num_envs=4, hidden=(16, 16), mesh=mesh, **kw)
