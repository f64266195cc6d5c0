"""The port's GTrXL torso and its PPO (port-only: the JAX package has none)
against the plain reference `benchmark/reference/gtrxl.py`, which imports
nothing of the port, at a small size: 2 layers, width 32, 4 heads, a memory
of 8, 4 envs and a chunk of 12, so that the ring wraps within a chunk and
episodes end inside it. Weights are the reference's seeded ones.

Tolerances. Outputs, ring contents and probes: 1e-5 · max(1, |ref|); the
same float32 arithmetic in another order (a masked softmax over at most
m + 1 keys, products 32 wide) measured 3.6e-7, so the tolerance leaves more
than a decade. A fresh env against a reset one: 1e-6, the same operations
on another batch (measured 0 to 2e-7). The update's loss 1e-5 relative and
each leaf's gradient 1e-4 of the largest leaf's norm: the gradient sums over
the minibatch's rows in another order (measured 3e-7). A mask that ignores
episode starts reads 1e-1 or more off."""

import dataclasses
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import gtrxl as ref  # noqa: E402
from benchmark.reference import gtrxl_ppo as ref_ppo  # noqa: E402
from surreal_tpu_torch.algos import ppo, ppo_gtrxl  # noqa: E402
from surreal_tpu_torch.algos.ppo import PPOConfig  # noqa: E402
from surreal_tpu_torch.cli.main import main  # noqa: E402
from surreal_tpu_torch.envs import available_envs, registry  # noqa: E402
from surreal_tpu_torch.envs.cartpole import Cartpole  # noqa: E402
from surreal_tpu_torch.models.actor_critic import PPOActorCritic  # noqa: E402
from surreal_tpu_torch.models.z_filter import zfilter_normalize  # noqa: E402
from surreal_tpu_torch.train import PPOTrainer  # noqa: E402
from surreal_tpu_torch.train.ppo_trainer import check_layout  # noqa: E402
import torch_helpers  # noqa: E402,F401  (one torch thread a test process)

TORSO = dict(layers=2, width=32, heads=4, memory=8, mlp_width=64)
SPEC = dict(obs_dim=17, action_dim=6, **TORSO)
B, T, M, T0 = 4, 12, 8, 5
TOL, TOL_FRESH, TOL_LOSS, TOL_GRAD = 1e-5, 1e-6, 1e-5, 1e-4


def close(ref_x, got, tol):
    return float(((got - ref_x).abs() / ref_x.abs().clamp(min=1.0)).max()) <= tol


@pytest.fixture(scope="module")
def net():
    n = PPOActorCritic(17, 6, gtrxl=TORSO)
    n.load_state_dict(ref.make_weights(SPEC, torch.Generator().manual_seed(1), "cpu"))
    return n


@pytest.fixture(scope="module")
def chunk():
    """A ring at clock T0 = 5 holding slots of times 0..4: env 0 sees them
    all, env 1 none (its episode began at T0), env 2 only the last, env 3
    all; env 0's episodes end at steps 3 and 7, env 3's at 10."""
    g = torch.Generator().manual_seed(2)
    memory = torch.randn(TORSO["layers"], B, M, TORSO["width"], generator=g)
    valid = torch.zeros(B, M, dtype=torch.bool)
    valid[[0, 3], :T0] = True
    valid[2, T0 - 1] = True
    done = torch.zeros(T, B, dtype=torch.bool)
    done[3, 0] = done[7, 0] = done[10, 3] = True
    return {"memory": memory, "valid": valid, "x": torch.randn(T, B, 17, generator=g),
            "done": done, "probe_x": torch.randn(B, 17, generator=g)}


def drive(net, c, ignore_starts=False):
    """T decode steps after a prefill, the validity kept as the rollout
    keeps it; the terminal probes where an episode ended and the bootstrap
    after the chunk. Returns (outputs (T, B, d), probes {(s, b): E^L},
    bootstrap (B, d), the ring and validity after)."""
    memory, valid = c["memory"].clone(), c["valid"].clone()
    with torch.no_grad():
        cache = net.gtrxl.prefill(memory)
        outs, probes, t = [], {}, T0
        for s in range(T):
            outs.append(net.gtrxl.step(c["x"][s], cache, t, valid))
            valid[:, t % M] = True
            if c["done"][s].any():
                e = net.gtrxl.step(c["probe_x"], cache, t + 1, valid, write=False)
                for b in torch.nonzero(c["done"][s]).flatten().tolist():
                    probes[(s, b)] = e[b]
            if not ignore_starts:
                valid &= ~c["done"][s][:, None]
            t += 1
        last = net.gtrxl.step(c["probe_x"], cache, t, valid, write=False)
    return torch.stack(outs), probes, last, cache.memory, valid


def reference(c):
    w = ref.make_weights(SPEC, torch.Generator().manual_seed(1), "cpu")
    mem_t, val_t = ref.time_ordered(c["memory"], T0, 2), ref.time_ordered(c["valid"], T0, 1)
    with torch.no_grad():
        e, inputs = ref.chain(w, SPEC, mem_t, val_t, c["x"], c["done"])
        starts = ref.episode_starts(c["done"])
        s_, b_ = torch.nonzero(c["done"], as_tuple=True)
        env = torch.cat([b_, torch.arange(B)])
        qt = torch.cat([s_ + 1, torch.full((B,), T)])
        ep = torch.cat([starts[b_, s_], starts[:, T]])
        pe, _ = ref.probe(w, SPEC, mem_t, val_t, inputs, c["probe_x"][env], env, qt, ep)
    probes = {(int(s), int(b)): pe[i] for i, (s, b) in enumerate(zip(s_, b_))}
    return e, inputs, probes, pe[len(s_):]


def test_step_after_prefill_matches_the_reference_at_every_position(net, chunk):
    outs, probes, last, ring, _ = drive(net, chunk)
    e, inputs, ref_probes, ref_last = reference(chunk)
    assert close(e, outs, TOL)
    assert set(probes) == set(ref_probes) == {(3, 0), (7, 0), (10, 3)}
    for k in probes:
        assert close(ref_probes[k], probes[k], TOL), k
    assert close(ref_last, last, TOL)
    for s in range(T - M, T):  # the ring's slots written in the chunk
        assert close(inputs[:, :, s], ring[:, :, (T0 + s) % M], TOL), s


def test_segment_matches_twelve_steps(net, chunk):
    outs = drive(net, chunk)[0]
    with torch.no_grad():
        seg = net.gtrxl.segment(chunk["x"], chunk["memory"], chunk["valid"], chunk["done"], T0)
    assert close(outs, seg, TOL)


def test_a_reset_env_matches_a_fresh_env(net, chunk):
    """Env 0's episode ends at step 7: from step 8 its outputs are those of
    an env whose memory holds nothing of its episode (its ring full of other
    numbers, no slot valid), started at the same time on the same inputs."""
    outs = drive(net, chunk)[0]
    fresh = {"memory": torch.randn(TORSO["layers"], 1, M, TORSO["width"]),
             "valid": torch.zeros(1, M, dtype=torch.bool)}
    with torch.no_grad():
        cache = net.gtrxl.prefill(fresh["memory"])
        valid, t = fresh["valid"], T0 + 8
        for s in range(8, T):
            e = net.gtrxl.step(chunk["x"][s, :1], cache, t, valid)
            valid[:, t % M] = True
            t += 1
            assert close(outs[s, :1], e, TOL_FRESH), s


def test_a_mask_that_ignores_episode_starts_fails_the_reference(net, chunk):
    outs = drive(net, chunk, ignore_starts=True)[0]
    e = reference(chunk)[0]
    gap = float(((outs - e).abs() / e.abs().clamp(min=1.0)).max())
    assert gap > 1e-1 > TOL


def _trainer(seed=3, **kw):
    cfg = PPOConfig(horizon=T, epochs=2, num_minibatches=2, fused_loss=True)
    t = PPOTrainer("cheetah-run", cfg, num_envs=B, seed=seed, device="cpu", torso="gtrxl",
                   gtrxl=TORSO, **kw)
    # episodes that end inside the first and the second chunk, out of phase
    t.env_state = dataclasses.replace(
        t.env_state, t=torch.tensor([994, 1000 - T - 3, 500, 990], dtype=t.env_state.t.dtype))
    return t


def test_the_update_loss_and_gradients_match_the_reference():
    """The second iteration's trajectory (its memory full, the ring wrapped,
    resets in the chunk): the first minibatch's loss and gradients, through
    PPO's loss gate (24 rows: the torch loss; the fused kernels take the
    benchmark's 16,384, on the card)."""
    t = _trainer()
    t.run(1, log_every=1 << 30)
    traj = ppo_gtrxl.rollout(t.cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.carry,
                             t.ep_ret, t.generator)[0]
    assert traj.done.any() and traj.valid.any() and traj.t0 == T
    perms = torch.stack([torch.randperm(B, generator=torch.Generator().manual_seed(e))
                         for e in range(2)])
    net, cfg, zf = t.state.net, t.cfg, t.state.zfilter
    with torch.no_grad():
        obs_n = zfilter_normalize(zf, traj.obs)
        from surreal_tpu_torch.ops.returns import gae
        adv, vtarg = gae(traj.reward, traj.value, traj.next_value, traj.discount, traj.done,
                         cfg.gamma, cfg.lam)
        adv = ppo.normalize_advantages(adv)
    idx = perms[0][:B // 2]
    mean, log_std, value = ppo_gtrxl.sequence_outputs(net, obs_n, traj, idx)
    n = mean.shape[0] * mean.shape[1]
    rest = tuple(x[:, idx].reshape(n, *x.shape[2:]) for x in (
        traj.action, traj.log_prob, traj.mean, traj.log_std, adv, vtarg, traj.value))
    loss = ppo.loss_of_outputs(cfg, mean.reshape(n, -1), log_std, value.reshape(n), rest,
                               t.state.kl_beta, 0.0)[0]
    grads = dict(zip([k for k, _ in net.named_parameters()],
                     torch.autograd.grad(loss, list(net.parameters()))))
    weights = {k: v.detach().clone() for k, v in net.named_parameters()}
    rows = {"obs_n": obs_n, "action": traj.action, "logp_old": traj.log_prob, "adv": adv,
            "vtarg": vtarg, "v_old": traj.value, "done": traj.done,
            "memory_t": ref.time_ordered(traj.memory, traj.t0, 2),
            "valid_t": ref.time_ordered(traj.valid, traj.t0, 1)}
    zeros = {k: torch.zeros_like(v) for k, v in weights.items()}
    cfg_d = {**dataclasses.asdict(cfg), "max_grad_norm": float("inf")}
    got = ref_ppo.first_steps(SPEC, cfg_d, {"params": weights, "mu": zeros, "nu": zeros,
                                            "count": 0, "lr": 0.0}, rows, perms, 1)
    assert abs(float(loss) - got["losses"][0]) <= TOL_LOSS * max(abs(got["losses"][0]), 1e-3)
    scale = max(float(g.norm()) for g in got["grads1"].values())
    for k, g in got["grads1"].items():
        assert float((grads[k] - g).norm()) <= TOL_GRAD * scale, k


def test_a_trainer_iteration_and_a_checkpoint_round_trip_of_the_carry(tmp_path):
    from surreal_tpu_torch.train.checkpoint import Checkpointer

    t = _trainer()
    logs = t.run(2, log_every=1)
    assert len(logs) == 2 and all(torch.isfinite(torch.tensor(m["kl"])) for m in logs)
    assert t.carry.t == 2 * T and t.carry.valid.any()
    ckpt = Checkpointer(str(tmp_path), rank_keys=t.rank_keys)
    ckpt.save(2 * T * B, t.full_state)
    ckpt.wait()
    twin = _trainer(seed=9)
    twin.load_full_state(ckpt.restore(twin.full_state))
    assert twin.carry.t == t.carry.t
    assert torch.equal(twin.carry.valid, t.carry.valid)
    assert torch.equal(twin.carry.memory, t.carry.memory)
    t.run(1, log_every=1 << 30)
    twin.run(1, log_every=1 << 30)
    for (k, a), (_, b) in zip(t.state.net.named_parameters(), twin.state.net.named_parameters()):
        assert torch.equal(a, b), k
    assert torch.equal(t.carry.memory, twin.carry.memory)
    ev = t.evaluate(episodes=2)
    assert ev["episodes"] == 2 and ev["return_mean"] == ev["return_mean"]


def test_the_cli_trains_resumes_and_evaluates_a_gtrxl_policy(tmp_path, monkeypatch):
    available_envs()

    def short_cartpole(**kw):
        env = Cartpole(swing_up=False, sparse=False, **kw)
        env.episode_steps = 30
        return env

    monkeypatch.setitem(registry._REGISTRY, "cartpole-balance", short_cartpole)
    argv = ["train", "ppo", "--env.env_name", "cartpole-balance", "--env.num_envs", "4",
            "--session.eval_episodes", "2", "--learner.horizon", "8",
            "--learner.num_minibatches", "2", "--learner.torso", "gtrxl",
            "--learner.gtrxl.layers", "1", "--learner.gtrxl.width", "16",
            "--learner.gtrxl.heads", "2", "--learner.gtrxl.memory", "4",
            "--learner.gtrxl.mlp_width", "32", "--session.eval_every_steps", "64",
            "--session.checkpoint_every_steps", "32", "--session.results_dir", str(tmp_path),
            "--session.experiment_name", "g", "--device", "cpu"]
    assert main(argv + ["--session.total_env_steps", "32"]) == 0
    cfg = json.loads((tmp_path / "g" / "config.json").read_text())
    assert cfg["learner"]["torso"] == "gtrxl" and cfg["learner"]["gtrxl"]["memory"] == 4
    assert main(argv + ["--session.total_env_steps", "64"]) == 0  # resumes at 32
    steps = sorted(int(s) for s in os.listdir(tmp_path / "g" / "checkpoints" / "latest")
                   if s.isdigit())
    assert steps[-1] == 64
    assert main(["eval", "--experiment", str(tmp_path / "g"), "--episodes", "2",
                 "--device", "cpu"]) == 0


@pytest.mark.parametrize("kw", [dict(data=2), dict(model=2), dict(time=2),
                                dict(overlap=True), dict(use_lstm=True)],
                         ids=["data", "model", "time", "overlap", "use_lstm"])
def test_check_layout_refuses_gtrxl_off_one_device(kw):
    cfg = PPOConfig(horizon=T)
    args = {"model": 1, "time": 1, "use_lstm": False, "overlap": False, "data": 1, **kw}
    order = (args["model"], args["time"], args["use_lstm"], args["overlap"])
    check_layout(cfg, *order, "mlp", args["data"])  # the MLP torso takes each of them
    with pytest.raises(ValueError, match="torso 'gtrxl' runs on one device only"):
        check_layout(cfg, *order, "gtrxl", args["data"])


def test_the_trainer_refuses_gtrxl_with_a_mesh_lstm_overlap_or_pixels():
    from surreal_tpu_torch.parallel.mesh import make_mesh

    for kw in (dict(mesh=make_mesh(1, device="cpu")), dict(use_lstm=True), dict(overlap=True)):
        with pytest.raises(ValueError, match="torso 'gtrxl' runs on one device only"):
            _trainer(**kw)
    with pytest.raises(ValueError, match="flat observations"):
        _trainer(pixel_obs=True)
    with pytest.raises(ValueError, match="unknown torso"):
        check_layout(PPOConfig(), 1, 1, torso="rnn")


def test_the_gtrxl_spans_nest_in_the_rollout_and_the_update():
    """One prefill a rollout; a decode for each step, each terminal probe
    and the bootstrap, each holding an attention span a layer, the steps'
    (and only theirs) a cache write; a segment a minibatch step inside its
    loss, holding an attention span a layer."""
    from torch.profiler import ProfilerActivity, profile

    t = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traj = ppo_gtrxl.rollout(t.cfg, t.env, t._flatten, t.state, t.env_state, t.obs,
                                 t.carry, t.ep_ret, t.generator)[0]
        ppo_gtrxl.update(t.cfg, t.state, traj, t.generator)
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()]

    def spans(name):
        return [e for e in ev if e[0] == name]

    def within(inner, outer):
        return all(any(o[1] <= i[1] and i[2] <= o[2] for o in spans(outer))
                   for i in spans(inner))

    probes = int(traj.done.any(1).sum())
    assert probes == 2
    assert len(spans("gtrxl.prefill")) == 1
    assert len(spans("gtrxl.decode")) == T + probes + 1
    assert len(spans("gtrxl.cache_write")) == T
    minibatches = t.cfg.epochs * t.cfg.num_minibatches
    assert len(spans("gtrxl.segment")) == minibatches
    assert len(spans("gtrxl.attention")) == TORSO["layers"] * (T + probes + 1 + minibatches)
    assert within("gtrxl.cache_write", "gtrxl.decode")
    assert within("gtrxl.segment", "ppo.update.loss")
    assert len([d for d in spans("gtrxl.decode")
                if any(p[1] <= d[1] and d[2] <= p[2] for p in spans("ppo.rollout.policy"))]) == T
