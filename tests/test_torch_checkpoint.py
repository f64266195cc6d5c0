"""The port's Checkpointer (latest and best retention, meta.json, restore
onto the target's device and structure) and the trainers' full state: a
run saved, loaded into a fresh trainer built with another seed and
continued equals the uninterrupted run bit for bit, for PPO with the fused
loss, LSTM-PPO with a stale actor snapshot and in bfloat16, DDPG past its replay warm-up,
and pixel PPO and pixel DDPG (shared encoder, random shift), whose frame
stacks are part of the state; and what a resumed gym run restores."""

import json
import os

import pytest
import torch

from surreal_tpu_torch.algos.ddpg import DDPGConfig
from surreal_tpu_torch.algos.ppo import PPOConfig
from surreal_tpu_torch.parallel.mesh import Mesh
from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer
from surreal_tpu_torch.train.checkpoint import Checkpointer
import torch_helpers  # noqa: F401  (one torch thread a test process)


def _state(offset):
    return {"w": torch.arange(4.0) + offset, "step": offset, "nested": {"k": [torch.ones(2)]}}


def test_checkpoint_latest_and_best(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep_latest=2)
    ck.save(1, _state(0), score=10.0)
    ck.save(2, _state(1), score=5.0)  # worse: not best
    ck.save(3, _state(2), score=20.0)  # new best
    ck.save(4, _state(3))  # no score: best unchanged
    ck.wait()
    assert ck.latest_step() == 4
    restored = ck.restore(_state(0))
    assert torch.equal(restored["w"], torch.arange(4.0) + 3) and restored["step"] == 3
    best = ck.restore(_state(0), best=True)
    assert torch.equal(best["w"], torch.arange(4.0) + 2)
    assert torch.equal(ck.restore(_state(0), step=3)["w"], torch.arange(4.0) + 2)
    assert ck.best_info == {"best_score": 20.0, "best_step": 3}
    assert sorted(os.listdir(tmp_path / "ck" / "latest")) == ["3", "4"]  # keep_latest=2
    assert os.listdir(tmp_path / "ck" / "best") == ["3"]
    with open(tmp_path / "ck" / "meta.json") as f:
        assert json.load(f) == {"best_score": 20.0, "best_step": 3}
    ck.close()
    # a new Checkpointer on the same root reads the best back, and moves it
    # only on a better score
    ck2 = Checkpointer(str(tmp_path / "ck"), keep_latest=2)
    assert ck2.best_info == {"best_score": 20.0, "best_step": 3}
    ck2.save(5, _state(4), score=19.0)
    assert ck2.best_info["best_step"] == 3
    ck2.save(6, _state(5), score=21.0)
    assert ck2.best_info == {"best_score": 21.0, "best_step": 6}
    assert os.listdir(tmp_path / "ck" / "best") == ["6"]
    assert not [n for n in os.listdir(tmp_path / "ck" / "latest") if not n.isdigit()]


def test_checkpoint_restore_missing(tmp_path):
    ck = Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.zeros(2)}, best=True)
    ck.save(1, {"w": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.zeros(2)}, step=2)


@pytest.mark.parametrize("target", [
    {"w": torch.zeros(3)}, {"w": torch.zeros(2, dtype=torch.int64)}, {"v": torch.zeros(2)},
    {"w": 0.0}], ids=["shape", "dtype", "keys", "type"])
def test_checkpoint_restore_rejects_another_structure(tmp_path, target):
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="checkpoint"):
        ck.restore(target)


# --- resume determinism ---

def _ppo(seed, **kw):
    cfg = PPOConfig(horizon=32, epochs=2, num_minibatches=1, fused_loss=True,
                    entropy_coef=0.01, publish_every=kw.pop("publish_every", 1))
    return PPOTrainer("cartpole-balance", cfg, num_envs=8, seed=seed, hidden=(16, 16),
                      device="cpu", **kw)


def _ddpg(seed):
    cfg = DDPGConfig(rollout_steps=4, updates_per_iteration=2, batch_size=16, min_replay=32,
                     replay_capacity=512)
    return DDPGTrainer("cartpole-balance", cfg, num_envs=8, seed=seed, actor_hidden=(16, 16),
                       critic_hidden=(16, 16), device="cpu")


PIXELS = {"height": 48, "width": 48, "action_repeat": 2}


def _pixel_ppo(seed):
    return PPOTrainer("cartpole-balance", PPOConfig(horizon=8, epochs=2, num_minibatches=2),
                      num_envs=4, seed=seed, hidden=(16, 16), device="cpu", pixel_obs=True,
                      pixel_kwargs=PIXELS)


def _pixel_ddpg(seed):
    cfg = DDPGConfig(rollout_steps=4, updates_per_iteration=2, batch_size=8, min_replay=16,
                     replay_capacity=64, shared_encoder=True, aug_shift=2)
    return DDPGTrainer("cartpole-balance", cfg, num_envs=4, seed=seed, actor_hidden=(16, 16),
                       critic_hidden=(16, 16), device="cpu", pixel_obs=True,
                       pixel_kwargs=PIXELS)


MAKERS = {
    "ppo_fused": lambda seed: _ppo(seed),
    "lstm_ppo_publish_every_2": lambda seed: _ppo(seed, use_lstm=True, lstm_size=16,
                                                  publish_every=2),
    # bfloat16 networks (float32 parameters and moments) with their bfloat16 carry
    "lstm_ppo_bf16": lambda seed: _ppo(seed, use_lstm=True, lstm_size=16,
                                       compute_dtype=torch.bfloat16),
    "ddpg": _ddpg,
    "pixel_ppo": _pixel_ppo,
    "pixel_ddpg": _pixel_ddpg,
}


def _leaves(tree, path="fs"):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _assert_equal_states(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


@pytest.mark.parametrize("kind", list(MAKERS))
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, kind):
    straight = MAKERS[kind](0)
    straight.run(4, log_every=4)

    first = MAKERS[kind](0)
    first.run(2, log_every=2)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(2, first.full_state)
    resumed = MAKERS[kind](123)  # another seed: other networks, env batch and generator
    modules = [m for m in vars(resumed.state).values() if isinstance(m, torch.nn.Module)]
    resumed.load_full_state(ck.restore(resumed.full_state))
    assert resumed.global_iter == 2
    assert all(a is b for a, b in zip(
        modules, [m for m in vars(resumed.state).values() if isinstance(m, torch.nn.Module)]))
    resumed.run(2, log_every=2)

    assert resumed.global_iter == 4
    _assert_equal_states(resumed.full_state, straight.full_state)
    if kind == "ddpg":
        assert straight.state.update_step == 8 and straight.replay.total == 16
    if kind.startswith("lstm_ppo_publish"):
        assert straight.state.psync.version == 4
    if kind.endswith("bf16"):
        assert straight.full_state["carry"][0].dtype == torch.bfloat16
    if kind.startswith("pixel"):
        assert straight.full_state["env_state"]["stack"].dtype == torch.uint8
        assert straight.full_state["env_state"]["stack"].shape == (4, 48, 48, 3)


def test_resumed_gym_run_restores_the_learner_not_the_envs(tmp_path):
    """A gym run's checkpoint holds the zero-width env state (torch.save
    takes it; orbax refuses it in the reference). A resumed run restores the
    learner: the network, Adam, the Z-filter, the KL and LR adaptation, the
    counters and the generator. The host envs' state lives in gymnasium and
    cannot be restored: they restart from their seed, so the resumed run is
    not the uninterrupted one."""
    pytest.importorskip("gymnasium")

    def make(seed):
        return PPOTrainer("gym:Pendulum-v1", PPOConfig(horizon=8, epochs=2, num_minibatches=2),
                          num_envs=4, seed=seed, hidden=(16, 16), device="cpu")

    first = make(0)
    first.run(3, log_every=3)  # 24 steps into the first episodes
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(3, first.full_state)
    saved = ck.restore(first.full_state)
    assert saved["env_state"]["q"].shape == (4, 0)
    resumed = make(123)
    resumed.load_full_state(ck.restore(resumed.full_state))
    fs = resumed.full_state
    for key in ("net", "opt", "zfilter", "kl_beta", "lr_scale", "update_step", "generator",
                "global_iter"):
        _assert_equal_states(fs[key], saved[key])
    assert torch.equal(resumed.obs, make(0).obs)  # the seeded reset's observations
    assert not torch.equal(resumed.obs, saved["obs"])
    assert torch.equal(resumed.ep_ret, torch.zeros(4)) and saved["ep_ret"].abs().sum() > 0
    first.run(1, log_every=1)
    resumed.run(1, log_every=1)
    assert not torch.equal(first.obs, resumed.obs)


@pytest.mark.parametrize("kind", ["lstm_ppo", "ddpg"])
def test_resumed_gym_run_starts_fresh_episodes(tmp_path, kind):
    """What belongs to the host envs' old episodes starts fresh with the new
    ones, as at any episode start: LSTM-PPO's carry is `initial_carry`;
    DDPG's OU noise is zero and the ring's last stored step ends its
    episode (done), so no n-step window bootstraps across the restart. The
    learner, and the rest of the ring, are restored bit for bit."""
    pytest.importorskip("gymnasium")

    def make(seed):
        if kind == "lstm_ppo":
            return PPOTrainer("gym:Pendulum-v1", PPOConfig(horizon=8, epochs=2, num_minibatches=2),
                              num_envs=4, seed=seed, hidden=(16, 16), use_lstm=True,
                              lstm_size=8, device="cpu")
        cfg = DDPGConfig(rollout_steps=4, updates_per_iteration=2, batch_size=8, min_replay=16,
                         replay_capacity=256)
        return DDPGTrainer("gym:Pendulum-v1", cfg, num_envs=4, seed=seed, device="cpu",
                           actor_hidden=(16, 16), critic_hidden=(16, 16),
                           env_kwargs={"num_envs": 4})

    first = make(0)
    first.run(3, log_every=3)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(3, first.full_state)
    saved = ck.restore(first.full_state)
    resumed = make(123)
    resumed.load_full_state(ck.restore(resumed.full_state))
    fs = resumed.full_state
    learner = [k for k in saved if k not in resumed.rank_keys] + ["generator"]
    for key in learner:
        _assert_equal_states(fs[key], saved[key])
    if kind == "lstm_ppo":
        assert saved["carry"][0].abs().sum() > 0
        _assert_equal_states(list(resumed.carry),
                             list(resumed.state.net.initial_carry((4,))))
        return
    assert saved["ou_state"].abs().sum() > 0 and torch.equal(fs["ou_state"], torch.zeros(4, 1))
    last = (saved["replay"]["total"] - 1) % resumed.replay.capacity_t
    assert saved["replay"]["total"] == fs["replay"]["total"] == 12
    assert not saved["replay"]["data"]["done"][last].any()
    assert fs["replay"]["data"]["done"][last].all()
    rest = torch.ones(resumed.replay.capacity_t, dtype=torch.bool)
    rest[last] = False
    for k, buf in fs["replay"]["data"].items():
        assert torch.equal(buf[rest], saved["replay"]["data"][k][rest]), k
        if k != "done":
            assert torch.equal(buf[last], saved["replay"]["data"][k][last]), k


# --- a resume under another mesh layout ---

# Layouts (data, model, time, zero); None is one device (no mesh).
# The reference's verdicts, from its CLI on cartpole-balance (8 envs, horizon
# 8, hidden [16,16] for PPO; rollout_steps 4, a ring of 256 and min_replay 16
# for DDPG), each half in a process of its own with
# XLA_FLAGS=--xla_force_host_platform_device_count=data*model*time, checkpointed
# at 64 env steps and resumed to 128:
#   python -m surreal_tpu.cli.main train ppo --env.env_name cartpole-balance
#     --env.num_envs 8 --learner.horizon 8 --learner.hidden [16,16]
#     --session.total_env_steps 64 --session.checkpoint_every_steps 64
#     --session.mesh.data 2 [--session.mesh.model M --session.mesh.time T
#     --learner.zero_optimizer true]
#   then the same with --session.total_env_steps 128 under the resumed layout.
RELAYOUTS = [
    ("ppo", (2, 1, 1, False), None, True),
    ("ppo", (2, 1, 1, False), (4, 1, 1, False), True),
    ("ppo", None, (2, 1, 1, False), True),
    ("ppo", (1, 2, 1, False), None, True),
    ("ppo", (1, 1, 2, False), None, True),
    ("ppo", (2, 2, 1, False), (1, 1, 1, False), True),
    ("ppo", (2, 1, 1, True), (2, 1, 1, False), False),
    ("ppo", (2, 1, 1, False), (2, 1, 1, True), False),
    # the reference: moment chunks (4, 193) against the stored (2, 386)
    ("ppo", (2, 1, 1, True), (4, 1, 1, True), False),
    ("ddpg", (2, 1, 1, False), None, True),
    ("ddpg", (2, 1, 1, False), (4, 1, 1, False), True),
    ("ddpg", (2, 1, 1, True), (2, 1, 1, False), False),
]
# beyond the probe: the generator rule into and out of a model axis, and a
# resume under the writer's own layout (each rank its own file, as written)
RELAYOUTS_BY_RULE = [
    ("ppo", (2, 1, 1, False), (2, 2, 1, False), True),
    ("ppo", (2, 2, 1, False), (2, 1, 1, False), True),
    ("ppo", (1, 2, 1, False), (1, 2, 1, False), True),
]
WHOLE_ENVS = 8
RING_STEPS = 6  # != WHOLE_ENVS: a ring cut along the wrong axis shows


def _layout_id(layout):
    if layout is None:
        return "none"
    return "x".join(map(str, layout[:3])) + ("z" if layout[3] else "")


def _whole_batch(algo, offset):
    """A whole env batch of every kind of rank key, numbered from `offset`."""
    g = torch.Generator().manual_seed(offset)
    batch = {"env_state": {"q": torch.randn(WHOLE_ENVS, 3, generator=g),
                           "t": torch.arange(WHOLE_ENVS) + offset,
                           # a pixel frame stack
                           "stack": torch.randint(0, 256, (WHOLE_ENVS, 6, 6, 3), generator=g,
                                                  dtype=torch.uint8)},
             "obs": torch.randn(WHOLE_ENVS, 5, generator=g),
             "ep_ret": torch.randn(WHOLE_ENVS, generator=g)}
    if algo == "ppo":  # an LSTM carry
        batch["carry"] = [torch.randn(WHOLE_ENVS, 4, generator=g) for _ in range(2)]
    else:
        batch["replay"] = {"data": {"obs": torch.randn(RING_STEPS, WHOLE_ENVS, 5, generator=g),
                                    "done": torch.rand(RING_STEPS, WHOLE_ENVS,
                                                       generator=g) > 0.5},
                           "total": 11}
        batch["ou_state"] = torch.randn(WHOLE_ENVS, 2, generator=g)
    return batch


def _rows(batch, index, shards):
    """Data index `index`'s slice of `shards` of a whole batch, the ring's
    along its env axis (dim 1)."""
    def cut(x, axis):
        if not isinstance(x, torch.Tensor):
            return x
        rows = x.shape[axis] // shards
        return x.narrow(axis, index * rows, rows).clone()

    out = {}
    for key, value in batch.items():
        axis = 1 if key == "replay" else 0
        if isinstance(value, dict):
            out[key] = {k: ({kk: cut(vv, axis) for kk, vv in v.items()} if isinstance(v, dict)
                            else cut(v, axis)) for k, v in value.items()}
        elif isinstance(value, list):
            out[key] = [cut(v, axis) for v in value]
        else:
            out[key] = cut(value, axis)
    return out


def _gen_state(seed):
    return torch.Generator().manual_seed(seed).get_state()


LEARNER = {"net": {"w": torch.arange(6.0).reshape(2, 3)}, "global_iter": 3, "update_step": 12}


def _write_checkpoint(folder, algo, layout):
    """A checkpoint as the port writes it under `layout`: rank r's generator
    is seeded with 100 + r; the ranks of a data index but its model-0,
    time-0 member hold rows of another batch, so a read of the wrong member
    shows."""
    whole, decoy = _whole_batch(algo, 0), _whole_batch(algo, 50)
    os.makedirs(folder)
    if layout is None:
        torch.save({**LEARNER, **whole, "generator": _gen_state(100)}, folder / "state.pt")
        return whole
    data, model, time_, zero = layout
    torch.save(LEARNER, folder / "state.pt")
    with open(folder / "mesh.json", "w") as f:
        json.dump({"data": data, "model": model, "time": time_, "zero": zero}, f)
    for r in range(data * model * time_):
        member = r % (model * time_)
        part = _rows(decoy if member else whole, r // (model * time_), data)
        torch.save({**part, "generator": _gen_state(100 + r)}, folder / f"rank{r}.pt")
    return whole


def _new_ranks(layout):
    """(mesh, data index) of each rank of `layout`; one (None, 0) for one device."""
    if layout is None:
        return [(None, 0)]
    shape = dict(zip(("data", "model", "time"), layout[:3]))
    world = layout[0] * layout[1] * layout[2]
    meshes = [Mesh(shape=shape, rank=r, world_size=world, device=torch.device("cpu"),
                   group=None) for r in range(world)]
    return [(m, m.index["data"]) for m in meshes]


@pytest.mark.parametrize(
    "algo,written,resumed,resumes", RELAYOUTS + RELAYOUTS_BY_RULE,
    ids=[f"{a}-{_layout_id(w)}-to-{_layout_id(r)}" for a, w, r, _ in
         RELAYOUTS + RELAYOUTS_BY_RULE])
def test_resume_under_another_layout(tmp_path, monkeypatch, algo, written, resumed, resumes):
    """Each rank of the resumed layout gets the learner of state.pt and its
    data index's slice of the writer's whole batch, bit for bit, from the
    files of the writer's model-0, time-0 members alone; its generator
    follows checkpoint.py's rule. A refused pair raises ValueError naming
    both layouts before a tensor file is read."""
    whole = _write_checkpoint(tmp_path / "ck" / "latest" / "7", algo, written)
    keys = PPOTrainer.rank_keys if algo == "ppo" else DDPGTrainer.rank_keys
    read = []
    load = torch.load

    def recording_load(path, *a, **k):
        read.append(os.path.basename(path))
        return load(path, *a, **k)

    monkeypatch.setattr(torch, "load", recording_load)
    old_data = 1 if written is None else written[0]
    members = 1 if written is None else written[1] * written[2]
    for mesh, index in _new_ranks(resumed):
        shards = 1 if resumed is None else resumed[0]
        target = {**LEARNER, **_rows(whole, index, shards),
                  "generator": _gen_state(1000 + index)}  # a fresh trainer's fold
        ck = Checkpointer(str(tmp_path / "ck"), mesh=mesh, rank_keys=keys,
                          zero=resumed is not None and resumed[3])
        read.clear()
        if not resumes:
            with pytest.raises(ValueError) as err:
                ck.restore(target)
            for layout in (written, resumed):
                d, m, t, zero = layout
                assert (f"a data mesh of {d}" if m == t == 1 else f"a {d}x{m}x{t}") + \
                    (" with ZeRO" if zero else "") in str(err.value)
            assert read == []
            continue
        got = ck.restore(target)
        _assert_equal_states({k: v for k, v in got.items() if k not in keys}, LEARNER)
        if written == resumed:  # the rank's own file, as written
            assert read == ["state.pt", f"rank{mesh.rank}.pt"]
            continue
        assert read == ["state.pt"] + [f"rank{d * members}.pt" for d in range(old_data)
                                       if written is not None]
        _assert_equal_states({k: v for k, v in got.items() if k in keys and k != "generator"},
                             _rows(whole, index, shards))
        if algo == "ddpg":
            assert got["replay"]["data"]["obs"].shape == (RING_STEPS, WHOLE_ENVS // shards, 5)
            assert got["replay"]["total"] == 11
        unfolded = resumed is not None and resumed[1] > 1
        if index == 0 or unfolded:  # the writer's data index 0
            want = 100
        elif written is not None and written[1] == 1 and index < old_data:
            want = 100 + index * members  # the writer's of the same data index
        else:
            want = 1000 + index  # a fresh start's
        assert torch.equal(got["generator"], _gen_state(want)), (mesh and mesh.rank, want)


def test_resume_under_another_layout_checks_the_ring_totals(tmp_path):
    """The writer's data indices must agree on the ring's count."""
    folder = tmp_path / "ck" / "latest" / "7"
    whole = _write_checkpoint(folder, "ddpg", (2, 1, 1, False))
    part = torch.load(folder / "rank1.pt", weights_only=True)
    part["replay"]["total"] = 12
    torch.save(part, folder / "rank1.pt")
    target = {**LEARNER, **whole, "generator": _gen_state(1000)}
    ck = Checkpointer(str(tmp_path / "ck"), rank_keys=DDPGTrainer.rank_keys)
    with pytest.raises(ValueError, match=r"replay\['total'\] differs"):
        ck.restore(target)
