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
from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer
from surreal_tpu_torch.train.checkpoint import Checkpointer


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
