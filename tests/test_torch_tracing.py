"""The port's spans (`utils/profiling.span`) in a profile of a PPO rollout
and update: every layer's span, nested as the program's layers nest, one a
rollout step and one a minibatch step, each a plain `cpu_op` host event;
the same outputs with and without a profiler; nothing recorded by a span
entered with no profiler running; and, on the card, no device event added
by a span. No JAX here: the card's test lives in this file too."""

import dataclasses

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from surreal_tpu_torch.algos import ppo
from surreal_tpu_torch.algos.ppo import PPOConfig
from surreal_tpu_torch.train import PPOTrainer
from surreal_tpu_torch.utils import profiling

torch.set_num_threads(1)  # as torch_helpers sets it for every port test file

# Each span and the span it nests in (None: outermost).
PARENT = {
    "ppo.rollout.step": None,
    "ppo.rollout.policy": "ppo.rollout.step",
    "env.step": "ppo.rollout.step",
    "env.physics": "env.step",
    "physics.dynamics": "env.physics",
    "physics.constraints": "env.physics",
    "env.reward_obs": "env.step",
    "env.reset": "env.step",
    "ppo.rollout.done_check": "ppo.rollout.step",
    "ppo.rollout.finish": None,
    "ppo.update.advantages": None,
    "ppo.update.minibatch": None,
    "ppo.update.loss": "ppo.update.minibatch",
    "ppo.update.backward": "ppo.update.minibatch",
    "ppo.update.allreduce": "ppo.update.backward",
    "ppo.update.optimizer": "ppo.update.minibatch",
    "ppo.update.finish": None,
}
CFG = PPOConfig(horizon=4, epochs=2, num_minibatches=2)
ENVS = 4


def _trainer(device="cpu") -> PPOTrainer:
    """A tiny cheetah trainer whose episodes end at the rollout's second
    step, so the terminal-value forward and the auto-reset's picks run."""
    t = PPOTrainer("cheetah-run", CFG, num_envs=ENVS, seed=3, hidden=(16, 16), device=device)
    t.env_state = dataclasses.replace(
        t.env_state, t=torch.full_like(t.env_state.t, t.env.episode_steps - 2))
    return t


def _rollout_and_update(t: PPOTrainer, horizon: int = CFG.horizon):
    cfg = dataclasses.replace(t.cfg, horizon=horizon)
    traj, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)
    ppo.update(cfg, t.state, traj, t.generator)
    return traj


def _kind(e) -> str | None:
    """The kineto activity type of a raw event, where this torch tells it
    (torch 2.11 does not: then "user_annotation" or None)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    return "user_annotation" if getattr(e, "is_user_annotation", lambda: False)() else None


def _events(prof):
    """(name, start ns, end ns, activity type, on the card) of every
    unhidden kineto event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), _kind(e),
             e.device_type() == DeviceType.CUDA)
            for e in prof.profiler.kineto_results.events()
            if not getattr(e, "is_hidden_event", lambda: False)()]


def _parent(span, spans):
    """The innermost other span that holds `span` in time."""
    name, s, e = span[:3]
    holders = [o for o in spans if o is not span and o[1] <= s and e <= o[2]]
    return max(holders, key=lambda o: (o[1], -o[2]))[0] if holders else None


def test_spans_nest_as_the_layers_do_one_per_step_each_a_cpu_op():
    t = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _rollout_and_update(t)
    events = _events(prof)
    spans = [e for e in events if e[0] in PARENT]
    counts = {n: sum(e[0] == n for e in spans) for n in PARENT}
    steps, minibatches = CFG.horizon, CFG.epochs * CFG.num_minibatches
    assert counts == {
        **{n: steps for n in PARENT if n.startswith(("ppo.rollout.", "env.", "physics."))},
        "ppo.rollout.finish": 1, "ppo.update.advantages": 1, "ppo.update.finish": 1,
        **{n: minibatches for n in ("ppo.update.minibatch", "ppo.update.loss",
                                    "ppo.update.backward", "ppo.update.allreduce",
                                    "ppo.update.optimizer")}}
    for span in spans:
        assert span[3] == "cpu_op" and not span[4], span
        assert _parent(span, spans) == PARENT[span[0]], span
    assert not [n for n in PARENT if "ppo_loss" in n]
    # the terminal-value forward of the step where the episodes end, and only there
    forwards = [any(e[0] == "aten::addmm" and d[1] <= e[1] and e[2] <= d[2] for e in events)
                for d in sorted((s for s in spans if s[0] == "ppo.rollout.done_check"),
                                key=lambda s: s[1])]
    assert forwards == [False, True, False, False]


def test_a_profiler_leaves_the_outputs_bitwise_unchanged():
    out = []
    for profiled in (True, False):
        t = _trainer()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                traj = _rollout_and_update(t)
        else:
            traj = _rollout_and_update(t)
        out.append([getattr(traj, f.name) for f in dataclasses.fields(traj)]
                   + [t.env_state.q, t.env_state.qd, t.obs, t.ep_ret]
                   + list(t.state.net.parameters()) + list(t.state.opt_state.mu.values())
                   + [t.state.zfilter.mean, t.state.lr_scale])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_a_span_entered_with_no_profiler_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("test.outside"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("test.inside"):
                torch.ones(8).sum()
    names = [e[0] for e in _events(prof)]
    assert "test.inside" in names and "test.outside" not in names


@pytest.mark.cuda
def test_spans_add_no_device_event_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = _trainer("cuda")
    _rollout_and_update(t, horizon=1)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _rollout_and_update(t, horizon=1)
        torch.cuda.synchronize()
    events = _events(prof)
    device = [e for e in events if e[4]]
    assert device, "the profiler saw no device event"
    assert not [e for e in device if e[3] in ("gpu_user_annotation", "user_annotation")
                or e[0] in PARENT]
    spans = [e for e in events if e[0] in PARENT]
    # On the card the env step replays CUDA graphs: the stepper's own spans
    # run only while the warm-up's step captures them.
    assert {e[0] for e in spans} == set(PARENT) - {"physics.dynamics", "physics.constraints"}
    assert not [e for e in spans if e[4] or e[3] not in ("cpu_op", None)]
    # with no profiler: no synchronise and no allocation
    before = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(1000):
            with profiling.span("test.off"):
                pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.cuda.memory_allocated() == before
