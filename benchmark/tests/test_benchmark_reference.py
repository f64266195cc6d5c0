"""The reference against the port at a tiny size on the CPU, and the check
that decides `correct` seeing the faults it exists to see: planted in the
program under a whole run of the harness (its look for a card skipped),
also where only the iteration after the window has it, and planted in the
reference put in the program's place. The control (the reference in TF32)
needs the card: marked `cuda`, it skips elsewhere."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import ppo as drv
from benchmark.reference import judge, producer
from benchmark.tests.bench_fixtures import tiny_cells  # noqa: F401 (a fixture)

SEED = 2**31 + 77  # more than 32 signed bits hold


def run_tiny(cell: str):
    ctx, numbers = harness.run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    cell_def, _ = harness.load_cell(cell)
    return ctx, numbers, harness.checks_against(numbers, cell_def["limits"])[0]


@pytest.mark.parametrize("cell", ["tiny_ppo_mlp.t"])
def test_the_port_agrees_with_the_reference(tiny_cells, cell):
    ctx, numbers, correct = run_tiny(cell)
    assert correct, numbers
    assert ctx["window"]["iterations"] >= 1
    assert numbers["wiring_faults"] == 0 and numbers["skipped_envs"] == 0


def test_the_iteration_after_the_window_starts_from_the_programs_state(tiny_cells):
    """After the window the reference follows the learner's state it is
    handed (moved Adam moments, count and LR scale) and still agrees."""
    cell, config = harness.load_cell("tiny_ppo_mlp.t")
    dev = torch.device("cpu")
    task = drv.load_task(config, dev)
    d = drv.Driver(config, cell["traffic"], SEED, dev, task)
    d.iterate()
    d.iterate()
    d.trainer.state.lr_scale.fill_(1.5)
    cap = d.captured_iteration()
    assert "start" not in cap and cap["learner"]["count"] > 0
    numbers = judge.judge(cap, d.spec, d.cfg, task, dev)
    assert harness.checks_against(numbers, cell["limits"])[0], numbers
    assert numbers["wiring_faults"] == 0


def _half_batch(monkeypatch):
    from surreal_tpu_torch.algos import ppo
    orig = ppo._loss_fn
    monkeypatch.setattr(ppo, "_loss_fn", lambda cfg, net, batch, kl, ent: orig(
        cfg, net, tuple(x[: x.shape[0] // 2] for x in batch), kl, ent))


def _unchanged(monkeypatch):
    from surreal_tpu_torch.algos import ppo
    monkeypatch.setattr(ppo, "apply_gradients",
                        lambda cfg, state, loss, lr, axis=None: torch.zeros(()))


def _reward_altered(monkeypatch):
    from surreal_tpu_torch.envs.cheetah import CheetahRun
    orig = CheetahRun._reward
    monkeypatch.setattr(CheetahRun, "_reward", lambda self, q, qd, a: orig(self, q, qd, a) + 0.01)


def _action_altered(monkeypatch):
    from surreal_tpu_torch.models.distributions import DiagGauss
    monkeypatch.setattr(DiagGauss, "sample",
                        staticmethod(lambda mean, log_std, noise=None, generator=None: mean))


def _stale_lr(monkeypatch):
    from surreal_tpu_torch.algos import ppo
    orig = ppo.apply_gradients
    monkeypatch.setattr(ppo, "apply_gradients", lambda cfg, state, loss, lr, axis=None: orig(
        cfg, state, loss, torch.full_like(lr, cfg.lr), axis))


def _one_leaf_unmoved(monkeypatch):
    from surreal_tpu_torch.algos import ppo
    orig = ppo.apply_gradients

    def apply(cfg, state, loss, lr, axis=None):
        bias = state.net.mean_head.bias
        kept = bias.detach().clone()
        out = orig(cfg, state, loss, lr, axis)
        with torch.no_grad():
            bias.copy_(kept)
        return out
    monkeypatch.setattr(ppo, "apply_gradients", apply)


FAULTS = [_unchanged, _half_batch, _reward_altered, _action_altered, _one_leaf_unmoved]
FAULT_IDS = ["state_unchanged", "half_batch", "reward_altered", "action_altered",
             "one_leaf_unmoved"]


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_a_fault_in_the_program_reads_incorrect(tiny_cells, monkeypatch, fault):
    fault(monkeypatch)
    _, numbers, correct = run_tiny("tiny_ppo_mlp.t")
    assert not correct, numbers


@pytest.mark.parametrize("fault", FAULTS + [_stale_lr], ids=FAULT_IDS + ["lr_scale_ignored"])
def test_a_fault_only_after_the_window_reads_incorrect(tiny_cells, monkeypatch, fault):
    """A fault that sets in only once the window has run (as one on a
    replayed graph would) fails the iteration judged after the window."""
    orig_window = harness.timed_window

    def window(*args, **kwargs):
        out = orig_window(*args, **kwargs)
        fault(monkeypatch)
        return out

    monkeypatch.setattr(harness, "timed_window", window)
    monkeypatch.setattr(drv.Driver, "iterate", _iterate_with_lr_scale(drv.Driver.iterate))
    _, numbers, correct = run_tiny("tiny_ppo_mlp.t")
    assert not correct, numbers


def _iterate_with_lr_scale(iterate):
    """The window's iterations, with the LR's scale moved off 1 as the KL
    adaptation moves it in a long window."""
    def wrapped(self):
        iterate(self)
        self.trainer.state.lr_scale.fill_(1.5)
    return wrapped


def _reference_capture(config_name: str, tiny_cells, fault=None, tf32=False, device="cpu"):
    cell, config = harness.load_cell(config_name)
    dev = torch.device(device)
    task = drv.load_task(config, dev)
    spec, cfg = drv.net_spec(config, task), drv.reference_cfg(config)
    w, rows, start_t, perms = drv.inputs(config, cell["traffic"], spec, task, SEED, dev)
    cap = producer.produce(spec, cfg, task, w, rows, start_t, perms, SEED + 1,
                           tf32=tf32, fault=fault)
    numbers = judge.judge(cap, spec, cfg, task, dev)
    return numbers, harness.checks_against(numbers, cell["limits"])[0]


@pytest.mark.parametrize("cell,fault", [
    ("tiny_ppo_mlp.t", None), ("tiny_ppo_mlp.t", "frozen"), ("tiny_ppo_mlp.t", "half_batch"),
    ("tiny_ppo_mlp.t", "no_noise"), ("tiny_ppo_mlp.t", "altered_reward")])
def test_the_reference_in_the_programs_place(tiny_cells, cell, fault):
    numbers, correct = _reference_capture(cell, tiny_cells, fault)
    assert correct == (fault is None), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_ppo_mlp.t"])
def test_the_tf32_control_reads_incorrect(tiny_cells, cell):
    if not torch.cuda.is_available():
        pytest.skip("the control computes in TF32, which only the card has")
    numbers, correct = _reference_capture(cell, tiny_cells, tf32=True, device="cuda")
    assert not correct, numbers
