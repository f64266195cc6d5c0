"""The port's NaN/Inf guards against the reference's checkify hooks: the
same switch (enable_checks, SURREAL_TPU_CHECKS), the same hook names, a
FloatingPointError on the host naming the first non-finite tensor when on,
and nothing read from the device when off; and the trainers' debug_checks."""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.ops import returns as jret
from surreal_tpu.utils import guards as jguards
from surreal_tpu_torch.algos.ddpg import DDPGConfig
from surreal_tpu_torch.algos.ppo import PPOConfig
from surreal_tpu_torch.ops import returns
from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer
from surreal_tpu_torch.utils import guards
import torch_helpers  # noqa: F401  (one torch thread a test process)

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, B = 8, 4


@pytest.fixture
def checks_on():
    guards.enable_checks(True)
    yield
    guards.enable_checks(False)


def _gae_args(reward_fill=0.0):
    r = torch.full((T, B), reward_fill)
    v = torch.zeros(T, B)
    return r, v, v, torch.ones(T, B), torch.zeros(T, B, dtype=torch.bool), 0.99, 0.95


@pytest.mark.parametrize("backend,name", [("xla", "ops.gae.advantages"),
                                          ("pallas", "ops.gae[pallas].advantages")])
def test_nan_reward_raises_naming_the_gae_hook(checks_on, backend, name):
    returns.gae(*_gae_args(), backend=backend)  # finite: no alarm
    with pytest.raises(FloatingPointError) as e:
        returns.gae(*_gae_args(float("nan")), backend=backend)
    assert str(e.value) == f"non-finite values in {name}"


def test_gae_hook_name_is_the_reference_message():
    """The reference's hook under checkify names the same tensor in the
    same words."""
    f = jguards.checked(lambda r: jret.gae(r, jnp.zeros((T, B)), jnp.zeros((T, B)),
                                           jnp.ones((T, B)), jnp.zeros((T, B), bool),
                                           0.99, 0.95))
    with pytest.raises(Exception) as ref:
        f(jnp.full((T, B), jnp.nan))
    guards.enable_checks(True)
    try:
        with pytest.raises(FloatingPointError) as port:
            returns.gae(*_gae_args(float("nan")))
    finally:
        guards.enable_checks(False)
    assert str(port.value) in str(ref.value)


def _hook_names(paths):
    names = set()
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "assert_finite"
                    and isinstance(node.args[1], ast.Constant)):
                names.add(node.args[1].value)
    return names


def test_hook_names_equal_the_reference():
    ref = _hook_names(sorted((ROOT / "surreal_tpu").rglob("*.py")))
    port = _hook_names(sorted((ROOT / "surreal_tpu_torch").rglob("*.py")))
    assert port == ref == {"ops.gae.advantages", "ops.gae[pallas].advantages",
                           "ppo.update.grad_norm"}


def test_grad_norm_hook(checks_on):
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic

    cfg = PPOConfig()
    state = ppo.init_state(cfg, PPOActorCritic(3, 1, hidden=(4,)), 3)
    def loss(scale=1.0):
        mean, log_std, value = state.net(torch.ones(2, 3))
        return (mean.sum() + log_std.sum() + value.sum()) * scale

    ppo.apply_gradients(cfg, state, loss(), torch.tensor(1e-3))
    with pytest.raises(FloatingPointError, match="non-finite values in ppo.update.grad_norm"):
        ppo.apply_gradients(cfg, state, loss(float("nan")), torch.tensor(1e-3))


class _NoRead:
    """A stand-in tensor that fails on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"the hook touched the tensor ({name}) with checks off")


def test_checks_off_no_raise_and_no_read():
    assert not guards.checks_enabled()
    guards.assert_finite(_NoRead(), "x")
    guards.assert_finite_tree({"a": [_NoRead()]}, "tree")
    adv, _ = returns.gae(*_gae_args(float("nan")))
    assert torch.isnan(adv).all()


def test_tree_names_the_first_non_finite_leaf(checks_on):
    tree = {"net": {"w": torch.ones(2), "b": torch.tensor([1.0, float("inf")])},
            "count": 3, "ids": torch.tensor([1, 2]), "carry": [torch.zeros(1)]}
    with pytest.raises(FloatingPointError, match=r"^non-finite values in fs\['net'\]\['b'\]$"):
        guards.assert_finite_tree(tree, "fs")
    guards.assert_finite_tree({"ok": [torch.ones(3)], "n": 1}, "fs")


@pytest.mark.parametrize("value,want", [("1", True), ("0", False), ("", False),
                                        ("false", False), ("yes", True)])
def test_environment_variable_switch(monkeypatch, value, want):
    """SURREAL_TPU_CHECKS read as the reference reads it, when the module
    is loaded."""
    monkeypatch.setenv("SURREAL_TPU_CHECKS", value)
    try:
        for mod in (jguards, guards):
            assert importlib.reload(mod).checks_enabled() is want, mod.__name__
    finally:
        monkeypatch.delenv("SURREAL_TPU_CHECKS")
        for mod in (jguards, guards):
            importlib.reload(mod)
    assert not guards.checks_enabled()


def test_environment_variable_at_process_start():
    env = dict(os.environ, SURREAL_TPU_CHECKS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", "from surreal_tpu_torch.utils import guards; "
                               "print(guards.checks_enabled())"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "True"


def _tiny_ppo(debug_checks):
    cfg = PPOConfig(horizon=4, epochs=1, num_minibatches=1)
    return PPOTrainer("cartpole-balance", cfg, num_envs=4, seed=0, hidden=(16, 16),
                      device="cpu", debug_checks=debug_checks)


def test_trainer_debug_checks_no_false_alarm():
    tr = _tiny_ppo(True)
    tr.run(2, log_every=2)
    cfg = DDPGConfig(rollout_steps=4, updates_per_iteration=2, batch_size=8, min_replay=16,
                     replay_capacity=256)
    DDPGTrainer("cartpole-balance", cfg, num_envs=4, seed=0, actor_hidden=(16, 16),
                critic_hidden=(16, 16), device="cpu", debug_checks=True).run(2, log_every=2)
    assert not guards.checks_enabled()  # the switch is restored after each iteration


def test_debug_checks_names_a_nan_parameter():
    tr = _tiny_ppo(True)
    tr.run(1, log_every=1)
    with torch.no_grad():
        tr.state.net.actor_torso.dense_0.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError) as e:
        tr.run(1, log_every=1)
    assert str(e.value) == "non-finite values in full_state['net']['actor_torso.dense_0.weight']"
    assert not guards.checks_enabled()
    unchecked = _tiny_ppo(False)
    with torch.no_grad():
        unchecked.state.net.actor_torso.dense_0.weight[0, 0] = float("nan")
    unchecked.run(1, log_every=2)  # no hook fires and no metric is read
    assert np.isnan(unchecked.state.net.actor_torso.dense_0.weight[0, 0].item())
