"""The walker (10 substeps) and hopper (4 substeps, touch from the contact
kinematics) envs of the port against the JAX package: reset and one
control step with auto-reset per registered task, on 32 envs from a numpy
seed (see tests/test_torch_envs_classic.py for what is compared).

Tolerances, relative (|port − ref| ≤ tol · max(1, max |ref|)): reset
TOL_CLOSED = 2e-6; control step TOL_STEP = 2e-5, ground contacts and limits
through 4 or 10 substeps of 20 Jacobi sweeps each (measured below 1e-5).
States within 1e-5 of an active-set switch at any substep are left out (at
most a quarter; none were, on these states). The swimmer is in
tests/test_torch_envs_swimmer.py.
"""

import pytest

from torch_helpers import check_reset, check_step

TOL_STEP = 2e-5
TASKS = {"hopper-hop": 4, "hopper-stand": 4, "walker-run": 10, "walker-stand": 10,
         "walker-walk": 10}


@pytest.fixture(scope="module")
def cache():
    return {}


@pytest.mark.parametrize("name", sorted(TASKS))
def test_reset_matches_reference(cache, name):
    check_reset(cache, name)


@pytest.mark.parametrize("name", sorted(TASKS))
def test_step_with_auto_reset_matches_reference(cache, name):
    check_step(cache, name, TASKS[name], TOL_STEP)


def test_ddpg_trainer_runs_on_walker_walk():
    """DDPGTrainer on walker-walk (its recipe's algorithm), 4 envs, rollouts
    of 4 steps: the first fills the replay's warm-up of 16 transitions, so
    every iteration updates twice; finite metrics."""
    import numpy as np

    from surreal_tpu_torch.algos.ddpg import DDPGConfig
    from surreal_tpu_torch.train import DDPGTrainer

    cfg = DDPGConfig(rollout_steps=4, batch_size=8, replay_capacity=64, min_replay=16,
                     updates_per_iteration=2)
    tr = DDPGTrainer("walker-walk", cfg, num_envs=4, actor_hidden=(16, 16),
                     critic_hidden=(16, 16), seed=0, device="cpu")
    logs = tr.run(3, log_every=1)
    assert all(np.isfinite(v) for m in logs for v in m.values())
    assert tr.state.update_step == 6 and tr.obs.shape == (4, 24)
