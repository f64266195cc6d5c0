"""The finger (pair rows with the friction cone, dof friction, joint refs,
implicit impulses, touch from the returned impulses; 2 substeps) and
ball_in_cup (pair rows and a rope row; 10 substeps) envs of the port
against the JAX package: reset, including which rejection candidate each
env starts from, and one control step with auto-reset per registered task,
on 32 envs from a numpy seed (see tests/test_torch_envs_classic.py for what
is compared). The manipulator is in tests/test_torch_envs_manipulator.py.

Tolerances, relative (|port − ref| ≤ tol · max(1, max |ref|)): reset
TOL_CLOSED = 2e-6; control step TOL_STEP = 2e-5 (measured below 1e-5).
The start states are moved by N(0, 0.05) so that some of them press
finger and spinner, or ball and cup, together. States within 1e-5 of an
active-set switch at any substep, or whose capsule segments cross, are left
out (at most a quarter).
"""

import numpy as np
import pytest
import torch

from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.envs.physics import engine
from torch_helpers import check_reset, check_step

TOL_STEP = 2e-5
TASKS = {"ball_in_cup-catch": 10, "finger-spin": 2, "finger-turn_easy": 2,
         "finger-turn_hard": 2}


@pytest.fixture(scope="module")
def cache():
    return {}


@pytest.mark.parametrize("name", sorted(TASKS))
def test_reset_matches_reference(cache, name):
    check_reset(cache, name)


@pytest.mark.parametrize("name", sorted(TASKS))
def test_step_with_auto_reset_matches_reference(cache, name):
    check_step(cache, name, TASKS[name], TOL_STEP)


def test_finger_touch_reads_the_pair_impulses():
    """A fingertip pressed into the spinner gives a positive touch reading
    from the impulses the solver returned, summed over both substeps."""
    env = make_env("finger-spin", device="cpu")
    gen = torch.Generator().manual_seed(3)
    q, qd = env._init(env.draw_reset(64, gen))
    q[:, :3] += 0.3 * torch.randn(64, 3, generator=gen)
    pressed = engine._pair_kinematics(env.model, q[:, :3])[2][:, env._tip_pairs].amax(1) > 0
    q2, _ = env._physics_step(q, qd, torch.zeros(64, 2))
    assert pressed.any()
    assert (q2[pressed, 3:5].sum(1) > 0).float().mean() > 0.5
    assert np.all(q2[:, 3:5].numpy() >= 0)
