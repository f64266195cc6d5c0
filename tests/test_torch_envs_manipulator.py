"""The manipulator envs (ground, wall, 73 or 101 pair rows, limits, the
equality row, tendon actuation, rotated body frames; touch from the
returned impulses; 10 substeps) of the port against the JAX package:
reset, including which of the 16 rejection candidates each env starts
from, and one control step with auto-reset per registered task, on 32 envs
from a numpy seed (see tests/test_torch_envs_classic.py for what is
compared). In a file of their own: each reference step takes ~20 s to
compile on a CPU.

Tolerances, relative (|port − ref| ≤ tol · max(1, max |ref|)): reset
TOL_CLOSED = 2e-6; control step TOL_STEP = 2e-5 (measured below 1e-5).
States within 1e-5 of an active-set switch at any substep, or whose capsule
segments cross, are left out (at most a quarter).
"""

import pytest

from torch_helpers import check_reset, check_step

TOL_STEP = 2e-5
TASKS = ["manipulator-bring_ball", "manipulator-bring_peg"]


@pytest.fixture(scope="module")
def cache():
    return {}


@pytest.mark.parametrize("name", TASKS)
def test_reset_matches_reference(cache, name):
    check_reset(cache, name)


@pytest.mark.parametrize("name", TASKS)
def test_step_with_auto_reset_matches_reference(cache, name):
    check_step(cache, name, 10, TOL_STEP)
