"""The swimmer envs (6 and 15 links, fluid drag, 15 substeps) of the port
against the JAX package: reset and one control step with auto-reset, on 32
envs from a numpy seed (see tests/test_torch_envs_classic.py for what is
compared). In a file of their own: the reference's 15-link step takes ~40 s
to compile on a CPU.

Tolerances, relative (|port − ref| ≤ tol · max(1, max |ref|)): reset
TOL_CLOSED = 2e-6; control step TOL_STEP = 1e-4 for 6 links and 1e-3 for
15. The mass matrix is ill-conditioned: condition numbers ~1.8e4 for 6
links and 1.2e5–1.7e5 on every 15-link state (its smallest eigenvalues,
~4e-6, are the light joints' armature), so each substep's solve carries
float32 rounding (6e-8) × the condition number into the acceleration
along those directions, of which h·qacc reaches qd, 15 times per step.
Measured over one control step: 3e-5 (6 links) and 3.5e-4 (15 links) in
qd, 5e-5 absolute in q; in the mass-matrix norm the 15-link error is
1.8e-4 of |qd|. Neither implementation is closer to the exact step than
that: the reference's own float32 rounding is amplified the same way.
The velocities are moved by N(0, 0.2), not 0.5: at 0.5 one of the 32
15-link swimmers diverges within the step (in both implementations).
"""

import pytest

from torch_helpers import check_reset, check_step

TASKS = {"swimmer-swimmer15": 1e-3, "swimmer-swimmer6": 1e-4}  # TOL_STEP


@pytest.fixture(scope="module")
def cache():
    return {}


@pytest.mark.parametrize("name", sorted(TASKS))
def test_reset_matches_reference(cache, name):
    check_reset(cache, name)


@pytest.mark.parametrize("name", sorted(TASKS))
def test_step_with_auto_reset_matches_reference(cache, name):
    check_step(cache, name, 15, TASKS[name], qd_noise=0.2)
