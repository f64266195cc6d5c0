"""The classic control envs of the port against the JAX package: pendulum,
acrobot (RK4 with ground rows), cartpole with 1, 2 and 3 poles (RK4 with a
limit row), point_mass (tendon actuation) and reacher; and the registry.

For each registered task, on 32 envs from a numpy seed:
- reset: the port's `_init` on the reference's draws (recomputed from its
  keys with the same jax.random calls) against the reference's `_init` on
  those keys, states and observations to TOL_CLOSED = 2e-6 relative
  (closed-form functions, as on cheetah);
- step: one control step with auto-reset (a quarter of the envs at their
  last step) from the same states, actions and reset draws, q, qd, reward
  and both observations to TOL_STEP = 2e-5 relative (one RK4 or Euler step
  with a linear solve; measured below 1e-5 on every task). States within
  1e-5 of an active-set switch are left out (none were, on these states).
Tolerances are relative: |port − ref| ≤ tol · max(1, max |ref|)
(`torch_helpers.assert_close`).
"""

import pytest

from surreal_tpu.envs import registry as jregistry
from surreal_tpu_torch.envs import available_envs, make_env
from torch_helpers import check_reset, check_step

TOL_STEP = 2e-5
TASKS = ["acrobot-swingup", "acrobot-swingup_sparse", "cartpole-balance",
         "cartpole-balance_sparse", "cartpole-swingup", "cartpole-swingup_sparse",
         "cartpole-three_poles", "cartpole-two_poles", "pendulum-swingup", "point_mass-easy",
         "reacher-easy", "reacher-hard"]


@pytest.fixture(scope="module")
def cache():
    return {}


@pytest.mark.parametrize("name", TASKS)
def test_reset_matches_reference(cache, name):
    check_reset(cache, name)


@pytest.mark.parametrize("name", TASKS)
def test_step_with_auto_reset_matches_reference(cache, name):
    check_step(cache, name, 1, TOL_STEP)


def test_registry_matches_reference():
    """The same 26 names; every one builds on the CPU with the reference's
    specs; a gym: name builds the gymnasium adapter, with the reference's
    specs, and needs num_envs as the reference's does."""
    assert available_envs() == jregistry.available_envs()
    for name in available_envs():
        env, ref = make_env(name, device="cpu"), jregistry.make_env(name)
        assert env.episode_steps == ref.episode_steps, name
        assert env.action_spec().shape == ref.action_spec().shape, name
        assert {k: s.shape for k, s in env.obs_spec().items()} == {
            k: s.shape for k, s in ref.obs_spec().items()}, name
    assert type(make_env("dm_control:walker-walk", device="cpu")).__name__ == "Walker"
    with pytest.raises(KeyError):
        make_env("walker-fly", device="cpu")
    pytest.importorskip("gymnasium")
    env = make_env("gym:Pendulum-v1", num_envs=2, device="cpu")
    ref = jregistry.make_env("gym:Pendulum-v1", num_envs=2)
    assert type(env).__name__ == type(ref).__name__ == "GymEnv"
    assert env.episode_steps == ref.episode_steps and env.action_dim == ref.action_dim
    assert env.obs_spec()["observations"].shape == ref.obs_spec()["observations"].shape
    for build in (make_env, jregistry.make_env):
        with pytest.raises(TypeError):
            build("gym:Pendulum-v1")
