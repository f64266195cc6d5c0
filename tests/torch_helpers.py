"""What the port's parity tests on cheetah-run share: numpy -> torch, a
relative closeness check, the reference's auto-reset draws and the port's
cheetah env replaying them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from surreal_tpu_torch.envs.cheetah import CheetahRun


def to_torch(x):
    return torch.tensor(np.asarray(x))


def assert_close(ref, port, tol, name):
    """|ref − port| <= tol · max(1, max|ref|)."""
    ref = np.asarray(ref)
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    err = np.abs(ref.astype(np.float64) - port).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (name, err)


def reference_reset_rows(env, env_state, dones):
    """The reset-pool row every env of the reference draws at each step of a
    rollout whose done flags were `dones` (T, B): the draw comes from the
    env's key, which moves on only when the env resets."""
    n_pool = env._pool_q.shape[0]
    keys, rows = env_state.key, []
    for done in np.asarray(dones):
        rows.append(np.asarray(jax.vmap(
            lambda k: jax.random.randint(jax.random.split(k)[0], (), 0, n_pool))(keys)))
        keys = jnp.where(done[:, None], jax.vmap(lambda k: jax.random.split(k)[1])(keys), keys)
    return rows


class ScriptedResets(CheetahRun):
    """The port's cheetah env, auto-resetting to the reference's pool rows."""

    def __init__(self, rows):
        super().__init__(device="cpu")
        self._rows = [torch.tensor(r) for r in rows]

    def draw_reset_rows(self, batch, generator):
        return self._rows.pop(0)
