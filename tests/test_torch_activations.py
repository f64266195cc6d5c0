"""The MLP torso's activations by name (surreal_tpu_torch/models/blocks.py)
against the reference's, which takes any `flax.linen` activation by name
(`getattr(nn, activation)`, surreal_tpu/models/blocks.py:27): every
elementwise one, on inputs that cross each one's kinks and saturations,
through a two-layer MLP from the same parameters (rtol 1e-6, atol 1e-6:
the same float32 functions, torch's and XLA's transcendental routines
aside). gelu is flax's tanh approximation and leaky_relu's slope flax's
0.01: torch's defaults (exact gelu, slope 0.01) would differ on the first.
A name that is not an elementwise activation of flax.linen is refused."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.models.blocks import MLP as FlaxMLP
from surreal_tpu_torch.models.blocks import _ACTIVATIONS, MLP
from surreal_tpu_torch.models.convert import params_from_flax
import torch_helpers  # noqa: F401  (one torch thread a test process)

ELEMENTWISE = ["celu", "elu", "gelu", "hard_sigmoid", "hard_silu", "hard_swish", "hard_tanh",
               "leaky_relu", "log_sigmoid", "relu", "relu6", "selu", "sigmoid", "silu",
               "soft_sign", "softplus", "swish", "tanh"]


def test_the_port_has_every_elementwise_flax_activation():
    assert sorted(_ACTIVATIONS) == ELEMENTWISE
    assert all(callable(getattr(nn, name)) for name in ELEMENTWISE)


@pytest.mark.parametrize("name", ELEMENTWISE)
def test_activation_matches_flax(name):
    rs = np.random.RandomState(0)
    x = np.concatenate([np.linspace(-8, 8, 33)[:, None].repeat(5, 1),
                        3 * rs.randn(31, 5)]).astype(np.float32)
    # the activation alone, elementwise
    want = np.asarray(getattr(nn, name)(jnp.asarray(x)))
    got = _ACTIVATIONS[name](torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # through the torso
    flax = FlaxMLP(hidden=(16, 16), activation=name)
    params = flax.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = MLP(5, (16, 16), activation=name)
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    np.testing.assert_allclose(port(torch.tensor(x)).detach().numpy(),
                               np.asarray(flax.apply(params, jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["softmax", "glu", "standardize", "no_such"])
def test_other_names_are_refused(name):
    with pytest.raises(ValueError, match="not an elementwise activation of flax.linen"):
        MLP(5, (8,), activation=name)
