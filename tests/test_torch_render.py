"""The port's rasteriser against the reference's, on every baked asset: the
geom segments (exactly) and the frames of a batch of four states, at
84 x 84 and at a non-square 48 x 64 (a swapped H and W fails the shape and
the grid), against `jax.vmap(make_renderer(...))`.

Tolerance: a pixel channel may differ by at most 1 grey level, on at most
1% of the channels. A channel is `clip(x, 0, 1) · 255` truncated to uint8,
so a rounding difference of ~1e-7 in x (the sigmoid's, the distance's)
flips a channel whose value sits within that of an integer: measured, at
most 0.01% of the channels, by one level."""

import pathlib

import jax
import numpy as np
import pytest
import torch

from surreal_tpu.envs.physics.model import load as jload
from surreal_tpu.envs import render as jrender
from surreal_tpu_torch.envs import render
from surreal_tpu_torch.envs.base import ASSET_DIR
from surreal_tpu_torch.envs.physics.model import load
import torch_helpers  # noqa: F401  (one torch thread a test process)

ASSETS = sorted(p.stem for p in pathlib.Path(ASSET_DIR).glob("*.npz") if p.stem != "cheetah_pool")
MAX_LEVELS, MAX_SHARE = 1, 0.01


def _states(m, B=4):
    """B states near the model's origin, joints moved by N(0, 0.3)."""
    rs = np.random.RandomState(len(m.parent) * 7 + m.nv)
    return (0.3 * rs.randn(B, m.nv)).astype(np.float32)


def test_every_asset_is_rendered():
    assert len(ASSETS) == 16


@pytest.mark.parametrize("asset", ASSETS)
def test_geom_segments_match_reference(asset):
    path = f"{ASSET_DIR}/{asset}.npz"
    ref, port = jrender._geom_segments(jload(path)), render._geom_segments(load(path))
    for a, b in zip(ref, port, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(84, 84), (48, 64)], ids=["84x84", "48x64"])
@pytest.mark.parametrize("asset", ASSETS)
def test_frames_match_reference(asset, hw):
    path = f"{ASSET_DIR}/{asset}.npz"
    m = load(path)
    q = _states(m)
    ref = np.asarray(jax.jit(jax.vmap(jrender.make_renderer(jload(path), *hw)))(q))
    got = render.make_renderer(m, *hw)(torch.tensor(q)).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (4, *hw, 3)
    diff = np.abs(ref.astype(np.int16) - got.astype(np.int16))
    assert diff.max() <= MAX_LEVELS and (diff > 0).mean() <= MAX_SHARE, (
        diff.max(), (diff > 0).mean())
    assert len(np.unique(got)) > 4  # bodies, ground and background are all in the frame


def test_floating_root_camera_and_grid():
    """A floating root (cheetah) is framed at a fixed height and follows its
    x; a fixed base (cartpole) is framed on the root body. The grid is
    jnp.linspace's float32 formula evaluated in IEEE arithmetic; XLA's CPU
    code for it, eager or jitted (which differ between themselves), lands
    within 2 ulps of it."""
    assert render.root_floats(load(f"{ASSET_DIR}/cheetah.npz"))
    assert not render.root_floats(load(f"{ASSET_DIR}/cartpole.npz"))
    ulp = np.spacing(np.float32(1.2))
    for num in (48, 64, 84, 168):
        grid = render._linspace32(-1.2, 1.2, num)
        assert grid.dtype == np.float32 and grid[0] == np.float32(-1.2) == -grid[-1]
        for ref in (jax.numpy.linspace(-1.2, 1.2, num, dtype=jax.numpy.float32),
                    jax.jit(lambda: jax.numpy.linspace(-1.2, 1.2, num,
                                                       dtype=jax.numpy.float32))()):
            assert np.abs(np.asarray(ref) - grid).max() <= 2 * ulp
    m = load(f"{ASSET_DIR}/cheetah.npz")
    q = torch.zeros(2, m.nv)
    q[1, 0] = 0.6  # the root's x: the camera moves with it, the body stays centred
    frames = render.make_renderer(m)(q)
    assert not torch.equal(frames[0], frames[1])  # the stripes moved
    body = ((frames[..., 0].int() - frames[..., 2].int()) > 5).numpy()  # the tint marks bodies
    assert body[0].mean() > 0.02  # the cheetah is in view
    assert (body[0] != body[1]).mean() <= MAX_SHARE  # up to the rounding of x + grid
