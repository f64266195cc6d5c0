"""The port's evaluation videos on the CPU: the GIF89a writer decoded by PIL
(frame count, size, loop, frame time, and every pixel within the fixed
palette's error of PALETTE_ERROR grey levels a channel; the port's own
`read_gif` decodes it as PIL does), and
`record_video` of a pixel trainer's policy, whose GIF holds the
rasteriser's frames of the recorded states; the 'mujoco' backend raises
naming its ROADMAP item."""

import numpy as np
import pytest
import torch
from PIL import Image

from surreal_tpu_torch.algos.ppo import PPOConfig
from surreal_tpu_torch.envs.render import make_renderer
from surreal_tpu_torch.train import PPOTrainer, video
from surreal_tpu_torch.train.video import (
    PALETTE_ERROR,
    read_gif,
    record_video,
    rollout_states,
    save_gif,
)


def _decode(path):
    gif = Image.open(path)
    frames = []
    for i in range(gif.n_frames):
        gif.seek(i)
        frames.append(np.asarray(gif.convert("RGB")))
    return gif, np.stack(frames)


@pytest.mark.parametrize("kind", ["noise", "ramp"])
def test_gif_decodes_within_palette_error(tmp_path, kind):
    """Noise fills the LZW table many times over (clear codes, 12-bit
    codes); a ramp visits every level of every channel."""
    rs = np.random.RandomState(0)
    if kind == "noise":
        frames = rs.randint(0, 256, (3, 90, 70, 3)).astype(np.uint8)
    else:
        frames = np.stack([np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None],
                                           (256, 3, 3)).copy() for _ in range(2)])
        frames[1] = frames[1][::-1]
    save_gif(frames, str(tmp_path / "v" / "a.gif"))
    gif, got = _decode(tmp_path / "v" / "a.gif")
    assert gif.n_frames == len(frames) and gif.size == (frames.shape[2], frames.shape[1])
    assert gif.info["loop"] == 0 and gif.info["duration"] == 20  # the reference's 25 ms -> 2 cs
    err = np.abs(got.astype(np.int16) - frames.astype(np.int16))
    assert err.max() <= PALETTE_ERROR
    if kind == "ramp":
        assert err.max() == PALETTE_ERROR  # the bound is tight
    np.testing.assert_array_equal(read_gif(str(tmp_path / "v" / "a.gif")), got)  # as PIL reads it


def test_record_video_of_a_pixel_policy(tmp_path, monkeypatch):
    monkeypatch.setattr(video, "_RENDER_CHUNK", 2)  # 5 states: three render calls joined
    tr = PPOTrainer("cheetah-run", PPOConfig(horizon=4, epochs=1, num_minibatches=1),
                    num_envs=2, hidden=(8, 8), device="cpu", pixel_obs=True,
                    pixel_kwargs={"height": 48, "width": 48, "action_repeat": 2})
    policy, zf = tr.deterministic_policy()
    assert zf is None  # pixels: no Z-filter
    path = str(tmp_path / "videos" / "steps_0.gif")
    ret = record_video(tr.env, policy, path, steps=5, flatten=tr._flatten)
    qs, ret2 = rollout_states(tr.env, policy, 5, flatten=tr._flatten)
    assert qs.shape == (5, tr.env.env.model.nv) and ret == ret2 and np.isfinite(ret)
    want = make_renderer(tr.env.env.model, 168, 168)(torch.tensor(qs)).numpy()
    gif, got = _decode(path)
    assert gif.n_frames == 5 and got.shape == want.shape == (5, 168, 168, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= PALETTE_ERROR
    assert not np.array_equal(want[0], want[-1])  # the states moved
    with pytest.raises(NotImplementedError, match="A16"):
        record_video(tr.env, policy, path, steps=2, backend="mujoco")
