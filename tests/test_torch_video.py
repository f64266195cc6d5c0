"""The port's evaluation videos on the CPU: the GIF89a writer decoded by PIL
(frame count, size, loop, frame time, and every pixel within the fixed
palette's error of PALETTE_ERROR grey levels a channel; the port's own
`read_gif` decodes it as PIL does), and
`record_video` of a pixel trainer's policy, whose GIF holds the
rasteriser's frames of the recorded states; the 'mujoco' backend's frames
equal the reference's on the same q trajectory, in a process of their own
with MUJOCO_GL=egl (dm_control picks its GL platform when it is first
imported)."""

import json
import os
import subprocess
import sys

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
import torch_helpers  # noqa: F401  (one torch thread a test process)


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
    with pytest.raises(ValueError, match="opengl"):
        record_video(tr.env, policy, path, steps=2, backend="opengl")


MUJOCO_FRAMES = r"""
import json, sys
import numpy as np
import torch
from surreal_tpu.envs import make_env as ref_make_env
from surreal_tpu.train import video as ref_video
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.train import video

out = {}
for name in ("cheetah-run", "walker-walk", "cartpole-balance"):
    env, ref = make_env(name, device="cpu"), ref_make_env(name)
    qs = np.random.RandomState(0).uniform(-0.4, 0.4, (4, env.model.nv))
    mine, theirs = video._mujoco_frames(env, qs, 48), ref_video._mujoco_frames(ref, qs, 48)
    out[name] = {"shape": list(mine.shape), "dtype": str(mine.dtype),
                 "equal": bool(np.array_equal(mine, theirs)),
                 "moved": bool(not np.array_equal(mine[0], mine[-1]))}
env = make_env("cheetah-run", device="cpu")
policy = lambda obs: torch.zeros(obs.shape[0], env.action_dim)
path = sys.argv[1]
ret = video.record_video(env, policy, path, steps=3, backend="mujoco", size=40)
qs, ret2 = video.rollout_states(env, policy, 3)
err = np.abs(video.read_gif(path).astype(int) - video._mujoco_frames(env, qs, 40)).max()
out["record"] = {"gif_error": int(err), "same_return": ret == ret2}
try:
    video._mujoco_frames(make_env("finger-spin", device="cpu"), qs[:1, :0], 40)
except KeyError as e:
    out["finger"] = repr(e)
print(json.dumps(out))
"""


def test_mujoco_backend_frames_equal_reference(tmp_path):
    pytest.importorskip("dm_control")
    env = {**os.environ, "MUJOCO_GL": "egl", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", MUJOCO_FRAMES, str(tmp_path / "m.gif")],
                          capture_output=True, text=True, env=env, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("cheetah-run", "walker-walk", "cartpole-balance"):
        assert out[name] == {"shape": [4, 48, 48, 3], "dtype": "uint8", "equal": True,
                             "moved": True}, name
    assert out["record"]["gif_error"] <= PALETTE_ERROR and out["record"]["same_return"]
    assert "finger" in out["finger"]  # the reference's name map: cheetah, walker, cartpole
