"""Evaluation videos (port of surreal_tpu/train/video.py).

One env runs under the deterministic policy; its states are rendered by
the rasteriser (`backend='raster'`) or replayed through dm_control's GL
renderer on the host (`backend='mujoco'`: cheetah, walker and cartpole;
mujoco and dm_control are imported there), and written as an animated GIF.
The GIF89a file is written here, with a fixed palette and LZW, so no
imaging package is needed.
"""

from __future__ import annotations

import os
import struct
from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.envs import base as env_base
from surreal_tpu_torch.envs.render import make_renderer
from surreal_tpu_torch.models.z_filter import zfilter_normalize

# The fixed palette: 6 x 7 x 6 levels of red, green and blue (252 colours),
# each channel rounded to its nearest level, so a decoded pixel is within
# PALETTE_ERROR of the frame on every channel.
_LEVELS = (6, 7, 6)
PALETTE_ERROR = 25
# States rendered per call: bounds the rasteriser's (n, size, size, G, 2)
# float32 intermediates to ~58 MB each at size 168 and cheetah's G = 8.
_RENDER_CHUNK = 32


@torch.no_grad()
def rollout_states(env, policy_fn: Callable, steps: int, seed: int = 0, zfilter=None,
                   flatten: Callable | None = None):
    """Runs one env for `steps` control steps under `policy_fn(obs) ->
    action`; returns the q after each step, (steps, nq) numpy, and the
    summed reward."""
    flatten = flatten or env_base.flatten_obs
    generator = torch.Generator(device=env.device).manual_seed(seed)
    env_state, ts = env.reset(1, generator)
    obs, ret, qs = flatten(ts.obs), torch.zeros(1, device=env.device), []
    for _ in range(steps):
        o = zfilter_normalize(zfilter, obs) if zfilter is not None else obs
        env_state, ts = env.step(env_state, policy_fn(o), generator)
        ret = ret + ts.reward
        obs = flatten(ts.carry_obs)
        qs.append(getattr(env_state, "inner", env_state).q[0])  # unwrap PixelState
    return torch.stack(qs).cpu().numpy(), float(ret[0])


def _palette() -> np.ndarray:
    """(256, 3) uint8: the 6 x 7 x 6 cube, index r·42 + g·6 + b, then black."""
    axes = [np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8) for n in _LEVELS]
    cube = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([cube, np.zeros((256 - len(cube), 3), np.uint8)])


def _quantize(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) palette indices, each channel to its
    nearest level."""
    r, g, b = (np.rint(frame[..., i] * ((n - 1) / 255.0)).astype(np.int32)
               for i, n in enumerate(_LEVELS))
    return (r * (_LEVELS[1] * _LEVELS[2]) + g * _LEVELS[2] + b).astype(np.uint8)


def _lzw(indices: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of 8-bit indices, codes packed LSB first; a
    clear code starts the data and restarts the table when it is full."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0
    size, next_code, table = min_size + 1, eoi + 1, {}

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear)
    prefix = indices[0]
    for c in indices[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            size, next_code, table = min_size + 1, eoi + 1, {}
        prefix = c
    emit(prefix)
    emit(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def save_gif(frames: np.ndarray, path: str, fps: int = 40) -> None:
    """Writes (N, H, W, 3) uint8 frames as a GIF89a that loops forever, with
    the reference's frame time (max(1000 / fps, 20) ms, in hundredths)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n, h, w, _ = frames.shape
    delay = max(int(1000 / fps), 20) // 10
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + _palette().tobytes())
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00")
        for frame in frames:
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
            data = _lzw(_quantize(frame).tobytes())
            for i in range(0, len(data), 255):
                f.write(bytes([len(data[i:i + 255])]) + data[i:i + 255])
            f.write(b"\x00")
        f.write(b"\x3b")


def read_gif(path: str) -> np.ndarray:
    """Decodes a GIF that `save_gif` wrote (one global palette, whole-frame
    images, no interlace) to (N, H, W, 3) uint8, for checks where no
    imaging package is installed."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != b"GIF89a":
        raise ValueError(f"{path} is not a GIF89a file")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13
    palette = np.zeros((256, 3), np.uint8)
    if packed & 0x80:
        n = 2 << (packed & 7)
        palette[:n] = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    frames = []
    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # an extension: skip its sub-blocks
            pos += 2
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
            continue
        if data[pos] != 0x2C:
            raise ValueError(f"unexpected block 0x{data[pos]:02x} in {path}")
        pos += 10
        min_size, pos, chunks = data[pos], pos + 1, []
        while data[pos]:
            chunks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += data[pos] + 1
        pos += 1
        idx = np.frombuffer(_unlzw(b"".join(chunks), min_size), np.uint8)[:w * h]
        frames.append(palette[idx].reshape(h, w, 3))
    return np.stack(frames)


def _unlzw(data: bytes, min_size: int) -> bytes:
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits, pos = bytearray(), 0, 0, 0
    size, table, prev = min_size + 1, None, None
    while True:
        while nbits < size and pos < len(data):
            acc |= data[pos] << nbits
            nbits, pos = nbits + 8, pos + 1
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc, nbits = acc >> size, nbits - size
        if code == clear:
            table, size, prev = [bytes([i]) for i in range(clear)] + [b"", b""], min_size + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            table.append(prev + entry[:1])
            if len(table) == (1 << size) and size < 12:
                size += 1
        out += entry
        prev = entry
    return bytes(out)


def record_video(env, policy_fn: Callable, path: str, steps: int = 400, seed: int = 0,
                 zfilter=None, flatten: Callable | None = None, backend: str = "raster",
                 size: int = 168) -> float:
    """Records a deterministic-policy rollout to an animated GIF at `path`;
    returns the summed reward over the recorded steps."""
    if backend not in ("raster", "mujoco"):
        raise ValueError(backend)
    qs, ret = rollout_states(env, policy_fn, steps, seed, zfilter, flatten)
    base_env = getattr(env, "env", env)  # unwrap PixelWrapper
    if backend == "raster":
        render = make_renderer(base_env.model, size, size)
        q = torch.as_tensor(qs, device=env.device)
        with torch.no_grad():
            frames = np.concatenate([render(q[i:i + _RENDER_CHUNK]).cpu().numpy()
                                     for i in range(0, len(q), _RENDER_CHUNK)])
    else:
        frames = _mujoco_frames(base_env, qs, size)
    save_gif(frames, path)
    return ret


def _mujoco_frames(env, qs: np.ndarray, size: int) -> np.ndarray:
    """Ground-truth GL rendering: the q trajectory replayed in dm_control's
    physics (mj_forward per state), camera 0, (N, size, size, 3) uint8.
    Renders through EGL unless MUJOCO_GL says otherwise."""
    os.environ.setdefault("MUJOCO_GL", "egl")
    import mujoco
    from dm_control import suite

    domain = type(env).__module__.rsplit(".", 1)[-1]
    name_map = {"cheetah": ("cheetah", "run"), "walker": ("walker", "walk"),
                "cartpole": ("cartpole", "balance")}
    denv = suite.load(*name_map[domain])
    denv.reset()
    frames = []
    for q in qs:
        denv.physics.data.qpos[:] = q
        mujoco.mj_forward(denv.physics.model._model, denv.physics.data._data)
        frames.append(denv.physics.render(size, size, camera_id=0))
    return np.stack(frames)
