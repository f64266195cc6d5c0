"""Checkpoint save/restore with latest + best-by-eval retention (port of
surreal_tpu/train/checkpoint.py, which is built on Orbax).

A checkpoint is one `torch.save` of a nested dict of tensors and Python
scalars (a trainer's `full_state`), loaded back with `weights_only=True`
onto the device of the state it restores into. Each step directory is
written under a temporary name and renamed into place, so a run killed
mid-save leaves the previous checkpoints and no partial one.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Mapping

import torch

STATE_FILE = "state.pt"


class Checkpointer:
    """Directory layout:
        <root>/latest/<step>/state.pt   (rolling, keep `keep_latest`)
        <root>/best/<step>/state.pt     (single best by score)
        <root>/meta.json                ({best_score, best_step})
    """

    def __init__(self, root: str, keep_latest: int = 3):
        self.root = os.path.abspath(root)
        self.keep_latest = keep_latest
        self._dirs = {"latest": os.path.join(self.root, "latest"),
                      "best": os.path.join(self.root, "best")}
        for d in self._dirs.values():
            os.makedirs(d, exist_ok=True)
        self._meta_path = os.path.join(self.root, "meta.json")
        self._meta = {"best_score": None, "best_step": None}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._meta = json.load(f)

    # ---- save ----
    def save(self, step: int, state: Mapping[str, Any], score: float | None = None) -> None:
        """Save rolling-latest; if `score` beats the best so far, also save
        to best/ (best-by-eval-reward retention)."""
        latest = self._publish("latest", step, lambda tmp: torch.save(
            dict(state), os.path.join(tmp, STATE_FILE)))
        self._prune("latest", self.keep_latest)
        if score is not None and (
            self._meta["best_score"] is None or score > self._meta["best_score"]
        ):
            self._publish("best", step, lambda tmp: shutil.copyfile(
                os.path.join(latest, STATE_FILE), os.path.join(tmp, STATE_FILE)))
            self._prune("best", 1)
            self._meta = {"best_score": float(score), "best_step": int(step)}
            tmp = self._meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._meta, f)
            os.replace(tmp, self._meta_path)

    def _publish(self, kind: str, step: int, write) -> str:
        """Writes a step directory under a temporary name, then renames it
        into place (replacing an older one of the same step)."""
        final = os.path.join(self._dirs[kind], str(int(step)))
        tmp = os.path.join(self._dirs[kind], f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        write(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final

    def _prune(self, kind: str, keep: int) -> None:
        for step in self._steps(kind)[:-keep]:
            shutil.rmtree(os.path.join(self._dirs[kind], str(step)))

    def _steps(self, kind: str) -> list[int]:
        return sorted(int(s) for s in os.listdir(self._dirs[kind]) if s.isdigit())

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for (the reference's
        saves may be asynchronous)."""

    # ---- restore ----
    def latest_step(self) -> int | None:
        steps = self._steps("latest")
        return steps[-1] if steps else None

    def restore(self, target: Mapping[str, Any], step: int | None = None,
                best: bool = False) -> dict:
        """Loads the checkpoint of `step` (the newest if None) from latest/
        or best/ onto the device of `target`'s tensors, and checks that it
        has `target`'s structure, shapes and dtypes."""
        kind = "best" if best else "latest"
        if step is None:
            steps = self._steps(kind)
            step = steps[-1] if steps else None
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dirs[kind]}")
        path = os.path.join(self._dirs[kind], str(int(step)), STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        device = next((t.device for t in _tensors(target)), torch.device("cpu"))
        state = torch.load(path, weights_only=True, map_location=device)
        _check_like(state, target, "state")
        return state

    @property
    def best_info(self) -> dict:
        return dict(self._meta)

    def close(self) -> None:
        self.wait()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _check_like(got, want, path: str) -> None:
    """Raises ValueError where `got` differs from `want` in structure,
    tensor shape or dtype, or Python type."""
    if isinstance(want, torch.Tensor):
        if not (isinstance(got, torch.Tensor) and got.shape == want.shape
                and got.dtype == want.dtype):
            raise ValueError(f"checkpoint {path}: expected a {want.dtype} tensor of "
                             f"{tuple(want.shape)}, got {_describe(got)}")
    elif isinstance(want, Mapping):
        if not isinstance(got, Mapping) or set(got) != set(want):
            raise ValueError(f"checkpoint {path}: expected keys {sorted(want)}, "
                             f"got {sorted(got) if isinstance(got, Mapping) else _describe(got)}")
        for k in want:
            _check_like(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"checkpoint {path}: expected {len(want)} items, got "
                             f"{_describe(got)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_like(g, w, f"{path}[{i}]")
    elif type(got) is not type(want):
        raise ValueError(f"checkpoint {path}: expected {type(want).__name__}, got "
                         f"{_describe(got)}")


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a {x.dtype} tensor of {tuple(x.shape)}"
    return type(x).__name__
