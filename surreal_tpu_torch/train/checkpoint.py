"""Checkpoint save/restore with latest + best-by-eval retention (port of
surreal_tpu/train/checkpoint.py, which is built on Orbax).

A checkpoint is one `torch.save` of a nested dict of tensors and Python
scalars (a trainer's `full_state`), loaded back with `weights_only=True`
onto the device of the state it restores into. Each step directory is
written under a temporary name and renamed into place, so a run killed
mid-save leaves the previous checkpoints and no partial one.

Under a mesh every rank calls `save` and `restore`, in the same order.
The learner is written once, by rank 0, to `state.pt`, whole: the
trainers' full state gathers ZeRO's moment chunks over the data ranks and
a tensor-parallel network's shards (and their moments) over the model
ranks, so `state.pt` holds what a one-device run's does, and each rank
takes its chunk or shard again on load. Each rank writes its own part (the
trainer's `rank_keys`: its envs, generator, carry, OU noise, replay shard)
to `rank<r>.pt`, and rank 0 writes `mesh.json`, the axis sizes and ZeRO
({"data": D, "model": M, "time": T, "zero": bool}). Every collective (the
gathers, the barriers) is reached by every rank; only the file writes are
rank 0's. `restore` does no collective: each rank reads the files it needs
on its own.

A checkpoint resumes under another layout where the reference's restore
(orbax, by the new run's sharded target) does: data, model and time may
change (a one-device run counts as data 1, model 1, time 1), but ZeRO must
be the same on both sides, and with ZeRO so must the data axis (the
reference's moments are (zero_shards, chunk) arrays). Any other change
raises ValueError, naming both layouts, before a tensor is read.
`learner_only` (an evaluation) takes the learner of any layout. The rank
keys are then cut from the whole env batch: the files of one rank for each
of the writer's data indices (its model-0, time-0 member: the ranks of one
data index hold the same batch), read on the host and joined in data-index
order (a one-device checkpoint is the whole batch already), along each
tensor's dim 0, but along dim 1 for the replay ring's (T_cap, B, ...)
tensors; Python values (the ring's `total`) must agree. A rank takes rows
[d·B/S, (d+1)·B/S) for its data index d of S, as `parallel.dp` slices a
fresh batch, and moves only those to its device. Its generator is, by
rule: data index 0's of the writer where the rank's data index is 0 or the
run keeps every rank on one unfolded stream (a model axis); else the
writer's of the same data index where the writer had that index on a
stream of its own (a mesh without a model axis); else the one `target`
holds, a fresh trainer's `parallel.dp.fold_in` of the seed and the index.
A resume under the writer's layout reads this rank's own file, as written.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Mapping

import torch

from surreal_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, barrier

STATE_FILE = "state.pt"
MESH_FILE = "mesh.json"
# A one-device run's layout, for the resume rule.
ONE_DEVICE = {"data": 1, "model": 1, "time": 1, "zero": False}
# The rank keys' env axis: dim 0 of every tensor but the replay ring's
# (T_cap, B, ...) ones (the reference's P(None, DATA_AXIS)).
ENV_AXIS = {"replay": 1}


class Checkpointer:
    """Directory layout:
        <root>/latest/<step>/state.pt   (rolling, keep `keep_latest`)
        <root>/best/<step>/state.pt     (single best by score)
        <root>/meta.json                ({best_score, best_step})
    and under a mesh, beside each state.pt, rank<r>.pt and mesh.json.
    """

    def __init__(self, root: str, keep_latest: int = 3, mesh: Mesh | None = None,
                 rank_keys: tuple[str, ...] = (), zero: bool = False):
        """`zero`: the run's optimizer is ZeRO's (its moments are split over
        the data axis), part of the layout a checkpoint resumes under."""
        self.root = os.path.abspath(root)
        self.keep_latest = keep_latest
        self.mesh = mesh
        self.layout = None if mesh is None else {**mesh.layout(), "zero": bool(zero)}
        self.rank_keys = tuple(rank_keys)
        self._primary = mesh is None or mesh.primary
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
        to best/ (best-by-eval-reward retention). Under a mesh, every rank
        calls it with its own `state` and the same `score`."""
        latest = self._publish("latest", step, lambda tmp: self._write(tmp, state))
        self._prune("latest", self.keep_latest)
        if score is not None and (
            self._meta["best_score"] is None or score > self._meta["best_score"]
        ):
            def copy(tmp):
                if self._primary:
                    for name in os.listdir(latest):
                        shutil.copyfile(os.path.join(latest, name), os.path.join(tmp, name))

            self._publish("best", step, copy)
            self._prune("best", 1)
            self._meta = {"best_score": float(score), "best_step": int(step)}
            if self._primary:
                tmp = self._meta_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(self._meta, f)
                os.replace(tmp, self._meta_path)

    def _write(self, tmp: str, state: Mapping[str, Any]) -> None:
        if self.mesh is None:
            torch.save(dict(state), os.path.join(tmp, STATE_FILE))
            return
        if self._primary:
            torch.save({k: v for k, v in state.items() if k not in self.rank_keys},
                       os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, MESH_FILE), "w") as f:
                json.dump(self.layout, f)
        torch.save({k: v for k, v in state.items() if k in self.rank_keys},
                   os.path.join(tmp, f"rank{self.mesh.rank}.pt"))

    def _publish(self, kind: str, step: int, write) -> str:
        """Writes a step directory under a temporary name, then renames it
        into place (replacing an older one of the same step). Under a mesh,
        every rank writes into rank 0's temporary directory between
        barriers."""
        final = os.path.join(self._dirs[kind], str(int(step)))
        tmp = os.path.join(self._dirs[kind], f".tmp-{int(step)}-{os.getpid()}"
                           if self.mesh is None else f".tmp-{int(step)}-mesh")
        if self._primary:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        barrier(self.mesh)
        write(tmp)
        barrier(self.mesh)
        if self._primary:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        barrier(self.mesh)
        return final

    def _prune(self, kind: str, keep: int) -> None:
        if not self._primary:
            return
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
                best: bool = False, learner_only: bool = False) -> dict:
        """Loads the checkpoint of `step` (the newest if None) from latest/
        or best/ onto the device of `target`'s tensors, and checks that it
        has `target`'s structure, shapes and dtypes. Under a mesh, the
        learner and this rank's part, cut anew where another layout wrote
        it (the module's docstring). `learner_only` takes the learner from
        the checkpoint, whatever mesh wrote it, and `rank_keys` from
        `target` (an evaluation needs no env batch)."""
        folder = self._folder(step, best)
        path = os.path.join(folder, STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        device = next((t.device for t in _tensors(target)), torch.device("cpu"))
        if learner_only:
            state = torch.load(path, weights_only=True, map_location=device)
            state = {k: v for k, v in state.items() if k not in self.rank_keys}
            state.update({k: v for k, v in target.items() if k in self.rank_keys})
        else:
            written = _mesh_layout(folder)
            if not _resumable(written, self.layout):
                raise ValueError(
                    f"checkpoint {folder} was written by {describe_layout(written)} and this "
                    f"run has {describe_layout(self.layout)}: a checkpoint resumes under "
                    "another layout only with the same learner.zero_optimizer, and one "
                    "written with ZeRO only under the same session.mesh.data")
            if written == self.layout:
                state = torch.load(path, weights_only=True, map_location=device)
                if self.mesh is not None:
                    state.update(torch.load(os.path.join(folder, f"rank{self.mesh.rank}.pt"),
                                            weights_only=True, map_location=device))
            else:
                state = self._relayout(folder, written, target, device)
        _check_like(state, target, "state")
        return state

    def written_layout(self, step: int | None = None, best: bool = False) -> dict | None:
        """The layout that wrote the checkpoint of `step` (the newest if
        None): {"data", "model", "time", "zero"}, or None for one device."""
        return _mesh_layout(self._folder(step, best))

    def _folder(self, step: int | None, best: bool) -> str:
        kind = "best" if best else "latest"
        if step is None:
            steps = self._steps(kind)
            step = steps[-1] if steps else None
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dirs[kind]}")
        return os.path.join(self._dirs[kind], str(int(step)))

    def _relayout(self, folder: str, written: dict | None, target: Mapping[str, Any],
                  device: torch.device) -> dict:
        """The learner of `folder` and this rank's part of its whole env
        batch under the run's layout, assembled on the host and moved to
        `device`."""
        state = torch.load(os.path.join(folder, STATE_FILE), weights_only=True,
                           map_location="cpu")
        if written is None:  # one device: state.pt holds the whole batch
            parts = [{k: state.pop(k) for k in self.rank_keys if k in state}]
        else:  # one rank of each data index: its model-0, time-0 member
            members = written["model"] * written["time"]
            parts = [torch.load(os.path.join(folder, f"rank{d * members}.pt"),
                                weights_only=True, map_location="cpu")
                     for d in range(written["data"])]
        layout = self.layout or ONE_DEVICE
        index = 0 if self.mesh is None else self.mesh.index[DATA_AXIS]
        for key in parts[0]:
            if key != "generator":
                axis = ENV_AXIS.get(key, 0)
                whole = _join([p[key] for p in parts], axis, key)
                state[key] = _cut(whole, axis, index, layout["data"], key)
        written = written or ONE_DEVICE
        if index == 0 or layout["model"] > 1:
            state["generator"] = parts[0]["generator"]
        elif written["model"] == 1 and index < len(parts):
            state["generator"] = parts[index]["generator"]
        else:
            state["generator"] = target["generator"]
        return _to(state, device)

    @property
    def best_info(self) -> dict:
        return dict(self._meta)

    def close(self) -> None:
        self.wait()


def _mesh_layout(folder: str) -> dict | None:
    """The layout that wrote a step directory; None for one device. A data
    mesh's checkpoint from before the model and time axes reads as one with
    model 1, time 1 and no ZeRO."""
    path = os.path.join(folder, MESH_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return {"model": 1, "time": 1, "zero": False, **json.load(f)}


def _resumable(written: dict | None, layout: dict | None) -> bool:
    """Whether a checkpoint written under `written` resumes under `layout`
    (None: one device), by the reference's rule: the same ZeRO, and with
    ZeRO the same data axis."""
    w, n = written or ONE_DEVICE, layout or ONE_DEVICE
    return w["zero"] == n["zero"] and (not w["zero"] or w["data"] == n["data"])


def describe_layout(layout: dict | None) -> str:
    if layout is None:
        return "one device (no mesh)"
    d, m, t = layout["data"], layout["model"], layout["time"]
    mesh = f"a data mesh of {d}" if m == t == 1 else f"a {d}x{m}x{t} (data x model x time) mesh"
    return mesh + (" with ZeRO" if layout["zero"] else "")


def _join(parts: list, axis: int, path: str):
    """The data indices' parts of one rank key joined along the env `axis`;
    Python values must agree."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, axis)
    if isinstance(first, Mapping):
        return {k: _join([p[k] for p in parts], axis, f"{path}[{k!r}]") for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_join([p[i] for p in parts], axis, f"{path}[{i}]")
                           for i in range(len(first)))
    if any(p != first for p in parts):
        raise ValueError(f"checkpoint {path} differs between the writer's data indices: {parts}")
    return first


def _cut(tree, axis: int, index: int, shards: int, path: str):
    """Data index `index`'s rows of `shards` along the env `axis`."""
    if isinstance(tree, torch.Tensor):
        if tree.shape[axis] % shards:
            raise ValueError(f"checkpoint {path}: {tree.shape[axis]} envs do not split over "
                             f"a data axis of {shards}")
        rows = tree.shape[axis] // shards
        return tree.narrow(axis, index * rows, rows).clone()
    if isinstance(tree, Mapping):
        return {k: _cut(v, axis, index, shards, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cut(v, axis, index, shards, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return tree


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, Mapping):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


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
