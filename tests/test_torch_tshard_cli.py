"""The CLI on the time axis, on the CPU: `train ppo --session.mesh.time 2`
(a process whose 2 gloo ranks are its children; tests/test_torch_dp_cli.py's
helpers and tiny flags) trains 2 iterations; both ranks log the same
evaluation, the checkpoint's `mesh.json` names the layout, and the two
time ranks hold one env batch."""

import json

import torch

from test_torch_dp_cli import _checkpoint, _evals
from test_torch_mesh_cli import ITER, _run


def test_time_axis_trains(tmp_path):
    out, text = _run(tmp_path, "time", 2, "--session.mesh.time", "2")
    assert "2 ranks over gloo" in out
    evals = _evals(text)
    assert set(evals) == {0, 1} and evals[0] == evals[1]
    with open(tmp_path / "time" / "checkpoints" / "latest" / str(2 * ITER) / "mesh.json") as f:
        assert json.load(f) == {"data": 1, "model": 1, "time": 2, "zero": False}
    ck = _checkpoint(tmp_path / "time", 2 * ITER)
    assert torch.equal(ck["rank0.pt"]["obs"], ck["rank1.pt"]["obs"])  # time ranks: one batch
