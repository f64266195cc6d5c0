"""The CLI with ZeRO on the CPU (the model axis: tests/test_torch_tp_cli.py;
the time axis: tests/test_torch_tshard_cli.py): `train ppo
--session.mesh.data 2 --learner.zero_optimizer true`, a process whose 2
gloo ranks are its children (tests/test_torch_dp_cli.py's helpers and
tiny flags), 2 iterations.

Held: the run, stopped after 1 iteration and resumed, ends with the
uninterrupted run's checkpoint bit for bit; the checkpoint's learner is
whole (the moments gathered over the data ranks) and `mesh.json` names
the layout; a resume on one device raises, as the reference's does for a
ZeRO checkpoint; `eval` takes the learner on one device and scores what
the ranks scored."""

import json
import re

import pytest

from surreal_tpu_torch.cli.main import main
from test_torch_dp_cli import (
    _argv,
    _checkpoint,
    _equal,
    _evals,
    _finish,
    _launch,
    resume_on_one_device,
)

ITER = 64  # 8 envs x horizon 8


def _run(tmp_path, name, iters, *flags):
    (out,) = _runs(tmp_path, [(name, iters)], *flags)
    return out


def _runs(tmp_path, runs, *flags):
    """The (name, iterations) runs at once, each a process of its own."""
    return _finish([_launch(_argv(tmp_path, name, iters * ITER, *flags,
                                  "--session.checkpoint_every_steps", str(ITER)))
                    for name, iters in runs])


def check_resume_and_eval(tmp_path, monkeypatch, flags, layout, refusal=None):
    """2 iterations straight; 1, then resumed to 2; on one device, a
    resume for one more iteration (`resume_on_one_device`), or with
    `refusal` the ValueError that matches it; `eval` (also
    tests/test_torch_tp_cli.py's)."""
    # the uninterrupted run and the first half of the stopped one, at once
    (out, text), _ = _runs(tmp_path, [("straight", 2), ("resumed", 1)], *flags)
    assert "2 ranks over gloo" in out
    evals = _evals(text)
    assert set(evals) == {0, 1} and evals[0] == evals[1]
    folder = tmp_path / "straight" / "checkpoints" / "latest" / str(2 * ITER)
    with open(folder / "mesh.json") as f:
        assert json.load(f) == layout
    straight = _checkpoint(tmp_path / "straight", 2 * ITER)
    learner = straight["state.pt"]
    # the learner is whole: the one-device layout
    assert learner["net"]["actor_torso.dense_0.weight"].shape == (16, 5)
    assert learner["opt"]["mu"]["actor_torso.dense_0.weight"].shape == (16, 5)
    assert learner["opt"]["count"] == 8  # 2 iterations x 4 epochs x 1 minibatch

    # `eval` of the straight run, a process of its own, beside the rest
    evaluating = _launch(["--device", "cpu", "eval", "--experiment",
                          str(tmp_path / "straight"), "--episodes", "2"])
    _, text = _run(tmp_path, "resumed", 2, *flags)
    assert len(re.findall(rf"rank\d\] resumed from checkpoint @ {ITER}", text)) == 2
    _equal(_checkpoint(tmp_path / "resumed", 2 * ITER), straight)

    if refusal is None:  # one device, in this process
        resume_on_one_device(tmp_path, monkeypatch, "resumed", 2 * ITER, "one_device")
    else:
        with pytest.raises(ValueError, match=refusal):
            main(_argv(tmp_path, "resumed", 3 * ITER))
    ((printed, _),) = _finish([evaluating])
    result = json.loads(printed.strip().splitlines()[-1])
    assert f"{result['return_mean']:.1f}" in evals[0][-1]


def test_zero_run_resumes_bit_for_bit_and_evaluates(tmp_path, monkeypatch):
    check_resume_and_eval(tmp_path, monkeypatch,
                          ["--session.mesh.data", "2", "--learner.zero_optimizer", "true"],
                          {"data": 2, "model": 1, "time": 1, "zero": True},
                          "written by a data mesh of 2 with ZeRO")
