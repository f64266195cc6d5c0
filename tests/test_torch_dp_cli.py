"""The port's CLI on a data mesh, on the CPU: `--session.mesh.data 2` (this
command spawns its 2 gloo ranks) and a 2-process `--session.multihost.*`
run of 2 ranks each (the reference's tests/test_multihost.py layout at a
smaller data axis), at tiny flags on cartpole-balance.

Held: config.json is written once, by rank 0; every rank logs the same
evaluation; a run checkpointed at 128 env steps and resumed to 256 ends
with the checkpoint of the uninterrupted run, bit for bit, the learner
and each rank's own part; a resume under another mesh.data raises; `eval`
takes the learner of a mesh's checkpoint. The ranks' evaluation runs the
reference's 1,000-step episodes (~7 s a run on the CPU: the children do
not see a test's registry)."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from surreal_tpu_torch.cli.main import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--env.env_name", "cartpole-balance", "--env.num_envs", "8",
        "--session.eval_episodes", "2", "--learner.horizon", "8",
        "--learner.hidden", "[16,16]", "--learner.num_minibatches", "1",
        "--session.checkpoint_every_steps", "128"]


ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")  # one torch thread a rank
TIMEOUT_S = 150


def _argv(tmp_path, name, total, *extra):
    return ["train", "ppo", *ARGS, "--session.total_env_steps", str(total),
            "--session.eval_every_steps", str(total), "--session.results_dir", str(tmp_path),
            "--session.experiment_name", name, *extra, "--device", "cpu"]


def _launch(argv, **env):
    """The CLI in a process of its own, whose ranks are its children."""
    return subprocess.Popen([sys.executable, "-m", "surreal_tpu_torch.cli.main", *argv],
                            env=dict(ENV, **env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs):
    """(stdout, stderr) of each process; kills them all and fails if one
    outlives TIMEOUT_S or exits non-zero."""
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def _train(tmp_path, name, total, *extra):
    """A data-2 run, (stdout, stderr)."""
    (out,) = _finish([_launch(_argv(tmp_path, name, total, "--session.mesh.data", "2",
                                    *extra))])
    return out


def _evals(text):
    """{rank: [eval lines]} from the ranks' log lines."""
    out = {}
    for rank, line in re.findall(r"cli\.rank(\d+)\] (eval @ .*)", text):
        out.setdefault(int(rank), []).append(line)
    return out


def _checkpoint(exp, step):
    folder = exp / "checkpoints" / "latest" / str(step)
    return {name: torch.load(folder / name, weights_only=True)
            for name in sorted(os.listdir(folder)) if name.endswith(".pt")}


def _equal(a, b, path="ck"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_data_two_resume_and_eval(tmp_path, capfd):
    out, text = _train(tmp_path, "straight", 256)
    assert len(re.findall(r"wrote .*config\.json", text)) == 1
    assert "2 ranks over gloo (the ranks run on the CPU)" in out
    for r in (0, 1):
        assert f"rank {r} of 2 on cpu: LOCAL_RANK {r} of LOCAL_WORLD_SIZE 2" in text
    evals = _evals(text)
    assert set(evals) == {0, 1} and evals[0] == evals[1] and len(evals[0]) == 1
    exp = tmp_path / "straight"
    with open(exp / "config.json") as f:
        assert json.load(f)["session"]["mesh"]["data"] == 2
    straight = _checkpoint(exp, 256)
    assert set(straight) == {"state.pt", "rank0.pt", "rank1.pt"}
    with open(exp / "checkpoints" / "latest" / "256" / "mesh.json") as f:
        assert json.load(f) == {"data": 2, "model": 1, "time": 1, "zero": False}
    assert "generator" in straight["rank1.pt"] and "net" in straight["state.pt"]
    assert not torch.equal(straight["rank0.pt"]["obs"], straight["rank1.pt"]["obs"])

    _train(tmp_path, "resumed", 128)
    _, text = _train(tmp_path, "resumed", 256)
    assert len(re.findall(r"rank\d\] resumed from checkpoint @ 128", text)) == 2
    _equal(_checkpoint(tmp_path / "resumed", 256), straight)

    # one device, or a 1-rank mesh, in this process: no ranks to wait for
    for extra in (["--session.mesh.data", "1"], []):
        with pytest.raises(ValueError, match="written by a data mesh of 2"):
            main(_argv(tmp_path, "resumed", 384, *extra))

    capfd.readouterr()
    assert main(["--device", "cpu", "eval", "--experiment", str(exp), "--episodes", "2"]) == 0
    result = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert f"{result['return_mean']:.1f}" in evals[0][0]


def test_two_process_multihost_run(tmp_path):
    """Two launched processes of 2 ranks each: global rank = process_id x 2
    + i, one data axis of 4, meeting at a file store."""
    store = "file://" + str(tmp_path / "store")
    argv = _argv(tmp_path, "mh", 128, "--session.mesh.data", "4",
                 "--session.multihost.coordinator", store,
                 "--session.multihost.num_processes", "2")
    # the two processes share this host: torchrun's LOCAL_RANK and LOCAL_WORLD_SIZE
    outs = _finish([_launch([*argv, "--session.multihost.process_id", str(i)],
                            LOCAL_RANK=str(i), LOCAL_WORLD_SIZE="2") for i in (0, 1)])
    text = outs[0][1] + outs[1][1]
    assert "4 ranks over gloo" in outs[0][0]
    assert len(re.findall(r"wrote .*config\.json", text)) == 1
    assert len(re.findall(r"wrote .*config\.json", outs[0][1])) == 1  # process 0 holds rank 0
    evals = _evals(text)
    assert set(evals) == {0, 1, 2, 3} and len({tuple(v) for v in evals.values()}) == 1
    assert set(_evals(outs[1][1])) == {2, 3}
    for r in range(4):  # the host's ranks 0..3 of 4, so each would take its own card
        assert f"rank {r} of 4 on cpu: LOCAL_RANK {r} of LOCAL_WORLD_SIZE 4" in text
    ck = _checkpoint(tmp_path / "mh", 128)
    assert set(ck) == {"state.pt", "rank0.pt", "rank1.pt", "rank2.pt", "rank3.pt"}
    assert ck["rank3.pt"]["obs"].shape == (2, 5)  # 8 envs over 4 ranks
