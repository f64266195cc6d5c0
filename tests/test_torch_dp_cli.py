"""The port's CLI on a data mesh, on the CPU: `--session.mesh.data 2` (this
command spawns its 2 gloo ranks) and a 2-process `--session.multihost.*`
run of 2 ranks each (the reference's tests/test_multihost.py layout at a
smaller data axis), at tiny flags on cartpole-balance.

Held: config.json is written once, by rank 0; every rank logs the same
evaluation; a run checkpointed at 128 env steps and resumed to 256 ends
with the checkpoint of the uninterrupted run, bit for bit, the learner
and each rank's own part; the data-2 checkpoint resumes under a 1-rank
mesh and on one device, as the reference's does, each run bit for bit a
one-device trainer given the writer's whole env batch; `eval` takes the
learner of a mesh's checkpoint. The ranks' evaluation runs the
reference's 1,000-step episodes (~7 s a run on the CPU: the children do
not see a test's registry); the in-process resumes register
cartpole-balance with 50-step episodes (tests/test_torch_cli.py's
`short_cartpole`), which the one iteration after the checkpoint does not
reach."""

import json
import logging
import os
import re
import shutil
import subprocess
import sys

import torch

from surreal_tpu_torch.cli.configs import generate_configs
from surreal_tpu_torch.cli.main import _build_trainer, _parse_overrides, main
from surreal_tpu_torch.envs import available_envs, registry
from surreal_tpu_torch.envs.cartpole import Cartpole
import torch_helpers  # noqa: F401  (one torch thread a test process)

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


def _short_cartpole(**kw):
    env = Cartpole(swing_up=False, sparse=False, **kw)
    env.episode_steps = 50
    return env


def whole_state(folder):
    """The one-device full state of a mesh's step directory: state.pt's
    learner, the env batch of the model-0, time-0 rank of each data index
    joined along the envs, and data index 0's generator."""
    with open(os.path.join(folder, "mesh.json")) as f:
        layout = json.load(f)
    members = layout.get("model", 1) * layout.get("time", 1)
    parts = [torch.load(os.path.join(folder, f"rank{d * members}.pt"), weights_only=True)
             for d in range(layout["data"])]

    def join(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs)
        if isinstance(xs[0], dict):
            return {k: join([x[k] for x in xs]) for k in xs[0]}
        return type(xs[0])(join([x[i] for x in xs]) for i in range(len(xs[0])))

    state = torch.load(os.path.join(folder, "state.pt"), weights_only=True)
    state.update({k: join([p[k] for p in parts]) for k in parts[0] if k != "generator"})
    state["generator"] = parts[0]["generator"]
    return state


class _Lines(logging.Handler):
    """Keeps the messages logged under `surreal_tpu_torch` while attached."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def resume_on_one_device(tmp_path, monkeypatch, source, step, name, *extra):
    """The checkpoint of run `source` at `step`, copied into experiment
    `name` and resumed by the CLI in this process under `extra` for one
    iteration (64 env steps): its checkpoint holds the new layout's files
    alone and equals, bit for bit, a one-device trainer given the writer's
    whole state (`whole_state`) through load_full_state that ran one
    iteration."""
    src = tmp_path / source / "checkpoints" / "latest" / str(step)
    shutil.copytree(src, tmp_path / name / "checkpoints" / "latest" / str(step))
    argv = _argv(tmp_path, name, step + 64, *extra)
    lines = _Lines()
    logger = logging.getLogger("surreal_tpu_torch")
    with monkeypatch.context() as m:
        available_envs()  # the builtin names first
        m.setitem(registry._REGISTRY, "cartpole-balance", _short_cartpole)
        logger.addHandler(lines)
        try:
            assert main(argv) == 0
        finally:
            logger.removeHandler(lines)
        learner, env_cfg, session = generate_configs("ppo", _parse_overrides(argv[2:-2]))
        twin = _build_trainer(learner, env_cfg, session, "cpu")
        twin.load_full_state(whole_state(src))
        twin.run(1)
    assert [m for m in lines.lines if m.startswith(
        f"resumed from checkpoint @ {step} env steps (iter {step // 64}), written by ")]
    got = _checkpoint(tmp_path / name, step + 64)
    assert set(got) == ({"state.pt", "rank0.pt"} if extra else {"state.pt"})
    merged = {**got["state.pt"], **got.get("rank0.pt", {})}
    _equal(merged, twin.full_state)


def test_data_two_resume_and_eval(tmp_path, monkeypatch):
    # the uninterrupted run and the first half of the stopped one, at once
    data2 = ["--session.mesh.data", "2"]
    (out, text), _ = _finish([_launch(_argv(tmp_path, "straight", 256, *data2)),
                              _launch(_argv(tmp_path, "resumed", 128, *data2))])
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

    # `eval` of the straight run, a process of its own, beside the rest
    evaluating = _launch(["--device", "cpu", "eval", "--experiment", str(exp),
                          "--episodes", "2"])
    _, text = _train(tmp_path, "resumed", 256)
    assert len(re.findall(r"rank\d\] resumed from checkpoint @ 128", text)) == 2
    _equal(_checkpoint(tmp_path / "resumed", 256), straight)

    # a 1-rank mesh, or one device, in this process: no ranks to wait for
    for name, extra in (("one_rank", ["--session.mesh.data", "1"]), ("one_device", [])):
        resume_on_one_device(tmp_path, monkeypatch, "straight", 128, name, *extra)

    ((printed, _),) = _finish([evaluating])
    result = json.loads(printed.strip().splitlines()[-1])
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
