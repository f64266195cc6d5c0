"""The port's CLI in process on the CPU (`main([..., "--device", "cpu"])`),
held to the expectations of the reference's tests/test_checkpoint_cli.py
on its tiny cartpole-balance run (8 envs, horizon 8, (16, 16), one
minibatch): config.json, checkpoints at the reference's steps, kill and
resume, eval from the latest and the best checkpoint, `envs`, the mesh
layouts the reference refuses, one DDPG run, and a pixel run with its eval
video.

A CPU cartpole control step takes ~13 ms, so a 1,000-step evaluation
would take most of a minute: these tests register cartpole-balance with
50-step episodes (`registry.register`), which changes nothing the CLI
does."""

import json
import logging
import math
import os
import subprocess
import sys

import pytest
import torch

from surreal_tpu.cli.configs import generate_configs as ref_generate_configs
from surreal_tpu_torch.cli.configs import generate_configs
from surreal_tpu_torch.cli.main import main
from surreal_tpu_torch.envs import available_envs, registry
from surreal_tpu_torch.envs.cartpole import Cartpole
import torch_helpers  # noqa: F401  (one torch thread a test process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODE_STEPS = 50
ENV = ["--env.env_name", "cartpole-balance", "--env.num_envs", "8",
       "--session.eval_episodes", "2"]
TINY = {"ppo": ["--learner.horizon", "8", "--learner.hidden", "[16,16]",
                "--learner.num_minibatches", "1"],
        "ddpg": ["--learner.rollout_steps", "4", "--learner.updates_per_iteration", "2",
                 "--learner.batch_size", "16", "--learner.min_replay", "32",
                 "--learner.replay_capacity", "512", "--learner.actor_hidden", "[16,16]",
                 "--learner.critic_hidden", "[16,16]"]}


def short_cartpole(**kw):
    env = Cartpole(swing_up=False, sparse=False, **kw)
    env.episode_steps = EPISODE_STEPS
    return env


@pytest.fixture(autouse=True)
def short_episodes(monkeypatch):
    available_envs()  # the builtin names first
    monkeypatch.setitem(registry._REGISTRY, "cartpole-balance", short_cartpole)


@pytest.fixture
def log_lines():
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep()
    root = logging.getLogger("surreal_tpu_torch")
    root.addHandler(handler)
    yield lines
    root.removeHandler(handler)


def _train(tmp_path, name, total_steps, *extra, algo="ppo", ckpt_every=128):
    argv = ["train", algo, *ENV, *TINY[algo], "--session.total_env_steps", str(total_steps),
            "--session.eval_every_steps", str(total_steps),
            "--session.checkpoint_every_steps", str(ckpt_every),
            "--session.results_dir", str(tmp_path), "--session.experiment_name", name,
            *extra, "--device", "cpu"]
    assert main(argv) == 0
    return argv


def _latest_steps(exp):
    return sorted(int(s) for s in os.listdir(exp / "checkpoints" / "latest") if s.isdigit())


def test_train_writes_config_and_checkpoints(tmp_path):
    _train(tmp_path, "t", 256, "--learner.lr=1e-3")
    exp = tmp_path / "t"
    overrides = {"learner": {"horizon": 8, "hidden": [16, 16], "num_minibatches": 1,
                             "lr": 1e-3},
                 "env": {"env_name": "cartpole-balance", "num_envs": 8},
                 "session": {"eval_episodes": 2, "total_env_steps": 256,
                             "eval_every_steps": 256, "checkpoint_every_steps": 128,
                             "results_dir": str(tmp_path), "experiment_name": "t"}}
    with open(exp / "config.json") as f:
        saved = json.load(f)
    for gen in (generate_configs, ref_generate_configs):
        want = dict(zip(("learner", "env", "session"),
                        (c.to_dict() for c in gen("ppo", overrides))))
        assert saved == want
    assert saved["learner"]["entropy_coef"] == 0.01  # the recipe's, under the user's flags
    assert _latest_steps(exp) == [128, 256]
    assert os.listdir(exp / "checkpoints" / "best") == ["256"]  # the eval at the end
    with open(exp / "checkpoints" / "meta.json") as f:
        assert json.load(f)["best_step"] == 256
    assert [n for n in os.listdir(exp / "tb") if "tfevents" in n]


def test_kill_and_resume(tmp_path, log_lines):
    _train(tmp_path, "r", 256)
    assert not [m for m in log_lines if "resumed" in m]
    _train(tmp_path, "r", 512)
    assert [m for m in log_lines if "resumed from checkpoint @ 256" in m]
    assert [m for m in log_lines if "(iter 4)" in m]
    assert max(_latest_steps(tmp_path / "r")) == 512
    log_lines.clear()
    _train(tmp_path, "r", 256, "--session.restore", "false")
    assert not [m for m in log_lines if "resumed from checkpoint" in m]
    with pytest.raises(SystemExit, match="no checkpoint"):
        _train(tmp_path, "fresh", 128, "--session.restore", "true")


def test_eval_latest_and_best(tmp_path, capsys):
    _train(tmp_path, "e", 256)
    capsys.readouterr()
    for extra in ([], ["--best"], ["--stochastic"]):
        assert main(["--device", "cpu", "eval", "--experiment", str(tmp_path / "e"),
                     "--episodes", "2", *extra]) == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert math.isfinite(result["return_mean"]) and result["episodes"] == 2


def test_envs_lists_the_registry(capsys):
    assert main(["envs"]) == 0
    assert capsys.readouterr().out.split() == available_envs()
    assert len(available_envs()) == 26


# Every mesh axis and ZeRO run through the CLI (tests/test_torch_dp_cli.py,
# test_torch_mesh_cli.py); the layouts below are the ones the reference's
# trainers refuse, with their messages, and the CLI refuses them before it
# starts a rank.
@pytest.mark.parametrize("algo,flags,item", [
    ("ppo", ["--session.mesh.model", "2", "--session.mesh.time", "2"],
     "mesh.model and mesh.time cannot both be > 1"),
    ("ppo", ["--session.mesh.model", "2", "--learner.use_lstm", "true"],
     "does not compose with use_lstm"),
    ("ddpg", ["--session.mesh.model", "2"], "PPO-only feature"),
], ids=lambda x: x if isinstance(x, str) else "_".join(x))
def test_unported_knobs_raise_naming_their_item(tmp_path, algo, flags, item):
    with pytest.raises(ValueError, match=item):
        _train(tmp_path, "n", 64, *flags, algo=algo)
    assert not (tmp_path / "n").exists()  # raised before anything was written


@pytest.mark.parametrize("algo,flags", [
    ("ppo", ["--learner.compute_dtype", "bfloat16"]),
    ("ppo", ["--learner.overlap", "true"]),
    ("ppo", ["--learner.compute_dtype", "bfloat16", "--learner.overlap", "true"]),
    ("ddpg", ["--learner.compute_dtype", "bfloat16"]),
], ids=["bf16", "overlap", "bf16_overlap", "ddpg_bf16"])
def test_learner_options_train_and_evaluate(tmp_path, capsys, algo, flags):
    """learner.compute_dtype and learner.overlap reach the trainers, as the
    reference's CLI passes them; the run's checkpoint evaluates."""
    from surreal_tpu_torch.cli import main as cli_main

    built = []
    build = cli_main._build_trainer
    def spy(*a, **k):
        built.append(build(*a, **k))
        return built[-1]
    cli_main._build_trainer = spy
    try:
        _train(tmp_path, "o", 64 if algo == "ppo" else 96, *flags, algo=algo, ckpt_every=32)
        capsys.readouterr()
        assert main(["eval", "--experiment", str(tmp_path / "o"), "--episodes", "2",
                     "--device", "cpu"]) == 0
    finally:
        cli_main._build_trainer = build
    assert math.isfinite(json.loads(capsys.readouterr().out.splitlines()[-1])["return_mean"])
    trainer = built[0]
    net = trainer.state.net if algo == "ppo" else trainer.state.actor
    want = "bfloat16" in flags and torch.bfloat16 or torch.float32
    assert net.torso.compute_dtype == want if algo == "ddpg" else (
        net.actor_torso.compute_dtype == want)
    if algo == "ppo":
        assert trainer.overlap == ("--learner.overlap" in flags)


def test_ddpg_run(tmp_path, capsys):
    _train(tmp_path, "d", 96, algo="ddpg", ckpt_every=32)
    assert _latest_steps(tmp_path / "d") == [32, 64, 96]
    capsys.readouterr()
    assert main(["eval", "--experiment", str(tmp_path / "d"), "--episodes", "2",
                 "--device", "cpu"]) == 0
    assert math.isfinite(json.loads(capsys.readouterr().out.splitlines()[-1])["return_mean"])


def test_pixel_run_with_video(tmp_path, capsys):
    """--env.pixel_obs true --session.video true: one iteration on 48 x 48
    frames (action repeat 2, which the 50-step episodes admit), the
    evaluation, one GIF of video_steps frames, and eval --best."""
    from PIL import Image

    _train(tmp_path, "px", 64, "--env.pixel_obs", "true", "--env.pixel.action_repeat", "2",
           "--env.pixel.height", "48", "--env.pixel.width", "48", "--session.video", "true",
           "--session.video_steps", "6")
    exp = tmp_path / "px"
    with open(exp / "config.json") as f:
        saved = json.load(f)
    assert saved["env"]["pixel_obs"] is True and saved["env"]["pixel"]["action_repeat"] == 2
    gif = Image.open(exp / "videos" / "steps_64.gif")
    assert gif.n_frames == 6 and gif.size == (168, 168)
    capsys.readouterr()
    assert main(["eval", "--experiment", str(exp), "--episodes", "2", "--best",
                 "--device", "cpu"]) == 0
    assert math.isfinite(json.loads(capsys.readouterr().out.splitlines()[-1])["return_mean"])


RUN_MODULE = """
import runpy, sys
from surreal_tpu_torch.envs import registry
from surreal_tpu_torch.envs.cartpole import Cartpole

def short_cartpole(**kw):
    env = Cartpole(swing_up=False, sparse=False, **kw)
    env.episode_steps = {episode_steps}
    return env

registry.register("cartpole-balance", short_cartpole)
sys.argv = ["main", "train", "ppo", *{argv!r}]
try:
    runpy.run_module("surreal_tpu_torch.cli.main", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
print(sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r}))
"""


def test_module_run_imports_no_jax(tmp_path):
    """`python -m surreal_tpu_torch.cli.main train ...` as runpy runs it:
    nothing of JAX, of the reference package or of TensorFlow is imported."""
    from tests.test_torch_imports import FORBIDDEN

    argv = [*ENV, *TINY["ppo"], "--session.total_env_steps", "64", "--session.results_dir",
            str(tmp_path), "--device", "cpu"]
    code = RUN_MODULE.format(argv=argv, forbidden=sorted(FORBIDDEN),
                             episode_steps=EPISODE_STEPS)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "eval @ 6.40e+01 steps" in out.stderr


GYM = ["--env.env_name", "gym:Pendulum-v1", "--env.num_envs", "8"]


def _gym_argv(tmp_path, name, total_steps, eval_episodes, *extra):
    return ["train", "ppo", *GYM, *TINY["ppo"], "--session.total_env_steps", str(total_steps),
            "--session.eval_every_steps", str(total_steps),
            "--session.checkpoint_every_steps", "64", "--session.eval_episodes",
            str(eval_episodes), "--session.results_dir", str(tmp_path),
            "--session.experiment_name", name, *extra]


def test_gym_run_to_its_end(tmp_path, capsys, log_lines):
    """train ppo on a gymnasium env runs to its end: training, a checkpoint
    of the zero-width env state each iteration, an evaluation of 2 episodes
    beside the 8 training envs; then a resumed run and `eval`."""
    pytest.importorskip("gymnasium")
    assert main([*_gym_argv(tmp_path, "g", 128, 2), "--device", "cpu"]) == 0
    exp = tmp_path / "g"
    assert _latest_steps(exp) == [64, 128]
    assert os.listdir(exp / "checkpoints" / "best") == ["128"]
    state = torch.load(exp / "checkpoints" / "latest" / "128" / "state.pt", weights_only=True)
    assert state["env_state"]["q"].shape == (8, 0) and state["global_iter"] == 2
    evals = [m for m in log_lines if m.startswith("eval @")]
    assert len(evals) == 1 and math.isfinite(float(evals[0].split(": ")[1].split(" ")[0]))
    assert main([*_gym_argv(tmp_path, "g", 256, 2), "--device", "cpu"]) == 0
    assert [m for m in log_lines if "resumed from checkpoint @ 128" in m]
    assert max(_latest_steps(exp)) == 256
    capsys.readouterr()
    assert main(["--device", "cpu", "eval", "--experiment", str(exp), "--episodes", "3"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["episodes"] == 3 and math.isfinite(result["return_mean"])


@pytest.mark.parametrize("eval_episodes,error,match", [
    (2, TypeError, "incompatible shapes for broadcasting"),
    (8, ValueError, "zero size"),
], ids=["eval_width", "checkpoint"])
def test_reference_cli_fails_a_gym_run(tmp_path, eval_episodes, error, match):
    """The reference's CLI on the same gym run: its evaluation runs on the
    trainer's own 8-wide GymEnv and fails at another width; at the same
    width it reaches the checkpoint, where orbax refuses the zero-width env
    state. The port repairs both (test_gym_run_to_its_end)."""
    pytest.importorskip("gymnasium")
    from surreal_tpu.cli.main import main as ref_main

    with pytest.raises(error, match=match):
        ref_main(_gym_argv(tmp_path, "ref", 64, eval_episodes))
