"""surreal-tpu CLI on the PyTorch port: train / eval / bench / envs (port of
surreal_tpu/cli/main.py).

The same flags, recipe defaults and results layout as the reference's CLI:
`<results_dir>/<experiment_name>/` holds `config.json` (written before
training, key for key what the reference writes), `checkpoints/` and `tb/`.
The run is on "cuda" unless `--device cpu` is given (the reference picks
its platform with SURREAL_TPU_PLATFORM); the device is not part of
`config.json`.

`--session.mesh.data D --session.mesh.model M --session.mesh.time T`
trains over a mesh of D x M x T ranks (`parallel.mesh`: the data axis
shards the envs, the model axis the networks' kernels, the time axis the
GAE scan; `--learner.zero_optimizer true` splits Adam's moments over the
data axis): this command spawns them, one process each, meeting at a file
store it makes. With `--session.multihost.{coordinator,num_processes,
process_id}` each launched process runs D·M·T / num_processes ranks and
they meet at the coordinator, host:port. Processes that share a
host are given LOCAL_RANK, their index among them, and LOCAL_WORLD_SIZE,
their count, as torchrun gives them: their ranks then take distinct cards,
and the backend counts every rank of the host (`parallel.mesh`). A run
resumes from its experiment's latest checkpoint under another mesh too,
where the reference's does: the same `learner.zero_optimizer`, and with it
the same `session.mesh.data` (`train.checkpoint`).

Usage:
    python -m surreal_tpu_torch.cli.main train ppo --env.env_name cheetah-run \\
        --session.experiment_name run1 --learner.lr 1e-4
    python -m surreal_tpu_torch.cli.main train ppo --env.env_name cheetah-run \\
        --session.mesh.data 2 --device cpu
    python -m surreal_tpu_torch.cli.main train ppo --env.env_name cheetah-run \\
        --session.mesh.model 2   # or --session.mesh.time 2, or
        # --session.mesh.data 2 --learner.zero_optimizer true
    python -m surreal_tpu_torch.cli.main eval --experiment results/run1 [--best]
    python -m surreal_tpu_torch.cli.main envs
    python -m surreal_tpu_torch.cli.main bench
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import torch

from surreal_tpu_torch.cli.configs import generate_configs, to_algo_config
from surreal_tpu_torch.config import Config
from surreal_tpu_torch.device import resolve as resolve_device
from surreal_tpu_torch.parallel.zero import uses_zero
from surreal_tpu_torch.parallel.mesh import distributed_init, host_slots, make_mesh, spawn
from surreal_tpu_torch.utils import get_logger


def _parse_overrides(unknown: list[str]) -> dict:
    """--learner.lr 1e-4 --env.num_envs 512 ... -> nested override dict."""
    out = Config({"learner": {}, "env": {}, "session": {}})
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(unknown):
                raise SystemExit(f"missing value for {tok!r}")
            val = unknown[i + 1]
            i += 2
        out.set_dotted(key, val)
    return out.to_dict()


def _mesh_layout(session: Config, device: str):
    """session.mesh and session.multihost -> (data, model, time, local,
    first, coordinator), or None for one device (no mesh). This process
    runs `local` ranks, global ranks first .. first + local - 1, of a mesh
    of data x model x time; `coordinator` is where they meet (None: this
    command's own ranks, which meet at a file store it makes). data='all'
    (or unset with the multihost flags or a model or time axis) means one
    rank per visible card (one on the CPU) in each process, divided by
    model x time, at least 1. With the multihost flags each process runs
    data·model·time / num_processes ranks: global rank process_id x local +
    i, the reference's "a process holds several mesh devices"."""
    m, mh = session.mesh, session.multihost
    model, time = int(m.model), int(m.time)
    multihost = any(v is not None for v in mh.values())
    if m.data is None and not multihost and model == time == 1:
        return None
    if multihost and None in (mh.coordinator, mh.num_processes, mh.process_id):
        raise ValueError("session.multihost needs coordinator, num_processes and process_id")
    processes = int(mh.num_processes) if multihost else 1
    if m.data in (None, "all"):
        cards = resolve_device(device).type == "cuda"
        ranks = (torch.cuda.device_count() if cards else 1) * processes
        data = max(ranks // (model * time), 1)
    else:
        data = int(m.data)
    world = data * model * time
    if world % processes != 0:
        raise ValueError(f"session.mesh's {data}x{model}x{time} ranks are not a multiple of "
                         f"session.multihost.num_processes {processes}")
    local = world // processes
    first = int(mh.process_id) * local if multihost else 0
    return data, model, time, local, first, str(mh.coordinator) if multihost else None


def _check_layout(learner: Config, data: int, model: int, time: int) -> None:
    """The trainers' refusals of a layout, before any rank starts."""
    algo_cfg = to_algo_config(learner)
    if learner.algo == "ppo":
        from surreal_tpu_torch.train.ppo_trainer import check_layout

        check_layout(algo_cfg, model, time, bool(learner.use_lstm), bool(learner.overlap),
                     str(learner.get("torso", "mlp")), data)
    else:
        from surreal_tpu_torch.train.ddpg_trainer import check_layout

        check_layout(model, time)


def _build_trainer(learner: Config, env_cfg: Config, session: Config, device: str, mesh=None):
    seed = int(session.seed)
    algo_cfg = to_algo_config(learner)
    # the networks' compute dtype (bfloat16: A13); parameters and the
    # optimizer stay float32, as in the reference
    common = {"device": device, "compute_dtype": str(learner.compute_dtype),
              "pixel_obs": bool(env_cfg.pixel_obs),
              "pixel_kwargs": env_cfg.pixel.to_dict() if env_cfg.pixel_obs else None,
              "mesh": mesh}
    if learner.algo == "ppo":
        from surreal_tpu_torch.train import PPOTrainer

        return PPOTrainer(
            env_cfg.env_name, algo_cfg, num_envs=int(env_cfg.num_envs), seed=seed,
            hidden=tuple(learner.hidden), use_lstm=bool(learner.use_lstm),
            lstm_size=int(learner.lstm_size), overlap=bool(learner.overlap),
            torso=str(learner.get("torso", "mlp")),
            gtrxl=learner.gtrxl.to_dict() if "gtrxl" in learner else None, **common,
        )
    from surreal_tpu_torch.train import DDPGTrainer

    return DDPGTrainer(
        env_cfg.env_name, algo_cfg, num_envs=int(env_cfg.num_envs), seed=seed,
        actor_hidden=tuple(learner.actor_hidden), critic_hidden=tuple(learner.critic_hidden),
        **common,
    )


def cmd_train(algo: str, overrides: dict, device: str = "cuda") -> int:
    learner, env_cfg, session = generate_configs(algo, overrides)
    layout = _mesh_layout(session, device)
    if layout is None:
        return _train(algo, learner, env_cfg, session, device, mesh=None)
    data, model, time, local, first, coordinator = layout
    _check_layout(learner, data, model, time)
    if data * model * time == 1:  # one rank: a mesh without a process group
        return _train(algo, learner, env_cfg, session, device, make_mesh(1, device=device))
    store = None
    if coordinator is None:  # this command's own ranks meet at a file store
        store = tempfile.mkdtemp(prefix="surreal_tpu_torch_ranks_")
        coordinator = "file://" + os.path.join(store, "store")
    args = (algo, overrides, device, (data, model, time), first, coordinator)
    try:
        if local == 1:  # LOCAL_RANK and LOCAL_WORLD_SIZE are the launcher's
            _train_rank(0, *args)
        else:
            # CPU ranks share this process's torch threads
            cpu = resolve_device(device).type == "cpu"
            first_slot, on_host = host_slots(local)
            spawn(_train_rank, local, args, first_slot=first_slot, on_host=on_host,
                  threads=max(1, torch.get_num_threads() // local) if cpu else None)
    finally:
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)
    return 0


def _train_rank(i: int, algo: str, overrides: dict, device: str, shape: tuple[int, int, int],
                first: int, coordinator: str) -> None:
    """Rank first + i of the data x model x time mesh `shape`: joins the
    process group and trains."""
    import torch.distributed as dist

    world = shape[0] * shape[1] * shape[2]
    distributed_init(coordinator, world, first + i, device=device)
    try:
        learner, env_cfg, session = generate_configs(algo, overrides)
        mesh = make_mesh(*shape, device=device)
        get_logger(f"cli.rank{mesh.rank}").info(
            "rank %d of %d on %s: LOCAL_RANK %s of LOCAL_WORLD_SIZE %s", mesh.rank, world,
            mesh.device, os.environ.get("LOCAL_RANK", 0), os.environ.get("LOCAL_WORLD_SIZE", 1))
        _train(algo, learner, env_cfg, session, device, mesh)
    finally:
        dist.destroy_process_group()


def _train(algo: str, learner: Config, env_cfg: Config, session: Config, device: str,
           mesh) -> int:
    """The training session of one device, or of one rank of a mesh:
    only the primary rank writes config.json, the event files, the videos
    and meta.json; every rank evaluates (their scores are equal, so they
    make the same best-checkpoint decision) and reaches every collective
    (the checkpoints' barriers) in the same order."""
    primary = mesh is None or mesh.primary
    log = get_logger("cli" if mesh is None else f"cli.rank{mesh.rank}")

    exp_dir = os.path.join(session.results_dir, session.experiment_name)
    os.makedirs(exp_dir, exist_ok=True)
    if primary:
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            f.write(
                json.dumps(
                    {"learner": learner.to_dict(), "env": env_cfg.to_dict(),
                     "session": session.to_dict()},
                    indent=2, default=str,
                )
            )
        log.info("wrote %s", os.path.join(exp_dir, "config.json"))

    trainer = _build_trainer(learner, env_cfg, session, device, mesh)

    from surreal_tpu_torch.train.checkpoint import Checkpointer, describe_layout
    from surreal_tpu_torch.train.metrics import MetricsWriter

    ckpt = Checkpointer(
        os.path.join(exp_dir, "checkpoints"), keep_latest=int(session.keep_latest_checkpoints),
        mesh=mesh, rank_keys=trainer.rank_keys, zero=uses_zero(trainer.cfg),
    )
    tb = MetricsWriter(os.path.join(exp_dir, "tb") if session.tensorboard and primary else None)

    # ---- resume: the FULL training state (network, optimizer, Z-filter, env
    # batch, replay, generator, counters) survives a kill ----
    restore = str(session.restore).lower()
    latest = ckpt.latest_step()
    if restore in ("auto", "true", "1") and latest is not None:
        # under another layout than the writer's, each rank takes its slice
        # of the whole env batch (train.checkpoint)
        trainer.load_full_state(ckpt.restore(trainer.full_state))
        written = ckpt.written_layout(latest)
        log.info("resumed from checkpoint @ %d env steps (iter %d)%s", latest,
                 trainer.global_iter,
                 "" if written == ckpt.layout else f", written by {describe_layout(written)}")
    elif restore in ("true", "1"):
        raise SystemExit(f"--session.restore true but no checkpoint under {exp_dir}")

    steps_per_iter = trainer.steps_per_iteration
    total_iters = max(int(session.total_env_steps) // steps_per_iter, 1)
    eval_every = max(int(session.eval_every_steps) // steps_per_iter, 1)
    ckpt_every = max(int(session.checkpoint_every_steps) // steps_per_iter, 1)
    seg = max(min(eval_every, ckpt_every), 1)
    log.info(
        "experiment %s: %s on %s, %d iters (%d env-steps/iter)",
        session.experiment_name, algo, env_cfg.env_name, total_iters, steps_per_iter,
    )

    from surreal_tpu_torch.utils.trackers import PeriodicTracker, ThroughputTracker

    start_steps = trainer.global_iter * steps_per_iter
    eval_trk = PeriodicTracker(eval_every * steps_per_iter, init_count=start_steps)
    ckpt_trk = PeriodicTracker(ckpt_every * steps_per_iter, init_count=start_steps)
    thru = ThroughputTracker()

    def sink(m):
        m["env_steps_per_s_smoothed"] = thru.update(m["env_steps"])
        tb.write(int(m["env_steps"]), m)

    while trainer.global_iter < total_iters:
        n = min(seg, total_iters - trainer.global_iter)
        trainer.run(n, log_every=int(session.log_every_iterations), metric_sink=sink)
        env_steps = trainer.global_iter * steps_per_iter
        finished = trainer.global_iter >= total_iters
        score = None
        if eval_trk.track(env_steps) or finished:
            ev = trainer.evaluate(episodes=int(session.eval_episodes))
            score = ev["return_mean"]
            tb.write(env_steps, ev, section="eval")
            log.info("eval @ %.2e steps: %.1f ± %.1f", env_steps, ev["return_mean"],
                     ev["return_std"])
            pol = trainer.deterministic_policy() if session.video and primary else None
            if pol is not None:  # the reference's eval-worker videos
                from surreal_tpu_torch.train.video import record_video

                policy_fn, zf = pol
                path = os.path.join(exp_dir, "videos", f"steps_{env_steps}.gif")
                record_video(trainer.env, policy_fn, path, steps=int(session.video_steps),
                             zfilter=zf, flatten=trainer._flatten)
                log.info("video -> %s", path)
        if ckpt_trk.track(env_steps) or finished:
            ckpt.save(env_steps, trainer.full_state, score=score)
    ckpt.close()
    tb.close()
    return 0


def cmd_eval(experiment: str, best: bool, episodes: int, stochastic: bool,
             device: str = "cuda") -> int:
    from surreal_tpu_torch.train.checkpoint import Checkpointer

    with open(os.path.join(experiment, "config.json")) as f:
        saved = json.load(f)
    learner = Config(saved["learner"])
    env_cfg = Config(saved["env"])
    session = Config(saved["session"])
    # the learner alone, on one device, whatever mesh trained it
    trainer = _build_trainer(learner, env_cfg, session, device)
    ckpt = Checkpointer(os.path.join(experiment, "checkpoints"), rank_keys=trainer.rank_keys)
    trainer.load_full_state(ckpt.restore(trainer.full_state, best=best, learner_only=True))
    # eval-deterministic / eval-stochastic agent modes; DDPG is deterministic
    kw = {"stochastic": True} if (stochastic and learner.algo == "ppo") else {}
    result = trainer.evaluate(episodes=episodes, **kw)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    device_help = "torch device to run on (default cuda; cpu only when asked for)"
    parser = argparse.ArgumentParser(prog="surreal-tpu-torch")
    parser.add_argument("--device", default="cuda", help=device_help)
    # the subcommands take --device too, after their own name; SUPPRESS keeps
    # their default from overwriting a --device given before the subcommand
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=argparse.SUPPRESS, help=device_help)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", parents=[dev], help="run a training experiment")
    p_train.add_argument("algo", choices=["ppo", "ddpg"])

    p_eval = sub.add_parser("eval", parents=[dev], help="evaluate a saved experiment")
    p_eval.add_argument("--experiment", required=True)
    p_eval.add_argument("--best", action="store_true")
    p_eval.add_argument("--episodes", type=int, default=16)
    p_eval.add_argument("--stochastic", action="store_true",
                        help="sample the policy (reference's eval-stochastic mode)")

    sub.add_parser("envs", help="list available environments")
    sub.add_parser("bench", parents=[dev], help="run the headline benchmark")

    args, unknown = parser.parse_known_args(argv)
    if args.cmd == "train":
        return cmd_train(args.algo, _parse_overrides(unknown), args.device)
    if unknown:
        raise SystemExit(f"unexpected args: {unknown}")
    if args.cmd == "eval":
        return cmd_eval(args.experiment, args.best, args.episodes, args.stochastic, args.device)
    if args.cmd == "envs":
        from surreal_tpu_torch.envs import available_envs

        print("\n".join(available_envs()))
        return 0
    if args.cmd == "bench":
        from surreal_tpu_torch.cli import bench

        bench.main(args.device)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
