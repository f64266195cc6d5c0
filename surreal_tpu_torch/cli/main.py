"""surreal-tpu CLI on the PyTorch port: train / eval / bench / envs (port of
surreal_tpu/cli/main.py, one card).

The same flags, recipe defaults and results layout as the reference's CLI:
`<results_dir>/<experiment_name>/` holds `config.json` (written before
training, key for key what the reference writes), `checkpoints/` and `tb/`.
The run is on "cuda" unless `--device cpu` is given (the reference picks
its platform with SURREAL_TPU_PLATFORM); the device is not part of
`config.json`.

Usage:
    python -m surreal_tpu_torch.cli.main train ppo --env.env_name cheetah-run \\
        --session.experiment_name run1 --learner.lr 1e-4
    python -m surreal_tpu_torch.cli.main eval --experiment results/run1 [--best]
    python -m surreal_tpu_torch.cli.main envs
    python -m surreal_tpu_torch.cli.main bench
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from surreal_tpu_torch.cli.configs import generate_configs, to_algo_config
from surreal_tpu_torch.config import Config
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


def _check_ported(session: Config) -> None:
    """Raises NotImplementedError, naming its ROADMAP.md Queue A item, for a
    configuration whose path the port does not have yet."""
    m = session.mesh
    if (not (m.data is None and int(m.model) == 1 and int(m.time) == 1)
            or any(v is not None for v in session.multihost.values())):
        raise NotImplementedError(
            "not ported yet (ROADMAP.md, Queue A): session.mesh and session.multihost "
            "other than one device (A15)")


def _build_trainer(learner: Config, env_cfg: Config, session: Config, device: str):
    seed = int(session.seed)
    algo_cfg = to_algo_config(learner)
    # the networks' compute dtype (bfloat16: A13); parameters and the
    # optimizer stay float32, as in the reference
    common = {"device": device, "compute_dtype": str(learner.compute_dtype),
              "pixel_obs": bool(env_cfg.pixel_obs),
              "pixel_kwargs": env_cfg.pixel.to_dict() if env_cfg.pixel_obs else None}
    if learner.algo == "ppo":
        from surreal_tpu_torch.train import PPOTrainer

        return PPOTrainer(
            env_cfg.env_name, algo_cfg, num_envs=int(env_cfg.num_envs), seed=seed,
            hidden=tuple(learner.hidden), use_lstm=bool(learner.use_lstm),
            lstm_size=int(learner.lstm_size), overlap=bool(learner.overlap), **common,
        )
    from surreal_tpu_torch.train import DDPGTrainer

    return DDPGTrainer(
        env_cfg.env_name, algo_cfg, num_envs=int(env_cfg.num_envs), seed=seed,
        actor_hidden=tuple(learner.actor_hidden), critic_hidden=tuple(learner.critic_hidden),
        **common,
    )


def cmd_train(algo: str, overrides: dict, device: str = "cuda") -> int:
    learner, env_cfg, session = generate_configs(algo, overrides)
    _check_ported(session)
    log = get_logger("cli")

    exp_dir = os.path.join(session.results_dir, session.experiment_name)
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        f.write(
            json.dumps(
                {"learner": learner.to_dict(), "env": env_cfg.to_dict(),
                 "session": session.to_dict()},
                indent=2, default=str,
            )
        )

    trainer = _build_trainer(learner, env_cfg, session, device)

    from surreal_tpu_torch.train.checkpoint import Checkpointer
    from surreal_tpu_torch.train.metrics import MetricsWriter

    ckpt = Checkpointer(
        os.path.join(exp_dir, "checkpoints"), keep_latest=int(session.keep_latest_checkpoints)
    )
    tb = MetricsWriter(os.path.join(exp_dir, "tb") if session.tensorboard else None)

    # ---- resume: the FULL training state (network, optimizer, Z-filter, env
    # batch, replay, generator, counters) survives a kill ----
    restore = str(session.restore).lower()
    latest = ckpt.latest_step()
    if restore in ("auto", "true", "1") and latest is not None:
        trainer.load_full_state(ckpt.restore(trainer.full_state))
        log.info("resumed from checkpoint @ %d env steps (iter %d)",
                 latest, trainer.global_iter)
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
            pol = trainer.deterministic_policy() if session.video else None
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
    _check_ported(session)
    trainer = _build_trainer(learner, env_cfg, session, device)
    ckpt = Checkpointer(os.path.join(experiment, "checkpoints"))
    trainer.load_full_state(ckpt.restore(trainer.full_state, best=best))
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
