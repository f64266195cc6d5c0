"""Headline benchmark on the port (the measurement of the repository's
bench.py): PPO env-steps/s on Cheetah-Run with 256 lockstep envs, a (256,
256) network, horizon 128 and 4 epochs x 8 minibatches, on one card.

The same BENCH_NUM_ENVS, BENCH_HORIZON, BENCH_WARMUP_ITERS, BENCH_ITERS and
BENCH_DTYPE variables and the same one JSON line {"metric", "value",
"unit", "vs_baseline"}, with the device it ran on added.

    python -m surreal_tpu_torch.cli.main bench
"""

from __future__ import annotations

import json
import os
import time

import torch

CPU_REFERENCE_STEPS_PER_S = 4800.0  # the reference's CPU actor loop, BASELINE.md


def main(device: str = "cuda") -> dict:
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 256))
    horizon = int(os.environ.get("BENCH_HORIZON", 128))
    warmup_iters = int(os.environ.get("BENCH_WARMUP_ITERS", 2))
    timed_iters = int(os.environ.get("BENCH_ITERS", 30))
    # BENCH_DTYPE=bfloat16 runs the networks in bfloat16; the parameters,
    # the optimizer and GAE stay float32, as in the reference's bench.py
    dtype = os.environ.get("BENCH_DTYPE", "float32")

    cfg = PPOConfig(horizon=horizon, epochs=4, num_minibatches=8, lr=3e-4)
    trainer = PPOTrainer("cheetah-run", cfg, num_envs=num_envs, seed=0, hidden=(256, 256),
                         device=device, compute_dtype=dtype)
    dev = trainer.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    trainer.run(warmup_iters, log_every=warmup_iters)
    sync()
    t0 = time.perf_counter()
    trainer.run(timed_iters, log_every=timed_iters)
    sync()
    dt = time.perf_counter() - t0

    sps = timed_iters * trainer.steps_per_iteration / dt
    result = {
        "metric": "ppo_cheetah_env_steps_per_s_per_chip",
        "value": round(sps, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(sps / CPU_REFERENCE_STEPS_PER_S, 2),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(result))
    return result
