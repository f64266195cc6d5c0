"""Drives the PyTorch port on one CUDA card and checks it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --loss-timing [ROOT]
    python3 chip_smoke.py --loss-sweep
    python3 chip_smoke.py --gae-timing [ROOT]
    python3 chip_smoke.py --gae-sweep
    python3 chip_smoke.py --spans [ROOT]
    python3 chip_smoke.py --learn [DIR] [cheetah-run] [CLI FLAGS]
    python3 chip_smoke.py --dp
    python3 chip_smoke.py --axes
    python3 chip_smoke.py --counted-cli CLI ARGUMENTS (phase 12 runs it)

Phases, each of which exits non-zero on failure:
  1. prints the card (nvidia-smi name, power limit) and the torch version;
  2. builds the CUDA C++ kernels from surreal_tpu_torch/ops/csrc with nvcc
     and prints ptxas's registers, shared memory and spills for each;
  3. runs each kernel at the main path's shapes against its plain PyTorch
     version on the card, and times both with CUDA events, and again at the
     finger-spin path's shapes (GAE at (T, B) = (128, 128), the loss at
     N = 4096 rows with A = 2) and, for the loss, at the CLI cartpole
     path's (A = 1), the pixel PPO path's (N = 2048, A = 6) and the GTrXL
     path's (N = 16,384, A = 6: 128 whole sequences of 128 steps); checks
     and times GAE at the recipes' other two (T, B) too; times the fused
     loss's forward and backward as autograd runs them; holds the GTrXL
     segment attention's forward and backward kernels at the cell's shape
     (B, H, T, m + T) = (128, 8, 128, 640), d_head 32, over ragged episodes
     and a partly empty ring, against the torch ops (`attention_plain`)
     through autograd (the output, dqu, dqv, dk, dv and dpos, each to 1e-5
     of its largest element) and times each way against them;
  4. checks the slice on a small input: one PPO update on the card (loss
     kernels; GAE by the reference's default, the torch scan) against the
     same update on the CPU (plain versions), the GAE kernel (backend
     "pallas") on the card against the update's GAE on the CPU, and one
     batched cheetah env step on the card against the CPU;
  5. runs the main path, PPO on cheetah-run at bench.py's configuration
     (256 envs, (256, 256) MLP, horizon 128, 4 epochs x 8 minibatches,
     fused loss), for 1 warm-up and 2 timed iterations, and checks from the
     launch counters that every iteration launched the loss forward and
     backward kernels 32 times each and the GAE kernel never (the
     reference's PPO takes its default GAE, the XLA scan);
  6. checks one block of DDPG updates on the card against the same block on
     the CPU, from the same state, replay contents and indices;
  7. runs DDPG on cheetah-run at the recipe's configuration (256 envs, actor
     (300, 200), critic (400, 300), LayerNorm, batch 256, 3-step returns, 16
     env steps and 16 updates per iteration, a ring of 1,000,000 transitions
     on the card) for 3 warm-up iterations, which the replay's warm-up of
     10,000 transitions ends, and 5 timed ones, then one more split into
     rollout and update block; checks the update and replay counts, that
     the targets follow the live networks and, from the launch counters set
     to 0 before its first iteration, that it launched none of the kernels;
  8. runs recurrent PPO on cheetah-run (256 envs, (256, 256) torsos behind
     an LSTM of 128, horizon 128, 4 epochs x 8 minibatches of 32 whole
     sequences) for 1 warm-up and 2 timed iterations, then one more split
     into rollout and update; checks from the launch counters, set to 0
     before its first iteration, that it launched none of the kernels (the
     reference's recurrent PPO uses neither), and that the carry is in use;
  9. serves the PPO slice's network and Z-filter over TCP on 127.0.0.1:
     5 requests of a (256, 17) batch, a parameter swap and one more, each
     answer held against the module's own forward on the card;
 10. the envs: one task for each baked asset but cheetah's, at its recipe's
     number of envs: a reset on the card with a quarter of the envs at
     their last step, one control step on the card and the same step on the
     CPU from the same state, actions and reset draw (q, qd, reward and
     both observations held to a relative tolerance; envs within 1e-5 of a
     switch of the constraint solver's active set left out, at most a
     quarter), and the median of 5 timed control steps on the card; one
     JSON line per task;
 11. runs PPO on finger-spin at its recipe (128 envs, (64, 64), horizon
     128, 4 epochs x 4 minibatches of 4096 rows, entropy 0.005, fused loss)
     for 1 warm-up and 2 timed iterations, then one more split into rollout
     and update; checks from the launch counters, set to 0 before its first
     iteration, that every iteration launched each loss kernel 16 times and
     the GAE kernel never;
 12. the session layer and the CLI (surreal_tpu_torch.cli.main): `envs`
     lists the 26 names; `train ppo` on cartpole-balance at its recipe's
     full width (256 envs, (256, 256), horizon 128, 4 epochs x 8
     minibatches of 4096 rows, entropy 0.01) with the fused loss for 3
     iterations and a checkpoint each, into a temporary directory, a
     process of its own (`--counted-cli`: the CLI with the counters set to
     0 before it, printed after it); checks from the counters that each
     iteration launched each loss kernel 32 times and GAE never, the
     checkpoints' steps and that config.json is generate_configs' output;
     the same command (a process too) to 5
     iterations must resume at iteration 3; the 98,304-step checkpoint
     loaded into a fresh trainer equals what was saved, bit for bit;
     `eval --best` over 16 episodes; the DDPG cell of phase 7 (its ring of
     999,936 transitions) saved and restored into a fresh trainer, every
     tensor equal, and equal again after one more iteration of both; one
     cartpole iteration with debug_checks beside an unchecked one;
     `bench` with BENCH_WARMUP_ITERS=1 BENCH_ITERS=2; and `train ppo` with
     `--learner.compute_dtype bfloat16 --learner.overlap true` for 2
     iterations in this process (32 + 32 loss launches each, from the
     counters) and `eval` of its checkpoint. The float32 runs and the two
     `eval` commands (processes of their own, as a user runs them) run
     beside the rest of the phase;
 13. the rasteriser at 128 envs and 84 x 84 on cheetah (a floating root),
     ball_in_cup, manipulator_bring_ball and cartpole (a stick figure):
     the card's frames against the CPU's from the same states (at most 1
     grey level on at most 1% of the channels) and ms per call; one JSON
     line per task;
 14. PPO from pixels on cheetah-run at its recipe (128 envs, action repeat
     4, 3 stacked grayscale 84 x 84 frames, the conv stem and (256, 256),
     horizon 128, 4 epochs x 8 minibatches of 2,048, fused loss) for two
     iterations, the second split into rollout (its render and policy
     shares timed alone) and update; checks from the counters, set to 0
     before it, that each iteration launched each loss kernel 32 times and
     GAE never, then one update on identical inputs on the card and the
     CPU, then one whole update of the rollout's trajectory in float32 and
     in bfloat16, in the turns f32, bf16, bf16, f32, each timed, then one
     overlapped step on that trajectory (time and peak memory);
 15. DDPG from pixels on ball_in_cup-catch at the evidence's configuration
     (results/bic_pixel_ddpg_aug_r5.txt: 128 envs, action repeat 2, a ring
     of 99,968 uint8 frame stacks, 2,116,122,624 bytes, min_replay 5,000,
     shared_encoder, aug_shift 4) until two iterations have updated; checks
     the ring, the counts, the stems equal after sync_encoder, no kernel
     launch, and one block of 2 updates on identical inputs (shift offsets
     injected) on the card and the CPU;
 16. the pixel CLI: `train ppo --env.env_name cheetah-run --env.pixel_obs
     true --session.video true` at the recipe for one iteration (the loss
     32 + 32 launches from the counters), the eval video read
     back to its frames, and `eval --best`, a process of its own that runs
     beside phase 12 and is checked after it;
 17. PPO on cheetah-run at bench.py's configuration with bfloat16 networks
     (parameters float32) and the fused loss, 1 warm-up and 2 timed
     iterations: the launch counters as in phase 5, and the loss kernels
     held against their plain versions on the path's own first minibatch
     (the float32 outputs of the bfloat16 heads);
 18. bfloat16 updates on the card against the CPU from the same state and
     draws: a small PPO update with the fused loss, an LSTM-PPO update and
     a block of 3 pixel DDPG updates (shared encoder, shifts injected), each
     parameter within the Adam steps' reach and all but a fifth within
     1e-5 (tests/test_torch_bf16_updates.py's bars);
 19. the overlapped PPO step at bench.py's configuration: the priming
     rollout and a first iteration, then 2 more, each checked to update on the trajectory
     the previous call returned and to launch each loss kernel 32 times
     and GAE never, each timed beside one iteration of phase 5's fused
     step, in turns;
 20. the host bridges: which of gymnasium, mujoco and dm_control this
     machine has (importlib's find_spec). A phase below that needs a
     missing one prints {"phase": ..., "ran": false, "missing": ...} and
     does nothing else;
 21. PPO on a pre-built `make_env("cheetah-run")` instance at bench.py's
     configuration for one iteration, bit for bit the iteration of the
     trainer built from the name with the same seed, with the loss kernels
     32 + 32 times and GAE never (from the counters);
 22. (gymnasium) PPO on gym:Pendulum-v1 at bench.py's widths (256 envs,
     (256, 256), horizon 128, 4 x 8 minibatches of 4096 rows, fused, A = 1)
     for 2 iterations: the counters as in phase 5, s/iteration,
     env-steps/s, ms per control step split into the gymnasium step on the
     host, the action's copy to the host, the results' copy to the card and
     the policy; one update of its trajectory on the card against the CPU
     (1e-5); and the CLI on the same name for 2 iterations with a
     checkpoint each and an evaluation, then `eval`;
 23. (mujoco, dm_control) the batched MuJoCo oracle built from
     native/mujoco_batch.cpp: 256 cheetah envs from the port's start states
     under 100 control steps of common actions, the oracle's ms per control
     step on the host and the drift of the port's engine on the card
     (float32) from it (float64) after each step;
 24. (mujoco, dm_control) one 'mujoco' eval GIF (dm_control's GL frames,
     MUJOCO_GL=egl unless set) of 8 steps, read back;
 25. the profiler checks of the PPO slice: times one more iteration split
     into rollout and update, profiles a window of 16 rollout steps and one
     whole update for the device's kernels and idle share per step, per
     update and per iteration, and profiles one minibatch step of the update for its loss kernels (2:
     one forward, one backward), a forward and a backward of
     fused_clip_loss and one call of returns.gae with backend "pallas" (one
     device kernel each). torch.profiler stays attached to the process once
     used and slows every later launch, so it comes last and nothing is
     timed after it. The profiles read the profiler's raw device events
     (`device_events`), not its event tree, which takes minutes to build
     for a whole iteration;
 26. profiles the DDPG cell (one rollout, one update block), the recurrent
     PPO cell (a rollout of 16 steps, one epoch of 8 minibatch steps) and
     the finger-spin cell (a rollout of 4 steps, one epoch of 4 minibatch
     steps) for their device kernels and device busy time, held against the
     unprofiled times of the same parts from phases 7, 8 and 11;
 27. profiles one render call per task of phase 13 and the pixel PPO cell
     (a rollout of 2 decision steps, one epoch of 8 minibatch steps, the
     epoch in float32 and in bfloat16): device kernels per decision step,
     the render's share of the rollout's device time, the idle shares, each
     epoch's kernels with the most device time.
 28-34, the data axis (A15a), run before the profiles: 28-33 from a
     thread once the chains of 34, 38 and 39 are done, beside 35-37 (from
     another), the rest of phase 12 and phase 40.
     A rank is a child process (the port's parallel.mesh.spawn) that writes
     its numbers to a JSON file; the parent checks them, and a failed or
     hung rank fails the run. Phases 28-32 run in one pair of gloo ranks
     sharing the card (NCCL refuses two ranks on one device):
 28. the flagship PPO (256 envs, 128 a rank, minibatches of 2,048 rows)
     for 2 iterations: each rank's s per iteration, env-steps/s over both,
     the parameters, lr_scale, kl_beta and update_step equal across ranks,
     each loss kernel 32 times an iteration a rank and GAE never (the
     counters set to 0 in each rank before it); then one more iteration
     split into rollout and update, the update's all-reduces timed;
 29. one sharded PPO update (loss kernels on the card) and one sharded
     block of DDPG updates, each on the card and on the CPU over the same
     group, on each rank's own inputs: parameters within 1e-5;
 30. LSTM-PPO at phase 8's configuration for 2 iterations (no kernel);
 31. the overlapped step at phase 19's for the priming call and one more
     (32 + 32 loss launches an iteration a rank);
 32. DDPG at phase 7's configuration with the recipe's ring of 999,936
     transitions, global (3,906 steps deep, 128 envs a rank), 6
     iterations: each rank's ring bytes, and updates from the 5th, when a
     rank's own 128 envs have put 10,000 transitions in its shard;
 33. a 1-rank NCCL group on the flagship for 2 iterations, bit for bit
     the one-device trainer's 2 from the same seed;
 34. `train ppo --session.mesh.data 2` through the port's CLI, as a
     subprocess, at the cartpole-balance recipe's width: 2 iterations with
     a checkpoint each, the same stopped after 1 and resumed, the two last
     checkpoints equal bit for bit, config.json written once, the ranks'
     evaluations equal, and `eval` of the checkpoint. Its runs go at once
     with phase 38's and 39's, from the end of phase 24 (see 39).
Phases 35-37 run in one more pair of gloo ranks sharing the card (beside
28-33's), which make a data 2, a time 2 and a model 2 mesh in turn over
their group:
 35. ZeRO: the flagship at data 2 with `zero_optimizer`, in turns with the
     replicated run from the same seed, 2 iterations each: the two learners
     bit for bit equal, 71,303 moment floats a rank, 32 + 32 loss launches
     an iteration a rank and GAE never, the all_gathers timed; then DDPG's
     recipe (phase 32's cell) with and without ZeRO, 6 iterations in turns,
     bit for bit;
 36. the time axis: the flagship at data 1 x time 2 for 2 iterations, the
     ranks' learners bitwise equal, 32 + 32 launches an iteration; the GAE
     scan split over time against `gae` on one rollout (1e-5 relative); a
     time-sharded update on the card against the CPU's (1e-5);
 37. the model axis: the flagship at data 1 x model 2 (71,821 parameter
     floats a rank): its first rollout step's means and values within
     1e-5 of the one-device trainer's from the same seed, its first update
     within 1e-5 of the one-device update of the same trajectory, and the
     whole first iteration within TP_ITERATION_TOL of the one-device one,
     a limit that a planted rollout fault (the noise of the wrong rows) is
     checked to exceed; 2 iterations, 32 + 32 launches each; one more split into rollout and update with the
     collectives counted and timed per rollout step and per minibatch step;
     one bfloat16 iteration;
 38. `python -m surreal_tpu_torch.dryrun 2 cuda`: the reference's six
     layouts (dp, dp + zero, dp + lstm, dp x time, dp x model, dp (ddpg));
 39. `train ppo` through the CLI at the cartpole-balance recipe's width
     under `--session.mesh.model 2`, `--session.mesh.time 2` and
     `--session.mesh.data 2 --learner.zero_optimizer true`, 2 iterations
     each, the ZeRO run stopped after 1 and resumed: its last
     checkpoint bit for bit phase 34's uninterrupted replicated run's; the
     ranks' evaluations equal. The dry run and the CLI runs of phases 34
     and 39 (five chains of commands) go at once, each command's 2 ranks
     sharing the card, from the end of phase 24, beside phases 16 and 12
     (launch-bound processes on cores of their own); their checks follow
     35-37. No timed in-process cell and no profile runs beside them. Each
     phase's wall time is printed.
 41. runs GTrXL PPO on cheetah-run (`torso="gtrxl"` at the published widths:
     12 layers, width 256, 8 heads, a memory of 512; 128 envs, horizon 128,
     4 epochs x 8 minibatches of 16 whole sequences) for 1 warm-up and 1
     timed iteration; checks from the launch counters, set to 0 before its
     first iteration, that each iteration launched the loss forward and
     backward kernels 32 times each and GAE never, the segment attention's
     forward and backward kernels 12 times each a minibatch step (once a
     layer), and that the memory holds the steps taken;
 40. a checkpoint resumed under another layout, as the reference's orbax
     restore resumes it, after phases 16 and 12 once the runs of 34 and 39
     that write its checkpoints are done (beside their other runs): phase
     34's data-2 checkpoint through the CLI in this process on one device
     for one iteration (the learner it loaded bit for bit state.pt, its env batch
     the two ranks' files joined, its generator rank 0's; its checkpoint
     after the iteration bit for bit a one-device trainer's given that
     state in this process; the same check with the ranks' rows swapped, a
     planted fault, must fail), and at once, in 2 gloo ranks sharing the
     card, phase 39's model-2 checkpoint under `--session.mesh.data 2`
     (the CLI's session in each rank: its rows of the batch, the learner,
     the generator by checkpoint.py's rule); 32 + 32 loss launches each
     (a rank) from the counters, and the seconds.
Phases 6 to 9, 11, 12, 14 to 24, 26 to 41 print one JSON object each
(three in phase 26), phases 10 and 13 one per task. The whole run's time
follows; the line before the card's is a JSON object with one entry per
kernel (GAE, on no trainer path since the reference's default is the XLA
scan, is still held by phases 3, 4 and 25); the last line is {"ok": true,
"device": {...}}.

With --dp, phases 1, 2 and 28-40 run alone; with --axes, 1, 2 and 35-40.
With --loss-timing, only phase 1 and the autograd timing of phase 3 run,
on the surreal_tpu_torch package under ROOT (default: this checkout), so
two versions of the package can be timed in turns in one run on one card.
With --loss-sweep, phase 1 runs, then the loss kernels are rebuilt from
ppo_loss.cu at other cluster sizes and block widths and timed beside the
committed ones and beside empty kernels (the launch's floor), twice each.
With --gae-timing, phase 1 runs, then `returns.gae` of the package under
ROOT is held against its plain version and timed at the recipes' three
(T, B). With --gae-sweep, phase 1 runs, then the GAE kernel is rebuilt from
gae.cu at other (columns, chunks, steps) per block, each held against the
plain version and timed twice beside an empty launch of the same grid and
beside a kernel of that grid that only loads the inputs and stores the
outputs (the launch plus one memory round trip). With --learn, phases 1
and 2 run, then cartpole-balance PPO is trained through the CLI to its
recipe's budget of 4,000,000 env steps with the fused loss (~15 min),
results under DIR (default: a temporary directory), and the eval curve and
a final 32-episode evaluation are printed; it fails below a return of 900.
With `--learn DIR cheetah-run`, the cheetah-run PPO recipe (15,000,000 env
steps, 256 envs, the default unfused loss) is trained in bfloat16 and in
float32 as two processes at once on the card, each under DIR/<dtype> with
its output in DIR/<dtype>.log (~35 min); it fails if either scores below
700, which every evidence run passes (bfloat16 816.9; float32 784.5, 745.6,
791.8 over seeds 0-2). CLI FLAGS after DIR (and the task) go to the train
command after the recipe's, for runs that diagnose a score
(--session.seed, --learner.fused_loss false,
--session.log_every_iterations; with --learner.compute_dtype, cheetah-run
runs that one dtype alone).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import copy
import dataclasses
import functools
import hashlib
import inspect
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# Float32 operations each kernel does, counted from its source (a
# transcendental, a compare or a select counts as one): GAE per element,
# the loss forward and backward per row at A action dims.
GAE_OPS_PER_ELEM = 9
LOSS_FWD_OPS_PER_ROW = (23, 29)  # 23·A + 29
LOSS_BWD_OPS_PER_ROW = (22, 40)  # 22·A + 40, the shared log_std's row sum included
TOL_GAE = 1e-4  # T is split into chunks and recombined, each step one fused multiply-add
# (T, B) of the recipes: the main path's first
GAE_SHAPES = ((128, 256), (256, 128), (256, 256))
FINGER_GAE = (128, 128)  # finger-spin's recipe: horizon 128, 128 envs
FINGER_ACTIONS = 2
CARTPOLE_ACTIONS = 1  # cartpole-balance, the CLI phase's path: one actuator
PIXEL_ROWS = 2048  # the pixel PPO recipe's minibatch: 128 envs x horizon 128 / 8
GTRXL_ROWS = 16384  # the GTrXL cell's minibatch: 128 of 1,024 envs' sequences x horizon 128
TOL_LOSS_FWD = 1e-5  # the loss and 5 means of O(1) terms; 4096-term sums in another order
TOL_LOSS_BWD = 1e-6  # per-row gradients of size ~1e-4 (they carry 1/N), and their row sum
# The GTrXL cell's segment attention: B sequences, T steps, a memory of m, H
# heads of d_head; each output held to TOL_ATTENTION of its largest plain
# element (float32 sums of up to 640 terms, and dpos's over B and T, in
# another order; tests/test_torch_gtrxl_attention.py's bar)
GTRXL_SEGMENT = (128, 128, 512, 8, 32)
TOL_ATTENTION = 1e-5
ATTENTION_KERNELS = ("gtrxl_attention_fwd", "gtrxl_attention_bwd")
# The env step on the card against the CPU: sinf/cosf in FK differ by a few
# ulps between the two, and 20 Jacobi sweeps amplify that by the Delassus
# operator's conditioning. A contact is active iff its depth is > 0, so
# envs whose active sets differ between the devices, or with a contact
# within one float32 spacing of body heights (DEPTH_EPS) of depth 0, are
# excluded, as in tests/test_torch_physics.py; resting contacts make those
# a few percent of pool states.
TOL_ENV = 1e-3
DEPTH_EPS = 6e-8


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, reps: int) -> tuple[float, float]:
    """(device ms, call ms) per call of `fn`. The device time replays `reps`
    calls captured in one CUDA graph, so the host's launch overhead is
    excluded; the call time runs them eagerly, bounded by whichever of the
    host and the device is slower. Both from CUDA events, after warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / reps
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_ms, start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: int) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of the bytes moved over the
    memory rate and the float32 operations over the float32 peak."""
    by_bytes, by_ops = moved / MEM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return smi


def phase_build():
    from surreal_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in libs)})")
    for source in ("gae.cu", "ppo_loss.cu", "gtrxl_attention.cu"):
        for line in build.build_log(source).splitlines():
            if "ptxas" in line:
                print(f"build {source}: {line.strip()}")


def timeline(fn) -> tuple[list, list]:
    """(device events, host events) of one call of `fn` under torch.profiler,
    each (name, start ns, end ns, correlation id: a launch's and the device
    work it queued share theirs). Read from the profiler's raw events:
    building its FunctionEvent tree (`prof.events()`) takes tens of µs of
    host time an event, and a whole PPO iteration records ~10^6 of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # A profile that saw no device event at all is taken again: kineto now
    # and then drops a short session's events (seen on the card: one GAE
    # call's kernel, right after the loss kernels' profiles saw theirs).
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            if not getattr(e, "is_hidden_event", lambda: False)():
                item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id())
                (dev if e.device_type() == DeviceType.CUDA else host).append(item)
        if dev:
            break
    return dev, host


def device_events(fn) -> list[tuple[str, float]]:
    """(name, device µs) of each device kernel that one call of `fn` runs,
    under torch.profiler."""
    return [(name, (end - start) * 1e-3) for name, start, end, _ in timeline(fn)[0]]


def device_kernels(fn) -> list[str]:
    """Names of the device kernels that one call of `fn` runs."""
    return [name for name, _ in device_events(fn)]


def loss_autograd_times(plk, batch, coefs) -> dict[str, tuple[float, float]]:
    """(device ms, call ms) of the fused loss as autograd runs it, using only
    what every version of the package has: the forward (fused_clip_loss),
    the whole backward (the Function's backward as the engine calls it, on
    the saved inputs and a cotangent of 1) and both through autograd.grad."""
    leaves = [x.detach().requires_grad_() for x in batch[:3]]
    kw = dict(zip(("clip_eps", "value_coef", "entropy_coef"), coefs))
    g = torch.ones((), device=batch[0].device)
    ctx = types.SimpleNamespace(saved_tensors=tuple(batch), coefs=coefs)

    def forward():
        return plk.fused_clip_loss(*leaves, *batch[3:], **kw)

    fns = {"forward": forward,
           "backward": lambda: plk._FusedClipLoss.backward(ctx, g, None),
           "forward+backward": lambda: torch.autograd.grad(forward()[0], leaves, g)}
    return {name: timed(fn, 200) for name, fn in fns.items()}


def print_autograd_times(label: str, times: dict[str, tuple[float, float]]) -> None:
    print(f"loss autograd ({label}): " + "; ".join(
        f"{name} device {ms * 1e3:.2f} us, call {call_ms * 1e3:.2f} us"
        for name, (ms, call_ms) in times.items()))


def loss_batch(rng, N, A, device):
    f = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=device)  # noqa: E731
    mean, value, action = f(N, A), f(N), f(N, A)
    log_std = f(A) * 0.3
    mean_old = mean + 0.1 * f(N, A)
    log_std_old = (log_std + 0.05).expand(N, A).contiguous()
    from surreal_tpu_torch.models.distributions import DiagGauss

    logp_old = DiagGauss.log_prob(mean_old, log_std_old, action)
    return (mean, log_std, value, action, logp_old, mean_old, log_std_old,
            f(N), f(N), value + 0.1 * f(N))


def gae_batch(rng, T, B, dev):
    """GAE's arguments at (T, B): N(0, 1) floats, 2% terminations, 5% dones."""
    g = lambda: torch.tensor(rng.standard_normal((T, B)), dtype=torch.float32, device=dev)  # noqa: E731
    r, v, nv = g(), g(), g()
    disc = torch.tensor(rng.random((T, B)) > 0.02, dtype=torch.float32, device=dev)
    done = torch.tensor(rng.random((T, B)) < 0.05, dtype=torch.bool, device=dev)  # as traj.done
    return r, v, nv, disc, done, 0.99, 0.95


def gae_error(kernel, plain, args) -> float:
    """Max abs error of kernel(*args) against plain(*args), both outputs;
    fails above TOL_GAE or if two calls are not bitwise equal."""
    k, again, p = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    T, B = args[0].shape
    if any(a.shape != b.shape for a, b in zip(k, p)):
        fail(f"gae at ({T}, {B}): output shapes differ from the plain version's")
    if not all(torch.equal(a, b) for a, b in zip(k, again)):
        fail(f"gae at ({T}, {B}): two calls on the same inputs differ")
    err = max((a - b).abs().max().item() for a, b in zip(k, p))
    if not err <= TOL_GAE:
        fail(f"gae at ({T}, {B}) disagrees with its plain version: {err} > {TOL_GAE}")
    return err


def gae_at_shapes(label: str, returns, dev, shapes=GAE_SHAPES) -> None:
    """`returns.gae` with the kernel asked for (backend "pallas"; packages
    from before the argument took the kernel by default) held against
    `returns.gae_plain` and timed at `shapes`."""
    kernel = returns.gae
    if "backend" in inspect.signature(returns.gae).parameters:
        kernel = functools.partial(returns.gae, backend="pallas")
    rng = np.random.default_rng(1)
    for T, B in shapes:
        args = gae_batch(rng, T, B, dev)
        err = gae_error(kernel, returns.gae_plain, args)
        ms, call_ms = timed(lambda: kernel(*args), 200)
        moved = nbytes(*args[:5]) + 2 * nbytes(args[0])  # five inputs, two outputs
        print(f"gae ({label}) at (T, B) = ({T}, {B}): max_abs_err {err:.3e} (tol "
              f"{TOL_GAE:.0e}), device {ms * 1e3:.2f} us, call {call_ms * 1e3:.2f} us, bound "
              f"{bound(moved, GAE_OPS_PER_ELEM * T * B)[0] * 1e3:.3f} us ({moved} bytes)")


def gae_case(gae_kernel, returns, rng, T, B, dev) -> dict:
    """GAE's kernel at (T, B) held against its plain version and timed."""
    args = gae_batch(rng, T, B, dev)
    err = gae_error(gae_kernel.gae_cuda, returns.gae_plain, args)
    ms, call_ms = timed(lambda: gae_kernel.gae_cuda(*args), 200)
    plain_ms, plain_call_ms = timed(lambda: returns.gae_plain(*args), 10)
    moved = nbytes(*args[:5]) + 2 * nbytes(args[0])  # five inputs, two outputs
    bound_ms, bound_by = bound(moved, GAE_OPS_PER_ELEM * T * B)
    return dict(name="gae", route="cuda", source="surreal_tpu_torch/ops/csrc/gae.cu",
                replaces="surreal_tpu/ops/pallas_gae.py:72", max_abs_err=err, tol=TOL_GAE,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                bytes=moved, call_ms=call_ms, plain_call_ms=plain_call_ms, shape=[T, B])


def loss_cases(plk, rng, N, A, dev, batch=None, coefs=(0.2, 0.5, 0.0)
               ) -> tuple[dict, dict, tuple]:
    """The fused loss's forward and backward kernels at N rows and A action
    dims (log_std (A,) shared by all rows, log_std_old (N, A), a cotangent
    of 1), each held against its plain version and timed; and the batch.
    `batch` (a path's own minibatch, as fused_clip_loss took it) replaces
    the random one."""
    batch = loss_batch(rng, N, A, dev) if batch is None else batch
    g = torch.ones((), device=dev)
    k_fwd, p_fwd = plk.loss_fwd(*batch, *coefs), plk.loss_fwd_plain(*batch, *coefs)
    k_bwd, p_bwd = plk.loss_bwd(*batch, g, *coefs), plk.loss_bwd_plain(*batch, g, *coefs)
    torch.cuda.synchronize()
    for k, p in (*zip(k_fwd, p_fwd), *zip(k_bwd, p_bwd)):
        if k.shape != p.shape:
            fail(f"loss kernel output of shape {tuple(k.shape)}, plain {tuple(p.shape)}")
    fwd_err = max((a - b).abs().max().item() for a, b in zip(k_fwd, p_fwd))
    bwd_err = max((a - b).abs().max().item() for a, b in zip(k_bwd, p_bwd))
    # the forward reads every input and writes the loss and 5 metrics; the
    # backward reads all but mean_old and log_std_old (batch[5], batch[6])
    # and the cotangent, and writes dmean, dlog_std (A,) and dvalue
    fwd_moved = nbytes(*batch) + nbytes(*k_fwd)
    bwd_moved = nbytes(*batch[:5], *batch[7:], g) + nbytes(*k_bwd)
    out = []
    for name, line, err, tol, moved, ops, kernel, plain in (
            ("ppo_loss_fwd", 134, fwd_err, TOL_LOSS_FWD, fwd_moved, LOSS_FWD_OPS_PER_ROW,
             lambda: plk.loss_fwd(*batch, *coefs), lambda: plk.loss_fwd_plain(*batch, *coefs)),
            ("ppo_loss_bwd", 178, bwd_err, TOL_LOSS_BWD, bwd_moved, LOSS_BWD_OPS_PER_ROW,
             lambda: plk.loss_bwd(*batch, g, *coefs),
             lambda: plk.loss_bwd_plain(*batch, g, *coefs))):
        ms, call_ms = timed(kernel, 200)
        plain_ms, plain_call_ms = timed(plain, 50)
        bound_ms, bound_by = bound(moved, N * (ops[0] * A + ops[1]))
        out.append(dict(
            name=name, route="cuda", source="surreal_tpu_torch/ops/csrc/ppo_loss.cu",
            replaces=f"surreal_tpu/ops/pallas_ppo_loss.py:{line}", max_abs_err=err, tol=tol,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bytes=moved, call_ms=call_ms, plain_call_ms=plain_call_ms, shape=[N, A]))
    return out[0], out[1], (batch, coefs)


def print_kernel(k: dict) -> None:
    print(f"kernel {k['name']} at {tuple(k['shape'])}: max_abs_err {k['max_abs_err']:.3e} (tol "
          f"{k['tol']:.0e}); device time: kernel {k['ms'] * 1e3:.2f} us, plain "
          f"{k['plain_ms'] * 1e3:.2f} us; call time: kernel {k['call_ms'] * 1e3:.2f} us, "
          f"plain {k['plain_call_ms'] * 1e3:.2f} us; bound {k['bound_ms'] * 1e3:.3f} us "
          f"by {k['bound_by']} ({k['bytes']} bytes at 3.35 TB/s)")
    if not k["max_abs_err"] <= k["tol"]:
        fail(f"kernel {k['name']} at {tuple(k['shape'])} disagrees with its plain version: "
             f"{k['max_abs_err']} > {k['tol']}")


SLIM = ("name", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")


def event_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`: CUDA events around `reps` eager calls
    after one warm-up call, for calls of milliseconds of device work (which
    hides their launches' host time) that `timed`'s graph capture cannot
    hold: autograd's backward through a graph recorded outside the capture."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_cases(dev) -> dict:
    """The GTrXL segment attention's kernels at the cell's shape
    (GTRXL_SEGMENT), each held against `attention_plain` through autograd on
    the same inputs and timed against it: the forward's output, and the
    backward's dqu, dqv, dk, dv and dpos for a random cotangent. The ring
    has wrapped (t0 = 5,000); each env's episode began 0-999 steps before
    t0 and ends every 1,000 steps, so slots past its start are empty and
    some chunks hold a reset. Bounds from the benchmark's count
    (`segment_attention_cost`), whatever implements the attention."""
    from benchmark.metrics.gtrxl_segment_attention_roofline import segment_attention_cost
    from surreal_tpu_torch.models.gtrxl import segment_mask
    from surreal_tpu_torch.ops import gtrxl_attention_kernel as ra

    B, T, m, H, D = GTRXL_SEGMENT
    t0 = 5000
    g = torch.Generator(device=dev).manual_seed(0)
    f = lambda *shape: torch.randn(*shape, device=dev, generator=g)  # noqa: E731
    kv = f(B, m + T, 2 * H * D)  # k and v as the segment's views of one projection
    k, v = (x.reshape(B, m + T, H, D) for x in kv.chunk(2, -1))
    leaves = [x.detach().requires_grad_() for x in (f(B, T, H, D), f(B, T, H, D), k, v,
                                                      f(m + 1, H, D))]
    dout = f(B, T, H, D)
    age = torch.randint(0, 1000, (B,), device=dev, generator=g)  # steps of the episode at t0
    done = (age[None, :] + torch.arange(T, device=dev)[:, None] + 1) % 1000 == 0  # (T, B)
    episode = torch.cumsum(done.long(), 0) - done.long()
    slot_dist = torch.remainder(t0 - 1 - torch.arange(m, device=dev), m) + 1
    valid = slot_dist[None, :] <= age[:, None]
    index, plain_index = ra.kernel_index(episode, valid, t0, m), segment_mask(episode, valid, t0, m)
    out = ra.attention(*leaves, *index)
    ref = ra.attention_plain(*leaves, *plain_index)
    grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    ref_grads = torch.autograd.grad(ref, leaves, dout, retain_graph=True)
    torch.cuda.synchronize()
    names = ("out", "dqu", "dqv", "dk", "dv", "dpos")
    pairs = list(zip(names, (out.detach(), *grads), (ref.detach(), *ref_grads)))
    rel = {n: float((a - b).abs().max() / b.abs().max()) for n, a, b in pairs}
    abs_err = {n: float((a - b).abs().max()) for n, a, b in pairs}

    def forward(fn, idx):
        with torch.no_grad():
            fn(*leaves, *idx)

    f_moved, f_ops, b_moved, b_ops = segment_attention_cost(
        {"width": H * D, "heads": H, "memory": m}, B, T)
    cases = {}
    for name, outputs, moved, ops, kernel, plain in (
            (ATTENTION_KERNELS[0], names[:1], f_moved, f_ops,
             lambda: forward(ra.attention, index), lambda: forward(ra.attention_plain, plain_index)),
            (ATTENTION_KERNELS[1], names[1:], b_moved, b_ops,
             lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True),
             lambda: torch.autograd.grad(ref, leaves, dout, retain_graph=True))):
        ms, plain_ms = event_ms(kernel, 10), event_ms(plain, 3)
        bound_ms, bound_by = bound(moved, ops)
        cases[name] = dict(
            name=name, route="cuda", source="surreal_tpu_torch/ops/csrc/gtrxl_attention.cu",
            replaces=None, max_abs_err=max(abs_err[n] for n in outputs),
            max_rel_err={n: rel[n] for n in outputs}, tol=TOL_ATTENTION, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bytes=moved, call_ms=ms, plain_call_ms=plain_ms, shape=[B, H, T, m + T, D])
        print(f"kernel {name} at (B, H, T, m + T, d_head) = {(B, H, T, m + T, D)}: max |kernel - "
              f"plain| / max |plain| {json.dumps({n: rel[n] for n in outputs})} (tol "
              f"{TOL_ATTENTION:.0e}); device time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
              f"bound {bound_ms:.3f} ms by {bound_by} ({ops} operations, {moved} bytes)")
        if not max(rel[n] for n in outputs) <= TOL_ATTENTION:
            fail(f"kernel {name} disagrees with attention_plain: {rel}")
    return cases


def phase_kernels(dev):
    """Each kernel at the cheetah path's shapes (the kernels line's entry),
    at the finger-spin path's, at the CLI cartpole path's and, for the loss,
    at the pixel PPO and GTrXL paths': GAE at (T, B) = (128, 256) and
    (128, 128), the loss at N = 4096 rows with A = 6, 2 and 1, at N = 2048
    with A = 6 and at N = 16,384 with A = 6; and the GTrXL segment
    attention's two kernels at the GTrXL cell's shape (`attention_cases`)."""
    from surreal_tpu_torch.ops import gae_kernel, ppo_loss_kernel as plk, returns

    rng = np.random.default_rng(0)
    out = {"gae": gae_case(gae_kernel, returns, rng, *GAE_SHAPES[0], dev)}
    fwd, bwd, (batch, coefs) = loss_cases(plk, rng, 4096, 6, dev)
    out.update(ppo_loss_fwd=fwd, ppo_loss_bwd=bwd)
    finger = {"gae": gae_case(gae_kernel, returns, rng, *FINGER_GAE, dev)}
    f_fwd, f_bwd, _ = loss_cases(plk, rng, 4096, FINGER_ACTIONS, dev)
    finger.update(ppo_loss_fwd=f_fwd, ppo_loss_bwd=f_bwd)
    c_fwd, c_bwd, _ = loss_cases(plk, rng, 4096, CARTPOLE_ACTIONS, dev)
    cartpole = {"ppo_loss_fwd": c_fwd, "ppo_loss_bwd": c_bwd}
    p_fwd, p_bwd, _ = loss_cases(plk, rng, PIXEL_ROWS, 6, dev)
    pixel = {"ppo_loss_fwd": p_fwd, "ppo_loss_bwd": p_bwd}
    g_fwd, g_bwd, _ = loss_cases(plk, rng, GTRXL_ROWS, 6, dev)
    gtrxl = {"ppo_loss_fwd": g_fwd, "ppo_loss_bwd": g_bwd}
    for name, k in out.items():
        print_kernel(k)
        print_kernel(finger[name])
        k["at_finger_spin_shape"] = {f: finger[name][f] for f in SLIM}
        if name in cartpole:
            print_kernel(cartpole[name])
            k["at_cartpole_shape"] = {f: cartpole[name][f] for f in SLIM}
            print_kernel(pixel[name])
            k["at_pixel_ppo_shape"] = {f: pixel[name][f] for f in SLIM}
            print_kernel(gtrxl[name])
            k["at_gtrxl_shape"] = {f: gtrxl[name][f] for f in SLIM}
    gae_at_shapes("this checkout", returns, dev, GAE_SHAPES[1:])
    print_autograd_times("this checkout", loss_autograd_times(plk, batch, coefs))
    out.update(attention_cases(dev))
    return out


def phase_small_parity(dev):
    """The card's update (loss kernels; GAE by the reference's default, the
    torch scan) against the CPU's (plain versions) on one small trajectory,
    the GAE kernel (backend "pallas") on the card against the update's GAE
    on the CPU on the same trajectory, and one env step on both devices."""
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.envs import flatten_obs, make_env
    from surreal_tpu_torch.envs.physics import engine
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic
    from surreal_tpu_torch.ops import gae_kernel, ppo_loss_kernel as plk, returns

    cfg = ppo.PPOConfig(horizon=16, epochs=2, num_minibatches=2, fused_loss=True)
    B = 32  # 16 x 32 = 512 rows, minibatches of 256: the fused gate admits
    env = make_env("cheetah-run", device="cpu")
    gen = torch.Generator().manual_seed(0)
    net = PPOActorCritic(17, 6, hidden=(32, 32), generator=torch.Generator().manual_seed(0))
    state = ppo.init_state(cfg, net, 17)
    env_state, ts = env.reset(B, gen)
    traj, *_ = ppo.rollout(cfg, env, flatten_obs, state, env_state, flatten_obs(ts.obs),
                           torch.zeros(B), gen)
    perms = torch.stack([torch.randperm(16 * B, generator=gen) for _ in range(cfg.epochs)])

    results = {}
    before = (gae_kernel.GAE.launches, plk.FWD.launches, plk.BWD.launches)
    for d in ("cpu", dev):
        net_d = PPOActorCritic(17, 6, hidden=(32, 32)).to(d)
        net_d.load_state_dict(net.state_dict())
        st = ppo.init_state(cfg, net_d, 17)
        tr = ppo.Trajectory(**{k: x.to(d) for k, x in vars(traj).items()})
        st, metrics = ppo.update(cfg, st, tr, None, perms.to(d))
        results[d] = ({k: p.detach().cpu() for k, p in net_d.named_parameters()},
                      {k: float(x) for k, x in metrics.items()})
    gae_args = (traj.reward, traj.value, traj.next_value, traj.discount, traj.done,
                cfg.gamma, cfg.lam)
    gae_card = returns.gae(*(x.to(dev) for x in gae_args[:5]), *gae_args[5:], backend="pallas")
    gae_err = max((a.cpu() - b).abs().max().item()
                  for a, b in zip(gae_card, returns.gae(*gae_args)))
    after = (gae_kernel.GAE.launches, plk.FWD.launches, plk.BWD.launches)
    if [a - b for a, b in zip(after, before)] != [1, 4, 4]:
        fail(f"the small update and GAE did not run through the kernels: {before} -> {after} "
             "(expected the loss kernels 4 times each in the update, GAE once when asked)")
    print(f"gae kernel on the card vs the update's gae on the cpu: max_abs_err {gae_err:.3e} "
          f"(tol {TOL_GAE:.0e})")
    if not gae_err <= TOL_GAE:
        fail("the GAE kernel on the card disagrees with the update's GAE on the CPU")
    p_err = max((results["cpu"][0][k] - results[dev][0][k]).abs().max().item()
                for k in results["cpu"][0])
    m_err = max(abs(results["cpu"][1][k] - results[dev][1][k]) / max(1.0, abs(results["cpu"][1][k]))
                for k in results["cpu"][1])
    print(f"small update card vs cpu: params max_abs_err {p_err:.3e} (tol 1e-5), "
          f"metrics max_rel_err {m_err:.3e} (tol 1e-4)")
    if not (p_err <= 1e-5 and m_err <= 1e-4):
        fail("the card's PPO update disagrees with the CPU's")

    env_gpu = make_env("cheetah-run", device=dev)
    draw = env.draw_reset(256, gen)
    action = torch.rand(256, 6, generator=gen) * 2 - 1
    outs = []
    for e, d in ((env, "cpu"), (env_gpu, dev)):
        s, _ = e.reset(256, reset_draw={k: x.to(d) for k, x in draw.items()})
        depth = engine._contact_kinematics(e.model, s.q)[1].cpu()
        s2, ts2 = e.step(s, action.to(d), reset_draw={k: x.to(d) for k, x in draw.items()})
        outs.append((s2.qd.cpu(), ts2.reward.cpu(), depth))
    (qd_c, rew_c, depth_c), (qd_g, rew_g, depth_g) = outs
    keep = (((depth_c > 0) == (depth_g > 0)).all(1)
            & (depth_c.abs().amin(1) > DEPTH_EPS) & (depth_g.abs().amin(1) > DEPTH_EPS))
    qd_err = (qd_c - qd_g).abs()[keep].max().item()
    rew_err = (rew_c - rew_g).abs()[keep].max().item()
    n_out = int((~keep).sum())
    print(f"env step card vs cpu: {int(keep.sum())} of 256 envs compared ({n_out} with "
          f"another active set or a contact within {DEPTH_EPS:.0e} of depth 0 excluded), "
          f"qd max_abs_err {qd_err:.3e}, reward max_abs_err {rew_err:.3e} (tol {TOL_ENV:.0e})")
    if n_out > 256 // 8:
        fail(f"{n_out} of 256 envs have a contact at depth ~0: too few left to compare")
    if not (qd_err <= TOL_ENV and rew_err <= TOL_ENV):
        fail("the card's env step disagrees with the CPU's")


def path_kernels() -> dict:
    """The launchers whose counts say which kernels a path went through."""
    from surreal_tpu_torch.ops import gae_kernel, ppo_loss_kernel as plk

    return {"gae": gae_kernel.GAE, "ppo_loss_fwd": plk.FWD, "ppo_loss_bwd": plk.BWD}


def attention_kernels() -> dict:
    """The GTrXL segment attention's launchers (`GTrXL.segment` alone
    launches them)."""
    from surreal_tpu_torch.ops import gtrxl_attention_kernel as ra

    return dict(zip(ATTENTION_KERNELS, (ra.FWD, ra.BWD)))


def phase_slice(dev):
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = PPOConfig(horizon=128, epochs=4, num_minibatches=8, lr=3e-4, fused_loss=True)
    trainer = PPOTrainer("cheetah-run", cfg, num_envs=256, hidden=(256, 256), seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    warm_iters, timed_iters = 1, 2
    t0 = time.perf_counter()
    trainer.run(warm_iters, log_every=warm_iters)  # raises on non-finite metrics
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logs = trainer.run(timed_iters, log_every=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    iters = warm_iters + timed_iters
    want = {"gae": 0, "ppo_loss_fwd": 32 * iters, "ppo_loss_bwd": 32 * iters}
    print(f"slice launches over {iters} iterations: {launches} (expected {want})")
    if launches != want:
        fail(f"main path launch counts {launches} != {want}")
    sec_per_iter = (t2 - t1) / timed_iters
    for m in logs:
        print("slice metrics: " + json.dumps({k: m[k] for k in (
            "iteration", "policy_loss", "value_loss", "entropy", "kl", "grad_norm",
            "reward_per_step", "env_steps_per_s")}))
    print(f"slice: warm-up {t1 - t0:.2f} s, {sec_per_iter:.3f} s/iteration, "
          f"{trainer.steps_per_iteration / sec_per_iter:.1f} env-steps/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return trainer, launches


PROFILED_STEPS = 16  # rollout steps of phase 25's profile, of the horizon's 128


def breakdown(trainer):
    """One more iteration split into rollout and update on the host clock;
    then, under torch.profiler, a window of PROFILED_STEPS rollout steps and
    one whole update of that iteration's trajectory, for the device's busy
    time and kernel count per rollout step and per update (the profiler
    slows the host, so the idle shares are taken against the unprofiled
    times of the same parts), and an iteration's from them; and the loss's
    device kernels, for one call each way and in one minibatch step."""
    from surreal_tpu_torch.algos import ppo

    t = trainer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
        t.cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ppo.update(t.cfg, t.state, traj, t.generator)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    # A forward and a backward of fused_clip_loss at the main path's
    # minibatch: one device kernel each. These short profiles go first: run
    # after a profile of a whole iteration, they saw no device events.
    from surreal_tpu_torch.ops import ppo_loss_kernel as plk

    batch = loss_batch(np.random.default_rng(0), 4096, 6, traj.obs.device)
    leaves = [x.requires_grad_() for x in batch[:3]]
    g = torch.ones((), device=traj.obs.device)
    state = {}
    fwd_names = device_kernels(lambda: state.update(loss=plk.fused_clip_loss(
        *leaves, *batch[3:], clip_eps=0.2, value_coef=0.5, entropy_coef=0.0)[0]))
    bwd_names = device_kernels(lambda: torch.autograd.grad(state["loss"], leaves, g))
    print(f"loss autograd: forward runs {fwd_names}, backward runs {bwd_names}")
    if len(fwd_names) != 1 or len(bwd_names) != 1:
        fail("a forward or a backward of fused_clip_loss is not one device kernel")
    from surreal_tpu_torch.ops import returns

    gae_names = device_kernels(lambda: returns.gae(
        traj.reward, traj.value, traj.next_value, traj.discount, traj.done, t.cfg.gamma,
        t.cfg.lam, backend="pallas"))
    print(f"returns.gae(backend='pallas') on the main path's trajectory runs {gae_names}")
    if len(gae_names) != 1 or "gae_kernel" not in gae_names[0]:
        fail("one call of returns.gae(backend='pallas') is not one device kernel")

    window = dataclasses.replace(t.cfg, horizon=PROFILED_STEPS)

    def rollout():
        t.env_state, t.obs, t.ep_ret = ppo.rollout(
            window, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)[1:4]

    n_roll, busy_roll = profiled(rollout)
    n_upd, busy_upd = profiled(lambda: ppo.update(t.cfg, t.state, traj, t.generator))
    per_step = n_roll / PROFILED_STEPS
    roll_wall = (t1 - t0) * PROFILED_STEPS / t.cfg.horizon
    busy_s = busy_roll * t.cfg.horizon / PROFILED_STEPS + busy_upd
    wall_s = t2 - t0
    print(f"breakdown: rollout {t1 - t0:.3f} s ({(t1 - t0) / t.cfg.horizon * 1e3:.2f} ms per "
          f"env step), update {t2 - t1:.3f} s; profiled {PROFILED_STEPS} rollout steps: "
          f"{n_roll} device kernels ({per_step:.1f} an env step), device busy {busy_roll:.4f} s "
          f"(idle {100 * (1 - busy_roll / roll_wall):.1f}% of the same steps unprofiled); the "
          f"whole update: {n_upd} device kernels, device busy {busy_upd:.4f} s (idle "
          f"{100 * (1 - busy_upd / (t2 - t1)):.1f}%); an iteration: "
          f"{per_step * t.cfg.horizon + n_upd:.0f} device kernels, device busy {busy_s:.3f} s "
          f"= {100 * busy_s / wall_s:.1f}% of the unprofiled {wall_s:.3f} s (idle "
          f"{100 * (1 - busy_s / wall_s):.1f}%)")
    if n_roll == 0 or n_upd == 0:
        fail("the profiler saw no device kernel in the PPO slice")

    # One minibatch step of the main path's update: the first 16 steps of the
    # rollout are 16 x 256 = 4096 rows, the main path's minibatch, taken in
    # one epoch of one minibatch.
    step_cfg = dataclasses.replace(t.cfg, epochs=1, num_minibatches=1)
    short = ppo.Trajectory(**{k: x[:16] for k, x in vars(traj).items()})
    names = device_kernels(lambda: ppo.update(step_cfg, t.state, short, t.generator))
    loss_names = [n for n in names if "ppo_loss" in n]
    print(f"one minibatch step of the update: {len(names)} device kernels (GAE and the "
          f"advantage normalisation included), of which {len(loss_names)} of the loss: "
          f"{loss_names}")
    if len(loss_names) != 2:
        fail(f"one minibatch step ran {len(loss_names)} loss kernels, not 2")


def profiled(fn, top: int = 0) -> tuple:
    """(device kernels, their summed device seconds) of one call of `fn`
    under torch.profiler; with `top`, also the `top` kernel names with the
    most device ms, and their ms."""
    events = device_events(fn)
    spans = [us for _, us in events]
    if not top:
        return len(spans), sum(spans) * 1e-6
    by_name = {}
    for name, us in events:
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + us * 1e-3
    return len(spans), sum(spans) * 1e-6, dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def new_cells_profile(ddpg_t, ddpg_times, lstm_t, lstm_times):
    """Device kernels and device busy time of the DDPG and recurrent PPO
    cells, under torch.profiler (so after every timing). DDPG: one whole
    rollout and one whole update block. Recurrent PPO: a rollout cut to 16
    of its 128 steps and one epoch (8 of the update's 32 minibatch steps; GAE
    and the advantage normalisation run once in it). The idle shares are
    taken against the unprofiled times of the same parts read in the cells'
    own phases."""
    from surreal_tpu_torch.algos import ddpg, ppo_lstm

    t, cfg = ddpg_t, ddpg_t.cfg

    def ddpg_rollout():
        (t.replay, t.env_state, t.obs, t.ou_state, t.ep_ret, _, _) = ddpg.rollout(
            cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ou_state, t.sigma, t.ep_ret,
            t.generator, t.replay)

    n_roll, busy_roll = profiled(ddpg_rollout)
    n_upd, busy_upd = profiled(lambda: ddpg.update(cfg, t.state, t.replay, t.generator))
    wall = ddpg_times["rollout_s"] + ddpg_times["update_block_s"]
    out = {"phase": "ddpg_profile", "rollout_steps": cfg.rollout_steps,
           "updates": cfg.updates_per_iteration, "rollout_kernels": n_roll,
           "kernels_per_env_step": n_roll / cfg.rollout_steps, "update_block_kernels": n_upd,
           "kernels_per_update": n_upd / cfg.updates_per_iteration,
           "kernels_per_iteration": n_roll + n_upd, "rollout_busy_s": busy_roll,
           "update_block_busy_s": busy_upd, "unprofiled_rollout_s": ddpg_times["rollout_s"],
           "unprofiled_update_block_s": ddpg_times["update_block_s"],
           "idle_share": 1 - (busy_roll + busy_upd) / wall}
    print(json.dumps(out))
    if n_roll == 0 or n_upd == 0:
        fail("the profiler saw no device kernel in the DDPG cell")

    t, cfg = lstm_t, lstm_t.cfg
    steps = 16
    short = dataclasses.replace(cfg, horizon=steps)
    state = {}

    def lstm_rollout():
        state["traj"], t.env_state, t.obs, t.carry, t.ep_ret, _ = ppo_lstm.rollout(
            short, t.env, t._flatten, t.state, t.env_state, t.obs, t.carry, t.ep_ret,
            t.generator)

    # the trajectory of the whole horizon for the update, unprofiled
    full, t.env_state, t.obs, t.carry, t.ep_ret, _ = ppo_lstm.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.carry, t.ep_ret, t.generator)
    n_roll, busy_roll = profiled(lstm_rollout)
    epoch = dataclasses.replace(cfg, epochs=1)
    n_upd, busy_upd = profiled(lambda: ppo_lstm.update(epoch, t.state, full, t.generator))
    roll_wall = lstm_times["ms_per_env_step"] * 1e-3 * steps
    epoch_wall = lstm_times["update_s"] / cfg.epochs
    out = {"phase": "lstm_ppo_profile", "rollout_steps_profiled": steps,
           "minibatch_steps_profiled": cfg.num_minibatches, "rollout_kernels": n_roll,
           "kernels_per_env_step": n_roll / steps, "epoch_kernels": n_upd,
           "kernels_per_minibatch_step": n_upd / cfg.num_minibatches,
           "rollout_busy_s": busy_roll, "epoch_busy_s": busy_upd,
           "unprofiled_s_of_the_same_rollout_steps": roll_wall,
           "unprofiled_s_of_one_epoch": epoch_wall,
           "rollout_idle_share": 1 - busy_roll / roll_wall,
           "update_idle_share": 1 - busy_upd / epoch_wall}
    print(json.dumps(out))
    if n_roll == 0 or n_upd == 0:
        fail("the profiler saw no device kernel in the recurrent PPO cell")


def finger_profile(t, times):
    """Device kernels and device busy time of the finger-spin cell under
    torch.profiler (after every timing): a rollout cut to 4 of its 128
    control steps, and one epoch of the update (4 of its 16 minibatch
    steps; GAE and the advantage normalisation run once in it). The idle
    shares are taken against the unprofiled times of the same parts."""
    from surreal_tpu_torch.algos import ppo

    steps = 4
    short = dataclasses.replace(t.cfg, horizon=steps)
    full, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
        t.cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)

    def rollout():
        t.env_state, t.obs, t.ep_ret = ppo.rollout(
            short, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)[1:4]

    n_roll, busy_roll = profiled(rollout)
    epoch = dataclasses.replace(t.cfg, epochs=1)
    n_upd, busy_upd = profiled(lambda: ppo.update(epoch, t.state, full, t.generator))
    roll_wall = times["ms_per_env_step"] * 1e-3 * steps
    epoch_wall = times["update_s"] / t.cfg.epochs
    out = {"phase": "ppo_finger_spin_profile", "rollout_steps_profiled": steps,
           "minibatch_steps_profiled": t.cfg.num_minibatches, "rollout_kernels": n_roll,
           "kernels_per_control_step": n_roll / steps,
           "kernels_per_substep_approx": n_roll / steps / 2, "epoch_kernels": n_upd,
           "kernels_per_minibatch_step": n_upd / t.cfg.num_minibatches,
           "rollout_busy_s": busy_roll, "epoch_busy_s": busy_upd,
           "unprofiled_s_of_the_same_rollout_steps": roll_wall,
           "unprofiled_s_of_one_epoch": epoch_wall,
           "rollout_idle_share": 1 - busy_roll / roll_wall,
           "update_idle_share": 1 - busy_upd / epoch_wall}
    print(json.dumps(out))
    if n_roll == 0 or n_upd == 0:
        fail("the profiler saw no device kernel in the finger-spin cell")


def check_finite(label: str, m: dict) -> None:
    bad = [k for k, v in m.items() if not np.isfinite(v)]
    if bad:
        fail(f"{label}: non-finite {bad} in {m}")


TOL_DDPG_PARITY = 1e-5  # the bar the small PPO update is held to; metrics 1e-4 relative


def phase_ddpg_parity(dev):
    """One block of 4 DDPG updates (TD3 knobs on, so every branch runs) on
    the card against the CPU's, from the same networks, ring and draws."""
    from surreal_tpu_torch.algos import ddpg
    from surreal_tpu_torch.data import replay as rp
    from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic

    B, D, A, U, batch = 16, 17, 6, 4, 64
    cfg = ddpg.DDPGConfig(batch_size=batch, updates_per_iteration=U, replay_capacity=48 * B,
                          actor_delay=2, target_noise=0.2)
    gen = torch.Generator().manual_seed(0)
    chunks = [{"obs": torch.randn(20, B, D, generator=gen),
               "action": torch.rand(20, B, A, generator=gen) * 2 - 1,
               "reward": torch.rand(20, B, generator=gen),
               "done": torch.rand(20, B, generator=gen) < 0.05} for _ in range(3)]  # 60 > 48: wraps
    oldest = 60 - 48
    indices = [(oldest + torch.randint(0, 48 - cfg.n_step, (batch,), generator=gen),
                torch.randint(0, B, (batch,), generator=gen)) for _ in range(U)]
    target_eps = torch.randn(U, batch, A, generator=gen)
    results = {}
    for d in ("cpu", dev):
        init = torch.Generator().manual_seed(1)
        state = ddpg.init_state(cfg, DDPGActor(D, A, (64, 48), generator=init).to(d),
                                DDPGCritic(D, A, (64, 48), generator=init).to(d), D)
        ring = ddpg.init_replay(cfg, B, D, A, d)
        for chunk in chunks:
            ring = rp.replay_insert(ring, {k: v.to(d) for k, v in chunk.items()})
        state, metrics = ddpg.update(cfg, state, ring, None,
                                     [(a.to(d), b.to(d)) for a, b in indices], target_eps.to(d))
        nets = {"actor": state.actor, "critic": state.critic,
                "target_actor": state.target_actor, "target_critic": state.target_critic}
        results[d] = ({f"{n}.{k}": p.detach().cpu() for n, net in nets.items()
                       for k, p in net.named_parameters()},
                      {k: float(x) for k, x in metrics.items()},
                      {k: v.cpu() for k, v in ring.data.items()})
    (p_c, m_c, r_c), (p_g, m_g, r_g) = results["cpu"], results[dev]
    if not all(torch.equal(r_c[k], r_g[k]) for k in r_c):
        fail("the ring on the card differs from the CPU's after a wrapped insert")
    p_err = max((p_c[k] - p_g[k]).abs().max().item() for k in p_c)
    m_err = max(abs(m_c[k] - m_g[k]) / max(1.0, abs(m_c[k])) for k in m_c)
    print(json.dumps({"phase": "ddpg_card_vs_cpu", "updates": U, "params_max_abs_err": p_err,
                      "tol": TOL_DDPG_PARITY, "metrics_max_rel_err": m_err,
                      "metrics_tol": 1e-4, "metrics": m_g}))
    check_finite("ddpg card vs cpu", m_g)
    if not (p_err <= TOL_DDPG_PARITY and m_err <= 1e-4):
        fail("the card's DDPG update block disagrees with the CPU's")


def phase_ddpg(dev):
    """DDPG at the cheetah-run recipe's configuration, nothing cut. Returns
    the trainer, the three kernels' launch counts as read after this path's
    last update (set to 0 before its first iteration) and its times."""
    from surreal_tpu_torch.algos import ddpg
    from surreal_tpu_torch.train import DDPGTrainer

    cfg = ddpg.DDPGConfig()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()  # the earlier phases' trainer is still alive
    t = DDPGTrainer("cheetah-run", cfg, num_envs=256, seed=0, device=dev)
    kernels = path_kernels()
    for k in kernels.values():
        k.launches = 0
    initial = [p.detach().clone() for p in t.state.target_critic.parameters()]
    warm_iters, timed_iters = 3, 5
    t0 = time.perf_counter()
    warm = t.run(warm_iters, log_every=warm_iters)[-1]  # raises on non-finite metrics
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if warm["updates"] != cfg.updates_per_iteration:
        fail(f"updates should begin at iteration 3: {warm['updates']} done after 3")
    m = t.run(timed_iters, log_every=timed_iters)[-1]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # one more iteration, split on the host clock
    (t.replay, t.env_state, t.obs, t.ou_state, t.ep_ret, _, _) = ddpg.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ou_state, t.sigma, t.ep_ret,
        t.generator, t.replay)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    _, last = ddpg.update(cfg, t.state, t.replay, t.generator)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    iters = warm_iters + timed_iters + 1
    sec_per_iter = (t2 - t1) / timed_iters
    ring_bytes = nbytes(*t.replay.data.values())
    out = {"phase": "ddpg_slice", "num_envs": 256, "capacity_t": t.replay.capacity_t,
           "ring_transitions": t.replay.capacity_t * 256, "ring_bytes": ring_bytes,
           "warmup_s": t1 - t0, "s_per_iteration": sec_per_iter,
           "env_steps_per_s": t.steps_per_iteration / sec_per_iter,
           "rollout_s": t3 - t2, "ms_per_env_step": (t3 - t2) / cfg.rollout_steps * 1e3,
           "update_block_s": t4 - t3,
           "ms_per_update": (t4 - t3) / cfg.updates_per_iteration * 1e3,
           "updates_done": t.state.update_step, "replay_total": t.replay.total,
           "critic_loss": m["critic_loss"], "actor_loss": m["actor_loss"],
           "q_mean": m["q_mean"], "kernel_launches": launches, "max_memory_allocated": peak,
           "memory_allocated_before": held_before, "peak_above_held_before": peak - held_before}
    print(json.dumps(out))
    check_finite("ddpg slice", {k: float(v) for k, v in last.items()} | m)
    if any(launches.values()):
        fail(f"the DDPG path launched {launches}: the reference's reaches none of these kernels")
    if t.replay.capacity_t * 256 < 999_000 or ring_bytes < 90e6:
        fail(f"the ring is not the recipe's 1,000,000 transitions: {out}")
    # updates run from the third iteration on; every iteration inserts 16 steps
    if t.state.update_step != cfg.updates_per_iteration * (iters - 2):
        fail(f"update_step {t.state.update_step} != 16 x {iters - 2}")
    if t.replay.total != cfg.rollout_steps * iters:
        fail(f"replay total {t.replay.total} != 16 x {iters}")
    if m["critic_loss"] <= 0:
        fail("the critic loss is not positive: no update ran")
    for tgt, live, init in zip(t.state.target_critic.parameters(), t.state.critic.parameters(),
                               initial):
        if tgt.dim() == 2 and (torch.equal(tgt, live) or torch.equal(tgt, init)):
            fail("a target weight equals the live one, or never moved")
    return t, launches, out


def phase_lstm(dev):
    """Recurrent PPO at the flagship's widths. Returns the trainer, the three
    kernels' launch counts as read after this path's last update (set to 0
    before its first iteration) and its times."""
    from surreal_tpu_torch.algos import ppo_lstm
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.ops import gae_kernel
    from surreal_tpu_torch.train import PPOTrainer

    cfg = PPOConfig(horizon=128, epochs=4, num_minibatches=8, lr=3e-4, fused_loss=True)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t = PPOTrainer("cheetah-run", cfg, num_envs=256, hidden=(256, 256), seed=0, device=dev,
                   use_lstm=True, lstm_size=128)
    kernels = path_kernels()
    for k in kernels.values():
        k.launches = 0
    warm_iters, timed_iters = 1, 2
    t0 = time.perf_counter()
    t.run(warm_iters, log_every=warm_iters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if gae_kernel.GAE.launches:
        fail(f"the recurrent warm-up launched GAE {gae_kernel.GAE.launches} times, not 0")
    m = t.run(timed_iters, log_every=timed_iters)[-1]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    traj, t.env_state, t.obs, t.carry, t.ep_ret, _ = ppo_lstm.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.carry, t.ep_ret, t.generator)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    _, last = ppo_lstm.update(cfg, t.state, traj, t.generator)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    iters = warm_iters + timed_iters + 1
    sec_per_iter = (t2 - t1) / timed_iters
    carry_abs = max(float(c.abs().max()) for c in t.carry)
    out = {"phase": "lstm_ppo_slice", "num_envs": 256, "hidden": [256, 256], "lstm_size": 128,
           "warmup_s": t1 - t0, "s_per_iteration": sec_per_iter,
           "env_steps_per_s": t.steps_per_iteration / sec_per_iter,
           "rollout_s": t3 - t2, "ms_per_env_step": (t3 - t2) / cfg.horizon * 1e3,
           "update_s": t4 - t3,
           "ms_per_minibatch_step": (t4 - t3) / (cfg.epochs * cfg.num_minibatches) * 1e3,
           "kernel_launches": launches, "iterations": iters, "carry_max_abs": carry_abs,
           "policy_loss": m["policy_loss"], "value_loss": m["value_loss"], "kl": m["kl"],
           "grad_norm": m["grad_norm"], "reward_per_step": m["reward_per_step"],
           "max_memory_allocated": peak, "memory_allocated_before": held_before,
           "peak_above_held_before": peak - held_before}
    print(json.dumps(out))
    check_finite("lstm slice", {k: float(v) for k, v in last.items()} | m)
    if launches["gae"]:
        fail(f"{iters} recurrent iterations launched the GAE kernel {launches['gae']} times: "
             "the reference's recurrent GAE is its default, the XLA scan")
    if launches["ppo_loss_fwd"] or launches["ppo_loss_bwd"]:
        fail("the recurrent path launched the fused loss, which the reference does not use there")
    if not carry_abs > 0:
        fail("the LSTM carry is zero after the rollouts")
    if t.state.update_step != iters or t.state.opt_state.count != 32 * iters:
        fail(f"update_step {t.state.update_step}, Adam count {t.state.opt_state.count}")
    return t, launches, out


def phase_gtrxl(dev):
    """GTrXL PPO at the published widths over 128 envs. Returns the five
    kernels' launch counts as read after its last update (set to 0 before
    its first iteration)."""
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    cfg = PPOConfig(horizon=128, epochs=4, num_minibatches=8, lr=3e-4, fused_loss=True)
    torso = dict(layers=12, width=256, heads=8, memory=512, mlp_width=1024)
    torch.cuda.reset_peak_memory_stats()
    t = PPOTrainer("cheetah-run", cfg, num_envs=128, seed=0, device=dev, torso="gtrxl",
                   gtrxl=torso)
    kernels = {**path_kernels(), **attention_kernels()}
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    t.run(1, log_every=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m = t.run(1, log_every=1)[-1]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    written = int(t.carry.valid.sum(1).min())
    out = {"phase": "gtrxl_ppo", "num_envs": 128, "gtrxl": torso, "warmup_s": t1 - t0,
           "s_per_iteration": t2 - t1, "env_steps_per_s": t.steps_per_iteration / (t2 - t1),
           "kernel_launches": launches, "iterations": 2, "fewest_valid_slots": written,
           "policy_loss": m["policy_loss"], "value_loss": m["value_loss"], "kl": m["kl"],
           "grad_norm": m["grad_norm"], "reward_per_step": m["reward_per_step"],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(json.dumps(out))
    check_finite("gtrxl", m)
    segments = 2 * cfg.epochs * cfg.num_minibatches  # minibatch steps in 2 iterations
    want = {"gae": 0, "ppo_loss_fwd": segments, "ppo_loss_bwd": segments,
            **dict.fromkeys(ATTENTION_KERNELS, torso["layers"] * segments)}
    if launches != want:
        fail(f"2 GTrXL iterations launched {launches}, not {want}: the loss forward and "
             "backward once a minibatch step, the attention's once a layer, GAE never")
    if t.carry.t != 2 * cfg.horizon or not 0 < written <= 2 * cfg.horizon:
        fail(f"the GTrXL clock is {t.carry.t} and an env's memory holds {written} steps after "
             f"{2 * cfg.horizon}")
    if t.state.update_step != 2 or t.state.opt_state.count != 64:
        fail(f"update_step {t.state.update_step}, Adam count {t.state.opt_state.count}")
    return launches


TOL_SERVING = 1e-6  # JSON carries float32 exactly; the forward is the same on the same card


def phase_serving(dev, trainer):
    """A PolicyService over the PPO slice's network and Z-filter, asked over
    TCP and directly."""
    from surreal_tpu_torch.models.z_filter import zfilter_normalize
    from surreal_tpu_torch.train.serving import PolicyService, request_actions

    net, zf = trainer.state.net, trainer.state.zfilter
    svc = PolicyService(net, zfilter=zf)  # no device given: the card
    server, addr = svc.serve("127.0.0.1")
    rng = np.random.default_rng(2)
    errs, round_trips = [], []

    def ask(module):
        obs = (2 * rng.standard_normal((256, 17))).astype(np.float32)
        t0 = time.perf_counter()
        got = request_actions(addr, obs)
        round_trips.append(time.perf_counter() - t0)
        with torch.no_grad():
            want = module(zfilter_normalize(zf, torch.as_tensor(obs, device=dev)))[0]
        if got.shape != (256, 6) or not np.isfinite(got).all():
            fail(f"serving answered shape {got.shape}, or non-finite actions")
        errs.append(float(np.abs(got - want.cpu().numpy()).max()))
        return got, obs

    try:
        for _ in range(5):
            ask(net)
        swapped = copy.deepcopy(net)
        with torch.no_grad():
            swapped.mean_head.bias.add_(0.25)
        svc.update_params(swapped.state_dict())
        got, obs = ask(swapped)
        with torch.no_grad():
            old = net(zfilter_normalize(zf, torch.as_tensor(obs, device=dev)))[0].cpu().numpy()
        swap_moved = float(np.abs(got - old).max())
        obs_act = (2 * rng.standard_normal((256, 17))).astype(np.float32)
        svc.act(obs_act)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            svc.act(obs_act)  # returns numpy: each call waits for the card
        act_ms = (time.perf_counter() - t0) / 20 * 1e3
    finally:
        server.shutdown()
        server.server_close()
    print(json.dumps({"phase": "serving", "requests": len(round_trips), "batch": [256, 17],
                      "max_abs_err": max(errs), "tol": TOL_SERVING,
                      "round_trip_ms_median": float(np.median(round_trips[:5])) * 1e3,
                      "round_trip_ms": [r * 1e3 for r in round_trips], "act_ms": act_ms,
                      "swap_moved": swap_moved}))
    if not max(errs) <= TOL_SERVING:
        fail(f"a served answer is {max(errs)} away from the module's forward")
    if not abs(swap_moved - 0.25) <= 1e-5:
        fail(f"update_params moved the answers by {swap_moved}, not by the 0.25 swapped in")


# One task per baked asset other than cheetah's: (task, envs: the task's
# recipe's num_envs in surreal_tpu/envs/recipes.py, physics substeps per
# control step: the env module's).
ENV_TASKS = {
    "acrobot": ("acrobot-swingup", 256, 1),
    "ball_in_cup": ("ball_in_cup-catch", 128, 10),
    "cartpole": ("cartpole-balance", 256, 1),
    "cartpole_2": ("cartpole-two_poles", 256, 1),
    "cartpole_3": ("cartpole-three_poles", 256, 1),
    "finger": ("finger-spin", 128, 2),
    "hopper": ("hopper-stand", 128, 4),
    "manipulator_ball": ("manipulator-bring_ball", 128, 10),
    "manipulator_peg": ("manipulator-bring_peg", 128, 10),
    "pendulum": ("pendulum-swingup", 256, 1),
    "point_mass": ("point_mass-easy", 256, 1),
    "reacher": ("reacher-easy", 256, 1),
    "swimmer6": ("swimmer-swimmer6", 256, 15),
    "swimmer15": ("swimmer-swimmer15", 256, 15),
    "walker": ("walker-walk", 128, 10),
}
# The card's control step against the CPU's from the same state, actions
# and reset draw, relative to max(1, max |CPU|): sinf/cosf differ by a few
# ulps between the two, and the solves and Jacobi sweeps amplify that by
# their conditioning over up to 15 substeps (the 15-link swimmer's mass
# matrix has condition numbers ~1.5e5; tests/test_torch_envs_swimmer.py).
# Envs within SWITCH_EPS of an active-set switch at any substep (a contact
# depth, a rope stretch or a limit distance within it of 0, or a pair
# whose capsule segments cross) are left out, at most a quarter of them.
TOL_ENV_REL = {"swimmer15": 1e-2}
TOL_ENV_REL_DEFAULT = 1e-3
SWITCH_EPS = 1e-5


def switch_margin(m, q) -> torch.Tensor:
    """(B,) distance of each state to the nearest switch of the constraint
    solver's active set: |depth| of every ground, wall and pair contact
    candidate, |stretch| of every rope, the distance of every limited joint
    to its bounds (a row is active iff its depth, stretch or violation is
    > 0, so two float32 runs may take different rows within rounding of
    a switch), and the distance between each pair's closest points (where
    two capsules' segments cross it is 0 and the contact normal is rounding
    noise). Also used by tests/torch_helpers.py."""
    from surreal_tpu_torch.envs.physics import engine as te

    parts = [torch.full((q.shape[0],), float("inf"), dtype=q.dtype, device=q.device)]
    fkd = te.fk_dofs(m, q)
    if m.ncon:
        parts.append(te._contact_kinematics(m, q, fkd)[1].abs().amin(1))
        if m.nwall:
            parts.append(te._wall_kinematics(m, q, fkd)[2].abs().amin(1))
    if m.npair:
        depth = te._pair_kinematics(m, q, fkd)[2]
        radii = torch.tensor(np.float32(m.geom_radius)[m.pair_geoms].sum(1), device=q.device)
        parts += [depth.abs().amin(1), (radii - depth).amin(1)]
    if m.nrope:
        parts.append(te._rope_kinematics(m, q, fkd)[1].abs().amin(1))
    lim = np.flatnonzero(m.limited)
    if len(lim):
        rng = torch.tensor(m.joint_range[lim], dtype=q.dtype, device=q.device)
        parts.append(torch.minimum((q[:, lim] - rng[:, 0]).abs(),
                                   (q[:, lim] - rng[:, 1]).abs()).amin(1))
    return torch.stack(parts, 1).amin(1)


def substep_margin(m, q, qd, ctrl, n_substeps) -> torch.Tensor:
    """The least switch_margin over the states a control step passes."""
    from surreal_tpu_torch.envs.physics import engine as te

    one = te.step_rk4 if m.integrator == "rk4" else te.step_euler
    margin = switch_margin(m, q)
    for _ in range(n_substeps):
        q, qd = one(m, q, qd, ctrl)[:2]
        margin = torch.minimum(margin, switch_margin(m, q))
    return margin


def phase_envs(dev) -> None:
    """Every other asset's env, one task each at its recipe's number of envs:
    reset on the card from a seed with a quarter of the envs at their last
    step, one control step on the card (auto-reset included) and the same
    step on the CPU from the same state, actions and reset draw; the
    median of 5 timed control steps on the card."""
    from surreal_tpu_torch.envs import flatten_obs, make_env
    from surreal_tpu_torch.envs.base import EnvState

    for asset, (task, B, substeps) in ENV_TASKS.items():
        env, env_cpu = make_env(task, device=dev), make_env(task, device="cpu")
        gen = torch.Generator(device=dev).manual_seed(0)
        state, _ = env.reset(B, gen)
        t = torch.where(torch.arange(B, device=dev) % 4 == 0, env.episode_steps - 1, 7)
        state = EnvState(state.q, state.qd, t.to(torch.int32))
        action = torch.rand(B, env.action_dim, generator=gen, device=dev) * 2.4 - 1.2
        draw = env.draw_reset(B, gen)
        outs = {}
        for d, e in ((dev, env), ("cpu", env_cpu)):
            st = EnvState(*(x.to(d) for x in (state.q, state.qd, state.t)))
            new, ts = e.step(st, action.to(d), reset_draw={k: v.to(d) for k, v in draw.items()})
            outs[d] = {"q": new.q, "qd": new.qd, "reward": ts.reward, "done": ts.done,
                       "obs": flatten_obs(ts.obs), "carry_obs": flatten_obs(ts.carry_obs)}
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            env.step(state, action, reset_draw=draw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        m = env_cpu.model
        q_cpu, qd_cpu = state.q.cpu()[:, : m.nv], state.qd.cpu()[:, : m.nv]
        keep = substep_margin(m, q_cpu, qd_cpu, action.cpu(), substeps) > SWITCH_EPS
        gpu = {k: v.cpu() for k, v in outs[dev].items()}
        cpu = outs["cpu"]
        tol = TOL_ENV_REL.get(asset, TOL_ENV_REL_DEFAULT)
        errs = {}
        for k in ("q", "qd", "reward", "obs", "carry_obs"):
            diff = (gpu[k] - cpu[k]).abs()[keep]
            errs[k] = float(diff.max()) / max(1.0, float(cpu[k][keep].abs().max()))
        row = {"asset": asset, "task": task, "num_envs": B, "substeps": substeps,
               "excluded": int((~keep).sum()), "max_rel_err": errs, "tol": tol,
               "resets": int(cpu["done"].sum()), "ms_per_control_step": float(np.median(times)),
               "ms_per_control_step_all": times}
        print("envs: " + json.dumps(row))
        if not torch.equal(gpu["done"], cpu["done"]) or int(cpu["done"].sum()) < B // 4:
            fail(f"{task}: the card's done flags differ from the CPU's, or no auto-reset ran")
        if row["excluded"] > B // 4:
            fail(f"{task}: {row['excluded']} of {B} envs within {SWITCH_EPS} of a switch")
        if not all(np.isfinite(v) and v <= tol for v in errs.values()):
            fail(f"{task}: the card's control step disagrees with the CPU's: {errs} > {tol}")


FINGER_CFG = dict(num_minibatches=4, entropy_coef=0.005, lr_max_scale=2.0, fused_loss=True)


def phase_finger(dev):
    """PPO on finger-spin at its recipe (surreal_tpu/envs/recipes.py: 128
    envs, 4 minibatches, entropy 0.005, lr_max_scale 2, hidden (64, 64);
    the default horizon 128 and 4 epochs) with the fused loss. Returns the
    trainer, the three kernels' launch counts read after its last update
    (set to 0 before its first iteration) and its times."""
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.train import PPOTrainer

    cfg = ppo.PPOConfig(**FINGER_CFG)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t = PPOTrainer("finger-spin", cfg, num_envs=128, hidden=(64, 64), seed=0, device=dev)
    kernels = path_kernels()
    for k in kernels.values():
        k.launches = 0
    warm_iters, timed_iters = 1, 2
    t0 = time.perf_counter()
    t.run(warm_iters, log_every=warm_iters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m = t.run(timed_iters, log_every=timed_iters)[-1]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    traj, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    _, last = ppo.update(cfg, t.state, traj, t.generator)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    iters = warm_iters + timed_iters + 1
    steps = cfg.epochs * cfg.num_minibatches
    sec_per_iter = (t2 - t1) / timed_iters
    out = {"phase": "ppo_finger_spin", "num_envs": 128, "hidden": [64, 64],
           "horizon": cfg.horizon, "minibatch_rows": cfg.horizon * 128 // cfg.num_minibatches,
           "warmup_s": t1 - t0, "s_per_iteration": sec_per_iter,
           "env_steps_per_s": t.steps_per_iteration / sec_per_iter,
           "rollout_s": t3 - t2, "ms_per_env_step": (t3 - t2) / cfg.horizon * 1e3,
           "update_s": t4 - t3, "ms_per_minibatch_step": (t4 - t3) / steps * 1e3,
           "kernel_launches": launches, "iterations": iters,
           "launches_per_iteration": {n: v / iters for n, v in launches.items()},
           "policy_loss": m["policy_loss"], "value_loss": m["value_loss"], "kl": m["kl"],
           "entropy": m["entropy"], "reward_per_step": m["reward_per_step"],
           "touch_max": float(traj.obs[..., 4:6].max()),
           "max_memory_allocated": peak, "memory_allocated_before": held_before,
           "peak_above_held_before": peak - held_before}
    print(json.dumps(out))
    check_finite("finger-spin PPO", {k: float(v) for k, v in last.items()} | m)
    want = {"gae": 0, "ppo_loss_fwd": steps * iters, "ppo_loss_bwd": steps * iters}
    if launches != want:
        fail(f"finger-spin PPO launch counts {launches} != {want}")
    if t.state.update_step != iters:
        fail(f"update_step {t.state.update_step} != {iters}")
    return t, launches, out


CARTPOLE_ITER = 256 * 128  # env steps per iteration of the cartpole-balance recipe
CARTPOLE_FLAGS = ["--env.env_name", "cartpole-balance", "--learner.fused_loss", "true"]
EVIDENCE_EVAL = 970.585205078125  # results/cartpole_balance_ppo_r5.txt, EVAL over 32 episodes


class LogLines(logging.Handler):
    """Keeps the messages the port logs under `surreal_tpu_torch` while in a
    `with` block."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("surreal_tpu_torch").addHandler(self)
        return self.lines

    def __exit__(self, *exc):
        logging.getLogger("surreal_tpu_torch").removeHandler(self)
        return False


class ThreadStdout:
    """Stands in for sys.stdout (main() installs it): a thread inside
    `captured` writes to its own buffer, every other thread to the real
    stdout. contextlib.redirect_stdout would swap sys.stdout for every
    thread, and take in what the phases running from threads print."""

    def __init__(self, real):
        self.real, self.local = real, threading.local()

    def write(self, text):
        return getattr(self.local, "buffer", self.real).write(text)

    def flush(self):
        getattr(self.local, "buffer", self.real).flush()

    def __getattr__(self, name):
        return getattr(self.real, name)

    @contextlib.contextmanager
    def captured(self, buffer):
        self.local.buffer = buffer
        try:
            yield buffer
        finally:
            del self.local.buffer


def cli_stdout(argv) -> str:
    """Runs the port's CLI in this process; returns what it printed."""
    from surreal_tpu_torch.cli.main import main as cli

    if not isinstance(sys.stdout, ThreadStdout):
        sys.stdout = ThreadStdout(sys.stdout)
    with sys.stdout.captured(io.StringIO()) as buf:
        if cli(argv) != 0:
            fail(f"the CLI returned non-zero for {argv}")
    return buf.getvalue()


def start_command(argv: list, timeout_s: float):
    """Runs `argv` as a subprocess, with this checkout on its PYTHONPATH,
    from a thread; returns a future of (seconds, CompletedProcess)."""
    from concurrent.futures import ThreadPoolExecutor

    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))

    def run():
        t0 = time.perf_counter()
        done = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=timeout_s)
        return time.perf_counter() - t0, done

    ex = ThreadPoolExecutor(1)
    future = ex.submit(run)
    ex.shutdown(wait=False)
    return future


def run_after(futures: list, fn):
    """fn() in a thread once every future in `futures` is done; returns its
    future."""
    from concurrent.futures import ThreadPoolExecutor, wait

    ex = ThreadPoolExecutor(1)
    future = ex.submit(lambda: (wait(futures), fn())[1])
    ex.shutdown(wait=False)
    return future


def start_eval(experiment: str, *flags):
    """`eval --experiment experiment *flags` through the port's CLI, a
    process of its own as a user runs it, started beside what follows."""
    return start_command([sys.executable, "-m", "surreal_tpu_torch.cli.main", "eval",
                          "--experiment", experiment, *flags, "--device", CLI_DEVICE], 600)


def eval_printed(started) -> tuple[dict, float]:
    """(the JSON line an `eval` of `start_eval` printed last, its seconds)."""
    secs, done = started.result()
    if done.returncode != 0:
        fail(f"{' '.join(done.args[2:])} failed:\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1]), secs


def evals_logged(lines) -> list[dict]:
    out = []
    for line in lines:
        if line.startswith("eval @ "):
            steps, rest = line[len("eval @ "):].split(" steps: ")
            mean, std = rest.split(" ± ")
            out.append({"env_steps": int(float(steps)), "return_mean": float(mean),
                        "return_std": float(std)})
    return out


def state_leaves(tree, path="fs"):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from state_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from state_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def unequal_leaves(a, b) -> list[str]:
    """Paths where two full states differ (bitwise for tensors, on the host)."""
    la, lb = list(state_leaves(a)), list(state_leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["<structure>"]
    bad = []
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
                bad.append(path)
        elif x != y:
            bad.append(path)
    return bad


def counted_cli(argv: list) -> None:
    """`python3 chip_smoke.py --counted-cli ARGV...`: the port's CLI in this
    process, the kernels' counters set to 0 before it; prints what the CLI
    printed, then the counters as the last line."""
    kernels = path_kernels()
    for k in kernels.values():
        k.launches = 0
    printed = cli_stdout(argv)
    torch.cuda.synchronize()
    print(printed, end="")
    print(json.dumps({n: k.launches for n, k in kernels.items()}))


def counted_cli_run(argv: list) -> tuple[float, list, dict]:
    """The port's CLI in a process of its own (`counted_cli`): (seconds,
    the messages it logged, the kernels' launches in it)."""
    secs, done = start_command([sys.executable, os.path.abspath(__file__), "--counted-cli",
                                *argv], 900).result()
    if done.returncode != 0:
        fail(f"the CLI failed for {argv}:\n{done.stderr[-3000:]}")
    logged = re.findall(r"surreal_tpu_torch[\w.]*\] (.*)", done.stderr)
    return secs, logged, json.loads(done.stdout.strip().splitlines()[-1])


def phase_cli(dev, ddpg_t) -> tuple[dict, dict]:
    """The session layer and the CLI on the card: `envs`; cartpole-balance
    PPO trained through the CLI at the recipe's full width with the fused
    loss for 3 iterations, a checkpoint each, killed and resumed to 5, each
    command a process of its own (`counted_cli`), then `eval --best`, the
    three beside the rest of the phase in this process: a short run with
    bfloat16 networks and the overlapped step (its `eval` a process too)
    and `cli_session_checks`; then the 98,304-step checkpoint loaded into a
    fresh trainer. Returns the kernels' launches on the CLI's training runs:
    the float32 ones' (both processes), the bfloat16 overlapped one's."""
    from surreal_tpu_torch.cli.configs import generate_configs
    from surreal_tpu_torch.cli.main import _build_trainer, _parse_overrides
    from surreal_tpu_torch.config import Config
    from surreal_tpu_torch.envs import available_envs
    from surreal_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer

    t_phase = time.perf_counter()
    out = {"phase": "cli"}
    names = cli_stdout(["envs"]).split()
    out["envs"] = len(names)
    if names != available_envs() or len(names) != 26:
        fail(f"`envs` listed {names}")

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    kernels = path_kernels()
    try:
        flags = [*CARTPOLE_FLAGS, "--session.checkpoint_every_steps", str(CARTPOLE_ITER),
                 "--session.results_dir", root, "--session.experiment_name", "cartpole",
                 "--device", str(dev)]
        exp = os.path.join(root, "cartpole")

        def steps_saved():
            return sorted(int(s) for s in os.listdir(os.path.join(exp, "checkpoints", "latest"))
                          if s.isdigit())

        def float32_runs():
            first = counted_cli_run(["train", "ppo", *flags, "--session.total_env_steps",
                                     str(3 * CARTPOLE_ITER)])
            latest = steps_saved()
            second = counted_cli_run(["train", "ppo", *flags, "--session.total_env_steps",
                                      str(5 * CARTPOLE_ITER)])
            return first, latest, second, steps_saved(), start_eval(exp, "--best", "--episodes",
                                                                    "16")

        float32 = run_after([], float32_runs)

        # bfloat16 networks and the overlapped step through the CLI: 2
        # iterations after the priming rollout, then its checkpoint evaluated
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        cli_stdout(["train", "ppo", *CARTPOLE_FLAGS, "--learner.compute_dtype", "bfloat16",
                    "--learner.overlap", "true", "--session.total_env_steps",
                    str(2 * CARTPOLE_ITER), "--session.eval_episodes", "4",
                    "--session.results_dir", root, "--session.experiment_name", "bf16_overlap",
                    "--device", str(dev)])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bf16_launches = {n: k.launches for n, k in kernels.items()}
        eval_bf16 = start_eval(os.path.join(root, "bf16_overlap"), "--episodes", "4")
        out.update(bf16_overlap_train_2_iterations_s=t1 - t0,
                   bf16_overlap_launches=bf16_launches)
        want = {"gae": 0, "ppo_loss_fwd": 32 * 2, "ppo_loss_bwd": 32 * 2}
        if bf16_launches != want:
            fail(f"the CLI's bf16 overlapped run launched {bf16_launches}, not {want}")
        cli_session_checks(dev, ddpg_t, out)

        (t_3, lines_3, launches_3), latest, (t_2, lines_2, launches_2), latest_after, \
            eval_best = float32.result()
        launches = {n: launches_3[n] + launches_2[n] for n in kernels}
        want3 = {"gae": 0, "ppo_loss_fwd": 32 * 3, "ppo_loss_bwd": 32 * 3}
        want5 = {"gae": 0, "ppo_loss_fwd": 32 * 5, "ppo_loss_bwd": 32 * 5}
        resumed = [m for m in lines_2 if m.startswith("resumed from checkpoint")]
        with open(os.path.join(exp, "config.json")) as f:
            saved_cfg = json.load(f)
        overrides = _parse_overrides(flags[:-2] + ["--session.total_env_steps",
                                                   str(5 * CARTPOLE_ITER)])
        want_cfg = dict(zip(("learner", "env", "session"),
                            (c.to_dict() for c in generate_configs("ppo", overrides))))
        out.update(train_3_iterations_s=t_3, resume_2_iterations_s=t_2,
                   launches_first_3_iterations=launches_3, launches_all_5_iterations=launches,
                   checkpoints_after_3=latest, checkpoints_after_resume=latest_after,
                   resumed_line=resumed, evals=evals_logged(lines_3 + lines_2),
                   config_json_equals_generate_configs=saved_cfg == want_cfg)
        if launches_3 != want3 or launches != want5:
            fail(f"the CLI cartpole path launched {launches_3} in 3 iterations and {launches} "
                 f"in 5: expected {want3} and {want5}")
        if latest != [CARTPOLE_ITER, 2 * CARTPOLE_ITER, 3 * CARTPOLE_ITER]:
            fail(f"checkpoints after 3 iterations at {latest}")
        if resumed != [f"resumed from checkpoint @ {3 * CARTPOLE_ITER} env steps (iter 3)"]:
            fail(f"the second run did not resume at iteration 3: {resumed}")
        if latest_after[-1] != 5 * CARTPOLE_ITER:
            fail(f"the latest checkpoint after resuming is {latest_after}")
        if saved_cfg != want_cfg:
            fail("config.json differs from generate_configs' output")

        # the 98,304-step checkpoint into a fresh trainer, against the bytes saved
        cfg = Config(saved_cfg)
        fresh = _build_trainer(cfg.learner, cfg.env, cfg.session, str(dev))
        ck = Checkpointer(os.path.join(exp, "checkpoints"))
        fresh.load_full_state(ck.restore(fresh.full_state, step=3 * CARTPOLE_ITER))
        on_disk = torch.load(os.path.join(exp, "checkpoints", "latest", str(3 * CARTPOLE_ITER),
                                          STATE_FILE), weights_only=True, map_location="cpu")
        bad = unequal_leaves(fresh.full_state, on_disk)
        out["reload_tensors"] = sum(isinstance(x, torch.Tensor)
                                    for _, x in state_leaves(on_disk))
        out["reload_unequal"] = bad
        if bad or fresh.global_iter != 3:
            fail(f"the reloaded trainer differs from the checkpoint at {bad}")
        del fresh

        out.update(best=ck.best_info)
        ev, out["eval_best_s"] = eval_printed(eval_best)
        out["eval_best"] = ev
        if not np.isfinite(ev["return_mean"]) or ev["episodes"] != 16:
            fail(f"eval --best printed {ev}")
        ev, out["bf16_overlap_eval_s"] = eval_printed(eval_bf16)
        out["bf16_overlap_eval"] = ev
        if not np.isfinite(ev["return_mean"]):
            fail(f"eval of the bf16 overlapped run printed {ev}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(out))
    return launches, bf16_launches


def cli_session_checks(dev, ddpg_t, out: dict) -> None:
    """Phase 12 beside its two evaluations: the DDPG cell's full state
    (its ring of 999,936 transitions) saved and restored into a fresh
    trainer, and one more iteration of both; one checked iteration
    (debug_checks) beside an unchecked one; and `bench`."""
    from surreal_tpu_torch.cli.configs import generate_configs, to_algo_config
    from surreal_tpu_torch.cli.main import _parse_overrides
    from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer
    from surreal_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer

    # the DDPG cell's full state, ring and all, into a fresh trainer
    root = tempfile.mkdtemp(prefix="chip_smoke_ddpg_")
    try:
        t = ddpg_t
        ck = Checkpointer(root)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(t.global_iter * t.steps_per_iteration, t.full_state)
        t1 = time.perf_counter()
        path = os.path.join(root, "latest", str(ck.latest_step()), STATE_FILE)
        fresh = DDPGTrainer("cheetah-run", t.cfg, num_envs=t.num_envs, seed=1, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fresh.load_full_state(ck.restore(fresh.full_state))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        bad = unequal_leaves(fresh.full_state, t.full_state)
        t.run(1, log_every=1)
        fresh.run(1, log_every=1)
        bad_next = unequal_leaves(fresh.full_state, t.full_state)
        out.update(ddpg_checkpoint_bytes=os.path.getsize(path), ddpg_save_s=t1 - t0,
                   ddpg_restore_s=t3 - t2, ddpg_ring_transitions=t.replay.capacity_t * t.num_envs,
                   ddpg_unequal_after_restore=bad, ddpg_unequal_after_one_more_iteration=bad_next)
        if bad or bad_next:
            fail(f"the restored DDPG trainer differs: {bad} after restoring, {bad_next} after "
                 "one more iteration")
        del fresh
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # one checked iteration (debug_checks) beside an unchecked one
    learner, env_cfg, _ = generate_configs("ppo", _parse_overrides(CARTPOLE_FLAGS))
    t = PPOTrainer("cartpole-balance", to_algo_config(learner), num_envs=int(env_cfg.num_envs),
                   hidden=tuple(learner.hidden), seed=0, device=dev, debug_checks=True)
    t.run(1, log_every=1)  # warm-up, checked
    times = {}
    for label, on in (("unchecked", False), ("checked", True)):
        t.debug_checks = on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.run(1, log_every=1)
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
    out.update(unchecked_iteration_s=times["unchecked"],
               debug_checks_iteration_s=times["checked"])
    del t

    env = {"BENCH_WARMUP_ITERS": "1", "BENCH_ITERS": "2"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        out["bench"] = json.loads(cli_stdout(["bench", "--device", str(dev)]
                                             ).strip().splitlines()[-1])
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# Pixel observations (phases 13 to 16)
# ---------------------------------------------------------------------------

RENDER_TASKS = ("cheetah-run", "ball_in_cup-catch", "manipulator-bring_ball", "cartpole-balance")
RENDER_B = 128
# The card's frames against the CPU's from the same states: a channel is
# clip(x, 0, 1)·255 truncated, so a rounding difference of x (sigmoid,
# sqrt, sin, a few ulps between the devices) flips a channel that sits
# within it of an integer; tests/test_torch_render.py holds the CPU to the
# reference at the same bar.
RENDER_MAX_LEVELS, RENDER_MAX_SHARE = 1, 0.01
PIXEL_ITER = 128 * 128  # decision steps per iteration of the pixel recipes (128 envs x 128)
# Card against CPU after a PPO or DDPG update on identical inputs: the
# torsos and heads within the MLP updates' 1e-5. Adam moves an element by
# ~lr·sign(g) even where g is rounding noise, and a few gradient elements of
# the conv stem are sums over the batch and the positions that cancel to
# that level (tests/test_torch_pixels.py, tests/test_torch_ddpg_pixels.py):
# the stem's elements within 1e-5 but for a share of STEM_SHARE, and those
# within the Adam steps' reach.
TOL_PIXEL_PARITY, STEM_SHARE = 1e-5, 1e-3


def median_ms(fn, reps: int = 5) -> float:
    """Median of `reps` calls of `fn`, each timed with CUDA events, in ms."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_render(dev) -> dict:
    """The rasteriser at B = 128 and 84 x 84 on a floating root (cheetah),
    ball_in_cup, manipulator_bring_ball and a stick figure (cartpole), from
    the same states (start states moved by N(0, 0.1)) on the card and the
    CPU: the largest grey-level difference, the share of channels that
    differ, and ms per call on the card (median of 5). Returns each task's
    renderer and states for the profile phase."""
    from surreal_tpu_torch.envs import make_env
    from surreal_tpu_torch.envs.render import _geom_segments, make_renderer

    cases = {}
    for name in RENDER_TASKS:
        env = make_env(name, device="cpu")
        gen = torch.Generator().manual_seed(0)
        q, _ = env._init(env.draw_reset(RENDER_B, gen))
        q = q + 0.1 * torch.randn(q.shape, generator=gen)
        render = make_renderer(env.model)
        cpu = render(q)
        q_dev = q.to(dev)
        card = render(q_dev)
        diff = (card.cpu().to(torch.int16) - cpu.to(torch.int16)).abs()
        ms = median_ms(lambda: render(q_dev))
        out = {"phase": "render", "task": name, "batch": RENDER_B, "hw": [84, 84],
               "geoms": len(_geom_segments(env.model)[0]), "max_levels": int(diff.max()),
               "share_differing": float((diff > 0).float().mean()), "ms_per_call": ms,
               "frame_bytes": nbytes(card)}
        print(json.dumps(out))
        if out["max_levels"] > RENDER_MAX_LEVELS or out["share_differing"] > RENDER_MAX_SHARE:
            fail(f"the card's frames of {name} differ from the CPU's: {out}")
        if len(torch.unique(card)) < 5:
            fail(f"the frames of {name} are nearly blank")
        cases[name] = (render, q_dev, out)
    return cases


def params_by_name(modules: dict) -> dict:
    return {f"{n}.{k}": p.detach().cpu() for n, m in modules.items()
            for k, p in m.named_parameters()}


def pixel_parity(label: str, cpu: tuple, card: tuple, reach: float) -> dict:
    """(params, metrics) of an update on the CPU and on the card -> the
    comparison's numbers; fails outside TOL_PIXEL_PARITY (the stems: the
    share and `reach` bounds)."""
    (p_c, m_c), (p_g, m_g) = cpu, card
    errs = {k: (p_c[k] - p_g[k]).abs() for k in p_c}
    stem = [k for k in errs if ".stem." in k or k.startswith("stem.")]
    rest = [k for k in errs if k not in stem]
    beyond = sum(int((errs[k] > TOL_PIXEL_PARITY).sum()) for k in stem)
    total = sum(errs[k].numel() for k in stem)
    out = {"params_max_abs_err_outside_stems": max(errs[k].max().item() for k in rest),
           "stem_max_abs_err": max(errs[k].max().item() for k in stem),
           "stem_share_beyond_tol": beyond / total, "stem_reach": reach,
           "tol": TOL_PIXEL_PARITY, "stem_share_tol": STEM_SHARE,
           "metrics_max_rel_err": max(abs(m_c[k] - m_g[k]) / max(1.0, abs(m_c[k]))
                                      for k in m_c)}
    if not (out["params_max_abs_err_outside_stems"] <= TOL_PIXEL_PARITY
            and out["stem_share_beyond_tol"] <= STEM_SHARE and out["stem_max_abs_err"] <= reach
            and out["metrics_max_rel_err"] <= 1e-4):
        fail(f"{label}: the card's update disagrees with the CPU's: {out}")
    return out


def pixel_ppo_trainer(dev, extra_learner=None):
    """PPOTrainer at the cheetah-run pixel recipe, built from the CLI's
    configs (surreal_tpu_torch/envs/recipes.py), with the fused loss."""
    from surreal_tpu_torch.cli.configs import generate_configs, to_algo_config
    from surreal_tpu_torch.train import PPOTrainer

    learner, env_cfg, _ = generate_configs("ppo", {
        "env": {"env_name": "cheetah-run", "pixel_obs": True},
        "learner": {"fused_loss": True, **(extra_learner or {})}})
    return PPOTrainer("cheetah-run", to_algo_config(learner), num_envs=int(env_cfg.num_envs),
                      hidden=tuple(learner.hidden), seed=0, device=dev, pixel_obs=True,
                      pixel_kwargs=env_cfg.pixel.to_dict())


def phase_pixel_ppo(dev):
    """PPO from pixels on cheetah-run at its recipe (128 envs, action repeat
    4, 3 stacked grayscale 84 x 84 frames, the conv stem and (256, 256),
    horizon 128, 4 epochs x 8 minibatches of 2,048, entropy 0.003, lr 1e-4,
    lr_max_scale 2) with the fused loss, for two iterations: the first
    whole, the second split into rollout and update, the rollout's render
    and policy shares timed alone at its states. Checks the launch counts
    (the loss 32 + 32 an iteration, GAE 0), then one update on identical
    inputs on the card and on the CPU."""
    from surreal_tpu_torch.algos import ppo

    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t = pixel_ppo_trainer(dev)
    cfg = t.cfg
    kernels = path_kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    m = t.run(1, log_every=1)[-1]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    traj, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, last = ppo.update(cfg, t.state, traj, t.generator)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    q = t.env_state.inner.q
    render_ms = median_ms(lambda: t.env._frame(q))
    with torch.no_grad():
        policy_ms = median_ms(lambda: t.state.net(t.obs))
    steps = cfg.epochs * cfg.num_minibatches
    rollout_s, update_s = t2 - t1, t3 - t2
    ar = t.env.action_repeat
    out = {"phase": "ppo_pixel_cheetah", "num_envs": t.num_envs, "action_repeat": ar,
           "frame_stack": t.env.frame_stack, "obs_shape": list(t.obs.shape[1:]),
           "obs_dtype": str(t.obs.dtype),
           "minibatch_rows": cfg.horizon * t.num_envs // cfg.num_minibatches,
           "first_iteration_s": t1 - t0, "s_per_iteration": rollout_s + update_s,
           "decision_steps_per_s": PIXEL_ITER / (rollout_s + update_s),
           "env_steps_per_s": PIXEL_ITER * ar / (rollout_s + update_s),
           "rollout_s": rollout_s, "ms_per_decision_step": rollout_s / cfg.horizon * 1e3,
           "render_ms_per_call": render_ms, "render_s_per_rollout": render_ms * cfg.horizon / 1e3,
           "policy_ms_per_call": policy_ms, "policy_s_per_rollout": policy_ms * cfg.horizon / 1e3,
           "physics_and_rest_s": rollout_s - (render_ms + policy_ms) * cfg.horizon / 1e3,
           "update_s": update_s, "ms_per_minibatch_step": update_s / steps * 1e3,
           "trajectory_obs_bytes": nbytes(traj.obs), "kernel_launches": launches,
           "iterations": 2, "launches_per_iteration": {n: v / 2 for n, v in launches.items()},
           "policy_loss": m["policy_loss"], "value_loss": m["value_loss"], "kl": m["kl"],
           "entropy": m["entropy"], "reward_per_step": m["reward_per_step"],
           "max_memory_allocated": peak, "memory_allocated_before": held_before,
           "peak_above_held_before": peak - held_before}
    check_finite("pixel PPO", {k: float(v) for k, v in last.items()} | m)
    want = {"gae": 0, "ppo_loss_fwd": steps * 2, "ppo_loss_bwd": steps * 2}
    if launches != want:
        fail(f"pixel PPO launch counts {launches} != {want}")
    if traj.obs.dtype != torch.uint8 or nbytes(traj.obs) != 128 * 128 * 84 * 84 * 3:
        fail(f"the pixel trajectory is not uint8 frame stacks: {traj.obs.dtype} {traj.obs.shape}")

    # one update (1 epoch of 2 minibatch steps of 2,048 rows) on identical
    # inputs: the first 32 steps of the rollout, the same permutation
    short_cfg = dataclasses.replace(cfg, epochs=1, num_minibatches=2)
    short = {k: x[:32].cpu() for k, x in vars(traj).items()}
    perms = torch.randperm(32 * t.num_envs, generator=torch.Generator().manual_seed(0))[None]
    results = {}
    for d in ("cpu", dev):
        net = copy.deepcopy(t.state.net).to(d)
        st = ppo.init_state(short_cfg, net, 1)
        st, metrics = ppo.update(short_cfg, st, ppo.Trajectory(
            **{k: x.to(d) for k, x in short.items()}), None, perms.to(d))
        results[d] = (params_by_name({"net": net}), {k: float(x) for k, x in metrics.items()})
    out["update_card_vs_cpu"] = pixel_parity("pixel PPO", results["cpu"], results[dev],
                                             reach=2 * cfg.lr * 1.01)
    out["update_s_by_compute_dtype"] = pixel_update_dtypes(t, traj)
    # one overlapped step at the recipe's width: the rollout's trajectory
    # pending while the next is collected, two uint8 trajectories held
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t.state, t.env_state, t.obs, t.ep_ret, nxt, m = ppo.train_step_overlapped(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, traj, t.generator)
    torch.cuda.synchronize()
    out.update(overlapped_step_s=time.perf_counter() - t0,
               overlapped_step_max_memory_allocated=torch.cuda.max_memory_allocated(),
               overlapped_pending_bytes=nbytes(traj.obs) + nbytes(nxt.obs))
    check_finite("pixel PPO overlapped step", {k: float(v) for k, v in m.items()})
    del nxt
    print(json.dumps(out))
    return t, launches, out


def dtype_twin(t, name: str):
    """The pixel trainer's network, parameters and all, computing in the
    dtype `name`."""
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic

    net = t.state.net
    twin = PPOActorCritic(tuple(t.obs.shape[1:]), net.mean_head.out_features,
                          (net.actor_torso.dense_0.out_features,
                           net.actor_torso.dense_1.out_features), pixel_obs=True,
                          compute_dtype=getattr(torch, name)).to(t.device)
    twin.load_state_dict(net.state_dict())
    return twin


def pixel_update_dtypes(t, traj) -> dict:
    """One whole update at the recipe's width (4 epochs x 8 minibatch steps
    of 2,048 frames through the conv stem) from the same trajectory and the
    same starting network, in float32 and in bfloat16, in the turns f32,
    bf16, bf16, f32: the seconds of each."""
    from surreal_tpu_torch.algos import ppo

    times = {"float32": [], "bfloat16": []}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        st = ppo.init_state(t.cfg, dtype_twin(t, name), 1)
        gen = torch.Generator(device=t.device).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = ppo.update(t.cfg, st, traj, gen)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        check_finite(f"pixel PPO update in {name}", {k: float(v) for k, v in m.items()})
    return times


def phase_pixel_ddpg(dev):
    """DDPG from pixels on ball_in_cup-catch at the evidence's configuration
    (results/bic_pixel_ddpg_aug_r5.txt line 1: 128 envs, action repeat 2,
    replay_capacity 100,000, min_replay 5,000, shared_encoder, aug_shift 4;
    the defaults otherwise: actor (300, 200), critic (400, 300), batch 256,
    16 env steps and 16 updates an iteration) until two iterations have
    updated (the fourth; the warm-up gate opens at the third), the last
    split into rollout and update block. Checks the ring's uint8 frames,
    the counts, that the actor's stem equals the critic's, no kernel launch,
    and one block of 2 updates on identical inputs (ring, indices, shift
    offsets) on the card and on the CPU."""
    from surreal_tpu_torch.algos import ddpg
    from surreal_tpu_torch.data.replay import ReplayState
    from surreal_tpu_torch.train import DDPGTrainer

    cfg = ddpg.DDPGConfig(replay_capacity=100_000, min_replay=5_000, shared_encoder=True,
                          aug_shift=4)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t = DDPGTrainer("ball_in_cup-catch", cfg, num_envs=128, seed=0, device=dev,
                    pixel_obs=True, pixel_kwargs={"action_repeat": 2})
    kernels = path_kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    m = t.run(3, log_every=3)[-1]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if m["updates"] != cfg.updates_per_iteration:
        fail(f"updates should begin at iteration 3: {m['updates']} done after 3")
    (t.replay, t.env_state, t.obs, t.ou_state, t.ep_ret, _, _) = ddpg.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ou_state, t.sigma, t.ep_ret,
        t.generator, t.replay)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, last = ddpg.update(cfg, t.state, t.replay, t.generator)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    ring_obs = t.replay.data["obs"]
    stems_equal = all(torch.equal(a, c) for a, c in zip(t.state.actor.stem.parameters(),
                                                        t.state.critic.stem.parameters()))
    out = {"phase": "ddpg_pixel_ball_in_cup", "num_envs": 128, "action_repeat": 2,
           "capacity_t": t.replay.capacity_t, "ring_transitions": t.replay.capacity_t * 128,
           "ring_obs_bytes": nbytes(ring_obs), "ring_bytes": nbytes(*t.replay.data.values()),
           "ring_obs_dtype": str(ring_obs.dtype), "first_3_iterations_s": t1 - t0,
           "rollout_s": t2 - t1, "ms_per_decision_step": (t2 - t1) / cfg.rollout_steps * 1e3,
           "update_block_s": t3 - t2,
           "ms_per_update": (t3 - t2) / cfg.updates_per_iteration * 1e3,
           "s_per_iteration": t3 - t1,
           "env_steps_per_s": t.steps_per_iteration * 2 / (t3 - t1),
           "updates_done": t.state.update_step, "replay_total": t.replay.total,
           "stems_equal_after_sync": stems_equal, "kernel_launches": launches,
           "critic_loss": float(last["critic_loss"]), "actor_loss": float(last["actor_loss"]),
           "q_mean": float(last["q_mean"]), "max_memory_allocated": peak,
           "peak_above_held_before": peak - held_before}
    check_finite("pixel DDPG", {k: float(v) for k, v in last.items()})
    if any(launches.values()):
        fail(f"the pixel DDPG path launched {launches}: the reference's reaches none of these")
    if ring_obs.dtype != torch.uint8 or nbytes(ring_obs) != 99_968 * 84 * 84 * 3:
        fail(f"the ring is not 99,968 uint8 frame stacks: {ring_obs.dtype} {ring_obs.shape}")
    if not stems_equal or t.state.update_step != 2 * cfg.updates_per_iteration:
        fail(f"after 2 update blocks: stems equal {stems_equal}, updates {t.state.update_step}")

    # a block of 2 updates on identical inputs: the ring, indices and shifts
    U, batch = 2, cfg.batch_size
    gen = torch.Generator().manual_seed(0)
    oldest = max(t.replay.total - t.replay.capacity_t, 0)
    valid = t.replay.total - cfg.n_step - oldest
    indices = [(oldest + torch.randint(0, valid, (batch,), generator=gen),
                torch.randint(0, 128, (batch,), generator=gen)) for _ in range(U)]
    shifts = [tuple(torch.randint(0, 2 * cfg.aug_shift + 1, (batch, 2), generator=gen)
                    for _ in range(2)) for _ in range(U)]
    block = dataclasses.replace(cfg, updates_per_iteration=U)
    results = {}
    for d in ("cpu", dev):
        state = copy.deepcopy(t.state)
        for n in ("actor", "critic", "target_actor", "target_critic"):
            getattr(state, n).to(d)
        for opt in (state.actor_opt, state.critic_opt):
            opt.mu = {k: v.to(d) for k, v in opt.mu.items()}
            opt.nu = {k: v.to(d) for k, v in opt.nu.items()}
        ring = ReplayState(data={k: v.to(d) for k, v in t.replay.data.items()},
                           total=t.replay.total)
        state, metrics = ddpg.update(block, state, ring, None,
                                     [(a.to(d), b.to(d)) for a, b in indices],
                                     aug_offsets=[(a.to(d), b.to(d)) for a, b in shifts])
        results[d] = (params_by_name({n: getattr(state, n) for n in (
            "actor", "critic", "target_actor", "target_critic")}),
            {k: float(x) for k, x in metrics.items()})
        del ring
    out["update_block_card_vs_cpu"] = pixel_parity(
        "pixel DDPG", results["cpu"], results[dev], reach=U * cfg.critic_lr * 1.01)
    print(json.dumps(out))
    return t, launches, out


def phase_cli_pixel(dev) -> tuple:
    """`train ppo --env.env_name cheetah-run --env.pixel_obs true` through
    the CLI at the recipe with the fused loss for one iteration and its
    checkpoint, with `--session.video true`: the evaluation at the end
    records one GIF of video_steps frames, which must decode (by the port's
    own reader: the card's machine has no imaging package) to that many
    168 x 168 frames; then `eval --best`, a process of its own that runs
    beside the phases that follow. Returns the loss kernels' launches on
    the training run and the phase's end: a function that waits for the
    evaluation and checks it."""
    from surreal_tpu_torch.train.video import read_gif

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_pixel_cli_")
    kernels = path_kernels()
    video_steps = 16
    out = {"phase": "cli_ppo_pixel_cheetah"}
    try:
        exp = os.path.join(root, "pixel")
        for k in kernels.values():
            k.launches = 0
        with LogLines() as lines:
            t0 = time.perf_counter()
            cli_stdout(["train", "ppo", "--env.env_name", "cheetah-run", "--env.pixel_obs",
                        "true", "--learner.fused_loss", "true", "--session.total_env_steps",
                        str(PIXEL_ITER), "--session.eval_every_steps", str(PIXEL_ITER),
                        "--session.checkpoint_every_steps", str(PIXEL_ITER),
                        "--session.video", "true", "--session.video_steps", str(video_steps),
                        "--session.results_dir", root, "--session.experiment_name", "pixel",
                        "--device", str(dev)])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        launches = {n: k.launches for n, k in kernels.items()}
        gif = os.path.join(exp, "videos", f"steps_{PIXEL_ITER}.gif")
        frames = read_gif(gif) if os.path.exists(gif) else None
        with open(os.path.join(exp, "config.json")) as f:
            saved = json.load(f)
        eval_best = start_eval(exp, "--best", "--episodes", "16")
        out.update(train_1_iteration_with_eval_and_video_s=t1 - t0, kernel_launches=launches,
                   evals=evals_logged(lines), video=[m for m in lines if m.startswith("video")],
                   gif_bytes=os.path.getsize(gif) if frames is not None else None,
                   gif_frames=None if frames is None else list(frames.shape),
                   pixel_config=saved["env"]["pixel"], learner_lr=saved["learner"]["lr"],
                   phase_s_before_eval_best=time.perf_counter() - t_phase)
        want = {"gae": 0, "ppo_loss_fwd": 32, "ppo_loss_bwd": 32}
        if launches != want:
            fail(f"the CLI pixel path launched {launches}, expected {want}")
        if frames is None or frames.shape != (video_steps, 168, 168, 3):
            fail(f"the eval video {gif} is missing or not {video_steps} frames of 168 x 168")
        if len(np.unique(frames)) < 5:
            fail("the eval video's frames are nearly blank")
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise

    def finish() -> None:
        try:
            ev, out["eval_best_s"] = eval_printed(eval_best)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out["eval_best"] = ev
        print(json.dumps(out))
        if not np.isfinite(ev["return_mean"]) or ev["episodes"] != 16:
            fail(f"eval --best printed {ev}")

    return launches, finish


def pixel_profile(t, times, render_cases):
    """Under torch.profiler (after every timing): the device kernels of one
    render call per task, and of the pixel PPO cell's rollout cut to 2 of
    its 128 decision steps and of one epoch of its update (8 of its 32
    minibatch steps), in float32 and in bfloat16: kernels per decision
    step, the render's share of the rollout's device time, the idle shares
    against the unprofiled times of the same parts, and each epoch's
    kernels with the most device time."""
    from surreal_tpu_torch.algos import ppo

    renders = {}
    for name, (render, q, _) in render_cases.items():
        n, busy = profiled(lambda: render(q))
        renders[name] = {"kernels_per_call": n, "device_ms_per_call": busy * 1e3}
    steps = 2
    short = dataclasses.replace(t.cfg, horizon=steps)
    full, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
        t.cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)

    def rollout():
        t.env_state, t.obs, t.ep_ret = ppo.rollout(
            short, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)[1:4]

    q = t.env_state.inner.q
    n_render, busy_render = profiled(lambda: t.env._frame(q))
    n_roll, busy_roll = profiled(rollout)
    epoch = dataclasses.replace(t.cfg, epochs=1)
    n_upd, busy_upd, top_upd = profiled(
        lambda: ppo.update(epoch, t.state, full, t.generator), top=6)
    bf16_state = ppo.init_state(epoch, dtype_twin(t, "bfloat16"), 1)
    ppo.update(epoch, bf16_state, full, t.generator)  # cuDNN's first bf16 calls, unprofiled
    n_bf16, busy_bf16, top_bf16 = profiled(
        lambda: ppo.update(epoch, bf16_state, full, t.generator), top=6)
    bf16_epoch_wall = min(times["update_s_by_compute_dtype"]["bfloat16"]) / t.cfg.epochs
    roll_wall = times["ms_per_decision_step"] * 1e-3 * steps
    epoch_wall = times["update_s"] / t.cfg.epochs
    out = {"phase": "pixel_profile", "render_by_task": renders,
           "rollout_steps_profiled": steps, "rollout_kernels": n_roll,
           "kernels_per_decision_step": n_roll / steps,
           "render_kernels_per_decision_step": n_render,
           "render_share_of_rollout_device_time": busy_render * steps / busy_roll,
           "minibatch_steps_profiled": t.cfg.num_minibatches, "epoch_kernels": n_upd,
           "kernels_per_minibatch_step": n_upd / t.cfg.num_minibatches,
           "rollout_busy_s": busy_roll, "epoch_busy_s": busy_upd,
           "unprofiled_s_of_the_same_rollout_steps": roll_wall,
           "unprofiled_s_of_one_epoch": epoch_wall,
           "rollout_idle_share": 1 - busy_roll / roll_wall,
           "update_idle_share": 1 - busy_upd / epoch_wall,
           "epoch_top_kernels_ms": top_upd,
           "bf16_epoch_kernels": n_bf16, "bf16_epoch_busy_s": busy_bf16,
           "bf16_unprofiled_s_of_one_epoch": bf16_epoch_wall,
           "bf16_update_idle_share": 1 - busy_bf16 / bf16_epoch_wall,
           "bf16_epoch_top_kernels_ms": top_bf16}
    print(json.dumps(out))
    if n_roll == 0 or n_upd == 0 or n_render == 0:
        fail("the profiler saw no device kernel in the pixel PPO cell")


# ---------------------------------------------------------------------------
# bfloat16 network compute and the overlapped PPO step (phases 17 to 19)
# ---------------------------------------------------------------------------

# The card's bfloat16 updates against the CPU's from the same state and
# draws: the bars of tests/test_torch_bf16_updates.py. cuBLAS and cuDNN sum
# in another order than the CPU, so a bfloat16 rounding can fall the other
# way; Adam moves an element whose gradient is near 0 by ~lr x sign(g), so
# after `steps` steps every element is within 2 x steps x lr (x 1.01) and
# all but BF16_SHARE of them within 1e-5; metrics within 1e-2 relative (or
# 1e-3 absolute).
BF16_SHARE, BF16_RTOL_METRIC = 0.2, 1e-2


def bf16_hold(label: str, cpu: tuple, card: tuple, reach: float) -> dict:
    """(params, metrics) of a bfloat16 update on the CPU and on the card ->
    the comparison's numbers; fails outside the bars above."""
    (p_c, m_c), (p_g, m_g) = cpu, card
    errs = torch.cat([(p_c[k] - p_g[k]).abs().ravel() for k in p_c])
    out = {"params_max_abs_err": errs.max().item(), "reach": reach,
           "share_beyond_1e-5": (errs > 1e-5).float().mean().item(), "share_tol": BF16_SHARE,
           "metrics_max_rel_err": max(abs(m_c[k] - m_g[k]) / max(1e-1, abs(m_c[k]))
                                      for k in m_c)}
    if not (out["params_max_abs_err"] <= reach and out["share_beyond_1e-5"] <= BF16_SHARE
            and all(abs(m_c[k] - m_g[k]) <= max(BF16_RTOL_METRIC * abs(m_c[k]), 1e-3)
                    for k in m_c)):
        fail(f"{label}: the card's bfloat16 update disagrees with the CPU's: {out}")
    return out


def synthetic_trajectory(T, B, A, obs_dim, rng, lstm_size=0) -> dict:
    """A rollout chunk on the CPU from `rng`: the old policy's means and
    log-std with actions drawn from it, values, rewards, a few episode ends
    (and with `lstm_size` a bfloat16 initial carry), as the CPU tests build
    it."""
    from surreal_tpu_torch.models.distributions import DiagGauss

    f = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)  # noqa: E731
    mean, log_std = 0.5 * f(T, B, A), torch.full((T, B, A), -0.5)
    action = mean + log_std.exp() * f(T, B, A)
    out = dict(obs=2 * f(T, B, obs_dim), action=action,
               log_prob=DiagGauss.log_prob(mean, log_std, action), mean=mean, log_std=log_std,
               value=f(T, B), next_value=f(T, B),
               reward=torch.tensor(rng.random((T, B)), dtype=torch.float32),
               discount=torch.tensor(rng.random((T, B)) > 0.03, dtype=torch.float32),
               done=torch.tensor(rng.random((T, B)) < 0.08))
    if lstm_size:
        out["init_carry"] = tuple((0.3 * f(B, lstm_size)).to(torch.bfloat16) for _ in range(2))
    return out


def phase_bf16(dev):
    """PPO on cheetah-run at bench.py's configuration with bfloat16
    networks and the fused loss, 1 warm-up and 2 timed iterations; checks
    from the counters, set to 0 before it, that each iteration launched each
    loss kernel 32 times and GAE never, and holds the loss kernels against
    their plain versions on the path's own first minibatch (float32 outputs
    of the bfloat16 heads, as fused_clip_loss took them)."""
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.ops import ppo_loss_kernel as plk
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = PPOConfig(horizon=128, epochs=4, num_minibatches=8, lr=3e-4, fused_loss=True)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t = PPOTrainer("cheetah-run", cfg, num_envs=256, hidden=(256, 256), seed=0, device=dev,
                   compute_dtype=torch.bfloat16)
    captured = {}
    fused = plk.fused_clip_loss

    def capture(*args, **kw):  # the first minibatch's inputs, kept aside
        if not captured:
            captured.update(batch=tuple(a.detach().clone() for a in args), coefs=(
                kw["clip_eps"], kw["value_coef"], kw["entropy_coef"]))
        return fused(*args, **kw)

    plk.fused_clip_loss = capture
    try:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        t.run(1, log_every=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logs = t.run(2, log_every=1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {n: k.launches for n, k in kernels.items()}
    finally:
        plk.fused_clip_loss = fused
    peak = torch.cuda.max_memory_allocated()
    want = {"gae": 0, "ppo_loss_fwd": 32 * 3, "ppo_loss_bwd": 32 * 3}
    if launches != want:
        fail(f"bf16 path launch counts {launches} != {want}")
    batch = captured["batch"]
    rows = t.cfg.horizon * t.num_envs // t.cfg.num_minibatches
    if [x.dtype for x in batch] != [torch.float32] * 10 or batch[0].shape != (rows, 6):
        fail(f"the bf16 path fed the loss {[(x.dtype, tuple(x.shape)) for x in batch]}")
    fwd, bwd, _ = loss_cases(plk, None, rows, 6, dev, batch=batch, coefs=captured["coefs"])
    for k in (fwd, bwd):
        print_kernel(k)
    sec = (t2 - t1) / 3
    out = {"phase": "ppo_bf16_cheetah", "compute_dtype": "bfloat16", "warm_up_s": t1 - t0,
           "s_per_iteration": sec, "env_steps_per_s": t.steps_per_iteration / sec,
           "kernel_launches": launches,
           "loss_kernels_on_path_minibatch": {k["name"]: {f: k[f] for f in SLIM}
                                              for k in (fwd, bwd)},
           "max_memory_allocated": peak, "peak_above_held_before": peak - held_before,
           "metrics": [{k: m[k] for k in ("iteration", "policy_loss", "value_loss", "kl",
                                          "entropy", "grad_norm")} for m in logs]}
    check_finite("bf16 PPO", logs[-1])
    print(json.dumps(out))
    return t, launches


def phase_bf16_parity(dev):
    """A small bfloat16 PPO update (fused: kernels on the card, plain versions
    on the CPU), an LSTM-PPO update and a DDPG update block with pixel nets
    (shared encoder, shifts injected) on the card against the same on the
    CPU, from the same state, trajectory, replay contents and draws."""
    from surreal_tpu_torch.algos import ddpg, ppo, ppo_lstm
    from surreal_tpu_torch.data import replay as treplay
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic
    from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic

    bf = torch.bfloat16
    rng = np.random.default_rng(8)
    out = {"phase": "bf16_updates_card_vs_cpu"}
    # PPO: 16 x 32 rows, 2 epochs x 2 minibatches of 256 (the fused gate admits)
    cfg = ppo.PPOConfig(horizon=16, epochs=2, num_minibatches=2, fused_loss=True)
    tr = synthetic_trajectory(16, 32, 6, 17, rng)
    net0 = PPOActorCritic(17, 6, (64, 64), generator=torch.Generator().manual_seed(0),
                          compute_dtype=bf)
    perms = torch.stack([torch.randperm(512, generator=torch.Generator().manual_seed(e))
                         for e in range(2)])
    res = {}
    for d in ("cpu", dev):
        net = copy.deepcopy(net0).to(d)
        st, m = ppo.update(cfg, ppo.init_state(cfg, net, 17), ppo.Trajectory(
            **{k: x.to(d) for k, x in tr.items()}), None, perms.to(d))
        res[d] = (params_by_name({"net": net}), {k: float(x) for k, x in m.items()})
    out["ppo"] = bf16_hold("bf16 PPO", res["cpu"], res[dev], 2 * 4 * cfg.lr * 1.01)
    # LSTM-PPO: 8 envs x 16 steps, 2 epochs x 2 minibatches of 4 sequences
    cfg = ppo.PPOConfig(horizon=16, epochs=2, num_minibatches=2)
    tr = synthetic_trajectory(16, 8, 6, 17, rng, lstm_size=32)
    net0 = PPOActorCritic(17, 6, (64, 64), use_lstm=True, lstm_size=32,
                          generator=torch.Generator().manual_seed(1), compute_dtype=bf)
    perms = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(e))
                         for e in range(2)])
    for d in ("cpu", dev):
        net = copy.deepcopy(net0).to(d)
        traj = ppo_lstm.LSTMTrajectory(**{k: (tuple(c.to(d) for c in x) if k == "init_carry"
                                              else x.to(d)) for k, x in tr.items()})
        st, m = ppo_lstm.update(cfg, ppo.init_state(cfg, net, 17), traj, None, perms.to(d))
        res[d] = (params_by_name({"net": net}), {k: float(x) for k, x in m.items()})
    out["ppo_lstm"] = bf16_hold("bf16 LSTM-PPO", res["cpu"], res[dev], 2 * 4 * cfg.lr * 1.01)
    # DDPG from pixels: 3 updates of batch 16 on 48 x 64 frames
    shape, B, batch, U = (48, 64, 3), 4, 16, 3
    cfg = ddpg.DDPGConfig(replay_capacity=16 * B, rollout_steps=8, batch_size=batch, n_step=3,
                          updates_per_iteration=U, target_noise=0.2, shared_encoder=True,
                          aug_shift=4)
    chunks = [{"obs": torch.tensor(rng.integers(0, 256, (8, B, *shape)), dtype=torch.uint8),
               "action": torch.tensor(rng.uniform(-1, 1, (8, B, 6)), dtype=torch.float32),
               "reward": torch.tensor(rng.random((8, B)), dtype=torch.float32),
               "done": torch.tensor(rng.random((8, B)) < 0.1)} for _ in range(3)]
    gen = torch.Generator().manual_seed(2)
    actor0 = DDPGActor(shape, 6, (64, 64), pixel_obs=True, detach_stem=True, generator=gen,
                       compute_dtype=bf)
    critic0 = DDPGCritic(shape, 6, (64, 64), pixel_obs=True, generator=gen, compute_dtype=bf)
    ddpg.sync_encoder(actor0, critic0)
    # 24 steps in a ring of 16: the oldest is step 8, and a 3-step window
    # must end by step 23
    indices = [(torch.tensor(rng.integers(8, 21, batch)), torch.tensor(rng.integers(0, B, batch)))
               for _ in range(U)]
    target_eps = torch.tensor(rng.standard_normal((U, batch, 6)), dtype=torch.float32)
    offsets = [tuple(torch.tensor(rng.integers(0, 9, (batch, 2))) for _ in range(2))
               for _ in range(U)]
    for d in ("cpu", dev):
        replay = ddpg.init_replay(cfg, B, 1, 6, d, obs_shape=shape, obs_dtype=torch.uint8)
        for c in chunks:
            replay = treplay.replay_insert(replay, {k: x.to(d) for k, x in c.items()})
        actor, critic = copy.deepcopy(actor0).to(d), copy.deepcopy(critic0).to(d)
        st, m = ddpg.update(cfg, ddpg.init_state(cfg, actor, critic, 1), replay, None,
                            [(a.to(d), b.to(d)) for a, b in indices], target_eps.to(d),
                            aug_offsets=[tuple(x.to(d) for x in o) for o in offsets])
        res[d] = (params_by_name({"actor": st.actor, "critic": st.critic,
                                  "target_actor": st.target_actor,
                                  "target_critic": st.target_critic}),
                  {k: float(x) for k, x in m.items()})
    out["ddpg_pixel"] = bf16_hold("bf16 pixel DDPG", res["cpu"], res[dev],
                                  2 * U * cfg.critic_lr * 1.01)
    print(json.dumps(out))
    return out


def phase_overlap(dev, fused_trainer):
    """PPO on cheetah-run at bench.py's configuration with the overlapped
    step and the fused loss: the priming rollout and a first iteration,
    then 2 more, each
    checked to update on the trajectory the previous call returned, and
    each launching each loss kernel 32 times and GAE never (the counters
    set to 0 before each iteration, read after it); each timed beside one
    iteration of the fused step (phase 5's trainer), in turns."""
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = PPOConfig(horizon=128, epochs=4, num_minibatches=8, lr=3e-4, fused_loss=True)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t = PPOTrainer("cheetah-run", cfg, num_envs=256, hidden=(256, 256), seed=0, device=dev,
                   overlap=True)
    consumed = []
    update = ppo.update

    def recording(cfg_, state, traj, *a, **k):
        consumed.append(traj)
        return update(cfg_, state, traj, *a, **k)

    launches = {n: 0 for n in kernels}
    times = {"overlap": [], "fused": []}
    ppo.update = recording
    try:
        t0 = time.perf_counter()
        t.run(1, log_every=1)  # the priming rollout and the first iteration
        torch.cuda.synchronize()
        prime_s = time.perf_counter() - t0
        for i in range(2):
            for label, trainer in (("overlap", t), ("fused", fused_trainer)):
                pending = t._pending
                for k in kernels.values():
                    k.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.run(1, log_every=1)[-1]
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
                if label == "overlap":
                    for n, k in kernels.items():
                        launches[n] += k.launches
                    if consumed[-1] is not pending or t._pending is pending:
                        fail(f"overlapped iteration {i + 2} did not update on the trajectory "
                             "the previous call returned")
                    check_finite("overlapped PPO", m)
    finally:
        ppo.update = update
    peak = torch.cuda.max_memory_allocated()
    want = {"gae": 0, "ppo_loss_fwd": 32 * 2, "ppo_loss_bwd": 32 * 2}
    if launches != want:
        fail(f"overlap path launch counts {launches} != {want}")
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    out = {"phase": "ppo_overlap_cheetah", "prime_and_first_iteration_s": prime_s,
           "s_per_iteration_overlap": times["overlap"], "s_per_iteration_fused": times["fused"],
           "mean_s_per_iteration": mean,
           "env_steps_per_s_overlap": t.steps_per_iteration / mean["overlap"],
           "env_steps_per_s_fused": t.steps_per_iteration / mean["fused"],
           "kernel_launches": launches, "pending_obs_bytes": nbytes(t._pending.obs),
           "max_memory_allocated": peak, "peak_above_held_before": peak - held_before}
    print(json.dumps(out))
    return launches


BRIDGES = ("gymnasium", "mujoco", "dm_control")
FLAGSHIP = dict(horizon=128, epochs=4, num_minibatches=8, lr=3e-4, fused_loss=True)
GYM_TASK = "gym:Pendulum-v1"  # Pendulum-v1: 3 observations, A = 1, 200-step episodes


def phase_host_bridges() -> dict:
    """Which host-bridge packages this machine has; the phases that need a
    missing one print that they did not run and do nothing else."""
    import importlib.util

    found = {p: importlib.util.find_spec(p) is not None for p in BRIDGES}
    print(json.dumps({"phase": "host_bridges", **found}))
    return found


def bridge_missing(phase: str, found: dict, needs: tuple) -> bool:
    missing = [p for p in needs if not found[p]]
    if missing:
        print(json.dumps({"phase": phase, "ran": False, "missing": ", ".join(missing)}))
    return bool(missing)


def phase_ppo_instance(dev) -> dict:
    """PPOTrainer on a pre-built `make_env("cheetah-run")` instance at
    bench.py's configuration: one iteration, which must equal one of the
    trainer built from the name and the same seed bit for bit (the same
    generator draws give the same trajectory and update), with 32 + 32
    loss launches and GAE 0 from the counters."""
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.envs import make_env
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = PPOConfig(**FLAGSHIP)
    common = dict(num_envs=256, hidden=(256, 256), seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    inst = PPOTrainer(make_env("cheetah-run", device=dev), cfg, **common)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = inst.run(1, log_every=1)[-1]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    named = PPOTrainer("cheetah-run", cfg, **common)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    named.run(1, log_every=1)
    torch.cuda.synchronize()
    sec_named = time.perf_counter() - t0
    unequal = unequal_leaves(inst.full_state, named.full_state)
    out = {"phase": "ppo_instance_cheetah", "kernel_launches": launches,
           "s_per_iteration": sec, "env_steps_per_s": inst.steps_per_iteration / sec,
           "s_per_iteration_named": sec_named, "bit_equal_to_named": not unequal,
           "max_memory_allocated": peak, "peak_above_held_before": peak - held_before}
    print(json.dumps(out))
    check_finite("PPO on an env instance", m)
    want = {"gae": 0, "ppo_loss_fwd": 32, "ppo_loss_bwd": 32}
    if launches != want:
        fail(f"the instance path launched {launches}, expected {want}")
    if unequal:
        fail(f"the instance trainer differs from the named one at {unequal[:5]}")
    return launches


def timed_gym_env(env, acc: dict) -> None:
    """Wraps the GymEnv's host round trip, so each part of a control step is
    timed on the host clock: the action's copy to the host (after a
    synchronize, so the policy's device work is not counted in it), the
    gymnasium step, and the copy of its results to the card (until they
    have arrived)."""
    def wrap(name, fn, before=None):
        def run(*args):
            if before:
                before()
            t0 = time.perf_counter()
            out = fn(*args)
            if name == "h2d_ms":
                torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    env._to_host = wrap("d2h_ms", env._to_host, torch.cuda.synchronize)
    env._host_step = wrap("gym_step_ms", env._host_step)
    env._to_device = wrap("h2d_ms", env._to_device)


def phase_ppo_gym(dev, found: dict) -> dict | None:
    """PPOTrainer("gym:Pendulum-v1") at bench.py's widths (256 envs,
    (256, 256), horizon 128, 4 x 8 minibatches of 4096 rows, fused; A = 1)
    for 2 iterations: the loss kernels 32 + 32 times an iteration and GAE
    never, s/iteration, env-steps/s, ms per control step split into the
    gymnasium step on the host, the action's copy to the host, the results'
    copy to the card and the policy (the rest of the rollout); one update of
    its last trajectory on the card against the CPU's; then the CLI on the
    same name for 2 iterations, a checkpoint each and an evaluation of 16
    episodes (on envs of their own), and `eval` of the checkpoint."""
    if bridge_missing("ppo_gym_pendulum", found, ("gymnasium",)):
        return None
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = ppo.PPOConfig(**FLAGSHIP)
    t_phase = time.perf_counter()
    t = PPOTrainer(GYM_TASK, cfg, num_envs=256, hidden=(256, 256), seed=0, device=dev)
    acc = {"gym_step_ms": 0.0, "d2h_ms": 0.0, "h2d_ms": 0.0}
    timed_gym_env(t.env, acc)
    rollout, trajs, rollout_s = ppo.rollout, [], []

    def timed_rollout(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout(*a, **k)
        torch.cuda.synchronize()
        rollout_s.append(time.perf_counter() - t0)
        trajs.append(res[0])
        return res

    for k in kernels.values():
        k.launches = 0
    times = []
    ppo.rollout = timed_rollout
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = t.run(1, log_every=1)[-1]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check_finite("PPO on gym:Pendulum-v1", m)
    finally:
        ppo.rollout = rollout
    launches = {n: k.launches for n, k in kernels.items()}
    steps = 2 * cfg.horizon
    per_step = {k: v / steps for k, v in acc.items()}
    per_step["policy_ms"] = sum(rollout_s) * 1e3 / steps - sum(per_step.values())

    # one update of the last trajectory, card against CPU, from the same state
    traj, results = trajs[-1], {}
    perms = torch.stack([torch.randperm(traj.reward.numel(), generator=torch.Generator()
                                        .manual_seed(e)) for e in range(cfg.epochs)])
    for d in ("cpu", dev):
        net = PPOActorCritic(3, 1, hidden=(256, 256)).to(d)
        net.load_state_dict(t.state.net.state_dict())
        st = ppo.init_state(cfg, net, 3)
        tr = ppo.Trajectory(**{k: x.to(d) for k, x in vars(traj).items()})
        st, metrics = ppo.update(cfg, st, tr, None, perms.to(d))
        results[d] = ({k: p.detach().cpu() for k, p in net.named_parameters()},
                      {k: float(x) for k, x in metrics.items()})
    p_err = max((results["cpu"][0][k] - results[dev][0][k]).abs().max().item()
                for k in results["cpu"][0])
    m_err = max(abs(results["cpu"][1][k] - results[dev][1][k])
                / max(1.0, abs(results["cpu"][1][k])) for k in results["cpu"][1])

    root = tempfile.mkdtemp(prefix="chip_smoke_gym_cli_")
    try:
        exp = os.path.join(root, "gym")
        for k in kernels.values():
            k.launches = 0
        with LogLines() as lines:
            t0 = time.perf_counter()
            cli_stdout(["train", "ppo", "--env.env_name", GYM_TASK, "--learner.fused_loss",
                        "true", "--session.total_env_steps", str(2 * CHEETAH_ITER),
                        "--session.eval_every_steps", str(2 * CHEETAH_ITER),
                        "--session.checkpoint_every_steps", str(CHEETAH_ITER),
                        "--session.results_dir", root, "--session.experiment_name", "gym",
                        "--device", str(dev)])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        cli_launches = {n: k.launches for n, k in kernels.items()}
        ckpts = sorted(int(s) for s in os.listdir(os.path.join(exp, "checkpoints", "latest"))
                       if s.isdigit())
        ev = json.loads(cli_stdout(["eval", "--experiment", exp, "--episodes", "16",
                                    "--device", str(dev)]).strip().splitlines()[-1])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mean = sum(times) / len(times)
    out = {"phase": "ppo_gym_pendulum", "ran": True, "kernel_launches": launches,
           "s_per_iteration": times, "env_steps_per_s": t.steps_per_iteration / mean,
           "rollout_s": rollout_s, "ms_per_control_step": per_step,
           "update_card_vs_cpu": {"params_max_abs_err": p_err, "metrics_max_rel_err": m_err,
                                  "tol": [1e-5, 1e-4]},
           "cli": {"train_2_iterations_with_eval_s": cli_s, "kernel_launches": cli_launches,
                   "checkpoints": ckpts, "evals": evals_logged(lines), "eval": ev},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps(out))
    want = {"gae": 0, "ppo_loss_fwd": 64, "ppo_loss_bwd": 64}
    if launches != want or cli_launches != want:
        fail(f"the gym path launched {launches}, its CLI run {cli_launches}: expected {want}")
    if not (p_err <= 1e-5 and m_err <= 1e-4):
        fail("the card's PPO update of the gym trajectory disagrees with the CPU's")
    if ckpts != [CHEETAH_ITER, 2 * CHEETAH_ITER] or len(out["cli"]["evals"]) != 1:
        fail(f"the gym CLI run left checkpoints {ckpts} and evals {out['cli']['evals']}")
    if not np.isfinite(ev["return_mean"]) or ev["episodes"] != 16:
        fail(f"eval of the gym run printed {ev}")
    return launches


def phase_oracle(dev, found: dict) -> None:
    """The batched MuJoCo oracle (native/mujoco_batch.cpp, built here with
    g++ against the installed mujoco): 256 cheetah envs stepped under 100
    control steps of common random actions, from the port's start states
    (resting on the ground) and from the same states lifted by 1 m (free
    flight until they land); the oracle's ms per control step on this host,
    and the drift of the port's engine on the card (float32) from it
    (MuJoCo, float64) after each step: the largest over the envs and the
    median env's (the engine's contacts and limits are not MuJoCo's soft
    constraints; away from them it agrees with MuJoCo to rounding)."""
    if bridge_missing("oracle_cheetah", found, ("mujoco", "dm_control")):
        return
    from surreal_tpu_torch.envs import make_env
    from surreal_tpu_torch.envs.oracle import BatchedOracle, library_path

    B, steps = 256, 100
    t0 = time.perf_counter()
    library_path()
    out = {"phase": "oracle_cheetah", "ran": True, "num_envs": B, "control_steps": steps,
           "build_s": time.perf_counter() - t0}
    env = make_env("cheetah-run", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = env.reset(B, gen)
    actions = torch.rand(steps, B, env.action_dim, generator=gen, device=dev) * 2 - 1
    ctrl = actions.double().cpu().numpy()
    oracle = BatchedOracle.for_domain("cheetah", B)
    for case, lift in (("resting", 0.0), ("lifted_1m", 1.0)):
        q, qd = state.q.clone(), state.qd
        q[:, 1] += lift  # rootz
        oracle.set_state(q.double().cpu().numpy(), qd.double().cpu().numpy())
        oracle_ms, engine_ms, drift_q, drift_q_median, drift_qd = [], [], [], [], []
        for i in range(steps):
            t0 = time.perf_counter()
            oracle.step(ctrl[i])
            oracle_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q, qd = env._physics_step(q, qd, actions[i])
            torch.cuda.synchronize()
            engine_ms.append((time.perf_counter() - t0) * 1e3)
            oq, oqd = oracle.get_state()
            per_env = np.abs(q.double().cpu().numpy() - oq).max(1)
            drift_q.append(float(per_env.max()))
            drift_q_median.append(float(np.median(per_env)))
            drift_qd.append(float(np.abs(qd.double().cpu().numpy() - oqd).max()))
        out[case] = {"oracle_ms_per_control_step": float(np.median(oracle_ms)),
                     "engine_ms_per_control_step": float(np.median(engine_ms)),
                     "drift_q_max_abs": drift_q, "drift_q_median_env": drift_q_median,
                     "drift_qd_max_abs": drift_qd}
        if not (np.isfinite(drift_q).all() and np.isfinite(drift_qd).all()):
            fail(f"the oracle or the engine went non-finite on cheetah ({case})")
    oracle.close()
    print(json.dumps(out))


def phase_video_mujoco(dev, found: dict, trainer) -> None:
    """One 'mujoco' GIF (dm_control's GL frames of the recorded states) of 8
    steps of the PPO slice's deterministic policy, written by the port's
    writer, read back and held against the frames of the same states."""
    if bridge_missing("video_mujoco", found, ("mujoco", "dm_control")):
        return
    from surreal_tpu_torch.train import video

    policy_fn, zf = trainer.deterministic_policy()
    root = tempfile.mkdtemp(prefix="chip_smoke_video_")
    try:
        path = os.path.join(root, "mujoco.gif")
        t0 = time.perf_counter()
        ret = video.record_video(trainer.env, policy_fn, path, steps=8, zfilter=zf,
                                 backend="mujoco", size=64)
        record_s = time.perf_counter() - t0
        frames = video.read_gif(path)
        qs, _ = video.rollout_states(trainer.env, policy_fn, 8, zfilter=zf)
        want = video._mujoco_frames(trainer.env, qs, 64)
        gif_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    err = int(np.abs(frames.astype(np.int16) - want.astype(np.int16)).max())
    out = {"phase": "video_mujoco", "ran": True, "frames": list(frames.shape),
           "gif_bytes": gif_bytes, "record_s": record_s, "max_grey_level_error": err,
           "tol": video.PALETTE_ERROR, "return": ret}
    print(json.dumps(out))
    if frames.shape != (8, 64, 64, 3) or err > video.PALETTE_ERROR or len(np.unique(want)) < 5:
        fail(f"the 'mujoco' GIF is {frames.shape}, {err} levels from its frames, or blank")


CHEETAH_ITER = 256 * 128  # env steps per iteration of the cheetah-run PPO recipe
# --learn's tasks: the recipe's flags after `train ppo`, env steps per
# iteration, the bar, and the evidence's final 32-episode deterministic
# evaluations by compute dtype
LEARN_TASKS = {
    "cartpole-balance": dict(
        flags=CARTPOLE_FLAGS, iter=CARTPOLE_ITER, bar=900.0,
        evidence={"float32": [EVIDENCE_EVAL]}),
    # surreal_tpu_torch/envs/recipes.py: 15M steps, 256 envs, the default
    # (unfused) loss; results/cheetah_bf16_ppo_r3.txt (bfloat16, seed 0),
    # results/cheetah_ppo_r4.txt, cheetah_ppo_s1_r5.txt, cheetah_ppo_s2_r5.txt
    # (float32, seeds 0-2). The bar is below every one of them.
    "cheetah-run": dict(
        flags=["--env.env_name", "cheetah-run"], iter=CHEETAH_ITER, bar=700.0,
        evidence={"bfloat16": [816.9249877929688],
                  "float32": [784.4754638671875, 745.6201171875, 791.81103515625]}),
}
LEARN_DTYPES = ("bfloat16", "float32")


def learn(out_dir: str | None, task: str, flags: list[str]) -> None:
    """Trains `task`'s PPO recipe through the port's CLI to its budget
    (evals every 500,000 env steps), then evaluates the last checkpoint over
    32 episodes, deterministically and sampled, as the evidence files did.
    Fails below the task's bar. `flags` go to the train command after the
    recipe's (a diagnosis run: another seed, the other loss, a shorter log
    interval). cheetah-run without a `--learner.compute_dtype` flag trains
    the recipe in bfloat16 and in float32, as two processes at once on the
    card, each under DIR/<dtype>."""
    from surreal_tpu_torch.device import resolve

    spec = LEARN_TASKS[task]
    resolve("cuda")
    smi = phase_card()
    phase_build()
    root = out_dir or tempfile.mkdtemp(prefix="chip_smoke_learn_")
    os.makedirs(root, exist_ok=True)
    if task == "cheetah-run" and "--learner.compute_dtype" not in flags:
        results = learn_dtypes(root, flags)
    else:
        results = [learn_one(root, task, spec, flags)]
    low = [r for r in results if not r["final_eval_32"]["return_mean"] >= spec["bar"]]
    if low:
        fail(f"{task} scored " + ", ".join(
            f"{r['final_eval_32']['return_mean']} ({r['compute_dtype']})" for r in low)
            + f" < {spec['bar']} after its recipe's budget (evidence {spec['evidence']})")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def learn_one(root: str, task: str, spec: dict, flags: list[str]) -> dict:
    """One recipe run and its final evaluations; prints and returns its
    JSON line."""
    name = task.replace("-", "_") + "_learn"
    exp = os.path.join(root, name)
    with LogLines() as lines:
        t0 = time.perf_counter()
        cli_stdout(["train", "ppo", *spec["flags"], "--session.results_dir", root,
                    "--session.experiment_name", name, "--session.restore", "false",
                    "--device", "cuda", *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(os.path.join(exp, "config.json")) as f:
        cfg = json.load(f)
    final = {}
    for label, extra in (("deterministic", []), ("stochastic", ["--stochastic"])):
        final[label] = json.loads(cli_stdout(
            ["eval", "--experiment", exp, "--episodes", "32", "--device", "cuda", *extra]
        ).strip().splitlines()[-1])
    iters = cfg["session"]["total_env_steps"] // spec["iter"]
    dtype = cfg["learner"]["compute_dtype"]
    out = {
        "phase": "learn", "env": task, "flags": flags, "seed": cfg["session"]["seed"],
        "compute_dtype": dtype, "fused_loss": cfg["learner"]["fused_loss"],
        "iterations": iters, "env_steps": iters * spec["iter"], "wall_s": wall,
        "env_steps_per_s_with_evals": iters * spec["iter"] / wall,
        "eval_curve": evals_logged(lines),
        "train_log": [ln for ln in lines if ln.startswith("it ")],
        "final_eval_32": final["deterministic"], "final_eval_32_stochastic": final["stochastic"],
        "bar": spec["bar"], "evidence_eval_32": spec["evidence"].get(dtype), "results_dir": root}
    print(json.dumps(out))
    return out


def learn_dtypes(root: str, flags: list[str]) -> list[dict]:
    """The cheetah-run recipe in each of LEARN_DTYPES at once, one child
    process each (`--learn DIR/<dtype> cheetah-run --learner.compute_dtype
    <dtype>`), their output under DIR/<dtype>.log; returns their learn
    lines. The children are waited for, whatever happens."""
    procs = {}
    try:
        for dtype in LEARN_DTYPES:
            log = open(os.path.join(root, f"{dtype}.log"), "w")
            procs[dtype] = (log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--learn", os.path.join(root, dtype),
                 "cheetah-run", "--learner.compute_dtype", dtype, *flags],
                stdout=log, stderr=subprocess.STDOUT))
        codes = {dtype: proc.wait() for dtype, (_, proc) in procs.items()}
    finally:
        for log, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    results = []
    for dtype in LEARN_DTYPES:
        with open(os.path.join(root, f"{dtype}.log")) as f:
            text = f.read()
        lines = [json.loads(ln) for ln in text.splitlines()
                 if ln.startswith('{"phase": "learn"')]
        if not lines:
            fail(f"the {dtype} run (exit {codes[dtype]}) printed no result: {text[-3000:]}")
        print(json.dumps(lines[-1]))
        results.append(lines[-1])
    return results


def loss_timing(root: str) -> None:
    """Phase 1 and the autograd timing of phase 3 on the package under
    `root`, at the main path's minibatch."""
    sys.path.insert(0, os.path.abspath(root))
    from surreal_tpu_torch.device import resolve
    from surreal_tpu_torch.ops import ppo_loss_kernel as plk

    dev = resolve("cuda")
    phase_card()
    print(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(plk.__file__)))}")
    batch = loss_batch(np.random.default_rng(0), 4096, 6, dev)
    print_autograd_times(root, loss_autograd_times(plk, batch, (0.2, 0.5, 0.0)))


def gae_timing(root: str) -> None:
    """Phase 1, then `returns.gae` of the package under `root` against its
    plain version and its times at the recipes' three (T, B)."""
    sys.path.insert(0, os.path.abspath(root))
    from surreal_tpu_torch.device import resolve
    from surreal_tpu_torch.ops import returns

    dev = resolve("cuda")
    phase_card()
    print(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(returns.__file__)))}")
    gae_at_shapes(root, returns, dev)


SPAN_LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")
SPAN_COPIES = ("Memcpy HtoD", "Memcpy DtoH")
SPAN_LEAVES = ("ppo.rollout.policy", "physics.dynamics", "physics.constraints", "env.reward_obs",
               "env.reset", "ppo.rollout.done_check", "ppo.rollout.finish",
               "ppo.update.advantages", "ppo.update.loss", "ppo.update.backward",
               "ppo.update.optimizer", "ppo.update.finish")
SPAN_PARENTS = ("ppo.rollout.step", "env.step", "env.physics", "ppo.update.minibatch")


def innermost_segments(host: list) -> list[tuple[int, int, str]]:
    """The time the spans among `host` cover, cut into (start, end, label)
    by the innermost open span: a leaf span's name, or a span with spans
    inside it as "<name> (self)"."""
    spans = sorted(((s, e, n) for n, s, e, _ in host if n in SPAN_LEAVES + SPAN_PARENTS),
                   key=lambda x: (x[0], -x[1]))
    segs, stack, t = [], [], 0

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            segs.append((t, end, name))
            t = end

    for s, e, name in spans:
        close(s)
        if stack:
            segs.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    close(float("inf"))
    return [(a, b, n if n in SPAN_LEAVES else f"{n} (self)") for a, b, n in segs if b > a]


def label_at(t: int, segs: list, starts: list) -> str:
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else "(no span)"


def idle_by_span(dev: list, segs: list, starts: list) -> dict[str, float]:
    """The device's idle time between its first and last event, in s, by
    the innermost span open on the host while it lasted."""
    out: dict[str, float] = {}
    end = None
    for _, s, e, _ in sorted(dev, key=lambda x: x[1]):
        if end is not None and s > end:
            left, a = s - end, end
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(segs) and segs[i][0] < s:
                cut = min(segs[i][1], s) - max(segs[i][0], a)
                if cut > 0:
                    out[segs[i][2]] = out.get(segs[i][2], 0.0) + cut * 1e-9
                    left -= cut
                i += 1
            out["(no span)"] = out.get("(no span)", 0.0) + left * 1e-9
        end = e if end is None else max(end, e)
    return out


def by_span(dev: list, host: list, per: int) -> dict[str, dict]:
    """Per innermost span label, over `per` steps: launches, host-device
    copies, device ms (device work by the span of its launch), idle ms and
    host ms."""
    segs = innermost_segments(host)
    starts = [a for a, _, _ in segs]
    rows: dict[str, dict] = {}

    def add(label, key, v):
        row = rows.setdefault(label, dict.fromkeys(
            ("launches", "copies", "device_ms", "idle_ms", "host_ms"), 0.0))
        row[key] += v / per

    launched = {}
    for name, s, _, corr in host:
        if name.startswith(SPAN_LAUNCH):
            launched[corr] = label_at(s, segs, starts)
            add(launched[corr], "launches", 1)
    for name, s, e, corr in dev:
        label = launched.get(corr) or label_at(s, segs, starts)
        add(label, "device_ms", (e - s) * 1e-6)
        if name.startswith(SPAN_COPIES):
            add(label, "copies", 1)
    for label, v in idle_by_span(dev, segs, starts).items():
        add(label, "idle_ms", v * 1e3)
    for a, b, label in segs:
        add(label, "host_ms", (b - a) * 1e-6)
    return {k: {n: round(v, 4) for n, v in row.items()}
            for k, row in sorted(rows.items(), key=lambda kv: -kv[1]["idle_ms"])}


def sync_sites(fn, root: str) -> dict[str, int]:
    """The Python lines whose torch calls synchronised the host with the
    card during one call of `fn` (`torch.cuda.set_sync_debug_mode`), and
    how often."""
    import warnings

    sites: dict[str, int] = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, os.path.abspath(root))}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def span_profile(root: str) -> None:
    """Phase 1, then PPO on cheetah-run from the package under `root`:
    2,048 envs, (256, 256) tanh torsos, horizon 128, 4 epochs x 8
    minibatches of 32,768 rows, the fused loss. After a warm-up iteration
    and a timed one, PROFILED_STEPS rollout steps and one whole update
    under torch.profiler, read by the innermost span open on the host:
    launches (host runtime calls whose name starts with one of
    SPAN_LAUNCH), host-device copies, device time and the device's idle
    time, per rollout step and per minibatch step; the profiled rollout's
    wall time per step; the Python lines of the rollout's synchronising
    calls; and, where the package has `profiling.span`, a span's host cost
    with no profiler running. A package without spans reads "(no span)"
    throughout."""
    sys.path.insert(0, os.path.abspath(root))
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.ops import build
    from surreal_tpu_torch.train import PPOTrainer
    from surreal_tpu_torch.utils import profiling

    phase_card()
    print(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(ppo.__file__)))}")
    build.build_all()
    t = PPOTrainer("cheetah-run", ppo.PPOConfig(num_minibatches=8, fused_loss=True),
                   num_envs=2048, seed=0, hidden=(256, 256), device="cuda")
    t.run(1, log_every=1 << 62)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.run(1, log_every=1 << 62)
    torch.cuda.synchronize()
    iteration_s = time.perf_counter() - t0
    traj = ppo.rollout(t.cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret,
                       t.generator)[0]

    def steps(n):
        def run():
            t.env_state, t.obs, t.ep_ret = ppo.rollout(
                dataclasses.replace(t.cfg, horizon=n), t.env, t._flatten, t.state,
                t.env_state, t.obs, t.ep_ret, t.generator)[1:4]
        return run

    sites = sync_sites(steps(2), root)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_dev, r_host = timeline(steps(PROFILED_STEPS))
    rollout_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    u_dev, u_host = timeline(lambda: ppo.update(t.cfg, t.state, traj, t.generator))
    update_wall = time.perf_counter() - t0
    if not r_dev or not u_dev:
        fail("the profiler saw no device event in the rollout or the update")
    minibatches = t.cfg.epochs * t.cfg.num_minibatches
    rollout_rows = by_span(r_dev, r_host, PROFILED_STEPS)
    spans_per_iteration = (
        sum(n in SPAN_LEAVES + SPAN_PARENTS for n, *_ in r_host) * t.cfg.horizon
        / PROFILED_STEPS + sum(n in SPAN_LEAVES + SPAN_PARENTS for n, *_ in u_host))
    out = {"phase": "spans", "root": root, "iteration_s": iteration_s,
           "rollout_wall_s_per_step": rollout_wall / PROFILED_STEPS,
           "update_wall_s": update_wall,
           "kernels_per_step": len(r_dev) / PROFILED_STEPS,
           "launches_in_step_spans_per_step": sum(
               r["launches"] for k, r in rollout_rows.items()
               if k not in ("ppo.rollout.finish", "(no span)")),
           "spans_per_iteration": spans_per_iteration,
           "rollout_idle_s": sum(r["idle_ms"] for r in rollout_rows.values())
           * PROFILED_STEPS * 1e-3,
           "rollout_by_span": rollout_rows,
           "update_by_span_per_minibatch": by_span(u_dev, u_host, minibatches),
           "sync_sites_per_step": {k: v / 2 for k, v in sites.items()},
           "host_runtime_calls": collections.Counter(
               n for n, *_ in r_host + u_host if n.startswith("cu"))}
    if hasattr(profiling, "span"):
        n = 200_000
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("test.off"):
                pass
        out["span_off_us"] = (time.perf_counter() - t0) / n * 1e6
    print(json.dumps(out))


def compile_variants(texts: dict[str, str]) -> dict:
    """Builds each source text into build/kernels/sweep/<name>.so with the
    package's nvcc flags, all nvcc processes at once, and loads them."""
    import ctypes

    from surreal_tpu_torch.ops import build

    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed on the variant {name}:\n{log}")
        for line in log.splitlines():
            if "Used" in line:
                print(f"build {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


FLOOR_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
template <int kCluster>
__global__ void __cluster_dims__(kCluster, 1, 1) empty_cluster(float* out) {
  cooperative_groups::cluster_group c = cooperative_groups::this_cluster();
  c.sync();
  if (c.block_rank() == 0 && threadIdx.x == 0) *out = 1.0f;
  c.sync();
}
__global__ void empty_plain(float* out) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = 1.0f;
}
extern "C" int empty(float* out, int cluster, int threads, cudaStream_t s) {
  if (cluster == 16) {
    cudaFuncSetAttribute(empty_cluster<16>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    empty_cluster<16><<<16, threads, 0, s>>>(out);
  } else if (cluster == 8) {
    empty_cluster<8><<<8, threads, 0, s>>>(out);
  } else {
    empty_plain<<<-cluster, threads, 0, s>>>(out);  // -cluster plain blocks
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def loss_sweep():
    """The loss kernels built at other (cluster, threads) than the source's,
    and empty kernels, each timed in a CUDA graph at the main path's
    minibatch; the variants' outputs are held against the plain versions."""
    import ctypes

    from surreal_tpu_torch.device import resolve
    from surreal_tpu_torch.ops import build, ppo_loss_kernel as plk

    dev = resolve("cuda")
    phase_card()
    source = (build.CSRC / "ppo_loss.cu").read_text()
    committed = ("constexpr int kThreads = 256;", "constexpr int kCluster = 16;")
    if not all(line in source for line in committed):
        fail("ppo_loss.cu no longer declares kThreads = 256 and kCluster = 16")

    shapes = ((16, 256), (8, 512), (8, 256), (16, 512))
    libs = compile_variants({"floor": FLOOR_CU} | {
        f"ppo_loss_c{cluster}_t{threads}": source.replace(
            committed[0], f"constexpr int kThreads = {threads};").replace(
            committed[1], f"constexpr int kCluster = {cluster};")
        for cluster, threads in shapes})
    floor = libs["floor"]
    floor.empty.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    floor.empty.restype = ctypes.c_int
    variants = {}
    for cluster, threads in shapes:
        lib = libs[f"ppo_loss_c{cluster}_t{threads}"]
        fns = lib.ppo_loss_fwd, lib.ppo_loss_bwd
        for fn, kernel in zip(fns, (plk.FWD, plk.BWD)):
            fn.argtypes = [*kernel.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        variants[(cluster, threads)] = fns

    batch = loss_batch(np.random.default_rng(0), 4096, 6, dev)
    coefs = (0.2, 0.5, 0.0)
    g = torch.ones((), device=dev)
    ptr, N, A, ls_stride, lso_stride = plk._kernel_args(*batch)
    loss, metrics = torch.empty((), device=dev), torch.empty(5, device=dev)
    grads = [torch.empty_like(batch[i]) for i in (0, 1, 2)]
    p_fwd, p_bwd = plk.loss_fwd_plain(*batch, *coefs), plk.loss_bwd_plain(*batch, g, *coefs)
    bwd_ptrs = [ptr[k] for k in ("mean", "log_std", "value", "action", "logp_old", "adv",
                                 "vtarg", "v_old")]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    o = torch.empty(1, device=dev)
    for rep in range(2):
        for cluster, threads in ((16, 256), (8, 512), (8, 256), (-16, 256)):
            ms, _ = timed(lambda: floor.empty(o.data_ptr(), cluster, threads, stream()), 200)
            kind = f"cluster of {cluster}" if cluster > 0 else f"{-cluster} plain blocks"
            print(f"sweep {rep}: empty kernel, {kind} x {threads} threads: "
                  f"device {ms * 1e3:.2f} us")
        for (cluster, threads), (fwd, bwd) in variants.items():
            def run_fwd():
                return fwd(*ptr.values(), N, A, ls_stride, lso_stride, *coefs,
                           loss.data_ptr(), metrics.data_ptr(), stream())

            def run_bwd():
                return bwd(*bwd_ptrs, g.data_ptr(), N, A, ls_stride, *coefs, 1.0 / N,
                           *(x.data_ptr() for x in grads), stream())

            if run_fwd() or run_bwd():
                fail(f"the loss kernels at cluster {cluster} x {threads} did not launch")
            torch.cuda.synchronize()
            err_f = max((a - b).abs().max().item() for a, b in zip((loss, metrics), p_fwd))
            err_b = max((a - b).abs().max().item() for a, b in zip(grads, p_bwd))
            if not (err_f <= TOL_LOSS_FWD and err_b <= TOL_LOSS_BWD):
                fail(f"the loss kernels at cluster {cluster} x {threads} disagree: "
                     f"{err_f}, {err_b}")
            t_f, t_b = timed(run_fwd, 200)[0], timed(run_bwd, 200)[0]
            print(f"sweep {rep}: loss kernels, cluster of {cluster} x {threads} threads"
                  f"{' (committed)' if (cluster, threads) == (16, 256) else ''}: forward "
                  f"device {t_f * 1e3:.2f} us (err {err_f:.2e}), backward device "
                  f"{t_b * 1e3:.2f} us (err {err_b:.2e})")
        # the committed backward with log_std (N, A): no row sum, so no
        # cluster barrier and no read of another block's shared memory
        rows = [x.contiguous() for x in (batch[1].expand(N, A), grads[1].expand(N, A))]
        bwd = variants[(16, 256)][1]
        t_rows = timed(lambda: bwd(*bwd_ptrs[:1], rows[0].data_ptr(), *bwd_ptrs[2:],
                                   g.data_ptr(), N, A, A, *coefs, 1.0 / N, grads[0].data_ptr(),
                                   rows[1].data_ptr(), grads[2].data_ptr(), stream()), 200)[0]
        print(f"sweep {rep}: loss backward, cluster of 16 x 256 threads (committed), log_std "
              f"({N}, {A}): device {t_rows * 1e3:.2f} us")


# The grid and the memory traffic of gae.cu without its arithmetic: thread
# (c, s) of a block of cols x chunks threads loads its ceil(T / chunks) steps
# of the five inputs, all loads first, and stores the two outputs.
GAE_ROUND_TRIP_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int kMax, int kThreads>
__global__ void __launch_bounds__(kThreads)
    round_trip_kernel(const float* __restrict__ r, const float* __restrict__ v,
                      const float* __restrict__ nv, const float* __restrict__ disc,
                      const uint8_t* __restrict__ done, float* __restrict__ adv,
                      float* __restrict__ vtarg, int T, int B, int cols, int L) {
  const int c = threadIdx.x % cols, s = threadIdx.x / cols;
  const int b = blockIdx.x * cols + c;
  const int n = b < B ? max(0, min(L, T - s * L)) : 0;
  const long base = static_cast<long>(s * L) * B + b;
  float rr[kMax], vv[kMax], nn[kMax], dd[kMax];
  uint8_t dn[kMax];
#pragma unroll
  for (int j = 0; j < kMax; ++j) {  // no load's result is used before all are started
    if (j < n) {
      const long i = base + static_cast<long>(j) * B;
      rr[j] = r[i];
      vv[j] = v[i];
      nn[j] = nv[i];
      dd[j] = disc[i];
      dn[j] = done[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    if (j < n) {
      const long i = base + static_cast<long>(j) * B;
      const float x = rr[j] + nn[j] + dd[j] + (dn[j] ? 0.0f : 1.0f);
      adv[i] = x;
      vtarg[i] = x + vv[j];
    }
  }
}
extern "C" int round_trip(const float* r, const float* v, const float* nv, const float* disc,
                          const uint8_t* done, float* adv, float* vtarg, int T, int B,
                          int cols, int chunks, cudaStream_t s) {
  const int L = (T + chunks - 1) / chunks, blocks = (B + cols - 1) / cols;
  if (L <= 8) {  // few enough registers for blocks of 1024 threads
    round_trip_kernel<8, 1024><<<blocks, cols * chunks, 0, s>>>(r, v, nv, disc, done, adv,
                                                                vtarg, T, B, cols, L);
  } else if (L <= 16 && cols * chunks <= 512) {
    round_trip_kernel<16, 512><<<blocks, cols * chunks, 0, s>>>(r, v, nv, disc, done, adv,
                                                                vtarg, T, B, cols, L);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def gae_sweep():
    """The GAE kernel built at other (columns, chunks, steps) per block than
    the source's, each held against the plain version and timed in a CUDA
    graph at two of the recipes' shapes, beside an empty launch of the same
    grid and beside the loads and stores alone on that grid."""
    import ctypes

    from surreal_tpu_torch.device import resolve
    from surreal_tpu_torch.ops import build, gae_kernel, returns

    dev = resolve("cuda")
    phase_card()
    source = (build.CSRC / "gae.cu").read_text()
    committed = {"kCols": 8, "kChunks": 32, "kSteps": 8}
    if not all(f"constexpr int {k} = {v};" in source for k, v in committed.items()):
        fail(f"gae.cu no longer declares {committed}")
    # (columns, chunks, steps): the block has columns x chunks threads and a
    # segment is chunks x steps long; steps covers T = 128 in one segment
    # except where it is cut to show the cost of a second segment
    shapes = ((8, 32, 8), (8, 32, 4), (4, 64, 8), (16, 16, 8), (8, 16, 8), (4, 32, 8),
              (16, 32, 8), (8, 64, 4), (32, 8, 16), (2, 128, 2), (8, 128, 2))

    def variant(cols, chunks, steps):
        text = source
        for (k, v), new in zip(committed.items(), (cols, chunks, steps)):
            text = text.replace(f"constexpr int {k} = {v};", f"constexpr int {k} = {new};")
        return text

    libs = compile_variants({"floor": FLOOR_CU, "round_trip": GAE_ROUND_TRIP_CU} | {
        "gae_c{}_s{}_l{}".format(*shape): variant(*shape) for shape in shapes})
    floor, trip = libs["floor"].empty, libs["round_trip"].round_trip
    floor.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    trip.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    floor.restype = trip.restype = ctypes.c_int
    variants = {shape: libs["gae_c{}_s{}_l{}".format(*shape)].gae_fused for shape in shapes}
    for fn in variants.values():
        fn.argtypes = [*gae_kernel.GAE.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    o = torch.empty(1, device=dev)
    rng = np.random.default_rng(1)
    for T, B in (GAE_SHAPES[0], GAE_SHAPES[2]):
        args = gae_batch(rng, T, B, dev)
        out = torch.empty((2, T, B), device=dev)
        ptrs = [x.data_ptr() for x in (*args[:5], *out)]
        for rep in range(2):
            for shape, fn in variants.items():
                cols, chunks, steps = shape

                def kernel(*a):
                    res = torch.empty((2, T, B), device=dev)
                    if fn(*(x.data_ptr() for x in (*a[:5], *res)), T, B, a[5], a[5] * a[6],
                          stream()):
                        fail(f"gae at {shape} did not launch")
                    return res

                err = gae_error(kernel, returns.gae_plain, args)
                blocks, threads = -(-B // cols), cols * chunks
                ms = timed(lambda: fn(*ptrs, T, B, args[5], args[5] * args[6], stream()), 200)[0]
                empty_ms = timed(lambda: floor(o.data_ptr(), -blocks, threads, stream()), 200)[0]
                line = (f"sweep {rep} at (T, B) = ({T}, {B}): gae, {cols} columns x {chunks} "
                        f"chunks x {steps} steps{' (committed)' if shape == shapes[0] else ''}"
                        f", {blocks} blocks of {threads}: device {ms * 1e3:.2f} us (err "
                        f"{err:.2e}); empty launch of that grid {empty_ms * 1e3:.2f} us")
                if -(-T // chunks) <= (8 if threads > 512 else 16):
                    if trip(*ptrs, T, B, cols, chunks, stream()):
                        fail(f"the round-trip kernel at {shape} did not launch")
                    trip_ms = timed(lambda: trip(*ptrs, T, B, cols, chunks, stream()), 200)[0]
                    line += f"; loads and stores alone {trip_ms * 1e3:.2f} us"
                print(line)


# ---------------------------------------------------------------------------
# Phases 28-34: the data axis (A15a), run before the profiles (25-27). A rank is a child process (the port's
# parallel.mesh.spawn); each writes its numbers to a JSON file and the
# parent checks them. A failed or hung rank fails the run.
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_TIMEOUT_S = 480  # a rank blocked in a collective with a failed one ends here
DP_ITERS = {"ppo": 2, "lstm": 2, "overlap": 2, "ddpg": 6}


def param_digest(*modules) -> str:
    """A hash of the modules' parameters' bytes: equal iff bitwise equal."""
    h = hashlib.sha256()
    for module in modules:
        for p in module.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def counts_zero(kernels: dict) -> None:
    for k in kernels.values():
        k.launches = 0


def counts(kernels: dict) -> dict:
    return {n: k.launches for n, k in kernels.items()}


class AllReduceClock:
    """Times every torch.distributed.all_reduce in a `with` block, the card
    synchronised before and after each (gloo stages a CUDA tensor through
    the host, so it waits for the card anyway)."""

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self.seconds, self._orig = 0, 0.0, dist.all_reduce

        def timed_all_reduce(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(*a, **k)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        dist.all_reduce = timed_all_reduce
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self._orig


def dp_timed_runs(t, iters: int) -> tuple[list, dict]:
    """`iters` single iterations of trainer `t`, each timed on the host
    clock with the card synchronised; the last iteration's metrics."""
    times, m = [], None
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = t.run(1, log_every=1)[-1]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, m


def dp_rank_ppo(mesh) -> dict:
    """The flagship over the mesh: 3 iterations, their launches and times,
    then one more iteration split into rollout and update, the update's
    all-reduces timed."""
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = PPOConfig(**FLAGSHIP)
    torch.cuda.reset_peak_memory_stats()
    t = PPOTrainer("cheetah-run", cfg, num_envs=256, hidden=(256, 256), seed=0, mesh=mesh)
    counts_zero(kernels)
    times, m = dp_timed_runs(t, DP_ITERS["ppo"])
    launches = counts(kernels)
    t0 = time.perf_counter()
    traj, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with AllReduceClock() as clock:
        ppo.update(cfg, t.state, traj, t.generator, axis=mesh)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"local_envs": t.local_envs, "rows_per_minibatch": traj.reward.numel() // 8,
            "s_per_iteration": times, "launches": launches, "metrics": m,
            "rollout_s": t1 - t0, "update_s": t2 - t1, "allreduce_s": clock.seconds,
            "allreduce_calls": clock.calls, "digest": param_digest(t.state.net),
            "lr_scale": float(t.state.lr_scale), "kl_beta": float(t.state.kl_beta),
            "update_step": t.state.update_step,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def dp_rank_card_vs_cpu(mesh) -> dict:
    """One sharded PPO update (the loss kernels on the card, the plain
    versions on the CPU) and one sharded block of DDPG updates, each on the
    card and on the CPU over the same gloo group, on this rank's own
    synthetic inputs."""
    from surreal_tpu_torch.algos import ddpg, ppo
    from surreal_tpu_torch.data import replay as rp
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic
    from surreal_tpu_torch.models.ddpg_nets import DDPGActor, DDPGCritic
    from surreal_tpu_torch.ops import ppo_loss_kernel as plk

    dev = mesh.device
    rng = np.random.default_rng(100 + mesh.rank)
    T, B, A = 16, 64, 6  # 1,024 rows a rank, minibatches of 256: the fused gate admits
    cfg = ppo.PPOConfig(horizon=T, epochs=2, num_minibatches=4, fused_loss=True)
    traj = synthetic_trajectory(T, B, A, 17, rng)
    perms = torch.stack([torch.tensor(rng.permutation(T * B)) for _ in range(cfg.epochs)])
    results = {}
    before = (plk.FWD.launches, plk.BWD.launches)
    for d in ("cpu", dev):
        net = PPOActorCritic(17, A, hidden=(64, 64),
                             generator=torch.Generator().manual_seed(0)).to(d)
        st = ppo.init_state(cfg, net, 17)
        tr = ppo.Trajectory(**{k: x.to(d) for k, x in traj.items()})
        st, metrics = ppo.update(cfg, st, tr, None, perms.to(d), axis=mesh)
        results[d] = ({k: p.detach().cpu() for k, p in net.named_parameters()},
                      {k: float(x) for k, x in metrics.items()})
    kernel_launches = [plk.FWD.launches - before[0], plk.BWD.launches - before[1]]
    ppo_err = max((results["cpu"][0][k] - results[dev][0][k]).abs().max().item()
                  for k in results["cpu"][0])
    ppo_m_err = max(abs(results["cpu"][1][k] - results[dev][1][k])
                    / max(1.0, abs(results["cpu"][1][k])) for k in results["cpu"][1])

    Bd, D, U, batch = 16, 17, 4, 64
    dcfg = ddpg.DDPGConfig(batch_size=batch, updates_per_iteration=U,
                           replay_capacity=48 * Bd * DP_RANKS, use_zfilter=True)
    gen = torch.Generator().manual_seed(200 + mesh.rank)
    chunks = [{"obs": torch.randn(20, Bd, D, generator=gen),
               "action": torch.rand(20, Bd, A, generator=gen) * 2 - 1,
               "reward": torch.rand(20, Bd, generator=gen),
               "done": torch.rand(20, Bd, generator=gen) < 0.05} for _ in range(3)]
    indices = [(12 + torch.randint(0, 48 - dcfg.n_step, (batch,), generator=gen),
                torch.randint(0, Bd, (batch,), generator=gen)) for _ in range(U)]
    dres = {}
    for d in ("cpu", dev):
        init = torch.Generator().manual_seed(1)
        state = ddpg.init_state(dcfg, DDPGActor(D, A, (64, 48), generator=init).to(d),
                                DDPGCritic(D, A, (64, 48), generator=init).to(d), D)
        ring = ddpg.init_replay(dcfg, Bd * DP_RANKS, D, A, d, shards=DP_RANKS)
        for chunk in chunks:
            ring = rp.replay_insert(ring, {k: v.to(d) for k, v in chunk.items()})
        state.zfilter = ddpg.zfilter_update(state.zfilter, ring.data["obs"], mesh)
        state, metrics = ddpg.update(dcfg, state, ring, None,
                                     [(a.to(d), b.to(d)) for a, b in indices], axis=mesh)
        dres[d] = ({f"{n}.{k}": p.detach().cpu() for n in ("actor", "critic", "target_actor",
                                                           "target_critic")
                    for k, p in getattr(state, n).named_parameters()},
                   {k: float(x) for k, x in metrics.items()})
    ddpg_err = max((dres["cpu"][0][k] - dres[dev][0][k]).abs().max().item()
                   for k in dres["cpu"][0])
    ddpg_m_err = max(abs(dres["cpu"][1][k] - dres[dev][1][k]) / max(1.0, abs(dres["cpu"][1][k]))
                     for k in dres["cpu"][1])
    return {"ppo_params_max_abs_err": ppo_err, "ppo_metrics_max_rel_err": ppo_m_err,
            "ppo_loss_launches_on_the_card": kernel_launches,
            "ddpg_params_max_abs_err": ddpg_err, "ddpg_metrics_max_rel_err": ddpg_m_err,
            "digests": [hashlib.sha256(b"".join(p.numpy().tobytes() for p in
                                                results[dev][0].values())).hexdigest(),
                        hashlib.sha256(b"".join(p.numpy().tobytes() for p in
                                                dres[dev][0].values())).hexdigest()]}


def dp_rank_lstm(mesh) -> dict:
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    torch.cuda.reset_peak_memory_stats()
    t = PPOTrainer("cheetah-run", PPOConfig(**FLAGSHIP), num_envs=256, hidden=(256, 256), seed=0,
                   use_lstm=True, lstm_size=128, mesh=mesh)
    counts_zero(kernels)
    times, m = dp_timed_runs(t, DP_ITERS["lstm"])
    return {"s_per_iteration": times, "launches": counts(kernels), "metrics": m,
            "digest": param_digest(t.state.net), "lr_scale": float(t.state.lr_scale),
            "carry_max_abs": max(float(c.abs().max()) for c in t.carry),
            "carry_rows": t.carry[0].shape[0],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def dp_rank_overlap(mesh) -> dict:
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    torch.cuda.reset_peak_memory_stats()
    t = PPOTrainer("cheetah-run", PPOConfig(**FLAGSHIP), num_envs=256, hidden=(256, 256), seed=0,
                   overlap=True, mesh=mesh)
    counts_zero(kernels)
    times, m = dp_timed_runs(t, DP_ITERS["overlap"])  # the first call primes the buffer
    return {"s_per_iteration_first_with_prime": times, "launches": counts(kernels),
            "metrics": m, "digest": param_digest(t.state.net),
            "pending_rows": t._pending.reward.shape[1],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def dp_rank_ddpg(mesh) -> dict:
    from surreal_tpu_torch.algos.ddpg import DDPGConfig
    from surreal_tpu_torch.train import DDPGTrainer

    kernels = path_kernels()
    torch.cuda.reset_peak_memory_stats()
    t = DDPGTrainer("cheetah-run", DDPGConfig(), num_envs=256, seed=0, mesh=mesh)
    counts_zero(kernels)
    times, m = dp_timed_runs(t, DP_ITERS["ddpg"])
    s = t.state
    return {"s_per_iteration": times, "launches": counts(kernels), "metrics": m,
            "digest": param_digest(s.actor, s.critic, s.target_actor, s.target_critic),
            "ring_shape": list(t.replay.data["obs"].shape),
            "ring_bytes": nbytes(*t.replay.data.values()), "replay_total": t.replay.total,
            "update_step": s.update_step, "sigma": [float(t.sigma[0]), float(t.sigma[-1])],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def dp_rank_shared(mesh) -> dict:
    """The phases of 2 gloo ranks sharing the card, in one process each."""
    out = {}
    for name, fn in (("ppo", dp_rank_ppo), ("card_vs_cpu", dp_rank_card_vs_cpu),
                     ("lstm", dp_rank_lstm), ("overlap", dp_rank_overlap),
                     ("ddpg", dp_rank_ddpg)):
        t0 = time.perf_counter()
        out[name] = fn(mesh)
        out[name]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def dp_rank_nccl(mesh) -> dict:
    """A 1-rank NCCL group on the flagship: 2 iterations on the mesh, then
    2 of the one-device trainer from the same seed."""
    import torch.distributed as dist

    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    out = {"backend": dist.get_backend()}
    for name, kw in (("mesh", {"mesh": mesh}), ("one_device", {"device": "cuda"})):
        t = PPOTrainer("cheetah-run", PPOConfig(**FLAGSHIP), num_envs=256, hidden=(256, 256),
                       seed=0, **kw)
        counts_zero(kernels)
        times, m = dp_timed_runs(t, 2)
        out[name] = {"s_per_iteration": times, "launches": counts(kernels), "metrics": m,
                     "digest": param_digest(t.state.net),
                     "zfilter_digest": hashlib.sha256(b"".join(
                         x.cpu().numpy().tobytes() for x in (t.state.zfilter.mean,
                                                             t.state.zfilter.m2))).hexdigest()}
    return out


# ---------------------------------------------------------------------------
# Phases 35-39: the model and time mesh axes and ZeRO. Phases 35-37 run in
# one pair of gloo ranks sharing the card, which make a data 2, a time 2 and
# a model 2 mesh in turn over the same group; each checks the shapes a rank
# holds. Phase 38 is the dry run of the reference's six layouts, phase 39
# the three knobs through the CLI.
# ---------------------------------------------------------------------------

AXES_ITERS = 2  # 1 warm-up and 1 timed iteration of each flagship cell
ZERO_CHUNK = 71_303  # ceil(142,605 / 2): a rank's chunk of the flagship's moments
TP_PARAM_FLOATS = 71_821  # the six kernels halved (141,568 / 2) + 1,037 replicated
# The tensor-parallel learner after one whole iteration against the one-device
# trainer's: cuBLAS rounds the sharded products otherwise and the physics
# amplifies it (7.5e-5 on an H100 80GB HBM3 at 700 W); a planted rollout
# fault, checked to read above the limit, read 9.9e-3 there.
TP_ITERATION_TOL = 1e-3
DDPG_ZERO_ITERS = 6  # as phase 32: a rank's warm-up ends in the 5th


class CollectiveClock:
    """Counts and times every torch.distributed all_reduce and all_gather in
    a `with` block, the card synchronised before and after each."""

    KINDS = ("all_reduce", "all_gather")

    def __enter__(self):
        import torch.distributed as dist

        self.calls = dict.fromkeys(self.KINDS, 0)
        self.seconds = dict.fromkeys(self.KINDS, 0.0)
        self._orig = {k: getattr(dist, k) for k in self.KINDS}

        def clocked(kind):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = self._orig[kind](*a, **k)
                torch.cuda.synchronize()
                self.seconds[kind] += time.perf_counter() - t0
                self.calls[kind] += 1
                return out

            return run

        for kind in self.KINDS:
            setattr(dist, kind, clocked(kind))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for kind, fn in self._orig.items():
            setattr(dist, kind, fn)

    def numbers(self, per: float = 1.0) -> dict:
        return {k: {"calls": self.calls[k] / per, "s": self.seconds[k] / per}
                for k in self.KINDS}


def add_counts(total: dict, kernels: dict) -> None:
    for n, k in kernels.items():
        total[n] = total.get(n, 0) + k.launches


def axes_rank_zero(mesh) -> dict:
    """Phase 35 in a rank: the flagship at data 2 with ZeRO, in turns with
    the replicated run from the same seed; then DDPG's recipe likewise."""
    from surreal_tpu_torch.algos.ddpg import DDPGConfig
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer

    kernels = path_kernels()
    out = {}
    for algo in ("ppo", "ddpg"):
        pair, iters = {}, AXES_ITERS if algo == "ppo" else DDPG_ZERO_ITERS
        for name in ("replicated", "zero"):
            if algo == "ppo":
                pair[name] = PPOTrainer("cheetah-run", PPOConfig(
                    **FLAGSHIP, zero_optimizer=name == "zero"), num_envs=256,
                    hidden=(256, 256), seed=0, mesh=mesh)
            else:
                pair[name] = DDPGTrainer("cheetah-run", DDPGConfig(
                    zero_optimizer=name == "zero"), num_envs=256, seed=0, mesh=mesh)
        res = {n: {"s_per_iteration": [], "launches": {}, "all_gather_calls": 0,
                   "all_gather_s": 0.0} for n in pair}
        for _ in range(iters):
            for name, t in pair.items():  # in turns
                counts_zero(kernels)
                with CollectiveClock() as clock:
                    times, m = dp_timed_runs(t, 1)
                r = res[name]
                r["s_per_iteration"] += times
                r["all_gather_calls"] += clock.calls["all_gather"]
                r["all_gather_s"] += clock.seconds["all_gather"]
                r["metrics"] = m
                add_counts(r["launches"], kernels)
        for name, t in pair.items():
            s = t.state
            nets = (s.net,) if algo == "ppo" else (s.actor, s.critic, s.target_actor,
                                                   s.target_critic)
            opts = (s.opt_state,) if algo == "ppo" else (s.actor_opt, s.critic_opt)
            res[name]["digest"] = param_digest(*nets)
            res[name]["moment_floats"] = [int(o.mu.numel()) if name == "zero"
                                          else sum(int(v.numel()) for v in o.mu.values())
                                          for o in opts]
            res[name]["updates"] = s.update_step
        out[algo] = res
        del pair
        torch.cuda.empty_cache()
    return out


def axes_rank_time(mesh) -> dict:
    """Phase 36 in a rank: the flagship at data 1 x time 2; the GAE split
    over the time axis against `gae` on one rollout's trajectory; a
    time-sharded update on the card against the same on the CPU."""
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic
    from surreal_tpu_torch.ops import ppo_loss_kernel as plk, returns
    from surreal_tpu_torch.parallel.tshard import replicated_reverse_scan
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = PPOConfig(**FLAGSHIP)
    t = PPOTrainer("cheetah-run", cfg, num_envs=256, hidden=(256, 256), seed=0, mesh=mesh)
    counts_zero(kernels)
    with CollectiveClock() as clock:
        times, m = dp_timed_runs(t, AXES_ITERS)
    launches = counts(kernels)
    digest = param_digest(t.state.net)
    traj = ppo.rollout(t.cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret,
                       t.generator)[0]
    delta, coef = returns.gae_delta_coef(traj.reward, traj.value, traj.next_value,
                                         traj.discount, traj.done, cfg.gamma, cfg.lam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = replicated_reverse_scan(delta, coef, mesh)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    whole = returns.gae(traj.reward, traj.value, traj.next_value, traj.discount, traj.done,
                        cfg.gamma, cfg.lam)[0]
    gae_rel = float((split - whole).abs().max()) / max(1.0, float(whole.abs().max()))

    # card vs CPU: one time-sharded update of a synthetic trajectory (the
    # same on both time ranks, as a rollout's is)
    rng = np.random.default_rng(300)
    T, B, A = 16, 64, 6
    ucfg = PPOConfig(horizon=T, epochs=2, num_minibatches=4, fused_loss=True, time_shards=2)
    syn = synthetic_trajectory(T, B, A, 17, rng)
    perms = torch.stack([torch.tensor(rng.permutation(T * B)) for _ in range(ucfg.epochs)])
    res = {}
    before = (plk.FWD.launches, plk.BWD.launches)
    for d in ("cpu", mesh.device):
        net = PPOActorCritic(17, A, hidden=(64, 64),
                             generator=torch.Generator().manual_seed(0)).to(d)
        st = ppo.init_state(ucfg, net, 17)
        tr = ppo.Trajectory(**{k: x.to(d) for k, x in syn.items()})
        st, metrics = ppo.update(ucfg, st, tr, None, perms.to(d), axis=mesh)
        res[d] = ({k: p.detach().cpu() for k, p in net.named_parameters()},
                  {k: float(x) for k, x in metrics.items()})
    card = mesh.device
    return {"time_shards": t.cfg.time_shards, "local_envs": t.local_envs,
            "s_per_iteration": times, "launches": launches, "metrics": m, "digest": digest,
            "collectives_per_iteration": clock.numbers(AXES_ITERS),
            "gae_max_rel_err": gae_rel, "time_sharded_scan_s": scan_s,
            "update_launches_on_the_card": [plk.FWD.launches - before[0],
                                            plk.BWD.launches - before[1]],
            "update_params_max_abs_err": max((res["cpu"][0][k] - res[card][0][k]).abs().max()
                                             .item() for k in res["cpu"][0]),
            "update_metrics_max_rel_err": max(abs(res["cpu"][1][k] - res[card][1][k])
                                              / max(1.0, abs(res["cpu"][1][k]))
                                              for k in res["cpu"][1])}


def whole_digest(trainer) -> str:
    """A hash of a tensor-parallel trainer's whole network (its shards
    gathered over the model ranks: collective)."""
    whole = trainer.sharding.gather(dict(trainer.state.net.named_parameters()))
    return hashlib.sha256(b"".join(p.detach().cpu().numpy().tobytes()
                                   for p in whole.values())).hexdigest()


def axes_rank_model(mesh) -> dict:
    """Phase 37 in a rank: the flagship at data 1 x model 2. Its first
    iteration is run by parts, and rank 0 holds it against the one-device
    trainer from the same seed: the rollouts (the first step's means and
    values), the learners after each side's own iteration, the one-device
    update of the tensor-parallel rollout's trajectory (same parameters,
    Z-filter and permutations) against the tensor-parallel update, and a
    one-device iteration with a planted rollout fault. Then AXES_ITERS - 1
    timed iterations, one more split into rollout and update with the
    collectives counted and timed, and one bfloat16 iteration."""
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.parallel import mesh as pmesh, tp
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = PPOConfig(**FLAGSHIP)

    def trainer(**kw):
        return PPOTrainer("cheetah-run", cfg, num_envs=256, hidden=(256, 256), seed=0, **kw)

    t = trainer(mesh=mesh)
    floats = sum(int(p.numel()) for p in t.state.net.parameters())
    shapes = {n: list(p.shape) for n, p in t.state.net.named_parameters()}
    counts_zero(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
        cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)
    traj = tp.gather_envs(traj, mesh)
    ppo.update(cfg, t.state, traj, t.generator)
    t.global_iter += 1
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = counts(kernels)
    gathered = {k: v.cpu() for k, v in t.sharding.gather(
        dict(t.state.net.named_parameters())).items()}
    vs_one = None
    if mesh.primary:  # the one-device trainer from the same seed
        one, twin, bad = (trainer(device=mesh.device) for _ in range(3))
        traj_one = ppo.rollout(cfg, one.env, one._flatten, one.state, one.env_state, one.obs,
                               one.ep_ret, one.generator)[0]
        twin.generator.set_state(one.generator.get_state())  # the same permutations
        ppo.update(cfg, one.state, traj_one, one.generator)
        ppo.update(cfg, twin.state, traj, twin.generator)
        # a planted fault confined to the rollout: the action noise of the
        # wrong rows (a `rows=` slice one env off), the rest as the one device's
        B = bad.obs.shape[0]
        traj_bad = ppo.rollout(cfg, bad.env, bad._flatten, bad.state, bad.env_state, bad.obs,
                               bad.ep_ret, bad.generator, rows=(1, B + 1, B + 1))[0]
        ppo.update(cfg, bad.state, traj_bad, bad.generator)

        def err(net):
            return max((gathered[k] - p.detach().cpu()).abs().max().item()
                       for k, p in net.named_parameters())

        vs_one = {"first_step_mean_max_abs_err": (traj_one.mean[0] - traj.mean[0]).abs().max()
                  .item(),
                  "first_step_value_max_abs_err": (traj_one.value[0] - traj.value[0]).abs()
                  .max().item(),
                  "rollout_obs_max_abs_err": (traj_one.obs - traj.obs).abs().max().item(),
                  "rollout_mean_max_abs_err": (traj_one.mean - traj.mean).abs().max().item(),
                  "iteration_max_abs_err": err(one.state.net),
                  "update_max_abs_err": err(twin.state.net),
                  "planted_fault_iteration_max_abs_err": err(bad.state.net)}
        del one, twin, bad
    pmesh.barrier(mesh)
    counts_zero(kernels)
    more, m = dp_timed_runs(t, AXES_ITERS - 1)
    add_counts(launches, kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CollectiveClock() as roll_clock:
        traj, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
            cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)
        traj = tp.gather_envs(traj, mesh)
    t1 = time.perf_counter()
    with CollectiveClock() as update_clock:
        ppo.update(cfg, t.state, traj, t.generator)
    t2 = time.perf_counter()
    digest = whole_digest(t)
    del t
    torch.cuda.empty_cache()
    tb = trainer(mesh=mesh, compute_dtype="bfloat16")
    counts_zero(kernels)
    bf16_times, bf16_m = dp_timed_runs(tb, 1)
    return {"param_floats": floats, "shapes": shapes, "s_per_iteration": times + more,
            "launches": launches, "metrics": m, "vs_one_device": vs_one,
            "digest": digest, "rollout_s": t1 - t0, "update_s": t2 - t1,
            "collectives_per_rollout_step": roll_clock.numbers(cfg.horizon),
            "collectives_per_minibatch_step": update_clock.numbers(
                cfg.epochs * cfg.num_minibatches),
            "bf16_s": bf16_times, "bf16_metrics": bf16_m, "bf16_launches": counts(kernels),
            "bf16_digest": whole_digest(tb)}


def dp_rank_axes(mesh) -> dict:
    """Phases 35-37: a data 2, a time 2 and a model 2 mesh in turn, made by
    both ranks in the same order over the same group."""
    from surreal_tpu_torch.parallel import mesh as pmesh

    out = {}
    for name, fn, shape in (("zero", axes_rank_zero, (2, 1, 1)),
                            ("time", axes_rank_time, (1, 1, 2)),
                            ("model", axes_rank_model, (1, 2, 1))):
        t0 = time.perf_counter()
        out[name] = fn(mesh if shape == (2, 1, 1)
                       else pmesh.make_mesh(*shape, device=mesh.device.type))
        out[name]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


DP_RANK_PHASES = {"shared": dp_rank_shared, "nccl": dp_rank_nccl, "axes": dp_rank_axes,
                  # phase 40's, defined with it below
                  "resume": lambda mesh, job: resume_rank(mesh, job)}


def dp_rank(local: int, folder: str, world: int, phases: str) -> None:
    """Rank `local` of `world`: joins the group at folder's file store, runs
    DP_RANK_PHASES[phases] (given folder/job.json where there is one) and
    writes its numbers to folder/rank<r>.json."""
    import torch.distributed as dist

    from surreal_tpu_torch.parallel import mesh as pmesh

    pmesh.distributed_init("file://" + os.path.join(folder, "store"), world, local,
                           device="cuda", timeout_s=DP_TIMEOUT_S)
    try:
        mesh = pmesh.make_mesh(world, device="cuda")
        job = os.path.join(folder, "job.json")
        if os.path.exists(job):
            with open(job) as f:
                out = DP_RANK_PHASES[phases](mesh, json.load(f))
        else:
            out = DP_RANK_PHASES[phases](mesh)
        with open(os.path.join(folder, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(phases: str, world: int, job: dict | None = None) -> list[dict]:
    """Spawns the ranks (handing them `job`) and returns their numbers;
    fails if any failed."""
    from surreal_tpu_torch.parallel.mesh import spawn

    folder = tempfile.mkdtemp(prefix=f"chip_smoke_dp_{phases}_")
    try:
        if job is not None:
            with open(os.path.join(folder, "job.json"), "w") as f:
                json.dump(job, f)
        spawn(dp_rank, world, (folder, world, phases), timeout_s=DP_TIMEOUT_S)
        out = []
        for r in range(world):
            with open(os.path.join(folder, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out
    except (RuntimeError, TimeoutError) as e:
        fail(f"the {phases} ranks failed: {e}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def phase_dp_shared() -> dict:
    """Phases 28-32: 2 gloo ranks sharing the card. Returns each path's
    launches, per rank."""
    t0 = time.perf_counter()
    ranks = run_ranks("shared", DP_RANKS)
    wall = time.perf_counter() - t0
    steps = 256 * 128
    by_path = {}

    def same(name, key="digest"):
        vals = [r[name][key] for r in ranks]
        if len(set(map(str, vals))) != 1:
            fail(f"{name}: {key} differs across ranks: {vals}")

    # 28: the flagship
    p = [r["ppo"] for r in ranks]
    n = DP_ITERS["ppo"]
    want = {"gae": 0, "ppo_loss_fwd": 32 * n, "ppo_loss_bwd": 32 * n}
    for r, x in enumerate(p):
        if x["launches"] != want:
            fail(f"ppo_dp2_cheetah: rank {r} launched {x['launches']}, not {want}")
        if x["rows_per_minibatch"] != 2048 or x["local_envs"] != 128:
            fail(f"ppo_dp2_cheetah: rank {r} ran {x['local_envs']} envs and "
                 f"{x['rows_per_minibatch']} rows a minibatch, not 128 and 2,048")
        check_finite("ppo_dp2_cheetah", x["metrics"])
        by_path[f"ppo_dp2_cheetah_rank{r}"] = x["launches"]
    for key in ("digest", "lr_scale", "kl_beta", "update_step"):
        same("ppo", key)
    s_iter = [sum(x["s_per_iteration"]) / n for x in p]
    print(json.dumps({
        "phase": "ppo_dp2_cheetah", "ranks": DP_RANKS, "backend": "gloo",
        "num_envs": 256, "envs_per_rank": 128, "rows_per_minibatch": 2048,
        "s_per_iteration_by_rank": [x["s_per_iteration"] for x in p],
        "env_steps_per_s_both": steps / max(s_iter),
        "params_bitwise_equal": True, "launches_by_rank": [x["launches"] for x in p],
        "split_iteration_by_rank": [{k: x[k] for k in ("rollout_s", "update_s", "allreduce_s",
                                                        "allreduce_calls")} for x in p],
        "allreduce_share_of_update": [x["allreduce_s"] / x["update_s"] for x in p],
        "max_memory_allocated_by_rank": [x["max_memory_allocated"] for x in p],
        "metrics_rank0": p[0]["metrics"], "phase_s": [x["phase_s"] for x in p]}))

    # 29: card vs CPU
    c = [r["card_vs_cpu"] for r in ranks]
    same("card_vs_cpu", "digests")
    print(json.dumps({"phase": "dp2_card_vs_cpu", "tol": 1e-5, "metrics_tol": 1e-4, "ranks": c}))
    for r, x in enumerate(c):
        if x["ppo_loss_launches_on_the_card"] != [8, 8]:
            fail(f"dp2_card_vs_cpu: rank {r}'s card update launched the loss kernels "
                 f"{x['ppo_loss_launches_on_the_card']} times, not 8 + 8")
        if not (x["ppo_params_max_abs_err"] <= 1e-5 and x["ppo_metrics_max_rel_err"] <= 1e-4
                and x["ddpg_params_max_abs_err"] <= TOL_DDPG_PARITY
                and x["ddpg_metrics_max_rel_err"] <= 1e-4):
            fail(f"dp2_card_vs_cpu: rank {r}'s sharded update on the card disagrees with the "
                 f"CPU's: {x}")

    # 30: LSTM-PPO
    ls = [r["lstm"] for r in ranks]
    same("lstm")
    same("lstm", "lr_scale")
    for r, x in enumerate(ls):
        if any(x["launches"].values()) or x["carry_rows"] != 128 or x["carry_max_abs"] <= 0:
            fail(f"lstm_dp2_cheetah: rank {r}: {x}")
        check_finite("lstm_dp2_cheetah", x["metrics"])
        by_path[f"lstm_dp2_cheetah_rank{r}"] = x["launches"]
    print(json.dumps({"phase": "lstm_dp2_cheetah", "envs_per_rank": 128,
                      "s_per_iteration_by_rank": [x["s_per_iteration"] for x in ls],
                      "env_steps_per_s_both": steps / max(x["s_per_iteration"][-1] for x in ls),
                      "launches_by_rank": [x["launches"] for x in ls],
                      "params_bitwise_equal": True,
                      "max_memory_allocated_by_rank": [x["max_memory_allocated"] for x in ls]}))

    # 31: the overlapped step
    ov = [r["overlap"] for r in ranks]
    same("overlap")
    n = DP_ITERS["overlap"]
    want = {"gae": 0, "ppo_loss_fwd": 32 * n, "ppo_loss_bwd": 32 * n}
    for r, x in enumerate(ov):
        if x["launches"] != want or x["pending_rows"] != 128:
            fail(f"overlap_dp2_cheetah: rank {r}: {x['launches']} (want {want}), "
                 f"pending of {x['pending_rows']} envs")
        check_finite("overlap_dp2_cheetah", x["metrics"])
        by_path[f"overlap_dp2_cheetah_rank{r}"] = x["launches"]
    print(json.dumps({"phase": "overlap_dp2_cheetah", "envs_per_rank": 128,
                      "s_per_iteration_by_rank_first_with_prime":
                          [x["s_per_iteration_first_with_prime"] for x in ov],
                      "env_steps_per_s_both":
                          steps / max(x["s_per_iteration_first_with_prime"][-1] for x in ov),
                      "launches_by_rank": [x["launches"] for x in ov],
                      "params_bitwise_equal": True}))

    # 32: DDPG, its recipe's global ring
    dd = [r["ddpg"] for r in ranks]
    same("ddpg")
    same("ddpg", "update_step")
    n = DP_ITERS["ddpg"]
    for r, x in enumerate(dd):
        # the warm-up counts a rank's own 128 envs: 10,000 transitions after
        # 79 steps, so iterations 5 and 6 update
        if (x["ring_shape"] != [999_936 // 256, 128, 17] or x["update_step"] != 32
                or x["replay_total"] != 16 * n or any(x["launches"].values())):
            fail(f"ddpg_dp2_cheetah: rank {r}: {x}")
        check_finite("ddpg_dp2_cheetah", x["metrics"])
        by_path[f"ddpg_dp2_cheetah_rank{r}"] = x["launches"]
    if abs(dd[0]["sigma"][0] - 0.05) > 1e-7 or abs(dd[1]["sigma"][1] - 0.4) > 1e-7:
        fail(f"ddpg_dp2_cheetah: the ranks' noise ladders {[x['sigma'] for x in dd]} are not "
             "the halves of the global one")
    print(json.dumps({"phase": "ddpg_dp2_cheetah", "envs_per_rank": 128,
                      "ring_transitions_global": 999_936,
                      "ring_shape_by_rank": [x["ring_shape"] for x in dd],
                      "ring_bytes_by_rank": [x["ring_bytes"] for x in dd],
                      "s_per_iteration_by_rank": [x["s_per_iteration"] for x in dd],
                      "env_steps_per_s_both_updating":
                          16 * 256 / max(x["s_per_iteration"][-1] for x in dd),
                      "update_step": dd[0]["update_step"], "launches_by_rank":
                          [x["launches"] for x in dd], "params_bitwise_equal": True,
                      "metrics_rank0": dd[0]["metrics"],
                      "max_memory_allocated_by_rank": [x["max_memory_allocated"] for x in dd]}))
    print(f"dp shared-card phases: {wall:.1f} s with the ranks' start")
    return by_path


def phase_dp_nccl() -> dict:
    """Phase 33: a 1-rank NCCL group on the flagship, bit for bit the
    one-device trainer. Returns its launches."""
    (r,) = run_ranks("nccl", 1)
    n = 2
    want = {"gae": 0, "ppo_loss_fwd": 32 * n, "ppo_loss_bwd": 32 * n}
    print(json.dumps({"phase": "ppo_dp1_nccl_cheetah", **r}))
    if r["backend"] != "nccl":
        fail(f"the 1-rank group ran over {r['backend']}, not nccl")
    if r["mesh"]["launches"] != want or r["one_device"]["launches"] != want:
        fail(f"ppo_dp1_nccl_cheetah launched {r['mesh']['launches']}, not {want}")
    for key in ("digest", "zfilter_digest"):
        if r["mesh"][key] != r["one_device"][key]:
            fail(f"the 1-rank NCCL trainer's {key} differs from the one-device trainer's")
    timeless = [{k: v for k, v in r[t]["metrics"].items() if "per_s" not in k}
                for t in ("mesh", "one_device")]
    if timeless[0] != timeless[1]:
        fail("the 1-rank NCCL trainer's metrics differ from the one-device trainer's")
    return r["mesh"]["launches"]


CLI_DEVICE = "cuda"  # where the CLI phases' commands run


def cli_train(root: str, name: str, flags: list, iters: int) -> tuple:
    """`train ppo` through the port's CLI as a subprocess, at the
    cartpole-balance recipe's width with the fused loss, `iters`
    iterations with a checkpoint each and an evaluation at the end:
    (name, iters, seconds, the CompletedProcess)."""
    argv = [sys.executable, "-m", "surreal_tpu_torch.cli.main", "train", "ppo",
            *CARTPOLE_FLAGS, *flags, "--session.total_env_steps", str(iters * CARTPOLE_ITER),
            "--session.checkpoint_every_steps", str(CARTPOLE_ITER),
            "--session.eval_every_steps", str(iters * CARTPOLE_ITER),
            "--session.results_dir", root, "--session.experiment_name", name,
            "--device", CLI_DEVICE]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    done = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=900)
    return name, iters, time.perf_counter() - t0, done


def cli_chains(root: str, chains: dict) -> dict:
    """Starts each chain of CLI runs (a list of (name, flags, iterations)),
    its runs in order, the chains at once; {chain: a future of its runs'
    results} (`check_runs` checks them)."""
    from concurrent.futures import ThreadPoolExecutor

    def run(chain):
        return [cli_train(root, *r) for r in chain]

    ex = ThreadPoolExecutor(len(chains))
    pending = {name: ex.submit(run, chain) for name, chain in chains.items()}
    ex.shutdown(wait=False)
    return pending


def check_runs(chains: dict) -> None:
    """Fails if a CLI run of `cli_chains` failed."""
    for runs in chains.values():
        for name, iters, _, done in runs:
            if done.returncode != 0:
                fail(f"the CLI run {name} ({iters} iterations) failed:\n{done.stderr[-3000:]}")


def rank_evals(text: str) -> dict:
    """{rank: [eval lines]} from the ranks' log lines."""
    got = {}
    for rank, line in re.findall(r"cli\.rank(\d+)\] (eval @ .*)", text):
        got.setdefault(rank, []).append(line)
    return got


def cli_checkpoint(root: str, name: str) -> tuple[dict, dict]:
    """The last checkpoint of run `name` (2 iterations): its .pt files and
    its mesh.json."""
    folder = os.path.join(root, name, "checkpoints", "latest", str(2 * CARTPOLE_ITER))
    files = {f: torch.load(os.path.join(folder, f), weights_only=True, map_location="cpu")
             for f in sorted(os.listdir(folder)) if f.endswith(".pt")}
    with open(os.path.join(folder, "mesh.json")) as f:
        return files, json.load(f)


# Phase 34's chains: 2 iterations straight; 1, then resumed to 2.
DP2_CHAINS = {"dp2_straight": [("straight", ["--session.mesh.data", "2"], 2)],
              "dp2_resumed": [("resumed", ["--session.mesh.data", "2"], 1),
                              ("resumed", ["--session.mesh.data", "2"], 2)]}


def phase_cli_dp2(root: str, chains: dict, evaluated) -> dict:
    """Phase 34: `train ppo --session.mesh.data 2` through the port's CLI,
    as a user runs it (the command spawns its 2 ranks), at the
    cartpole-balance recipe's width with the fused loss: 2 iterations with
    a checkpoint each; the same run stopped after 1 and resumed; its last
    checkpoint against the uninterrupted run's, bit for bit; config.json
    written once; the ranks' evaluation lines equal; then `eval`, the
    future `evaluated` of its printed line. The runs are DP2_CHAINS', done
    (`cli_chains`) at once with phase 39's."""
    out = {"phase": "cli_ppo_cartpole_dp2", "run_at_once_with_phase_39": True}
    (_, _, straight_s, straight), = chains["dp2_straight"]
    (_, _, first_s, first), (_, _, resumed_s, resumed) = chains["dp2_resumed"]
    writes = len(re.findall(r"wrote .*config\.json", straight.stderr))
    ev = rank_evals(straight.stderr)
    unequal = unequal_leaves(cli_checkpoint(root, "straight")[0],
                             cli_checkpoint(root, "resumed")[0])
    resumed_lines = re.findall(r"rank\d\] resumed from checkpoint @ (\d+)", resumed.stderr)
    result, _ = evaluated.result()
    out.update(straight_2_iterations_s=straight_s, stopped_and_resumed_s=first_s + resumed_s,
               config_json_writes=writes, evals_by_rank=ev,
               resumed_from=resumed_lines, unequal_after_resume=unequal, eval=result,
               backend_line=[ln for ln in straight.stdout.splitlines() if "ranks over" in ln],
               rank_lines=[ln for ln in straight.stderr.splitlines() if "LOCAL_RANK" in ln],
               first_run_evals=rank_evals(first.stderr))
    print(json.dumps(out))
    if writes != 1:
        fail(f"config.json was written {writes} times")
    if sorted(ev) != ["0", "1"] or ev["0"] != ev["1"]:
        fail(f"the ranks' evaluations differ: {ev}")
    if resumed_lines != [str(CARTPOLE_ITER)] * 2:
        fail(f"the ranks did not both resume at iteration 1: {resumed_lines}")
    if unequal:
        fail(f"the resumed run's checkpoint differs from the uninterrupted one's: {unequal}")
    if f"{result['return_mean']:.1f}" not in ev["0"][-1]:
        fail(f"`eval` of the checkpoint ({result}) is not the ranks' evaluation {ev['0']}")
    return out


def phase_axes() -> dict:
    """Phases 35-37: ZeRO, the time axis and the model axis, 2 gloo ranks
    sharing the card. Returns each path's launches, per rank."""
    t0 = time.perf_counter()
    ranks = run_ranks("axes", DP_RANKS)
    wall = time.perf_counter() - t0
    n = AXES_ITERS
    want = {"gae": 0, "ppo_loss_fwd": 32 * n, "ppo_loss_bwd": 32 * n}
    none = {"gae": 0, "ppo_loss_fwd": 0, "ppo_loss_bwd": 0}
    by_path = {}

    def same(part, *keys):
        vals = [functools.reduce(lambda x, k: x[k], keys, r[part]) for r in ranks]
        if len(set(map(str, vals))) != 1:
            fail(f"{part}: {keys} differs across ranks: {vals}")

    # 35: ZeRO
    z = [r["zero"] for r in ranks]
    for algo in ("ppo", "ddpg"):
        same("zero", algo, "zero", "digest")
    for r, x in enumerate(z):
        p, d = x["ppo"], x["ddpg"]
        for algo, pair in (("ppo", p), ("ddpg", d)):
            if pair["zero"]["digest"] != pair["replicated"]["digest"]:
                fail(f"{algo}_zero_dp2: rank {r}'s ZeRO learner differs from the replicated one")
            check_finite(f"{algo}_zero_dp2", pair["zero"]["metrics"])
        if p["zero"]["moment_floats"] != [ZERO_CHUNK] or p["replicated"]["moment_floats"] != [
                142_605]:
            fail(f"ppo_zero_dp2: rank {r} holds {p['zero']['moment_floats']} moment floats, "
                 f"not [{ZERO_CHUNK}]")
        if p["zero"]["launches"] != want or p["replicated"]["launches"] != want:
            fail(f"ppo_zero_dp2: rank {r} launched {p['zero']['launches']}, not {want}")
        if p["zero"]["all_gather_calls"] != 32 * n:
            fail(f"ppo_zero_dp2: {p['zero']['all_gather_calls']} all_gathers, not {32 * n}")
        halves = [-(-f // 2) for f in d["replicated"]["moment_floats"]]
        if (d["zero"]["moment_floats"] != halves or d["zero"]["updates"] != 32
                or d["zero"]["launches"] != none):
            fail(f"ddpg_zero_dp2: rank {r}: {d['zero']}")
        by_path[f"ppo_zero_dp2_cheetah_rank{r}"] = p["zero"]["launches"]
        by_path[f"ddpg_zero_dp2_cheetah_rank{r}"] = d["zero"]["launches"]
    print(json.dumps({
        "phase": "ppo_zero_dp2_cheetah", "ranks": DP_RANKS, "backend": "gloo",
        "moment_floats_a_rank": ZERO_CHUNK, "moment_bytes_a_rank": 2 * 4 * ZERO_CHUNK,
        "moment_bytes_replicated": 2 * 4 * 142_605, "params_bitwise_equal_to_replicated": True,
        "in_turns_s_per_iteration_by_rank": [
            {k: x["ppo"][k]["s_per_iteration"] for k in ("replicated", "zero")} for x in z],
        "all_gather_s_per_update_by_rank": [x["ppo"]["zero"]["all_gather_s"] / n for x in z],
        "all_gather_calls_per_update": z[0]["ppo"]["zero"]["all_gather_calls"] / n,
        "launches_by_rank": [x["ppo"]["zero"]["launches"] for x in z],
        "metrics_rank0": z[0]["ppo"]["zero"]["metrics"]}))
    print(json.dumps({
        "phase": "ddpg_zero_dp2_cheetah", "iterations": DDPG_ZERO_ITERS,
        "moment_floats_a_rank": z[0]["ddpg"]["zero"]["moment_floats"],
        "moment_floats_replicated": z[0]["ddpg"]["replicated"]["moment_floats"],
        "params_bitwise_equal_to_replicated": True, "updates": z[0]["ddpg"]["zero"]["updates"],
        "in_turns_s_per_iteration_by_rank": [
            {k: x["ddpg"][k]["s_per_iteration"] for k in ("replicated", "zero")} for x in z],
        "all_gather_s_by_rank": [x["ddpg"]["zero"]["all_gather_s"] for x in z]}))

    # 36: the time axis
    tm = [r["time"] for r in ranks]
    same("time", "digest")
    for r, x in enumerate(tm):
        if x["time_shards"] != 2 or x["local_envs"] != 256 or x["launches"] != want:
            fail(f"ppo_time2_cheetah: rank {r}: time_shards {x['time_shards']}, "
                 f"{x['local_envs']} envs, launches {x['launches']} (want {want})")
        if not x["gae_max_rel_err"] <= 1e-5:
            fail(f"ppo_time2_cheetah: the time-sharded GAE is {x['gae_max_rel_err']} from gae")
        if x["update_launches_on_the_card"] != [8, 8] or not (
                x["update_params_max_abs_err"] <= 1e-5
                and x["update_metrics_max_rel_err"] <= 1e-4):
            fail(f"ppo_time2_cheetah: rank {r}'s time-sharded update, card vs CPU: {x}")
        check_finite("ppo_time2_cheetah", x["metrics"])
        by_path[f"ppo_time2_cheetah_rank{r}"] = x["launches"]
    print(json.dumps({"phase": "ppo_time2_cheetah", "ranks": DP_RANKS, "mesh": "1x1x2",
                      "envs_per_rank": 256, "params_bitwise_equal": True,
                      **{k: [x[k] for x in tm] for k in (
                          "s_per_iteration", "gae_max_rel_err", "time_sharded_scan_s",
                          "update_params_max_abs_err", "update_metrics_max_rel_err",
                          "collectives_per_iteration", "launches")},
                      "tol": 1e-5, "metrics_rank0": tm[0]["metrics"]}))

    # 37: the model axis
    md = [r["model"] for r in ranks]
    same("model", "digest")
    same("model", "bf16_digest")
    for r, x in enumerate(md):
        if x["param_floats"] != TP_PARAM_FLOATS or x["shapes"]["actor_torso.dense_0.weight"] \
                != [128, 17] or x["shapes"]["mean_head.weight"] != [3, 256]:
            fail(f"ppo_model2_cheetah: rank {r} holds {x['param_floats']} parameter floats "
                 f"({x['shapes']}), not {TP_PARAM_FLOATS}")
        if x["launches"] != want or x["bf16_launches"] != {k: v // n for k, v in want.items()}:
            fail(f"ppo_model2_cheetah: rank {r} launched {x['launches']} "
                 f"(bf16 {x['bf16_launches']}), not {want}")
        check_finite("ppo_model2_cheetah", x["metrics"])
        check_finite("ppo_model2_bf16_cheetah", x["bf16_metrics"])
        by_path[f"ppo_model2_cheetah_rank{r}"] = x["launches"]
        by_path[f"ppo_model2_bf16_cheetah_rank{r}"] = x["bf16_launches"]
    vs_one = md[0]["vs_one_device"]
    for k in ("first_step_mean_max_abs_err", "first_step_value_max_abs_err",
              "update_max_abs_err"):
        if not vs_one[k] <= 1e-5:
            fail(f"ppo_model2_cheetah: {k} {vs_one[k]} against the one-device trainer")
    if not vs_one["iteration_max_abs_err"] <= TP_ITERATION_TOL:
        fail(f"ppo_model2_cheetah: the gathered learner is {vs_one['iteration_max_abs_err']} "
             f"from the one-device trainer's after one iteration (limit {TP_ITERATION_TOL})")
    if not vs_one["planted_fault_iteration_max_abs_err"] > TP_ITERATION_TOL:
        fail(f"ppo_model2_cheetah: a planted rollout fault reads "
             f"{vs_one['planted_fault_iteration_max_abs_err']}, inside the limit "
             f"{TP_ITERATION_TOL}: the gate cannot see it")
    print(json.dumps({"phase": "ppo_model2_cheetah", "ranks": DP_RANKS, "mesh": "1x2x1",
                      "param_floats_a_rank": TP_PARAM_FLOATS, "envs_per_rank": 256,
                      "vs_one_device_rank0": vs_one,
                      "tol": 1e-5, "iteration_tol": TP_ITERATION_TOL,
                      "params_bitwise_equal": True,
                      **{k: [x[k] for x in md] for k in (
                          "s_per_iteration", "rollout_s", "update_s",
                          "collectives_per_rollout_step", "collectives_per_minibatch_step",
                          "launches", "bf16_s")},
                      "metrics_rank0": md[0]["metrics"],
                      "bf16_metrics_rank0": md[0]["bf16_metrics"]}))
    print(f"axes phases 35-37: {wall:.1f} s with the ranks' start; per rank "
          f"{[{k: round(r[k]['phase_s'], 1) for k in ('zero', 'time', 'model')} for r in ranks]}")
    return by_path


DRYRUN_LABELS = ("dp", "dp + zero", "dp + lstm", "dp x sp(time)", "dp x tp(model)", "dp (ddpg)")


def start_dryrun():
    """Phase 38's command, started in a thread: `python -m
    surreal_tpu_torch.dryrun 2 cuda`, the reference's six layouts over 2
    ranks sharing the card. Returns its future: (seconds, CompletedProcess)."""
    return start_command([sys.executable, "-m", "surreal_tpu_torch.dryrun", "2", CLI_DEVICE],
                         600)


def phase_dryrun(started) -> None:
    """Phase 38: the dry run's six layouts each printed OK."""
    secs, done = started.result(timeout=600)
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith("dryrun_multichip(2)")]
    print(json.dumps({"phase": "dryrun_multichip_2_cuda", "s": secs,
                      "run_at_once_with_phases_34_39": True, "lines": lines}))
    if done.returncode != 0 or [ln.split(" OK:")[0] for ln in lines] != [
            f"dryrun_multichip(2) {k}" for k in DRYRUN_LABELS]:
        fail(f"the dry run failed:\n{done.stdout[-2000:]}\n{done.stderr[-3000:]}")


CLI_KNOBS = {"model2": ["--session.mesh.model", "2"], "time2": ["--session.mesh.time", "2"],
             "zero_dp2": ["--session.mesh.data", "2", "--learner.zero_optimizer", "true"]}
# Phase 39's chains: model 2 and time 2 for 2 iterations; ZeRO's run 1, then
# resumed to 2, against phase 34's uninterrupted replicated data-2 run (ZeRO's
# learner is the replicated one's bit for bit, phase 35).
AXES_CHAINS = {"model2": [("model2", CLI_KNOBS["model2"], 2)],
               "time2": [("time2", CLI_KNOBS["time2"], 2)],
               "zero_dp2": [("zero_dp2", CLI_KNOBS["zero_dp2"], 1),
                            ("zero_dp2", CLI_KNOBS["zero_dp2"], 2)]}


def phase_cli_axes(root: str, chains: dict) -> dict:
    """Phase 39: `train ppo` through the CLI at the cartpole-balance
    recipe's width with the fused loss under each knob of CLI_KNOBS, 2
    iterations, a checkpoint each; the ZeRO run stopped after 1 and resumed,
    its last checkpoint against phase 34's uninterrupted replicated run's,
    bit for bit. The runs are AXES_CHAINS', done at once with phase 34's."""
    out = {"phase": "cli_ppo_cartpole_axes", "run_at_once_with_phase_34": True, "runs": {}}
    runs = [r for k in AXES_CHAINS for r in chains[k]]
    for name, iters, secs, done in runs:
        got = rank_evals(done.stderr)
        if sorted(got) != ["0", "1"] or got["0"] != got["1"]:
            fail(f"{name}: the ranks' evaluations differ: {got}")
        out["runs"][f"{name}_{iters}"] = {"s": secs, "eval": got["0"]}
    resumed = re.findall(r"rank\d\] resumed from checkpoint @ (\d+)", runs[-1][3].stderr)
    if resumed != [str(CARTPOLE_ITER)] * 2:
        fail(f"the ZeRO run did not resume at iteration 1 on both ranks: {resumed}")
    layouts = {name: cli_checkpoint(root, name)[1] for name in CLI_KNOBS}
    want = {"model2": {"data": 1, "model": 2, "time": 1, "zero": False},
            "time2": {"data": 1, "model": 1, "time": 2, "zero": False},
            "zero_dp2": {"data": 2, "model": 1, "time": 1, "zero": True}}
    if layouts != want:
        fail(f"the checkpoints' layouts are {layouts}, not {want}")
    unequal = unequal_leaves(cli_checkpoint(root, "straight")[0],
                             cli_checkpoint(root, "zero_dp2")[0])
    out.update(layouts=layouts, unequal_after_resume=unequal, zero_resumed_from=resumed)
    print(json.dumps(out))
    if unequal:
        fail(f"the resumed ZeRO run's checkpoint differs from the uninterrupted replicated "
             f"one's: {unequal}")
    return out


# Phase 40: phase 34's `straight` checkpoint (data 2) and phase 39's `model2`
# one (data 1 x model 2), each resumed for one iteration under another layout.
RESUME_STEP = 2 * CARTPOLE_ITER


def writer_state(folder: str, order=None) -> dict:
    """The one-device full state of a mesh's step directory, on the host:
    state.pt's learner, the env batch of each data index's model-0, time-0
    rank joined along the envs in data-index order (`order`, a permutation
    of the data indices, plants a fault), data index 0's generator."""
    with open(os.path.join(folder, "mesh.json")) as f:
        layout = json.load(f)
    members = layout["model"] * layout["time"]
    parts = [torch.load(os.path.join(folder, f"rank{d * members}.pt"), weights_only=True,
                        map_location="cpu") for d in (order or range(layout["data"]))]

    def join(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs)
        if isinstance(xs[0], dict):
            return {k: join([x[k] for x in xs]) for k in xs[0]}
        return type(xs[0])(join([x[i] for x in xs]) for i in range(len(xs[0])))

    state = torch.load(os.path.join(folder, "state.pt"), weights_only=True, map_location="cpu")
    state.update({k: join([p[k] for p in parts]) for k in parts[0] if k != "generator"})
    state["generator"] = parts[0]["generator"]
    return state


def rows_of(state: dict, keys, index: int, shards: int) -> dict:
    """Data index `index`'s rows of the env batch's `keys` (all dim 0: PPO)."""
    def cut(x):
        if isinstance(x, torch.Tensor):
            b = x.shape[0] // shards
            return x[index * b:(index + 1) * b]
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        return x

    return {k: cut(state[k]) for k in keys if k in state and k != "generator"}


@contextlib.contextmanager
def loads_recorded():
    """Within it, every PPOTrainer.load_full_state appends the trainer's
    full state just after the load, on the host, to the list it yields."""
    from surreal_tpu_torch.train import PPOTrainer

    orig, seen = PPOTrainer.load_full_state, []

    def load(self, fs):
        orig(self, fs)
        seen.append(moved(self.full_state))

    PPOTrainer.load_full_state = load
    try:
        yield seen
    finally:
        PPOTrainer.load_full_state = orig


def moved(tree, device="cpu"):
    """A copy of a tree of tensors on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device).clone()
    if isinstance(tree, dict):
        return {k: moved(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(moved(v, device) for v in tree)
    return tree


def max_abs_diff(a: dict, b: dict, paths: list[str]) -> float:
    """The largest difference of two full states' floating leaves at `paths`."""
    la, lb = dict(state_leaves(a)), dict(state_leaves(b))
    return max((float((la[p].double() - lb[p].double()).abs().max()) for p in paths
                if isinstance(la.get(p), torch.Tensor) and la[p].is_floating_point()),
               default=0.0)


def split_state(fs: dict, rank_keys) -> tuple[dict, dict]:
    """(the learner, the env batch and generator) of a full state."""
    return ({k: v for k, v in fs.items() if k not in rank_keys},
            {k: v for k, v in fs.items() if k in rank_keys})


def resume_flags(root: str, name: str, *extra) -> list:
    """The CLI's flags for one iteration past RESUME_STEP in experiment `name`."""
    return [*CARTPOLE_FLAGS, *extra, "--session.total_env_steps",
            str(RESUME_STEP + CARTPOLE_ITER), "--session.checkpoint_every_steps",
            str(CARTPOLE_ITER), "--session.eval_every_steps", str(RESUME_STEP + CARTPOLE_ITER),
            "--session.results_dir", root, "--session.experiment_name", name]


def copy_checkpoint(root: str, source: str, name: str) -> str:
    """Run `source`'s checkpoint at RESUME_STEP copied into experiment
    `name`, whose only checkpoint it is; returns the source's folder."""
    src = os.path.join(root, source, "checkpoints", "latest", str(RESUME_STEP))
    shutil.copytree(src, os.path.join(root, name, "checkpoints", "latest", str(RESUME_STEP)))
    return src


def resume_rank(mesh, job: dict) -> dict:
    """Phase 40's second resume in a rank of a data 2 mesh: the CLI's
    session (`_train`, what `train ppo --session.mesh.data 2` runs in each
    rank) resumes phase 39's model2 checkpoint for one iteration. What the
    rank's trainer loaded against the writer's files: the learner against
    state.pt, the env batch against its rows of the whole batch (the
    writer's one data index: rank0.pt), the generator against the rule's
    (rank 0: the writer's; rank 1: a fresh start's fold_in of the run's
    seed and index 1); its loss launches and seconds."""
    from surreal_tpu_torch.cli.configs import generate_configs
    from surreal_tpu_torch.cli.main import _parse_overrides, _train
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    learner, env_cfg, session = generate_configs("ppo", _parse_overrides(job["flags"]))
    counts_zero(kernels)
    t0 = time.perf_counter()
    with loads_recorded() as seen, LogLines() as lines:
        _train("ppo", learner, env_cfg, session, mesh.device.type, mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(kernels)
    whole = writer_state(job["source"])
    d = mesh.index["data"]
    got_learner, got_batch = split_state(seen[0], PPOTrainer.rank_keys)
    want_learner = split_state(whole, PPOTrainer.rank_keys)[0]
    if d == 0:
        want_gen = whole["generator"]
    else:
        word = np.random.SeedSequence([int(session.seed), d]).generate_state(1, np.uint64)[0]
        want_gen = torch.Generator(device=mesh.device).manual_seed(int(word)).get_state()
    return {"rank": mesh.rank, "s": seconds, "launches": launches,
            "resumed": [m for m in lines if m.startswith("resumed from checkpoint")],
            "learner_unequal": unequal_leaves(got_learner, want_learner),
            "batch_unequal": unequal_leaves(
                {k: v for k, v in got_batch.items() if k != "generator"},
                rows_of(whole, PPOTrainer.rank_keys, d, 2)),
            "generator_as_ruled": bool(torch.equal(got_batch["generator"], want_gen.cpu()))}


def phase_resume_layouts(root: str) -> dict:
    """Phase 40: a checkpoint resumed under another layout, as the
    reference's orbax restore resumes it. Resume 1: phase 34's `straight`
    checkpoint (data 2) through the CLI in this process on one device (no
    mesh), one iteration: the learner it loaded bit for bit state.pt, its
    env batch the two ranks' files joined and its generator rank 0's, and
    its checkpoint after the iteration bit for bit that of a one-device
    trainer in this process given that whole state and run one iteration;
    the same check with the two ranks' rows swapped (a planted fault) must
    fail. Resume 2, in two ranks at once with resume 1: phase 39's model2
    checkpoint under --session.mesh.data 2, one iteration (`resume_rank`).
    Returns the loss kernels' launches on each resume (resume 2's summed
    over its ranks)."""
    from concurrent.futures import ThreadPoolExecutor

    from surreal_tpu_torch.cli.configs import generate_configs
    from surreal_tpu_torch.cli.main import _build_trainer, _parse_overrides
    from surreal_tpu_torch.train import PPOTrainer

    keys = PPOTrainer.rank_keys
    out = {"phase": "cli_resume_other_layout", "step": RESUME_STEP}
    model2 = copy_checkpoint(root, "model2", "model2_as_data2")
    ex = ThreadPoolExecutor(1)
    ranks = ex.submit(run_ranks, "resume", DP_RANKS,
                      {"source": model2, "flags": resume_flags(root, "model2_as_data2",
                                                               "--session.mesh.data", "2")})
    ex.shutdown(wait=False)

    src = copy_checkpoint(root, "straight", "straight_on_one_device")
    flags = resume_flags(root, "straight_on_one_device")
    kernels = path_kernels()
    counts_zero(kernels)
    t0 = time.perf_counter()
    with loads_recorded() as seen, LogLines() as lines:
        cli_stdout(["train", "ppo", *flags, "--device", CLI_DEVICE])
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_launches = counts(kernels)
    whole = writer_state(src)
    got_learner, got_batch = split_state(seen[0], keys)
    want_learner, want_batch = split_state(whole, keys)
    swapped = split_state(writer_state(src, order=(1, 0)), keys)[1]
    fault = unequal_leaves(got_batch, swapped)
    learner_cfg, env_cfg, session = generate_configs("ppo", _parse_overrides(flags))
    twin = _build_trainer(learner_cfg, env_cfg, session, CLI_DEVICE)
    twin.load_full_state(moved(whole, CLI_DEVICE))
    twin.run(1)
    folder = os.path.join(root, "straight_on_one_device", "checkpoints", "latest",
                          str(RESUME_STEP + CARTPOLE_ITER))
    files = sorted(os.listdir(folder))
    after = torch.load(os.path.join(folder, "state.pt"), weights_only=True, map_location="cpu")
    twin_state = moved(twin.full_state)
    twin_unequal = unequal_leaves(after, twin_state)
    out["one_device"] = {
        "s": one_s, "launches": one_launches,
        "resumed": [m for m in lines if m.startswith("resumed from checkpoint")],
        "learner_unequal": unequal_leaves(got_learner, want_learner),
        "batch_unequal": unequal_leaves(got_batch, want_batch),
        "files_after": files, "unequal_to_twin": twin_unequal,
        "max_abs_to_twin": max_abs_diff(after, twin_state, twin_unequal),
        "planted_fault_rows_swapped": {
            "unequal": fault, "obs_max_abs": float(
                (got_batch["obs"] - swapped["obs"]).abs().max())}}
    del twin
    rank_out = ranks.result()
    out["data2_from_model2"] = rank_out
    print(json.dumps(out))
    one = out["one_device"]
    want = {"gae": 0, "ppo_loss_fwd": 32, "ppo_loss_bwd": 32}
    if one["launches"] != want:
        fail(f"the one-device resume launched {one['launches']}, not {want}")
    if not (one["resumed"] and one["resumed"][0].startswith(
            f"resumed from checkpoint @ {RESUME_STEP} env steps (iter 2), written by a data "
            "mesh of 2")):
        fail(f"the one-device run did not resume the data-2 checkpoint: {one['resumed']}")
    if one["learner_unequal"] or one["batch_unequal"]:
        fail(f"the one-device resume loaded other values than the data-2 checkpoint's: "
             f"{one['learner_unequal']} {one['batch_unequal']}")
    if not one["planted_fault_rows_swapped"]["unequal"]:
        fail("the check of the loaded env batch missed the planted fault (rows swapped)")
    if files != ["state.pt"]:
        fail(f"the one-device checkpoint after the resume holds {files}")
    if twin_unequal:
        fail(f"the resumed run's checkpoint differs from the one-device twin's: {twin_unequal}")
    for r in rank_out:
        if r["launches"] != want:
            fail(f"rank {r['rank']} of the data-2 resume launched {r['launches']}, not {want}")
        if not (r["resumed"] and r["resumed"][0].startswith(
                f"resumed from checkpoint @ {RESUME_STEP} env steps (iter 2), written by a "
                "1x2x1 (data x model x time) mesh")):
            fail(f"rank {r['rank']} did not resume the model2 checkpoint: {r['resumed']}")
        if r["learner_unequal"] or r["batch_unequal"] or not r["generator_as_ruled"]:
            fail(f"rank {r['rank']} loaded other values than its part of the model2 "
                 f"checkpoint: {r}")
    return {"cli_ppo_cartpole_resume_one_device": one_launches,
            "cli_ppo_cartpole_resume_data2": {
                n: sum(r["launches"][n] for r in rank_out) for n in want}}


def start_cli_mesh(dp2: bool = True) -> dict:
    """Starts phases 34 (with `dp2`; without, only its uninterrupted run,
    which phase 39 holds the resumed ZeRO run against), 38 and 39: the dry
    run and every chain of CLI runs at once in threads, each command's 2
    ranks sharing the card. `finish_cli_mesh` waits and checks."""
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_mesh_")
    chains = cli_chains(root, {**(DP2_CHAINS if dp2 else {
        "dp2_straight": DP2_CHAINS["dp2_straight"]}), **AXES_CHAINS})
    # phase 34's `eval` of the run it reads, as soon as that is written
    evaluated = run_after([chains["dp2_straight"]], lambda: eval_printed(start_eval(
        os.path.join(root, "straight"), "--episodes", "16"))) if dp2 else None
    return {"root": root, "dp2": dp2, "t0": time.perf_counter(), "dryrun": start_dryrun(),
            "chains": chains, "evaluated": evaluated}


def resume_when_written(started: dict) -> dict:
    """Phase 40, as soon as the runs whose checkpoints it resumes are done
    (beside the other chains, on cores those leave idle); returns its
    launches."""
    written = {k: started["chains"][k].result() for k in ("dp2_straight", "model2")}
    check_runs(written)
    t0 = time.perf_counter()
    launches = phase_resume_layouts(started["root"])
    print(f"chip_smoke: 40 resume under another layout took {time.perf_counter() - t0:.1f} s")
    return launches


def check_cli_mesh(started: dict) -> None:
    """Phases 34, 38 and 39's checks, in order, once all their runs are
    done; then their root goes."""
    root = started["root"]
    try:
        chains = {k: f.result() for k, f in started["chains"].items()}
        check_runs(chains)
        if started["dp2"]:
            phase_cli_dp2(root, chains, started["evaluated"])
        phase_dryrun(started["dryrun"])
        phase_cli_axes(root, chains)
        print(f"CLI and dry-run phases {'34, ' if started['dp2'] else ''}38, 39, 40: "
              f"{time.perf_counter() - started['t0']:.1f} s from their start")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def finish_cli_mesh(started: dict) -> dict:
    """Phase 40, then phases 34, 38 and 39's checks; returns phase 40's
    launches."""
    try:
        launches = resume_when_written(started)
    except BaseException:
        shutil.rmtree(started["root"], ignore_errors=True)
        raise
    check_cli_mesh(started)
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if sys.argv[1:2] == ["--loss-timing"]:
        loss_timing(sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(__file__) or ".")
        return
    if sys.argv[1:2] == ["--loss-sweep"]:
        loss_sweep()
        return
    if sys.argv[1:2] == ["--gae-timing"]:
        gae_timing(sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(__file__) or ".")
        return
    if sys.argv[1:2] == ["--gae-sweep"]:
        gae_sweep()
        return
    if sys.argv[1:2] == ["--spans"]:
        span_profile(sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(__file__) or ".")
        return
    if sys.argv[1:2] == ["--dp"]:
        phase_card()
        phase_build()
        phase_dp_shared()
        phase_dp_nccl()
        phase_axes()
        finish_cli_mesh(start_cli_mesh())
        return
    if sys.argv[1:2] == ["--axes"]:
        phase_card()
        phase_build()
        phase_axes()
        finish_cli_mesh(start_cli_mesh(dp2=False))
        return
    if sys.argv[1:2] == ["--counted-cli"]:
        counted_cli(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--learn"]:
        rest = sys.argv[2:]
        out_dir = (rest.pop(0) if rest and not rest[0].startswith("--")
                   and rest[0] not in LEARN_TASKS else None)
        task = rest.pop(0) if rest and rest[0] in LEARN_TASKS else "cartpole-balance"
        learn(out_dir, task, rest)
        return
    from surreal_tpu_torch.device import resolve

    t_start = time.perf_counter()
    dev = resolve("cuda")

    def timed_phase(label, fn, *args):
        """fn(*args), its wall time printed (where the run's time goes)."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"chip_smoke: {label} took {time.perf_counter() - t0:.1f} s")
        return out

    smi = phase_card()
    phase_build()
    kernels = timed_phase("3 kernels", phase_kernels, dev)
    timed_phase("4 small parity", phase_small_parity, dev)
    trainer, launches = timed_phase("5 slice", phase_slice, dev)
    timed_phase("6 ddpg parity", phase_ddpg_parity, dev)
    ddpg_trainer, ddpg_launches, ddpg_times = timed_phase("7 ddpg", phase_ddpg, dev)
    lstm_trainer, lstm_launches, lstm_times = timed_phase("8 lstm", phase_lstm, dev)
    timed_phase("9 serving", phase_serving, dev, trainer)
    timed_phase("10 envs", phase_envs, dev)
    finger_trainer, finger_launches, finger_times = timed_phase("11 finger", phase_finger, dev)
    render_cases = timed_phase("13 render", phase_render, dev)
    pixel_trainer, pixel_launches, pixel_times = timed_phase("14 pixel ppo", phase_pixel_ppo,
                                                             dev)
    # its 2.1 GB ring is freed here
    pixel_ddpg_launches = timed_phase("15 pixel ddpg", phase_pixel_ddpg, dev)[1]
    bf16_launches = timed_phase("17 bf16", phase_bf16, dev)[1]
    timed_phase("18 bf16 parity", phase_bf16_parity, dev)
    gtrxl_launches = timed_phase("41 gtrxl", phase_gtrxl, dev)
    overlap_launches = timed_phase("19 overlap", phase_overlap, dev, trainer)
    found = phase_host_bridges()
    os.environ.setdefault("MUJOCO_GL", "egl")  # dm_control picks its GL platform when imported
    instance_launches = timed_phase("21 instance", phase_ppo_instance, dev)
    gym_launches = phase_ppo_gym(dev, found)
    phase_oracle(dev, found)
    phase_video_mujoco(dev, found, trainer)
    # Every timed in-process cell is behind us. The CLI and dry-run
    # subprocesses of 34, 38 and 39 start here and run beside the CLI
    # phases 16 and 12; once they are done, two rank pairs at a time run
    # 28-33 and 35-37 from threads, beside the rest of 12 and phase 40
    # (launch-bound processes, each on cores of its own). The profiles
    # 25-27 wait for all of them: a profile must have the card to itself.
    t_mesh = time.perf_counter()
    cli_mesh = start_cli_mesh()
    started = [*cli_mesh["chains"].values(), cli_mesh["dryrun"]]
    data_axis = run_after(started, lambda: (timed_phase("28-32 data axis", phase_dp_shared),
                                            timed_phase("33 nccl", phase_dp_nccl)))
    axes = run_after(started, lambda: timed_phase("35-37 zero, time, model", phase_axes))
    cli_pixel_launches, cli_pixel_eval = timed_phase("16 pixel cli", phase_cli_pixel, dev)
    cli_launches, cli_bf16_launches = timed_phase("12 cli", phase_cli, dev, ddpg_trainer)
    cli_pixel_eval()
    resume_launches = resume_when_written(cli_mesh)
    (dp_launches, nccl_launches), axes_launches = data_axis.result(), axes.result()
    check_cli_mesh(cli_mesh)
    print(f"chip_smoke: 34, 38, 39 cli and dry run, 40 resume took "
          f"{time.perf_counter() - t_mesh:.1f} s (beside 12, 16 and 28-37)")
    timed_phase("25 profile", breakdown, trainer)
    timed_phase("26 profiles", new_cells_profile, ddpg_trainer, ddpg_times, lstm_trainer,
                lstm_times)
    timed_phase("26 finger profile", finger_profile, finger_trainer, finger_times)
    timed_phase("27 pixel profile", pixel_profile, pixel_trainer, pixel_times, render_cases)
    for name, k in kernels.items():
        # every number is a reading: each path was driven with the counts at
        # 0 just before it and read just after its last update
        if name in ATTENTION_KERNELS:
            # GTrXL.segment alone launches them: phase 41 is the one path here
            by_path = {"ppo_gtrxl": gtrxl_launches[name]}
        else:
            by_path = {"ppo": launches[name], "ppo_lstm": lstm_launches[name],
                       "ddpg": ddpg_launches[name], "ppo_finger": finger_launches[name],
                       "cli_ppo_cartpole": cli_launches[name],
                       "ppo_pixel_cheetah": pixel_launches[name],
                       "ddpg_pixel_ball_in_cup": pixel_ddpg_launches[name],
                       "cli_ppo_pixel_cheetah": cli_pixel_launches[name],
                       "ppo_bf16": bf16_launches[name], "ppo_overlap": overlap_launches[name],
                       "ppo_gtrxl": gtrxl_launches[name],
                       "cli_ppo_cartpole_bf16_overlap": cli_bf16_launches[name],
                       "ppo_instance": instance_launches[name],
                       # None: gymnasium is missing, so the path was not driven
                       "ppo_gym": None if gym_launches is None else gym_launches[name],
                       # the data axis, per rank (each rank counts in its own process)
                       **{path: n[name] for path, n in dp_launches.items()},
                       "ppo_dp1_nccl_cheetah": nccl_launches[name],
                       # None: the CLI's ranks are its own processes, whose counts
                       # this script does not read (phase 34 checks the run itself)
                       "cli_ppo_cartpole_dp2": None,
                       # the model and time axes and ZeRO, per rank (35-37); the dry
                       # run's and the CLI's ranks are processes of their own (38, 39)
                       **{path: n[name] for path, n in axes_launches.items()},
                       "dryrun_multichip_2": None, "cli_ppo_cartpole_axes": None,
                       # a checkpoint resumed under another layout (40): in this
                       # process, and summed over its 2 ranks
                       **{path: n[name] for path, n in resume_launches.items()}}
        k["launches"] = sum(v for v in by_path.values() if v is not None)
        k["launches_by_path"] = by_path
        for extra in ("tol", "bytes", "call_ms", "plain_call_ms"):
            k.pop(extra)
    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
