"""Drives the PyTorch port on one CUDA card and checks it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --loss-timing [ROOT]
    python3 chip_smoke.py --loss-sweep
    python3 chip_smoke.py --gae-timing [ROOT]
    python3 chip_smoke.py --gae-sweep

Phases, each of which exits non-zero on failure:
  1. prints the card (nvidia-smi name, power limit) and the torch version;
  2. builds the CUDA C++ kernels from surreal_tpu_torch/ops/csrc with nvcc
     and prints ptxas's registers, shared memory and spills for each;
  3. runs each kernel at the main path's shapes against its plain PyTorch
     version on the card, and times both with CUDA events, and again at the
     finger-spin path's shapes (GAE at (T, B) = (128, 128), the loss at
     N = 4096 rows with A = 2); checks and times GAE at the recipes' other
     two (T, B) too; times the fused loss's forward and backward as
     autograd runs them;
  4. checks the slice on a small input: one PPO update on the card (kernels)
     against the same update on the CPU (plain versions), and one batched
     cheetah env step on the card against the CPU;
  5. runs the main path, PPO on cheetah-run at bench.py's configuration
     (256 envs, (256, 256) MLP, horizon 128, 4 epochs x 8 minibatches,
     fused loss), for 1 warm-up and 3 timed iterations, and checks from the
     launch counters that every iteration launched the GAE kernel once and
     the loss forward and backward kernels 32 times each;
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
     before its first iteration, that every iteration launched the GAE
     kernel exactly once and the loss kernels never, and that the carry is
     in use;
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
     iteration, that every iteration launched the GAE kernel once and each
     loss kernel 16 times;
 12. the profiler checks of the PPO slice: times one more iteration split
     into rollout and update, profiles another for the device's idle share,
     and profiles one minibatch step of the update for its loss kernels (2:
     one forward, one backward), a forward and a backward of
     fused_clip_loss and one call of returns.gae (one device kernel each).
     torch.profiler stays attached to the process once used and slows every
     later launch, so it comes last and nothing is timed after it;
 13. profiles the DDPG cell (one rollout, one update block), the recurrent
     PPO cell (a rollout of 16 steps, one epoch of 8 minibatch steps) and
     the finger-spin cell (a rollout of 4 steps, one epoch of 4 minibatch
     steps) for their device kernels and device busy time, held against the
     unprofiled times of the same parts from phases 7, 8 and 11.
Phases 6 to 9, 11 and 13 print one JSON object each (three in phase 13),
phase 10 one per task. The line before the card's is a JSON object with
one entry per kernel; the last line is {"ok": true, "device": {...}}.

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
outputs (the launch plus one memory round trip).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
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
TOL_LOSS_FWD = 1e-5  # the loss and 5 means of O(1) terms; 4096-term sums in another order
TOL_LOSS_BWD = 1e-6  # per-row gradients of size ~1e-4 (they carry 1/N), and their row sum
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
    for source in ("gae.cu", "ppo_loss.cu"):
        for line in build.build_log(source).splitlines():
            if "ptxas" in line:
                print(f"build {source}: {line.strip()}")


def device_kernels(fn) -> list[str]:
    """Names of the device kernels that one call of `fn` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


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
    """`returns.gae` held against `returns.gae_plain` and timed at `shapes`."""
    rng = np.random.default_rng(1)
    for T, B in shapes:
        args = gae_batch(rng, T, B, dev)
        err = gae_error(returns.gae, returns.gae_plain, args)
        ms, call_ms = timed(lambda: returns.gae(*args), 200)
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


def loss_cases(plk, rng, N, A, dev) -> tuple[dict, dict, tuple]:
    """The fused loss's forward and backward kernels at N rows and A action
    dims (log_std (A,) shared by all rows, log_std_old (N, A), a cotangent
    of 1), each held against its plain version and timed; and the batch."""
    batch = loss_batch(rng, N, A, dev)
    coefs = (0.2, 0.5, 0.0)
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


def phase_kernels(dev):
    """Each kernel at the cheetah path's shapes (the kernels line's entry)
    and at the finger-spin path's: GAE at (T, B) = (128, 256) and (128,
    128), the loss at N = 4096 rows with A = 6 and A = 2."""
    from surreal_tpu_torch.ops import gae_kernel, ppo_loss_kernel as plk, returns

    rng = np.random.default_rng(0)
    out = {"gae": gae_case(gae_kernel, returns, rng, *GAE_SHAPES[0], dev)}
    fwd, bwd, (batch, coefs) = loss_cases(plk, rng, 4096, 6, dev)
    out.update(ppo_loss_fwd=fwd, ppo_loss_bwd=bwd)
    finger = {"gae": gae_case(gae_kernel, returns, rng, *FINGER_GAE, dev)}
    f_fwd, f_bwd, _ = loss_cases(plk, rng, 4096, FINGER_ACTIONS, dev)
    finger.update(ppo_loss_fwd=f_fwd, ppo_loss_bwd=f_bwd)
    for name, k in out.items():
        print_kernel(k)
        print_kernel(finger[name])
        k["at_finger_spin_shape"] = {f: finger[name][f] for f in SLIM}
    gae_at_shapes("this checkout", returns, dev, GAE_SHAPES[1:])
    print_autograd_times("this checkout", loss_autograd_times(plk, batch, coefs))
    return out


def phase_small_parity(dev):
    """The card's update (GAE and loss kernels) against the CPU's (plain
    versions) on one small trajectory, and one env step on both devices."""
    from surreal_tpu_torch.algos import ppo
    from surreal_tpu_torch.envs import flatten_obs, make_env
    from surreal_tpu_torch.envs.physics import engine
    from surreal_tpu_torch.models.actor_critic import PPOActorCritic
    from surreal_tpu_torch.ops import gae_kernel, ppo_loss_kernel as plk

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
    after = (gae_kernel.GAE.launches, plk.FWD.launches, plk.BWD.launches)
    if [a - b for a, b in zip(after, before)] != [1, 4, 4]:
        fail(f"small update did not run through the kernels: {before} -> {after}")
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


def phase_slice(dev):
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.train import PPOTrainer

    kernels = path_kernels()
    cfg = PPOConfig(horizon=128, epochs=4, num_minibatches=8, lr=3e-4, fused_loss=True)
    trainer = PPOTrainer("cheetah-run", cfg, num_envs=256, hidden=(256, 256), seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    warm_iters, timed_iters = 1, 3
    t0 = time.perf_counter()
    trainer.run(warm_iters, log_every=warm_iters)  # raises on non-finite metrics
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logs = trainer.run(timed_iters, log_every=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    iters = warm_iters + timed_iters
    want = {"gae": iters, "ppo_loss_fwd": 32 * iters, "ppo_loss_bwd": 32 * iters}
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


def breakdown(trainer):
    """Two more iterations: one split into rollout and update on the host
    clock, then one under torch.profiler for the device's busy time and
    kernel count (the profiler slows the host, so the idle share is taken
    against the unprofiled iteration's wall time); and the loss's device
    kernels, for one call each way and in one minibatch step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from surreal_tpu_torch.algos import ppo

    t = trainer

    def iteration():
        traj, t.env_state, t.obs, t.ep_ret, _ = ppo.rollout(
            t.cfg, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret, t.generator)
        torch.cuda.synchronize()
        mid = time.perf_counter()
        ppo.update(t.cfg, t.state, traj, t.generator)
        torch.cuda.synchronize()
        return mid, traj

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t1, traj = iteration()
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
        t.cfg.lam))
    print(f"returns.gae on the main path's trajectory runs {gae_names}")
    if len(gae_names) != 1 or "gae_kernel" not in gae_names[0]:
        fail("one call of returns.gae is not one device kernel")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iteration()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    wall_s = t2 - t0
    print(f"breakdown: rollout {t1 - t0:.3f} s ({(t1 - t0) / t.cfg.horizon * 1e3:.2f} ms per "
          f"env step), update {t2 - t1:.3f} s; profiled iteration: {len(kernels)} device "
          f"kernels, device busy {busy_s:.3f} s = {100 * busy_s / wall_s:.1f}% of the "
          f"unprofiled {wall_s:.3f} s (idle {100 * (1 - busy_s / wall_s):.1f}%)")

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


def profiled(fn) -> tuple[int, float]:
    """(device kernels, their summed device seconds) of one call of `fn`
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(spans), sum(spans) * 1e-6


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
    if gae_kernel.GAE.launches != warm_iters:
        fail(f"the recurrent warm-up launched GAE {gae_kernel.GAE.launches} times, not 1")
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
    if launches["gae"] != iters:
        fail(f"{iters} recurrent iterations launched the GAE kernel {launches['gae']} times")
    if launches["ppo_loss_fwd"] or launches["ppo_loss_bwd"]:
        fail("the recurrent path launched the fused loss, which the reference does not use there")
    if not carry_abs > 0:
        fail("the LSTM carry is zero after the rollouts")
    if t.state.update_step != iters or t.state.opt_state.count != 32 * iters:
        fail(f"update_step {t.state.update_step}, Adam count {t.state.opt_state.count}")
    return t, launches, out


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
    want = {"gae": iters, "ppo_loss_fwd": steps * iters, "ppo_loss_bwd": steps * iters}
    if launches != want:
        fail(f"finger-spin PPO launch counts {launches} != {want}")
    if t.state.update_step != iters:
        fail(f"update_step {t.state.update_step} != {iters}")
    return t, launches, out


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
    from surreal_tpu_torch.device import resolve

    dev = resolve("cuda")
    smi = phase_card()
    phase_build()
    kernels = phase_kernels(dev)
    phase_small_parity(dev)
    trainer, launches = phase_slice(dev)
    phase_ddpg_parity(dev)
    ddpg_trainer, ddpg_launches, ddpg_times = phase_ddpg(dev)
    lstm_trainer, lstm_launches, lstm_times = phase_lstm(dev)
    phase_serving(dev, trainer)
    phase_envs(dev)
    finger_trainer, finger_launches, finger_times = phase_finger(dev)
    breakdown(trainer)
    new_cells_profile(ddpg_trainer, ddpg_times, lstm_trainer, lstm_times)
    finger_profile(finger_trainer, finger_times)
    for name, k in kernels.items():
        # every number is a reading: each path was driven with the counts at
        # 0 just before it and read just after its last update
        by_path = {"ppo": launches[name], "ppo_lstm": lstm_launches[name],
                   "ddpg": ddpg_launches[name], "ppo_finger": finger_launches[name]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        for extra in ("tol", "bytes", "call_ms", "plain_call_ms"):
            k.pop(extra)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
