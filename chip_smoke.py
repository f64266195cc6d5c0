"""Drives the PyTorch port on one CUDA card and checks it end to end.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. prints the card (nvidia-smi name, power limit) and the torch version;
  2. builds the CUDA C++ kernels from surreal_tpu_torch/ops/csrc with nvcc;
  3. runs each kernel at the main path's shapes against its plain PyTorch
     version on the card, and times both with CUDA events;
  4. checks the slice on a small input: one PPO update on the card (kernels)
     against the same update on the CPU (plain versions), and one batched
     cheetah env step on the card against the CPU;
  5. runs the main path, PPO on cheetah-run at bench.py's configuration
     (256 envs, (256, 256) MLP, horizon 128, 4 epochs x 8 minibatches,
     fused loss), for 1 warm-up and 3 timed iterations, and checks from the
     launch counters that every iteration launched the GAE kernel once and
     the loss forward and backward kernels 32 times each; then times one
     more iteration split into rollout and update, and profiles another for
     the device's idle share.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# Float32 operations each kernel does, counted from its source (a
# transcendental, a compare or a select counts as one): GAE per element,
# the loss forward and backward per row at A action dims.
GAE_OPS_PER_ELEM = 9
LOSS_FWD_OPS_PER_ROW = (23, 28)  # 23·A + 28
LOSS_BWD_OPS_PER_ROW = (17, 29)  # 17·A + 29
TOL_GAE = 1e-4  # fp contraction and the γλ product round differently; 128-step scan
TOL_LOSS_FWD = 1e-5  # 5 means of O(1) terms; 4096-term sums in another order
TOL_LOSS_BWD = 1e-6  # per-row gradients of size ~1e-4 (they carry 1/N)
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


def phase_kernels(dev):
    from surreal_tpu_torch.ops import gae_kernel, ppo_loss_kernel as plk, returns

    rng = np.random.default_rng(0)
    out = {}
    # --- GAE at the main path's (T, B) = (128, 256) ---
    T, B = 128, 256
    g = lambda: torch.tensor(rng.standard_normal((T, B)), dtype=torch.float32, device=dev)  # noqa: E731
    r, v, nv = g(), g(), g()
    disc = torch.tensor(rng.random((T, B)) > 0.02, dtype=torch.float32, device=dev)
    done = torch.tensor(rng.random((T, B)) < 0.05, dtype=torch.bool, device=dev)  # as traj.done
    args = (r, v, nv, disc, done, 0.99, 0.95)
    k_adv, k_vt = gae_kernel.gae_cuda(*args)
    p_adv, p_vt = returns.gae_plain(*args)
    torch.cuda.synchronize()
    err = max((k_adv - p_adv).abs().max().item(), (k_vt - p_vt).abs().max().item())
    ms, call_ms = timed(lambda: gae_kernel.gae_cuda(*args), 200)
    plain_ms, plain_call_ms = timed(lambda: returns.gae_plain(*args), 10)
    moved = nbytes(r, v, nv, disc, done) + nbytes(k_adv, k_vt)
    bound_ms, bound_by = bound(moved, GAE_OPS_PER_ELEM * T * B)
    out["gae"] = dict(name="gae", route="cuda", source="surreal_tpu_torch/ops/csrc/gae.cu",
                      replaces="surreal_tpu/ops/pallas_gae.py:72", max_abs_err=err,
                      tol=TOL_GAE, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None, bytes=moved, call_ms=call_ms,
                      plain_call_ms=plain_call_ms)

    # --- fused loss at the main path's minibatch N = 4096, A = 6 ---
    N, A = 4096, 6
    batch = loss_batch(rng, N, A, dev)
    coefs = (0.2, 0.5, 0.0)
    k_means = plk.loss_fwd(*batch, coefs[0])
    p_means = plk.loss_fwd_plain(*batch, coefs[0])
    k_grads = plk.loss_bwd(*batch, *coefs)
    p_grads = plk.loss_bwd_plain(*batch, *coefs)
    torch.cuda.synchronize()
    fwd_err = (k_means - p_means).abs().max().item()
    bwd_err = max((a - b).abs().max().item() for a, b in zip(k_grads, p_grads))
    # the forward reads every input; the backward all but mean_old and
    # log_std_old (batch[5], batch[6])
    fwd_moved = nbytes(*batch) + nbytes(k_means)
    bwd_moved = nbytes(*batch[:5], *batch[7:]) + nbytes(*k_grads)
    for name, line, err, tol, moved, ops, kernel, plain in (
            ("ppo_loss_fwd", 134, fwd_err, TOL_LOSS_FWD, fwd_moved, LOSS_FWD_OPS_PER_ROW,
             lambda: plk.loss_fwd(*batch, coefs[0]), lambda: plk.loss_fwd_plain(*batch, coefs[0])),
            ("ppo_loss_bwd", 178, bwd_err, TOL_LOSS_BWD, bwd_moved, LOSS_BWD_OPS_PER_ROW,
             lambda: plk.loss_bwd(*batch, *coefs), lambda: plk.loss_bwd_plain(*batch, *coefs))):
        ms, call_ms = timed(kernel, 200)
        plain_ms, plain_call_ms = timed(plain, 50)
        bound_ms, bound_by = bound(moved, N * (ops[0] * A + ops[1]))
        out[name] = dict(
            name=name, route="cuda", source="surreal_tpu_torch/ops/csrc/ppo_loss.cu",
            replaces=f"surreal_tpu/ops/pallas_ppo_loss.py:{line}", max_abs_err=err, tol=tol,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bytes=moved, call_ms=call_ms, plain_call_ms=plain_call_ms)
    for k in out.values():
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3e} (tol {k['tol']:.0e}); "
              f"device time: kernel {k['ms'] * 1e3:.2f} us, plain {k['plain_ms'] * 1e3:.2f} us; "
              f"call time: kernel {k['call_ms'] * 1e3:.2f} us, "
              f"plain {k['plain_call_ms'] * 1e3:.2f} us; bound {k['bound_ms'] * 1e3:.3f} us "
              f"by {k['bound_by']} ({k['bytes']} bytes at 3.35 TB/s)")
        if not k["max_abs_err"] <= k["tol"]:
            fail(f"kernel {k['name']} disagrees with its plain version: "
                 f"{k['max_abs_err']} > {k['tol']}")
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
    rows = torch.randint(0, env.num_reset_rows, (256,), generator=gen)
    action = torch.rand(256, 6, generator=gen) * 2 - 1
    outs = []
    for e, d in ((env, "cpu"), (env_gpu, dev)):
        s, _ = e.reset(256, reset_rows=rows.to(d))
        depth = engine._contact_kinematics(e.model, s.q)[1].cpu()
        s2, ts2 = e.step(s, action.to(d), reset_rows=rows.to(d))
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


def phase_slice(dev):
    from surreal_tpu_torch.algos.ppo import PPOConfig
    from surreal_tpu_torch.ops import gae_kernel, ppo_loss_kernel as plk
    from surreal_tpu_torch.train import PPOTrainer

    kernels = {"gae": gae_kernel.GAE, "ppo_loss_fwd": plk.FWD, "ppo_loss_bwd": plk.BWD}
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
    breakdown(trainer)
    return launches


def breakdown(trainer):
    """Two more iterations: one split into rollout and update on the host
    clock, then one under torch.profiler for the device's busy time and
    kernel count (the profiler slows the host, so the idle share is taken
    against the unprofiled iteration's wall time)."""
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
        return mid

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t1 = iteration()
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iteration()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    wall_s = t2 - t0
    print(f"breakdown: rollout {t1 - t0:.3f} s ({(t1 - t0) / t.cfg.horizon * 1e3:.2f} ms per "
          f"env step), update {t2 - t1:.3f} s; profiled iteration: {len(kernels)} device "
          f"kernels, device busy {busy_s:.3f} s = {100 * busy_s / wall_s:.1f}% of the "
          f"unprofiled {wall_s:.3f} s (idle {100 * (1 - busy_s / wall_s):.1f}%)")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from surreal_tpu_torch.device import resolve

    dev = resolve("cuda")
    smi = phase_card()
    phase_build()
    kernels = phase_kernels(dev)
    phase_small_parity(dev)
    launches = phase_slice(dev)
    for name, k in kernels.items():
        k["launches"] = launches[name]
        for extra in ("tol", "bytes", "call_ms", "plain_call_ms"):
            k.pop(extra)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
