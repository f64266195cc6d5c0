"""The GTrXL PPO driver: builds `surreal_tpu_torch.train.PPOTrainer` with
the GTrXL torso for a configuration and a cell's traffic, hands it the
benchmark's weights and start states (each env at its own step of its
episode, the memory empty), drives its first iteration through its own
`run` with the outputs captured (also the warm-up), runs the measured
window, in a traced run times the layers and profiles the device, then
captures one more iteration from where the window left the trainer. With
the window closed, the peak read and the trainer freed, the reference
(`reference/gtrxl_judge.py`) judges both captured iterations.

A program without the GTrXL torso fails here at once, before any build."""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from .. import harness, launched, profile
from ..reference import gtrxl as ref_gtrxl
from .ppo import LOG_NEVER, load_task, sync

PROFILED_STEPS = 16  # rollout steps under the profiler, of the horizon's 128
TORSO_KEYS = ("layers", "width", "heads", "memory", "mlp_width")


def net_spec(config: dict, task) -> dict:
    g = config["gtrxl"]
    return {"obs_dim": task.obs_dim, "action_dim": task.action_dim,
            **{k: g[k] for k in TORSO_KEYS}}


def inputs(config: dict, traffic: dict, spec: dict, task, seed: int, device):
    """The benchmark's inputs, from the seed: the weights, the start states
    (start-pool rows, each env at a step of its episode drawn uniformly over
    it) and the updates' permutations of the envs."""
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = ref_gtrxl.make_weights(spec, gen, device)
    B = traffic["num_envs"]
    rows = torch.randint(0, task.pool_q.shape[0], (B,), generator=gen, device=device)
    start_t = torch.randint(0, task.episode_steps, (B,), generator=gen, device=device,
                            dtype=torch.int32)
    perms = torch.stack([torch.randperm(B, generator=gen, device=device)
                         for _ in range(config["ppo"]["epochs"])])
    return weights, rows, start_t, perms


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> tuple[dict, dict]:
    from surreal_tpu_torch.algos import ppo_gtrxl  # noqa: F401  (fails at once without it)

    from ..reference import gtrxl_judge

    task = load_task(config, device)
    if device.type == "cuda":
        from surreal_tpu_torch.ops import build
        build.build_all()
    drv = Driver(config, cell["traffic"], seed, device, task)
    first = drv.captured_iteration()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ctx = {"net": drv.spec, "cfg": drv.cfg, "num_envs": cell["traffic"]["num_envs"],
           "trace": trace}
    ctx["window"] = harness.timed_window(drv.iterate, seconds, lambda: sync(device),
                                         drv.samples_per_iteration)
    ctx["setup_s"] = ctx["window"]["opened"] - t_start
    if trace:
        ctx["timers"] = drv.timed_layers()
        ctx["profile"] = p = drv.profile()
        ctx["busy_s"] = sum(profile.busy_seconds(p[k]["device"]) for k in ("rollout", "update"))
        ctx["window_s"] = sum(p[k]["wall_s"] for k in ("rollout", "update"))
        dev = p["rollout"]["device"] + p["update"]["device"]
        host = p["rollout"]["host"] + p["update"]["host"]
        ctx["breakdown"] = {"device_ops": profile.top_ops(dev),
                            "idle_gaps": profile.idle_gaps(dev, host)}
    if device.type == "cuda":
        ctx["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    after = drv.captured_iteration()
    drv.close()
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = gtrxl_judge.judge_all([first, after], ctx["net"], ctx["cfg"], task, device)
    return ctx, numbers


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, task):
        from surreal_tpu_torch.algos.ppo import PPOConfig
        from surreal_tpu_torch.train import PPOTrainer

        cfg = config["ppo"]
        if traffic.get("ranks", 1) != 1:
            raise NotImplementedError("the GTrXL trainer runs on one device")
        if cfg.get("objective", "clip") != "clip" or cfg.get("publish_every", 1) != 1:
            raise ValueError("the reference follows the 'clip' objective without staleness")
        self.device = device
        self.spec = net_spec(config, task)
        self.cfg = dict(cfg)
        B = traffic["num_envs"]
        self.trainer = PPOTrainer(
            config["env_name"], PPOConfig(**cfg), num_envs=B, seed=seed, device=device,
            compute_dtype=config["compute_dtype"], torso="gtrxl",
            gtrxl={k: self.spec[k] for k in TORSO_KEYS})
        self.weights, self.start_rows, self.start_t, self.perms = inputs(
            config, traffic, self.spec, task, seed, device)
        self.iterations = 0
        t = self.trainer
        t.state.net.load_state_dict(self.weights)
        state, ts = t.env.reset(B, reset_draw={config["reset_draw_key"]: self.start_rows})
        t.env_state = dataclasses.replace(state, t=self.start_t.to(state.t.dtype))
        t.obs = t._flatten(ts.obs)

    @property
    def samples_per_iteration(self) -> int:
        return self.trainer.steps_per_iteration

    def iterate(self) -> None:
        self.trainer.run(1, log_every=LOG_NEVER)
        self.iterations += 1

    def captured_iteration(self) -> dict:
        """One iteration through the trainer's own `run`, recorded as
        `drivers/ppo.py` records it, with the trajectory's memory and the
        carry the rollout hands on."""
        from surreal_tpu_torch.algos import ppo_gtrxl

        first = self.iterations == 0
        t = self.trainer
        env = t.env
        rec: dict[str, list] = {}
        cap: dict = {}
        orig_step, orig_rollout = env.step, ppo_gtrxl.rollout
        orig_update, orig_apply = ppo_gtrxl.update, ppo_gtrxl.apply_gradients
        clone = lambda d: {n: v.detach().clone() for n, v in d.items()}
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}

        def zf(state):
            z = state.zfilter
            return tuple(x.detach().clone() for x in (z.count, z.mean, z.m2))

        st = t.state
        learner = {"params": clone(dict(st.net.named_parameters())),
                   "mu": clone(st.opt_state.mu), "nu": clone(st.opt_state.nu),
                   "count": int(st.opt_state.count), "zf": zf(st),
                   "lr_scale": float(st.lr_scale)}

        def step(state, action, generator=None, reset_draw=None):
            new_state, ts = orig_step(state, action, generator, reset_draw)
            row = {"q_in": state.q, "qd_in": state.qd, "t_in": state.t, "action": action,
                   "q_out": new_state.q, "qd_out": new_state.qd, "t_out": new_state.t,
                   "obs": t._flatten(ts.obs), "carry": t._flatten(ts.carry_obs),
                   "reward": ts.reward, "done": ts.done}
            for k, v in row.items():
                rec.setdefault(k, []).append(v.cpu())
            return new_state, ts

        def rollout(*args, **kw):
            out = orig_rollout(*args, **kw)
            c = out[3]
            cap["carry_after"] = {"memory": c.memory.to("cpu", copy=True),
                                  "valid": c.valid.to("cpu", copy=True), "t": c.t}
            return out

        def update(cfg, state, traj, generator, perms=None):
            cap["traj"] = {f.name: getattr(traj, f.name) for f in dataclasses.fields(traj)}
            cap["zf_before"] = zf(state)
            out = orig_update(cfg, state, traj, generator, self.perms)
            cap["zf_after"] = zf(state)
            return out

        losses, lrs = [], []

        def apply_gradients(cfg, state, loss, lr, axis=None):
            out = orig_apply(cfg, state, loss, lr, axis)
            losses.append(loss.detach())
            lrs.append(lr)
            if len(losses) == 1:
                cap["mu1"] = clone(state.opt_state.mu)
                cap["count1"] = int(state.opt_state.count)
                cap["params1"] = clone(dict(state.net.named_parameters()))
            if len(losses) == 3:
                cap["params3"] = clone(dict(state.net.named_parameters()))
            return out

        env.step = step
        ppo_gtrxl.rollout, ppo_gtrxl.update = rollout, update
        ppo_gtrxl.apply_gradients = apply_gradients
        try:
            self.iterate()
        finally:
            del env.step
            ppo_gtrxl.rollout, ppo_gtrxl.update = orig_rollout, orig_update
            ppo_gtrxl.apply_gradients = orig_apply
        traj = cap.pop("traj")
        t0 = traj.pop("t0")
        out = {"learner": {**{k: cpu(learner[k]) for k in ("params", "mu", "nu")},
                           "count": learner["count"], "lr_scale": learner["lr_scale"],
                           "zf": tuple(x.cpu() for x in learner["zf"])},
               "records": {k: torch.stack(v) for k, v in rec.items()},
               "traj": cpu(traj), "t0": t0, "perms": self.perms.cpu(),
               "carry_after": cap["carry_after"],
               "losses": [float(x) for x in losses[:3]],
               "lrs": [float(x) for x in lrs[:3]], "mu1": cpu(cap["mu1"]),
               "count1": cap["count1"], "params1": cpu(cap["params1"]),
               "params3": cpu(cap["params3"]),
               "zf_before": tuple(x.cpu() for x in cap["zf_before"]),
               "zf_after": tuple(x.cpu() for x in cap["zf_after"])}
        if first:
            out["start"] = {"weights": cpu(self.weights), "rows": self.start_rows.cpu(),
                            "t": self.start_t.cpu()}
        return out

    # ---- a traced run ----
    def timed_layers(self) -> dict:
        """One iteration with synchronised timers around the rollout, the
        update and the env's step."""
        from surreal_tpu_torch.algos import ppo_gtrxl

        t, dev = self.trainer, self.device
        secs: dict[str, float] = {}
        calls: dict[str, int] = {}
        kept: dict = {}

        def timed(fn, key):
            def wrapper(*args, **kwargs):
                sync(dev)
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sync(dev)
                secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
                calls[key] = calls.get(key, 0) + 1
                return out
            return wrapper

        orig_rollout, orig_update = ppo_gtrxl.rollout, ppo_gtrxl.update

        def update(cfg, state, traj, *rest, **kw):
            kept["traj"] = traj
            return orig_update(cfg, state, traj, *rest, **kw)

        t.env.step = timed(t.env.step, "env_step")
        ppo_gtrxl.rollout = timed(orig_rollout, "rollout")
        ppo_gtrxl.update = timed(update, "update")
        try:
            self.iterate()
        finally:
            ppo_gtrxl.rollout, ppo_gtrxl.update = orig_rollout, orig_update
            del t.env.step
        self._traj = kept["traj"]
        c = self.cfg
        return {"seconds": secs, "calls": calls, "horizon": c["horizon"],
                "minibatch_steps": c["epochs"] * c["num_minibatches"] * calls["update"]}

    def profile(self) -> dict:
        """Device events, with their correlation ids, of PROFILED_STEPS
        rollout steps (after the rollout's prefill, which is profiled on its
        own) and of one whole update of the timed iteration's trajectory."""
        from surreal_tpu_torch.algos import ppo_gtrxl

        t, dev = self.trainer, self.device
        short = dataclasses.replace(t.cfg, horizon=PROFILED_STEPS)

        def rollout():
            (_, t.env_state, t.obs, t.carry, t.ep_ret, _) = ppo_gtrxl.rollout(
                short, t.env, t._flatten, t.state, t.env_state, t.obs, t.carry, t.ep_ret,
                t.generator)

        out = {"steps": PROFILED_STEPS, "horizon": t.cfg.horizon, "num_envs": t.num_envs,
               "minibatches": t.cfg.epochs * t.cfg.num_minibatches}
        for name, fn in (("rollout", rollout),
                         ("update", lambda: ppo_gtrxl.update(t.cfg, t.state, self._traj,
                                                             t.generator))):
            sync(dev)
            t0 = time.perf_counter()
            dev_events, host_events = launched.device_events(fn, lambda: sync(dev))
            out[name] = {"device": [e[:3] for e in dev_events],
                         "host": [e[:3] for e in host_events],
                         "device_corr": dev_events, "host_corr": host_events,
                         "wall_s": time.perf_counter() - t0}
        return out

    def close(self) -> None:
        self.trainer = None
        self._traj = None
