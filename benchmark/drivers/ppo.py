"""The PPO driver: builds `surreal_tpu_torch.train.PPOTrainer` for a
configuration and a cell's traffic, hands it the benchmark's weights and
start states, drives its first iteration through its own `run` with the
outputs captured (it is also the warm-up), runs the measured window of
whole iterations, in a traced run times the layers and profiles the device,
then captures one more iteration from wherever the window left the trainer.
With the window closed, the peak read and the trainer freed, the reference
(`reference/judge.py`) judges both captured iterations."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import torch

from .. import harness, profile

PROFILED_STEPS = 16  # rollout steps under the profiler, of the horizon's 128
TIMED_ITERATIONS = 1  # iterations timed layer by layer in a traced run
LOG_NEVER = 1 << 62  # `run`'s log interval: the window reads no metric


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def net_spec(config: dict, task) -> dict:
    """The network's shapes, for the reference and the operation counts."""
    return {"obs_dim": task.obs_dim, "action_dim": task.action_dim,
            "hidden": list(config["hidden"])}


def reference_cfg(config: dict) -> dict:
    """The PPO settings the reference follows."""
    return dict(config["ppo"])


def load_task(config: dict, device: torch.device):
    module = importlib.import_module(f"benchmark.reference.tasks.{config['task']}")
    return module.Task(str(harness.ASSETS), device)


def inputs(config: dict, traffic: dict, spec: dict, task, seed: int, device):
    """The benchmark's inputs, from the seed: the weights, the start states
    (start-pool rows, `steps_to_episode_end` steps before their episodes
    end) and the updates' minibatch permutations."""
    from ..reference import ppo as ref_ppo

    gen = torch.Generator(device=device).manual_seed(seed)
    weights = ref_ppo.make_weights(spec, gen, device)
    num_envs = traffic["num_envs"]
    rows = torch.randint(0, task.pool_q.shape[0], (num_envs,), generator=gen, device=device)
    start_t = task.episode_steps - traffic["steps_to_episode_end"]
    n = config["ppo"]["horizon"] * num_envs
    perms = torch.stack([torch.randperm(n, generator=gen, device=device)
                         for _ in range(config["ppo"]["epochs"])])
    return weights, rows, start_t, perms


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> tuple[dict, dict]:
    """One run of a cell (see harness.py): set-up, the window, the trace,
    then the reference's judgement of the captured iterations."""
    from ..reference import judge

    task = load_task(config, device)
    if device.type == "cuda":
        from surreal_tpu_torch.ops import build
        build.build_all()
    drv = Driver(config, cell["traffic"], seed, device, task)
    first = drv.captured_iteration()  # also the warm-up: every shape the window runs
    sync(device)
    if device.type == "cuda":  # the peak of the program's own run, not of the capture
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
    after = drv.captured_iteration()  # follows the window's updates (and the trace's)
    drv.close()
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge.judge_all([first, after], ctx["net"], ctx["cfg"], task, device)
    return ctx, numbers


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, task):
        from surreal_tpu_torch.algos.ppo import PPOConfig
        from surreal_tpu_torch.train import PPOTrainer

        cfg = config["ppo"]
        if config["activation"] != "tanh":
            raise ValueError("the trainer's torsos are tanh MLPs")
        if traffic.get("ranks", 1) != 1:
            raise NotImplementedError("this driver runs one process on one card; a cell over "
                                      "ranks names a driver of its own in its traffic")
        if cfg.get("objective", "clip") != "clip" or cfg.get("publish_every", 1) != 1:
            raise ValueError("the reference follows the 'clip' objective without staleness")
        self.device = device
        self.spec = net_spec(config, task)
        self.cfg = reference_cfg(config)
        num_envs = traffic["num_envs"]
        self.trainer = PPOTrainer(
            config["env_name"], PPOConfig(**cfg), num_envs=num_envs, seed=seed,
            hidden=tuple(config["hidden"]), device=device,
            compute_dtype=config["compute_dtype"])
        self.weights, self.start_rows, self.start_t, self.perms = inputs(
            config, traffic, self.spec, task, seed, device)
        self.iterations = 0
        t = self.trainer
        t.state.net.load_state_dict(self.weights)
        state, ts = t.env.reset(num_envs, reset_draw={config["reset_draw_key"]: self.start_rows})
        t.env_state = dataclasses.replace(state, t=torch.full_like(state.t, self.start_t))
        t.obs = t._flatten(ts.obs)

    @property
    def samples_per_iteration(self) -> int:
        return self.trainer.steps_per_iteration

    def iterate(self) -> None:
        self.trainer.run(1, log_every=LOG_NEVER)
        self.iterations += 1

    # ---- an iteration, captured for the reference ----
    def captured_iteration(self) -> dict:
        """One iteration through the trainer's own `run`, with its env steps,
        its update's trajectory, its first three optimizer steps (losses,
        LRs, Adam's first moment and the parameters after the first, the
        parameters after the third) and the
        learner's state at its start recorded. The first captured iteration
        also carries the benchmark's start (weights, start rows), which the
        reference starts from; a later one the learner's state, which the
        reference follows."""
        from surreal_tpu_torch.algos import ppo

        first = self.iterations == 0
        t = self.trainer
        env = t.env
        rec: dict[str, list] = {}
        cap: dict = {}
        orig_step, orig_update, orig_apply = env.step, ppo.update, ppo.apply_gradients
        clone = lambda d: {n: v.detach().clone() for n, v in d.items()}

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
                rec.setdefault(k, []).append(v)
            return new_state, ts

        def update(cfg, state, traj, generator, perms=None, axis=None):
            cap["traj"] = {f.name: getattr(traj, f.name) for f in dataclasses.fields(traj)}
            cap["zf_before"] = zf(state)
            out = orig_update(cfg, state, traj, generator, self.perms, axis)
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
        ppo.update, ppo.apply_gradients = update, apply_gradients
        try:
            self.iterate()
        finally:
            del env.step
            ppo.update, ppo.apply_gradients = orig_update, orig_apply
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
        out = {"learner": {**{k: cpu(learner[k]) for k in ("params", "mu", "nu")},
                           "count": learner["count"], "lr_scale": learner["lr_scale"],
                           "zf": tuple(x.cpu() for x in learner["zf"])},
               "records": {k: torch.stack(v).cpu() for k, v in rec.items()},
               "traj": cpu(cap["traj"]), "perms": self.perms.cpu(),
               "losses": [float(x) for x in losses[:3]],
               "lrs": [float(x) for x in lrs[:3]], "mu1": cpu(cap["mu1"]),
               "count1": cap["count1"], "params1": cpu(cap["params1"]),
               "params3": cpu(cap["params3"]),
               "zf_before": tuple(x.cpu() for x in cap["zf_before"]),
               "zf_after": tuple(x.cpu() for x in cap["zf_after"])}
        if first:
            out["start"] = {"weights": cpu(self.weights), "rows": self.start_rows.cpu(),
                            "t": self.start_t}
        return out

    # ---- a traced run: the layers on synchronised timers, then the profile ----
    def timed_layers(self) -> dict:
        from surreal_tpu_torch.algos import ppo

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

        orig_rollout, orig_update = ppo.rollout, ppo.update

        def update(cfg, state, traj, *rest, **kw):
            kept["traj"] = traj
            return orig_update(cfg, state, traj, *rest, **kw)

        t.env.step = timed(t.env.step, "env_step")
        ppo.rollout, ppo.update = timed(orig_rollout, "rollout"), timed(update, "update")
        try:
            for _ in range(TIMED_ITERATIONS):
                self.iterate()
        finally:
            ppo.rollout, ppo.update = orig_rollout, orig_update
            del t.env.step
        self._traj = kept["traj"]
        c = self.cfg
        return {"seconds": secs, "calls": calls, "horizon": c["horizon"],
                "minibatch_steps": c["epochs"] * c["num_minibatches"] * calls["update"]}

    def profile(self) -> dict:
        """Device events of PROFILED_STEPS rollout steps and of one whole
        update of the timed iteration's trajectory, with the wall time of
        each under the profiler."""
        from surreal_tpu_torch.algos import ppo

        t, dev = self.trainer, self.device
        short = dataclasses.replace(t.cfg, horizon=PROFILED_STEPS)

        def rollout():
            t.env_state, t.obs, t.ep_ret = ppo.rollout(
                short, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret,
                t.generator)[1:4]

        out = {"steps": PROFILED_STEPS, "horizon": t.cfg.horizon,
               "minibatch_rows": t.cfg.horizon * t.num_envs // t.cfg.num_minibatches,
               "action_dim": self.spec["action_dim"]}
        for name, fn in (("rollout", rollout),
                         ("update", lambda: ppo.update(t.cfg, t.state, self._traj, t.generator))):
            sync(dev)
            t0 = time.perf_counter()
            dev_events, host_events = profile.device_events(fn, lambda: sync(dev))
            out[name] = {"device": dev_events, "host": host_events,
                         "wall_s": time.perf_counter() - t0}
        return out

    def close(self) -> None:
        self.trainer = None
        self._traj = None
