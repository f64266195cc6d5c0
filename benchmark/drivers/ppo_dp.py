"""The data-parallel PPO driver: the e2048 cell's trainer over a data axis
of `ranks` processes, one card each (NCCL), each rank with its share of
`num_envs` envs (`parallel.dp`: replicated learner, averaged gradients).

The harness's process starts the ranks (`parallel.mesh.spawn`) and waits:
each rank builds `PPOTrainer` with its mesh, takes the benchmark's weights
and its slice of the start states, drives a captured first iteration, then
the measured window of whole iterations (rank 0 decides after each
iteration whether the window goes on, and every rank follows it), in a
traced run times and profiles the layers (rank 0 under the profiler, the
others running the same work alongside), then captures one more
iteration. Every rank writes its captures; rank 0 merges them into one
capture of the whole batch (the ranks' env steps and trajectories side by
side, the losses averaged over the ranks, the minibatches the union of the
ranks' minibatches) and has `reference/judge.py` judge it: each rank's env
and policy as e2048's, the learner after steps 1 and 3 against the
reference's update over the whole gathered batch. The ranks' parameters
must be equal bit for bit (`rank_param_mismatch`: elements that differ from
rank 0's, after each captured iteration). A rank that fails fails the run;
one that hangs is killed at `TIMEOUT_S` past the window."""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import sys
import tempfile
import time

import torch

from .. import launched, profile
from ..reference import judge
from ..reference import ppo as ref_ppo
from . import ppo as ppo_driver
from .ppo import PROFILED_STEPS, load_task, net_spec, reference_cfg

TIMEOUT_S = 900  # past the window: set-up, the trace, the captures and the judge


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> tuple[dict, dict]:
    from surreal_tpu_torch.parallel.mesh import spawn

    traffic = cell["traffic"]
    if device.type == "cuda":
        from surreal_tpu_torch.ops import build
        build.build_all()  # once, before the ranks load it
    t0_wall = time.time() - (time.perf_counter() - t_start)
    out_dir = tempfile.mkdtemp(prefix="bench_ppo_dp_")
    try:
        spawn(rank_main, traffic["ranks"],
              (cell, config, seed, seconds, trace, device.type, t0_wall, out_dir),
              timeout_s=seconds + TIMEOUT_S)
        res = torch.load(os.path.join(out_dir, "result.pt"), weights_only=False)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return res["ctx"], res["numbers"]


def inputs(config: dict, traffic: dict, spec: dict, task, seed: int, device, rank: int):
    """The benchmark's inputs from the seed, drawn alike on every rank: the
    weights, the start rows of the whole batch (rank r keeps its slice),
    and each rank's minibatch permutations of its own rows (rank r keeps
    its own)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = ref_ppo.make_weights(spec, gen, device)
    B, ranks = traffic["num_envs"], traffic["ranks"]
    rows = torch.randint(0, task.pool_q.shape[0], (B,), generator=gen, device=device)
    start_t = task.episode_steps - traffic["steps_to_episode_end"]
    n = config["ppo"]["horizon"] * (B // ranks)
    perms = [torch.stack([torch.randperm(n, generator=gen, device=device)
                          for _ in range(config["ppo"]["epochs"])]) for _ in range(ranks)]
    return weights, rows, start_t, perms[rank]


def merged_perms(perms: list[torch.Tensor], local: int, minibatches: int) -> torch.Tensor:
    """The whole batch's (epochs, T·B) permutations whose k-th minibatch is
    the union of the ranks' k-th minibatches: rank r's local row
    t·B_r + b is global row t·B + r·B_r + b."""
    ranks = len(perms)
    mb = perms[0].shape[1] // minibatches
    glob = [(p // local) * (local * ranks) + r * local + p % local for r, p in enumerate(perms)]
    return torch.stack([torch.cat([g[e, k * mb:(k + 1) * mb] for k in range(minibatches)
                                   for g in glob]) for e in range(perms[0].shape[0])])


def merge(caps: list[dict], cfg: dict, local: int) -> dict:
    """The ranks' captures of one iteration as one capture of the whole
    batch (envs side by side in rank order)."""
    first = caps[0]
    out = dict(first)
    for key in ("records", "traj"):
        out[key] = {k: torch.cat([c[key][k] for c in caps], 1) for k in first[key]}
    out["perms"] = merged_perms([c["perms"] for c in caps], local, cfg["num_minibatches"])
    if "start" in first:
        out["start"] = {**first["start"],
                        "rows": torch.cat([c["start"]["rows"] for c in caps])}
    return out


def rank_main(i: int, cell: dict, config: dict, seed: int, seconds: float, trace: bool,
              device_type: str, t0_wall: float, out_dir: str) -> None:
    import torch.distributed as dist

    from surreal_tpu_torch.parallel.mesh import distributed_init, make_mesh

    traffic = cell["traffic"]
    ranks = traffic["ranks"]
    if traffic.get("fault"):
        plant(traffic["fault"])
    distributed_init("file://" + os.path.join(out_dir, "store"), ranks, i, device=device_type,
                     ranks_per_host=ranks)
    try:
        mesh = make_mesh(ranks, device=device_type)
        dev = mesh.device
        task = load_task(config, dev)
        drv = DPDriver(config, traffic, seed, mesh, task)
        first = drv.captured_iteration()
        ppo_driver.sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ctx = {"net": drv.spec, "cfg": drv.cfg, "num_envs": traffic["num_envs"],
               "trace": trace}
        ctx["window"] = drv.window(seconds)
        ctx["setup_s"] = ctx["window"].pop("opened_wall") - t0_wall
        if trace:
            ctx["timers"] = drv.timed_layers()
            ctx["profile"] = p = drv.profile()
            if p is not None:
                ctx["busy_s"] = sum(profile.busy_seconds(p[k]["device"])
                                    for k in ("rollout", "update"))
                ctx["window_s"] = sum(p[k]["wall_s"] for k in ("rollout", "update"))
                devs = p["rollout"]["device"] + p["update"]["device"]
                host = p["rollout"]["host"] + p["update"]["host"]
                ctx["breakdown"] = {"device_ops": profile.top_ops(devs),
                                    "idle_gaps": profile.idle_gaps(devs, host)}
        peak = torch.tensor([torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0],
                            dtype=torch.float64, device=dev)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        ctx["memory_peak_bytes"] = int(peak)
        mismatch = drv.param_mismatch()
        after = drv.captured_iteration()
        mismatch += drv.param_mismatch()
        drv.close()
        del drv
        gc.collect()
        torch.save({"first": first, "after": after},
                   os.path.join(out_dir, f"caps_{mesh.rank}.pt"))
        dist.barrier()
        if mesh.rank != 0:
            return
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        caps = [torch.load(os.path.join(out_dir, f"caps_{r}.pt"), weights_only=False)
                for r in range(ranks)]
        local = traffic["num_envs"] // ranks
        cfg = reference_cfg(config)
        merged = [merge([c[k] for c in caps], cfg, local) for k in ("first", "after")]
        del caps
        numbers = judge.judge_all(merged, ctx["net"], cfg, task, dev)
        numbers["rank_param_mismatch"] = mismatch
        torch.save({"ctx": ctx, "numbers": numbers}, os.path.join(out_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


def plant(fault: str) -> None:
    """A fault planted in this rank's program, for the benchmark's own
    checks (a cell's traffic names it under "fault"): 'no_allreduce', each
    rank steps on its own gradients."""
    from surreal_tpu_torch.algos import ppo

    if fault != "no_allreduce":
        raise ValueError(f"unknown fault {fault!r}")
    ppo.pmean_flat = lambda tensors, axis, name=None: list(tensors)


class DPDriver(ppo_driver.Driver):
    """The e2048 driver's trainer, captures and layers on one rank of a data
    mesh."""

    def __init__(self, config: dict, traffic: dict, seed: int, mesh, task):
        from surreal_tpu_torch.algos.ppo import PPOConfig
        from surreal_tpu_torch.train import PPOTrainer

        cfg = config["ppo"]
        if config["activation"] != "tanh":
            raise ValueError("the trainer's torsos are tanh MLPs")
        if cfg.get("objective", "clip") != "clip" or cfg.get("publish_every", 1) != 1:
            raise ValueError("the reference follows the 'clip' objective without staleness")
        self.mesh, self.device = mesh, mesh.device
        self.spec = net_spec(config, task)
        self.cfg = reference_cfg(config)
        B, ranks = traffic["num_envs"], traffic["ranks"]
        self.local = B // ranks
        self.trainer = PPOTrainer(
            config["env_name"], PPOConfig(**cfg), num_envs=B, seed=seed,
            hidden=tuple(config["hidden"]), device=mesh.device,
            compute_dtype=config["compute_dtype"], mesh=mesh)
        self.weights, rows, self.start_t, self.perms = inputs(
            config, traffic, self.spec, task, seed, mesh.device, mesh.rank)
        self.start_rows = rows[mesh.rank * self.local:(mesh.rank + 1) * self.local]
        self.iterations = 0
        t = self.trainer
        t.state.net.load_state_dict(self.weights)
        state, ts = t.env.reset(self.local,
                                reset_draw={config["reset_draw_key"]: self.start_rows})
        t.env_state = dataclasses.replace(state, t=torch.full_like(state.t, self.start_t))
        t.obs = t._flatten(ts.obs)

    @property
    def samples_per_iteration(self) -> int:
        return self.trainer.cfg.horizon * self.trainer.num_envs  # the whole batch

    def _agree(self, go: bool) -> bool:
        """Rank 0's decision, on every rank."""
        import torch.distributed as dist

        flag = torch.tensor([1.0 if go else 0.0], device=self.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def window(self, seconds: float) -> dict:
        """`harness.timed_window` across the ranks: whole iterations until
        rank 0's clock passes `seconds`, a synchronise at each end."""
        dev = self.device
        ppo_driver.sync(dev)
        self._agree(True)  # the ranks open the window together
        opened_wall = time.time()
        t0 = time.perf_counter()
        ends = []
        while True:
            self.iterate()
            ends.append(time.perf_counter() - t0)
            if not self._agree(ends[-1] < seconds):
                break
        ppo_driver.sync(dev)
        window_s = time.perf_counter() - t0
        if self.mesh.rank == 0:
            print("window: iterations end at " + " ".join(f"{e:.3f}" for e in ends) + " s",
                  file=sys.stderr)
        return {"iterations": len(ends), "seconds": window_s, "opened": t0,
                "opened_wall": opened_wall, "samples": len(ends) * self.samples_per_iteration}

    def captured_iteration(self) -> dict:
        """The e2048 driver's capture of this rank's iteration, with each
        optimizer step's loss averaged over the ranks (the loss of the
        union of their minibatches)."""
        import torch.distributed as dist

        from surreal_tpu_torch.algos import ppo

        orig_apply = ppo.apply_gradients
        ranks = self.mesh.shape["data"]

        def apply_gradients(cfg, state, loss, lr, axis=None):
            out = orig_apply(cfg, state, loss, lr, axis)
            mean = loss.detach().clone()
            dist.all_reduce(mean)
            self._loss_means.append(mean / ranks)
            return out

        self._loss_means = []
        ppo.apply_gradients = apply_gradients
        try:
            cap = super().captured_iteration()
        finally:
            ppo.apply_gradients = orig_apply
        cap["losses"] = [float(x) for x in self._loss_means[:3]]
        return cap

    def param_mismatch(self) -> int:
        """Parameter elements of any rank that differ from rank 0's."""
        from surreal_tpu_torch.parallel.mesh import all_gather

        flat = torch.cat([p.detach().reshape(-1) for p in self.trainer.state.net.parameters()])
        every = all_gather(flat[None], self.mesh)
        return int((every != every[:1]).sum())

    def profile(self) -> dict | None:
        """Rank 0's device events, with correlation ids, of PROFILED_STEPS
        rollout steps and one update of the timed iteration's trajectory;
        the other ranks run the same work unprofiled (the update's
        all-reduces need them)."""
        from surreal_tpu_torch.algos import ppo

        t, dev, mesh = self.trainer, self.device, self.mesh
        short = dataclasses.replace(t.cfg, horizon=PROFILED_STEPS)

        def rollout():
            t.env_state, t.obs, t.ep_ret = ppo.rollout(
                short, t.env, t._flatten, t.state, t.env_state, t.obs, t.ep_ret,
                t.generator)[1:4]

        out = {"steps": PROFILED_STEPS, "horizon": t.cfg.horizon,
               "minibatch_rows": t.cfg.horizon * self.local // t.cfg.num_minibatches,
               "action_dim": self.spec["action_dim"]}
        for name, fn in (("rollout", rollout),
                         ("update", lambda: ppo.update(t.cfg, t.state, self._traj, t.generator,
                                                       axis=mesh))):
            for _ in range(3):  # a profile that saw no device event is taken again, by all
                ppo_driver.sync(dev)
                self._agree(True)
                t0 = time.perf_counter()
                if mesh.rank == 0:
                    dev_events, host_events = launched.device_events(
                        fn, lambda: ppo_driver.sync(dev), 1)
                else:
                    fn()
                    ppo_driver.sync(dev)
                    dev_events = host_events = []
                wall_s = time.perf_counter() - t0
                if self._agree(bool(dev_events)):
                    break
            out[name] = {"device": [e[:3] for e in dev_events],
                         "host": [e[:3] for e in host_events],
                         "device_corr": dev_events, "host_corr": host_events,
                         "wall_s": wall_s}
        return out if mesh.rank == 0 else None
