"""What the data-parallel tests run in their ranks: each rank is a process
of its own (`parallel.mesh.spawn`) that imports nothing of JAX. The test
writes a job (inputs, the reference's per-shard draws) with torch.save
under its tmp_path; each rank joins a gloo group at a file store there,
runs the job's kind and writes its outputs to rank<r>.pt beside it."""

import contextlib
import os

import torch
import torch.distributed as dist

from surreal_tpu_torch.algos import ddpg as tddpg
from surreal_tpu_torch.algos import ppo as tppo
from surreal_tpu_torch.envs import flatten_obs
from surreal_tpu_torch.envs.base import EnvState
from surreal_tpu_torch.envs.cheetah import CheetahRun
from surreal_tpu_torch.models import ddpg_nets
from surreal_tpu_torch.models.actor_critic import PPOActorCritic
from surreal_tpu_torch.models.z_filter import ZFilterState, zfilter_update
from surreal_tpu_torch.parallel import dp, mesh as pmesh, zero

TIMEOUT_S = 120


class Rows(CheetahRun):
    """Cheetah auto-resetting to scripted pool rows, one (B,) tensor a step."""

    def __init__(self, rows):
        super().__init__(device="cpu")
        self._rows = [torch.as_tensor(r) for r in rows]

    def draw_reset(self, batch, generator):
        return {"row": self._rows.pop(0)}


def run(local, folder, world):
    """Rank `local` of `world`: the job in folder/job.pt -> folder/rank<r>.pt,
    on the mesh of the job's "shape" (data x model x time; default a data
    axis of `world`)."""
    pmesh.distributed_init(f"file://{os.path.join(folder, 'store')}", world, local,
                           device="cpu", timeout_s=TIMEOUT_S)
    try:
        job = torch.load(os.path.join(folder, "job.pt"), weights_only=False)
        mesh = pmesh.make_mesh(*job.get("shape", (world,)), device="cpu")
        out = KINDS[job["kind"]](job, mesh)
        torch.save(out, os.path.join(folder, f"rank{mesh.rank}.pt"))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _local_kls(record):
    """Within it, dp's metric reduction keeps each step's local KL."""
    reduce = dp.reduce_metrics

    def keep(metrics, axis):
        record.append(float(metrics["kl"]))
        return reduce(metrics, axis)

    dp.reduce_metrics = keep
    try:
        yield
    finally:
        dp.reduce_metrics = reduce


def collectives(job, mesh):
    r = mesh.rank
    x = job["x"][r]
    zf = ZFilterState(*job["zf0"])
    out = {"psum": pmesh.psum(x, mesh), "pmean": pmesh.pmean(x, mesh),
           "flat": pmesh.pmean_flat([x, 2 * x[:3], x[None]], mesh),
           "metrics": pmesh.reduce_metrics({"episodes_done": x[0], "kl": x[1],
                                            "episode_return_sum": x[2]}, mesh),
           "zfilter": zfilter_update(zf, job["batch"][r], mesh),
           "replicated": dp.replicate(mesh, {"a": torch.full((3,), float(r))}),
           "shard": dp.shard_env_batch(mesh, EnvState(*job["env"]))}
    pmesh.barrier(mesh)
    return out


def axes(job, mesh):
    """On each mesh of job["shapes"] (every rank making each in turn): the
    rank's index on each axis, and over each axis the group's global ranks
    (an all_gather of them), the psum and the all_gather of job["x"][rank]."""
    out = {}
    for shape in job["shapes"]:
        m = pmesh.make_mesh(*shape, device="cpu")
        x = job["x"][m.rank]
        out[shape] = {"index": dict(m.index), "by_axis": {
            ax: {"members": pmesh.all_gather(torch.tensor([m.rank]), m, ax).tolist(),
                 "psum": pmesh.psum(x, m, ax), "pmean": pmesh.pmean(x, m, ax),
                 "gather": pmesh.all_gather(x[None], m, ax)} for ax in pmesh.AXES}}
        pmesh.barrier(m)
    return out


def _ppo_net(job):
    net = PPOActorCritic(17, 6, job["hidden"], use_lstm=job.get("lstm", 0) > 0,
                         lstm_size=job.get("lstm", 0) or 128)
    net.load_state_dict(job["params"])
    return net


def _moments(opt):
    """A ZeRO state's chunks of the moments; None for the replicated Adam."""
    if isinstance(opt, zero.ZeroAdamState):
        return {"mu": opt.mu.clone(), "nu": opt.nu.clone(), "count": opt.count}
    return None


def ppo(job, mesh):
    """Chained sharded PPO steps (plain, LSTM or overlapped) on the
    reference's per-shard draws; with job["twin"] (a ZeRO job), the same
    steps with the replicated Adam after them, whose learner is "twin"."""
    out = _ppo(job, mesh, tppo.PPOConfig(**job["cfg"]))
    if job.get("twin"):
        cfg = tppo.PPOConfig(**{**job["cfg"], "zero_optimizer": False, "zero_shards": 1})
        out["twin"] = _ppo(job, mesh, cfg)["params"]
    return out


def _ppo(job, mesh, cfg):
    r = mesh.index["data"]
    net = _ppo_net(job)
    state = tppo.init_state(cfg, net, 17)
    dp.replicate(mesh, state)
    env = Rows(list(job["rows"][r]))
    es = EnvState(*job["env"][r])
    obs, ep_ret = job["obs"][r], torch.zeros(job["obs"][r].shape[0])
    gen = torch.Generator().manual_seed(0)
    kls, metrics, lr_scales = [], [], []
    with _local_kls(kls):
        noise, perms = job["noise"][r], job["perms"][r]
        if job["mode"] == "lstm":
            step = dp.make_sharded_ppo_lstm_step(cfg, env, flatten_obs, mesh)
            carry = tuple(job["carry"][r])
            for i in range(len(perms)):
                state, es, obs, carry, ep_ret, m = step(state, es, obs, carry, ep_ret, gen,
                                                        noise[i], perms[i])
                metrics.append(m)
                lr_scales.append(state.lr_scale.clone())
        elif job["mode"] == "overlap":
            step, prime = dp.make_sharded_ppo_overlap_step(cfg, env, flatten_obs, mesh)
            pending, es, obs, ep_ret = prime(state, es, obs, ep_ret, gen, noise[0])
            for i in range(len(perms)):
                state, es, obs, ep_ret, pending, m = step(state, es, obs, ep_ret, pending, gen,
                                                          noise[i + 1], perms[i])
                metrics.append(m)
                lr_scales.append(state.lr_scale.clone())
        else:
            step = dp.make_sharded_ppo_step(cfg, env, flatten_obs, mesh)
            for i in range(len(perms)):
                state, es, obs, ep_ret, m = step(state, es, obs, ep_ret, gen, noise[i], perms[i])
                metrics.append(m)
                lr_scales.append(state.lr_scale.clone())
    return {"params": {n: p.detach() for n, p in state.net.named_parameters()},
            "zfilter": (state.zfilter.count, state.zfilter.mean, state.zfilter.m2),
            "lr_scale": lr_scales, "kl_beta": state.kl_beta, "update_step": state.update_step,
            "adam_count": state.opt_state.count, "metrics": metrics, "local_kl": kls,
            "obs": obs, "moments": _moments(state.opt_state)}


def ddpg(job, mesh):
    """Chained sharded DDPG steps on the reference's per-shard draws; with
    job["twin"] (a ZeRO job), the same steps with the replicated Adam after
    them, whose networks are "twin"."""
    out = _ddpg(job, mesh, tddpg.DDPGConfig(**job["cfg"]))
    if job.get("twin"):
        cfg = tddpg.DDPGConfig(**{**job["cfg"], "zero_optimizer": False, "zero_shards": 1})
        out["twin"] = _ddpg(job, mesh, cfg)["nets"]
    return out


def _ddpg(job, mesh, cfg):
    r = mesh.rank
    actor = ddpg_nets.DDPGActor(17, 6, job["a_hid"])
    critic = ddpg_nets.DDPGCritic(17, 6, job["c_hid"])
    actor.load_state_dict(job["ap"])
    critic.load_state_dict(job["cp"])
    state = tddpg.init_state(cfg, actor, critic, 17)
    B = job["num_envs"]
    replay = tddpg.init_replay(cfg, B, 17, 6, "cpu", shards=pmesh.data_axis_size(mesh))
    sigma = dp.shard_env_batch(mesh, torch.as_tensor(tddpg.noise_ladder(cfg, B)))
    env = Rows(list(job["rows"][r]))
    es = EnvState(*job["env"][r])
    obs, ep_ret = job["obs"][r], torch.zeros(B // mesh.world_size)
    ou = torch.zeros(B // mesh.world_size, 6)
    step = dp.make_sharded_ddpg_step(cfg, env, flatten_obs, mesh)(replay)
    metrics = []
    for i in range(len(job["eps"][r])):
        state, replay, es, obs, ou, ep_ret, m = step(
            state, replay, es, obs, ou, sigma, ep_ret, None, eps=job["eps"][r][i],
            indices=job["indices"][r][i], target_eps=job["target_eps"][r][i])
        metrics.append(m)
    nets = {n: {k: p.detach() for k, p in getattr(state, n).named_parameters()}
            for n in ("actor", "critic", "target_actor", "target_critic")}
    return {"nets": nets, "zfilter": (state.zfilter.count, state.zfilter.mean, state.zfilter.m2),
            "update_step": state.update_step, "metrics": metrics,
            "replay": {k: v.clone() for k, v in replay.data.items()}, "total": replay.total,
            "ring_shape": tuple(replay.data["obs"].shape), "ou": ou,
            "moments": {n: _moments(getattr(state, n)) for n in ("actor_opt", "critic_opt")}}


def trainer(job, mesh):
    """A trainer on the mesh for a few iterations: its learner state."""
    from surreal_tpu_torch.train import DDPGTrainer, PPOTrainer

    if job["algo"] == "ppo":
        t = PPOTrainer("cheetah-run", tppo.PPOConfig(**job["cfg"]), mesh=mesh, **job["kw"])
    else:
        t = DDPGTrainer("cheetah-run", tddpg.DDPGConfig(**job["cfg"]), mesh=mesh, **job["kw"])
    logs = t.run(job["iterations"], log_every=1)
    fs = t.full_state
    return {"learner": {k: v for k, v in fs.items() if k not in t.rank_keys},
            "own": {k: v for k, v in fs.items() if k in t.rank_keys}, "logs": logs}


def zero_adam(job, mesh):
    """The ZeRO Adam direction over the data axis, a few steps on given
    gradients, for each case's network: its chunks and directions."""
    out = {}
    for name, case in job["cases"].items():
        net = PPOActorCritic(17, 6, case["hidden"])
        state = zero.zero_adam_init(net, pmesh.data_axis_size(mesh))
        steps = []
        for g in case["grads"]:
            u = zero.scale_by_zero_adam(g, state, mesh)
            steps.append({"mu": state.mu.clone(), "nu": state.nu.clone(), "updates": u})
        out[name] = steps
    return out


def tshard(job, mesh):
    """The time-sharded scans on a data x 1 x time mesh (`mesh`) and on a
    1 x 1 x world one, and an LSTM-PPO trainer's iteration on `mesh`."""
    from surreal_tpu_torch.parallel import tshard as ts
    from surreal_tpu_torch.train import PPOTrainer

    out = {}
    for m in (mesh, pmesh.make_mesh(1, 1, mesh.world_size, device="cpu")):
        K, t = m.shape["time"], m.index["time"]
        blk = job["x"].shape[0] // K
        out[K] = {"replicated": ts.replicated_reverse_scan(job["x"], job["c"], m),
                  "sharded": ts.time_sharded_reverse_scan(
                      m, job["x"][t * blk:(t + 1) * blk], job["c"][t * blk:(t + 1) * blk])}
    t = PPOTrainer("cheetah-run", tppo.PPOConfig(**job["lstm_cfg"]), num_envs=4,
                   hidden=(16, 16), use_lstm=True, lstm_size=8, mesh=mesh)
    t.run(1, log_every=1)
    out["lstm"] = {"params": {n: p.detach() for n, p in t.state.net.named_parameters()},
                   "carry": [c.clone() for c in t.carry], "obs": t.obs.clone(),
                   "time_shards": t.cfg.time_shards}
    return out


def _tp_net(job, dtype=torch.float32):
    net = PPOActorCritic(17, 6, job["hidden"], compute_dtype=dtype)
    net.load_state_dict(job["params"])
    return net


def tp(job, mesh):
    """Tensor parallelism over the mesh's model axis: the sharded forward
    and gradient in float32 and bfloat16 ("probe"), a bfloat16 update on a
    synthetic trajectory ("bf16_update"), and chained tensor-parallel PPO
    steps on the reference's one-device draws ("steps")."""
    from surreal_tpu_torch.parallel import tp as ptp

    out = {}
    if "probe" in job:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            net = _tp_net(job, dtype)
            sharding = ptp.shard_module(net, mesh)
            mean, log_std, value = net(job["probe"])
            loss = torch.sum(mean ** 2) + torch.sum(value ** 2)
            names, params = zip(*net.named_parameters())
            grads = sharding.complete_grads(dict(zip(names, torch.autograd.grad(
                loss, params, allow_unused=True, materialize_grads=True))))
            out[name] = {"mean": mean.detach(), "value": value.detach(),
                         "contiguous": mean.is_contiguous() and value.is_contiguous(),
                         "grads": sharding.gather(grads),
                         "norm": sharding.global_norm(grads),
                         "local_floats": sum(p.numel() for p in params),
                         "shapes": {n: tuple(p.shape) for n, p in zip(names, params)}}
    if "bf16_update" in job:
        u = job["bf16_update"]
        cfg = tppo.PPOConfig(**u["cfg"])
        net = _tp_net(job, torch.bfloat16)
        sharding = ptp.shard_module(net, mesh)
        state = tppo.init_state(cfg, net, 17)
        state, metrics = tppo.update(cfg, state, tppo.Trajectory(**u["traj"]), None,
                                     perms=u["perms"])
        out["bf16_update"] = {"params": sharding.gather(dict(net.named_parameters())),
                              "metrics": metrics, "lr_scale": state.lr_scale}
    if "steps" in job:
        cfg = tppo.PPOConfig(**job["cfg"])
        net = _tp_net(job)
        sharding = ptp.shard_module(net, mesh)
        state = tppo.init_state(cfg, net, 17)
        d, b = mesh.index["data"], job["obs"].shape[0] // mesh.shape["data"]
        env = Rows(list(job["rows"]))
        es = EnvState(*(x[d * b:(d + 1) * b] for x in job["env"]))
        obs, ep_ret = job["obs"][d * b:(d + 1) * b], torch.zeros(b)
        step = ptp.make_tp_ppo_step(cfg, env, flatten_obs, mesh)
        gen = torch.Generator().manual_seed(0)
        metrics = []
        for noise, perms in zip(job["noise"], job["perms"]):
            state, es, obs, ep_ret, m = step(state, es, obs, ep_ret, gen, noise, perms)
            metrics.append(m)
        out["steps"] = {"params": sharding.gather(dict(net.named_parameters())),
                        "zfilter": (state.zfilter.count, state.zfilter.mean, state.zfilter.m2),
                        "lr_scale": float(state.lr_scale), "metrics": metrics,
                        "update_step": state.update_step,
                        "opt_count": state.opt_state.count,
                        "mu_shapes": {n: tuple(m.shape) for n, m in state.opt_state.mu.items()}}
    return out


def zero_twins(job, mesh):
    """A PPO trainer on the mesh with and without ZeRO, from one seed, for 2
    iterations each: both networks' parameters and the ZeRO one's chunk."""
    from surreal_tpu_torch.train import PPOTrainer

    out = {}
    for zero_optimizer in (False, True):
        t = PPOTrainer("cheetah-run", tppo.PPOConfig(**job["cfg"], zero_optimizer=zero_optimizer),
                       num_envs=8, hidden=(16, 16), mesh=mesh, **job["kw"])
        t.run(2, log_every=1)
        out[zero_optimizer] = {n: p.detach().clone() for n, p in t.state.net.named_parameters()}
        out["chunk"] = getattr(t.state.opt_state, "mu", None)
    out["chunk"] = tuple(out["chunk"].shape)
    return out


def ddpg_zero_resume(job, mesh):
    """A DDPG trainer with ZeRO on the mesh for 2 iterations; its full state
    (the moments gathered whole) loaded into a fresh one: each rank's
    chunks, and one more iteration of both."""
    from surreal_tpu_torch.train import DDPGTrainer

    def trainer():
        return DDPGTrainer("cheetah-run", tddpg.DDPGConfig(**job["cfg"]), num_envs=8,
                           actor_hidden=(16, 16), critic_hidden=(16, 16), mesh=mesh)

    a = trainer()
    a.run(2, log_every=1)
    fs = a.full_state
    b = trainer()
    b.load_full_state(fs)
    same = [torch.equal(getattr(getattr(a.state, o), m), getattr(getattr(b.state, o), m))
            for o in ("actor_opt", "critic_opt") for m in ("mu", "nu")]
    a.run(1, log_every=1)
    b.run(1, log_every=1)
    nets = [torch.equal(p, q) for n in ("actor", "critic")
            for p, q in zip(getattr(a.state, n).parameters(), getattr(b.state, n).parameters())]
    return {"chunks_equal": same, "nets_equal_after_one_more": nets,
            "whole_mu": {k: tuple(v.shape) for k, v in fs["actor_opt"]["mu"].items()},
            "chunk": a.state.actor_opt.mu.numel(), "updates": a.state.update_step}


def ddpg_relayout(job, mesh):
    """A DDPG trainer on the mesh resumed from the one-device checkpoint
    under job["root"], then saved at job["step"] under the mesh: its
    generator before the load, and its full state after it."""
    from surreal_tpu_torch.train import DDPGTrainer
    from surreal_tpu_torch.train.checkpoint import Checkpointer

    t = DDPGTrainer("cheetah-run", tddpg.DDPGConfig(**job["cfg"]), mesh=mesh, **job["kw"])
    fresh = t.generator.get_state()
    ck = Checkpointer(job["root"], mesh=mesh, rank_keys=t.rank_keys)
    t.load_full_state(ck.restore(t.full_state))
    fs = t.full_state
    ck.save(job["step"], fs)
    return {"fresh_generator": fresh, "fs": fs}


def fail_one(local):
    """Rank 1 fails; rank 0 waits, as a rank blocked in a collective would."""
    if local == 1:
        raise SystemExit(3)
    hang(local)


def hang(local):
    import time

    time.sleep(60)


KINDS = {"collectives": collectives, "axes": axes, "ppo": ppo, "ddpg": ddpg, "trainer": trainer,
         "zero_adam": zero_adam, "tshard": tshard, "tp": tp,
         "ddpg_zero_resume": ddpg_zero_resume, "zero_twins": zero_twins,
         "ddpg_relayout": ddpg_relayout}
