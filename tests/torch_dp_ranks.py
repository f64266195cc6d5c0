"""What the data-parallel tests run in their ranks: each rank is a process
of its own (`parallel.mesh.spawn`) that imports nothing of JAX. The test
writes a job (inputs, the reference's per-shard draws) with torch.save
under its tmp_path; each rank joins a gloo group at a file store there,
runs the job's kind and writes its outputs to rank<r>.pt beside it."""

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
from surreal_tpu_torch.parallel import dp, mesh as pmesh

TIMEOUT_S = 120


class Rows(CheetahRun):
    """Cheetah auto-resetting to scripted pool rows, one (B,) tensor a step."""

    def __init__(self, rows):
        super().__init__(device="cpu")
        self._rows = [torch.as_tensor(r) for r in rows]

    def draw_reset(self, batch, generator):
        return {"row": self._rows.pop(0)}


def run(local, folder, world):
    """Rank `local` of `world`: the job in folder/job.pt -> folder/rank<r>.pt."""
    pmesh.distributed_init(f"file://{os.path.join(folder, 'store')}", world, local,
                           device="cpu", timeout_s=TIMEOUT_S)
    try:
        job = torch.load(os.path.join(folder, "job.pt"), weights_only=False)
        mesh = pmesh.make_mesh(world, device="cpu")
        out = KINDS[job["kind"]](job, mesh)
        torch.save(out, os.path.join(folder, f"rank{mesh.rank}.pt"))
    finally:
        dist.destroy_process_group()


def _local_kls(record):
    """Wraps dp's metric reduction to keep each step's local KL."""
    reduce = dp.reduce_metrics

    def keep(metrics, axis):
        record.append(float(metrics["kl"]))
        return reduce(metrics, axis)

    dp.reduce_metrics = keep


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


def _ppo_net(job):
    net = PPOActorCritic(17, 6, job["hidden"], use_lstm=job.get("lstm", 0) > 0,
                         lstm_size=job.get("lstm", 0) or 128)
    net.load_state_dict(job["params"])
    return net


def ppo(job, mesh):
    """Chained sharded PPO steps (plain, LSTM or overlapped) on the
    reference's per-shard draws."""
    r = mesh.rank
    cfg = tppo.PPOConfig(**job["cfg"])
    net = _ppo_net(job)
    state = tppo.init_state(cfg, net, 17)
    dp.replicate(mesh, state)
    env = Rows(job["rows"][r])
    es = EnvState(*job["env"][r])
    obs, ep_ret = job["obs"][r], torch.zeros(job["obs"][r].shape[0])
    gen = torch.Generator().manual_seed(0)
    kls, metrics, lr_scales = [], [], []
    _local_kls(kls)
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
            "obs": obs}


def ddpg(job, mesh):
    """Chained sharded DDPG steps on the reference's per-shard draws."""
    r = mesh.rank
    cfg = tddpg.DDPGConfig(**job["cfg"])
    actor = ddpg_nets.DDPGActor(17, 6, job["a_hid"])
    critic = ddpg_nets.DDPGCritic(17, 6, job["c_hid"])
    actor.load_state_dict(job["ap"])
    critic.load_state_dict(job["cp"])
    state = tddpg.init_state(cfg, actor, critic, 17)
    B = job["num_envs"]
    replay = tddpg.init_replay(cfg, B, 17, 6, "cpu", shards=pmesh.data_axis_size(mesh))
    sigma = dp.shard_env_batch(mesh, torch.as_tensor(tddpg.noise_ladder(cfg, B)))
    env = Rows(job["rows"][r])
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
            "ring_shape": tuple(replay.data["obs"].shape), "ou": ou}


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


def fail_one(local):
    """Rank 1 fails; rank 0 waits, as a rank blocked in a collective would."""
    if local == 1:
        raise SystemExit(3)
    hang(local)


def hang(local):
    import time

    time.sleep(60)


KINDS = {"collectives": collectives, "ppo": ppo, "ddpg": ddpg, "trainer": trainer}
