"""The reference's PPO with the GTrXL policy (`gtrxl.py`): the rollout's
outputs recomputed from the stored memory and observations, the first
optimizer steps of an update over minibatches of whole env sequences, and
a whole first iteration computed by the reference alone (`produce`: the
control, in TF32, put in the program's place), in the capture format of
`drivers/ppo_gtrxl.py`. The PPO arithmetic (Gaussian, Z-filter, GAE, the
clipped loss, the clip, Adam) is `ppo.py`'s."""

from __future__ import annotations

import torch

from . import gtrxl, ppo, producer, steps


def outputs(p: dict, spec: dict, memory_t: torch.Tensor, valid_t: torch.Tensor,
            obs_n: torch.Tensor, done: torch.Tensor, block: int):
    """`gtrxl.chain` over blocks of envs: (mean (T, B, A), log_std (A,),
    value (T, B), the layer inputs (L, B, T, d))."""
    B = done.shape[1]
    means, values, inputs = [], [], []
    for i in range(0, B, block):
        sl = slice(i, i + block)
        dev = obs_n.device
        e, inp = gtrxl.chain(p, spec, memory_t[:, sl].to(dev), valid_t[sl].to(dev),
                             obs_n[:, sl], done[:, sl])
        mean, log_std, value = gtrxl.heads(p, e)
        means.append(mean)
        values.append(value)
        inputs.append(inp)
    return torch.cat(means, 1), log_std, torch.cat(values, 1), torch.cat(inputs, 1)


def probe_values(p: dict, spec: dict, memory_t, valid_t, inputs, obs_n, env, query_time,
                 ep_start, block: int) -> torch.Tensor:
    """The value of each probe (`gtrxl.probe`), in blocks of probes."""
    out = []
    for i in range(0, env.shape[0], block):
        sl = slice(i, i + block)
        e_env = env[sl]
        e, _ = gtrxl.probe(p, spec, memory_t[:, e_env.cpu()].to(obs_n.device),
                           valid_t[e_env.cpu()].to(obs_n.device), inputs[:, e_env],
                           obs_n[sl], torch.arange(len(e_env), device=obs_n.device),
                           query_time[sl], ep_start[sl])
        out.append(gtrxl.heads(p, e)[2])
    return torch.cat(out) if out else torch.zeros(0, device=obs_n.device)


def update_rows(cfg: dict, reward, done, value, next_value) -> tuple[torch.Tensor, torch.Tensor]:
    """(advantages, value targets), (T, B): GAE with the reference's
    values, the advantages normalised over the whole batch."""
    adv, vtarg = ppo.gae(reward, value, next_value, torch.ones_like(reward), done,
                         cfg["gamma"], cfg["lam"])
    if cfg["normalize_adv"]:
        adv = ppo.normalize_advantages(adv)
    return adv, vtarg


def first_steps(spec: dict, cfg: dict, start: dict, rows: dict, perms: torch.Tensor,
                n_steps: int) -> dict:
    """The update's first `n_steps` optimizer steps. `rows` holds (T, B, ...)
    obs_n, action, logp_old, adv, vtarg, v_old, done and the chunk-start
    memory_t (L, B, m, d) and valid_t (B, m), oldest first; `perms`
    (epochs, B) the envs' order. Each minibatch's envs are recomputed over
    their memory (`gtrxl.chain`), with autograd. Returns what
    `steps.first_steps` returns."""
    B = rows["done"].shape[1]
    mb = B // cfg["num_minibatches"]
    params = {n: w.detach().clone().requires_grad_(True) for n, w in start["params"].items()}
    adam = ppo.Adam(start["mu"], start["nu"], start["count"])
    out = {"losses": []}
    dev = rows["obs_n"].device
    for j in range(n_steps):
        e, k = divmod(j, cfg["num_minibatches"])
        idx = perms[e][k * mb:(k + 1) * mb]
        h, _ = gtrxl.chain(params, spec, rows["memory_t"][:, idx.cpu()].to(dev),
                           rows["valid_t"][idx.cpu()].to(dev), rows["obs_n"][:, idx],
                           rows["done"][:, idx])
        mean, log_std, value = gtrxl.heads(params, h)
        flat = lambda x: x[:, idx].reshape(-1, *x.shape[2:])
        loss = ppo.clip_loss(cfg, mean.reshape(-1, mean.shape[-1]), log_std, value.reshape(-1),
                             flat(rows["action"]), flat(rows["logp_old"]), flat(rows["adv"]),
                             flat(rows["vtarg"]), flat(rows["v_old"]))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads = ppo.clip_by_global_norm(grads, cfg["max_grad_norm"])
        out["losses"].append(float(loss.detach()))
        if j == 0:
            out["grads1"] = {n: g.detach() for n, g in grads.items()}
        direction = adam.direction(grads)
        with torch.no_grad():
            for n, prm in params.items():
                prm.sub_(start["lr"] * direction[n])
        if j == 0:
            out["mu1"] = {n: m.clone() for n, m in adam.mu.items()}
            out["count1"] = adam.count
            out["params1"] = {n: prm.detach().clone() for n, prm in params.items()}
    out["params"] = {n: prm.detach() for n, prm in params.items()}
    return out


@torch.no_grad()
def _rollout(spec: dict, cfg: dict, task, p: dict, start_rows, start_t, generator, block):
    """The first rollout from an empty memory, step by step: each position
    recomputed over the chunk's earlier positions (`gtrxl.probe`, the
    memory empty)."""
    q, qd = task.start(start_rows)
    B, T, m, L = q.shape[0], cfg["horizon"], spec["memory"], spec["layers"]
    dev = q.device
    t = start_t.clone()
    obs = task.obs_flat(q, qd)
    zf = ppo.zfilter_init(obs.shape[-1], dev) if cfg["use_zfilter"] else None
    memory_t = torch.zeros(L, B, m, spec["width"], device=dev)
    valid_t = torch.zeros(B, m, dtype=torch.bool, device=dev)
    inputs = torch.zeros(L, B, T, spec["width"], device=dev)
    ep_start = torch.full((B,), gtrxl.BEFORE, dtype=torch.int64, device=dev)
    envs = torch.arange(B, device=dev)
    rec = {k: [] for k in ("q_in", "qd_in", "t_in", "action", "q_out", "qd_out", "t_out", "obs",
                           "carry", "reward", "done")}
    cols = {k: [] for k in ("obs", "action", "log_prob", "mean", "log_std", "value", "reward",
                            "discount", "done")}
    term_values = []

    def at(x, s, starts):
        es, own = [], []
        for i in range(0, B, block):
            sl = slice(i, i + block)
            e, o = gtrxl.probe(p, spec, memory_t[:, sl], valid_t[sl], inputs[:, sl], x[sl],
                               envs[sl] - i, torch.full_like(envs[sl], s), starts[sl])
            es.append(e)
            own.append(o)
        return torch.cat(es), torch.cat(own, 1)

    for s in range(T):
        x = steps.normalized_obs(obs, zf)
        e, own = at(x, s, ep_start)
        inputs[:, :, s] = own
        mean, log_std, value = gtrxl.heads(p, e)
        noise = torch.randn(mean.shape, generator=generator, device=dev)
        action = mean + torch.exp(log_std) * noise
        logp = ppo.log_prob(mean, log_std, action)
        q2, qd2, t2, r, done, div = task.step(q, qd, t, action)
        rows = torch.randint(0, task.pool_q.shape[0], (B,), generator=generator, device=dev)
        q0, qd0 = task.start(rows)
        term = torch.where(div[:, None], task.obs_flat(q0, qd0), task.obs_flat(q2, qd2))
        carry = torch.where(done[:, None], task.obs_flat(q0, qd0), term)
        term_values.append(gtrxl.heads(p, at(steps.normalized_obs(term, zf), s + 1,
                                             ep_start)[0])[2]
                           if bool(done.any()) else torch.zeros_like(value))
        q_new = torch.where(done[:, None], q0, q2)
        qd_new = torch.where(done[:, None], qd0, qd2)
        t_new = torch.where(done, torch.zeros_like(t2), t2)
        for k, v in (("q_in", q), ("qd_in", qd), ("t_in", t), ("action", action),
                     ("q_out", q_new), ("qd_out", qd_new), ("t_out", t_new), ("obs", term),
                     ("carry", carry), ("reward", r), ("done", done)):
            rec[k].append(v)
        for k, v in (("obs", obs), ("action", action), ("log_prob", logp), ("mean", mean),
                     ("log_std", log_std.expand_as(mean)), ("value", value), ("reward", r),
                     ("discount", torch.ones_like(r)), ("done", done)):
            cols[k].append(v)
        ep_start = torch.where(done, torch.full_like(ep_start, s + 1), ep_start)
        q, qd, t, obs = q_new, qd_new, t_new, carry
    traj = {k: torch.stack(v) for k, v in cols.items()}
    v_last = gtrxl.heads(p, at(steps.normalized_obs(obs, zf), T, ep_start)[0])[2]
    nv = torch.cat([traj["value"][1:], v_last[None]])
    traj["next_value"] = torch.where(traj["done"], torch.stack(term_values), nv)
    records = {k: torch.stack(v) for k, v in rec.items()}
    return records, traj, zf, inputs, ep_start


def produce(spec: dict, cfg: dict, task, weights: dict, start_rows, start_t, perms, seed: int,
            tf32: bool = False, block: int = 128) -> dict:
    """A first iteration from the benchmark's start (an empty memory, the
    clock at 0), computed by the reference alone, in the capture format of
    `drivers/ppo_gtrxl.py`."""
    dev = start_rows.device
    T, m, L, B = cfg["horizon"], spec["memory"], spec["layers"], start_rows.shape[0]
    zeros = {n: torch.zeros_like(w) for n, w in weights.items()}
    with producer.precision(tf32):
        gen = torch.Generator(device=dev).manual_seed(seed)
        records, traj, zf, inputs, ep_start = _rollout(spec, cfg, task, weights, start_rows,
                                                       start_t, gen, block)
        memory_t = torch.zeros(L, B, m, spec["width"], device=dev)
        valid_t = torch.zeros(B, m, dtype=torch.bool, device=dev)
        with torch.no_grad():
            adv, vtarg = update_rows(cfg, traj["reward"], traj["done"], traj["value"],
                                     traj["next_value"])
            rows = {"obs_n": steps.normalized_obs(traj["obs"], zf), "action": traj["action"],
                    "logp_old": traj["log_prob"], "adv": adv, "vtarg": vtarg,
                    "v_old": traj["value"], "done": traj["done"], "memory_t": memory_t,
                    "valid_t": valid_t}
        start = {"params": weights, "mu": zeros, "nu": zeros, "count": 0, "lr": cfg["lr"]}
        out = first_steps(spec, cfg, start, rows, perms, 3)
        zf_after = ppo.zfilter_update(zf, traj["obs"]) if zf is not None else zf
    # the ring after the chunk: slot (time mod m) of the last m steps
    ring = torch.zeros(L, B, m, spec["width"], device=dev)
    valid_ring = torch.zeros(B, m, dtype=torch.bool, device=dev)
    for s in range(max(T - m, 0), T):
        ring[:, :, s % m] = inputs[:, :, s]
        valid_ring[:, s % m] = s >= ep_start
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    zf_cpu = None if zf is None else tuple(x.cpu() for x in zf)
    traj.update(memory=memory_t, valid=valid_t)
    return {"start": {"weights": cpu(weights), "rows": start_rows.cpu(), "t": start_t.cpu()},
            "learner": {"params": cpu(weights), "mu": cpu(zeros), "nu": cpu(zeros),
                        "count": 0, "lr_scale": 1.0, "zf": zf_cpu},
            "records": cpu(records), "traj": cpu(traj), "t0": 0, "perms": perms.cpu(),
            "carry_after": {"memory": ring.cpu(), "valid": valid_ring.cpu(), "t": T},
            "losses": out["losses"], "lrs": [cfg["lr"]] * 3, "mu1": cpu(out["mu1"]),
            "count1": out["count1"], "params1": cpu(out["params1"]),
            "params3": cpu(out["params"]), "zf_before": zf_cpu,
            "zf_after": None if zf_after is None else tuple(x.cpu() for x in zf_after)}
