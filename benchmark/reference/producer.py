"""The reference put in the program's place: one training iteration
computed by the reference alone, captured in the program's capture format.
It is the benchmark's control (computed in a lower precision than the
configuration states) and the carrier of planted faults; the benchmark's
timed runs never run it.

Faults: 'frozen' (the update leaves the learner's state as it was: the
parameters, Adam and the observation filter), 'half_batch'
(each minibatch's loss over half its rows), 'no_noise' (the action is the
policy's mean: the sampled answer altered where it is produced),
'altered_reward' (one env's reward at the first step off by 1)."""

from __future__ import annotations

import contextlib

import torch

from . import ppo, steps


@contextlib.contextmanager
def precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@torch.no_grad()
def rollout(spec: dict, cfg: dict, task, weights: dict, start_rows, start_t: int,
            generator: torch.Generator, fault: str | None):
    q, qd = task.start(start_rows)
    B = q.shape[0]
    t = torch.full((B,), start_t, dtype=torch.int32, device=q.device)
    obs = task.obs_flat(q, qd)
    zf = ppo.zfilter_init(obs.shape[-1], q.device) if cfg["use_zfilter"] else None
    rec = {k: [] for k in ("q_in", "qd_in", "t_in", "action", "q_out", "qd_out", "t_out", "obs",
                           "carry", "reward", "done")}
    cols = {k: [] for k in ("obs", "action", "log_prob", "mean", "log_std", "value", "reward",
                            "discount", "done")}
    term_values = []
    for step in range(cfg["horizon"]):
        x = steps.normalized_obs(obs, zf)
        mean, log_std, value = ppo.forward(weights, x, spec)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        action = mean if fault == "no_noise" else mean + torch.exp(log_std) * noise
        logp = ppo.log_prob(mean, log_std, action)
        q2, qd2, t2, r, done, div = task.step(q, qd, t, action)
        if fault == "altered_reward" and step == 0:
            r = r.clone()
            r[0] += 1.0
        rows = torch.randint(0, task.pool_q.shape[0], (B,), generator=generator,
                             device=q.device)
        q0, qd0 = task.start(rows)
        q_new = torch.where(done[:, None], q0, q2)
        qd_new = torch.where(done[:, None], qd0, qd2)
        t_new = torch.where(done, torch.zeros_like(t2), t2)
        term = torch.where(div[:, None], task.obs_flat(q0, qd0), task.obs_flat(q2, qd2))
        carry = torch.where(done[:, None], task.obs_flat(q0, qd0), term)
        term_values.append(ppo.forward(weights, steps.normalized_obs(term, zf), spec)[2]
                           if bool(done.any()) else torch.zeros_like(value))
        for k, v in (("q_in", q), ("qd_in", qd), ("t_in", t), ("action", action),
                     ("q_out", q_new), ("qd_out", qd_new), ("t_out", t_new), ("obs", term),
                     ("carry", carry), ("reward", r), ("done", done)):
            rec[k].append(v)
        for k, v in (("obs", obs), ("action", action), ("log_prob", logp), ("mean", mean),
                     ("log_std", log_std.expand_as(mean)), ("value", value), ("reward", r),
                     ("discount", torch.ones_like(r)), ("done", done)):
            cols[k].append(v)
        q, qd, t, obs = q_new, qd_new, t_new, carry
    traj = {k: torch.stack(v) for k, v in cols.items()}
    v_last = ppo.forward(weights, steps.normalized_obs(obs, zf), spec)[2]
    nv = torch.cat([traj["value"][1:], v_last[None]])
    traj["next_value"] = torch.where(traj["done"], torch.stack(term_values), nv)
    return {k: torch.stack(v) for k, v in rec.items()}, traj, zf


def produce(spec: dict, cfg: dict, task, weights: dict, start_rows, start_t: int,
            perms, seed: int, tf32: bool = False, fault: str | None = None) -> dict:
    """A first iteration from the benchmark's start, in the capture format
    of `drivers/ppo.py`."""
    device = start_rows.device
    zeros = {n: torch.zeros_like(w) for n, w in weights.items()}
    with precision(tf32):
        gen = torch.Generator(device=device).manual_seed(seed)
        records, traj, zf = rollout(spec, cfg, task, weights, start_rows, start_t, gen, fault)
        with torch.no_grad():
            rows = steps.update_rows(cfg, traj["obs"], traj["action"], traj["reward"],
                                     traj["done"], traj["value"], traj["next_value"],
                                     traj["log_prob"], zf)
        start = {"params": weights, "mu": zeros, "nu": zeros, "count": 0, "lr": cfg["lr"]}
        out = steps.first_steps(spec, cfg, start, rows, perms, 3, fault)
        zf_after = (ppo.zfilter_update(zf, traj["obs"])
                    if zf is not None and fault != "frozen" else zf)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    zf_cpu = None if zf is None else tuple(x.cpu() for x in zf)
    return {"start": {"weights": cpu(weights), "rows": start_rows.cpu(), "t": start_t},
            "learner": {"params": cpu(weights), "mu": cpu(zeros), "nu": cpu(zeros),
                        "count": 0, "lr_scale": 1.0, "zf": zf_cpu},
            "records": cpu(records), "traj": cpu(traj), "perms": perms.cpu(),
            "losses": out["losses"], "lrs": [cfg["lr"]] * 3, "mu1": cpu(out["mu1"]),
            "count1": out["count1"], "params1": cpu(out["params1"]),
            "params3": cpu(out["params"]), "zf_before": zf_cpu,
            "zf_after": None if zf_after is None else tuple(x.cpu() for x in zf_after)}
