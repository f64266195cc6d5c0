"""Judges captured training iterations of the GTrXL PPO program against the
reference (`gtrxl.py`, `gtrxl_ppo.py`), as `judge.py` judges the MLP's.

A capture holds what `judge.py`'s does (the env steps, the trajectory, the
first three optimizer steps, the learner's state at the start) and besides
the memory the trajectory stores (the ring of each layer's inputs and its
validity at the chunk's start, the clock `t0`) and the carry the rollout
handed on (the ring, its validity and the clock after the chunk).

Every rollout output is recomputed from the stored memory and the
observations the program fed: each position through every layer, with no
cache (`gtrxl.chain`), the terminal values and the bootstrap as extra
positions over the memory before the reset (`gtrxl.probe`). The update is
the reference's own from the learner's start: its values, GAE, the
minibatches of whole env sequences the given permutations cut, each
recomputed over its chunk-start memory with autograd, the clip and Adam.

Numbers (each the worst of the iterations; the counts summed), as in
`judge.py`, and:
- policy_gap: mean, log-std, value, log-probability and the bootstrap
  values (next_value), relative;
- carry_gap: the ring's slots written in the chunk against the reference's
  layer inputs of those steps, relative;
- wiring_faults also counts: the ring's other slots changed, the handed-on
  validity and clock, and a first iteration's memory not empty.
"""

from __future__ import annotations

import math

import torch

from . import gtrxl, gtrxl_ppo, judge, ppo, producer, steps

SUMMED = judge.SUMMED


def judge_all(caps: list[dict], spec: dict, cfg: dict, task, device, block: int = 64,
              details: dict | None = None) -> dict:
    out: dict = {}
    for i, cap in enumerate(caps):
        d = {} if details is not None else None
        nums = judge_one(cap, spec, cfg, task, device, block, d)
        if details is not None:
            details[i] = {"numbers": nums, **d}
        for k, v in nums.items():
            out[k] = out.get(k, 0) + v if k in SUMMED else max(v, out.get(k, v))
    return out


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def judge_one(cap: dict, spec: dict, cfg: dict, task, device, block: int = 64,
              details: dict | None = None) -> dict:
    with producer.precision(False):
        return _judge(cap, spec, cfg, task, device, block, details)


def _judge(cap, spec, cfg, task, device, block, details):
    with torch.no_grad():
        nums = judge.env_numbers(cap, task, device, 16384)
    tr = cap["traj"]
    R = cap["records"]
    T, B = tr["reward"].shape
    m, t0 = spec["memory"], int(cap["t0"])
    start, faults = judge.learner_start(cap, cfg, tr["obs"].shape[-1], device)
    # the trajectory the update consumed against the env steps
    faults += _count((tr["obs"][1:] != R["carry"][:-1]).reshape(T - 1, B, -1).any(-1))
    faults += _count((tr["obs"][0] != task.obs_flat(R["q_in"][0], R["qd_in"][0]).cpu()
                      ).reshape(B, -1).any(-1))
    for k in ("action", "reward", "done"):
        faults += _count((tr[k] != R[k]).reshape(T, B, -1).any(-1))
    faults += _count(tr["discount"] != 1.0)
    if "start" in cap:  # the benchmark's start: an empty memory, the clock at 0
        faults += int(t0 != 0) + _count(tr["valid"])
    # the learner's state handed on
    faults += int(cap["count1"] != start["count"] + 1)
    zf0 = start["zf"]
    if zf0 is not None:
        faults += sum(_count(a.to(device) != b) for a, b in zip(cap["zf_before"], zf0))
    lr = float(torch.tensor(start["lr_scale"], dtype=torch.float32) * cfg["lr"])
    faults += sum(int(abs(x - lr) > 1e-6 * lr) for x in cap["lrs"])
    weights = start["params"]
    memory_t = gtrxl.time_ordered(tr["memory"], t0, 2)  # on the host, moved in blocks
    valid_t = gtrxl.time_ordered(tr["valid"], t0, 1)
    done = tr["done"].to(device)

    with torch.no_grad():
        obs_n = steps.normalized_obs(tr["obs"].to(device), zf0)
        mean, log_std, value, inputs = gtrxl_ppo.outputs(weights, spec, memory_t, valid_t,
                                                         obs_n, done, block)
        action = tr["action"].to(device)
        logp = ppo.log_prob(mean, log_std, action)
        # the bootstrap values: after each done on the terminal observation, in
        # the episode that ended; after the chunk on the carried observation
        starts = gtrxl.episode_starts(done)  # (B, T + 1)
        d_s, d_b = torch.nonzero(done, as_tuple=True)
        env = torch.cat([d_b, torch.arange(B, device=device)])
        qtime = torch.cat([d_s + 1, torch.full((B,), T, device=device)])
        ep = torch.cat([starts[d_b, d_s], starts[:, T]])
        pobs = torch.cat([R["obs"].to(device)[d_s, d_b], R["carry"][-1].to(device)])
        pv = gtrxl_ppo.probe_values(weights, spec, memory_t, valid_t, inputs,
                                    steps.normalized_obs(pobs, zf0), env, qtime, ep, block)
        next_value = torch.cat([value[1:], pv[len(d_s):][None]])
        next_value[d_s, d_b] = pv[:len(d_s)]
        rel = judge._rel
        nums["policy_gap"] = max(rel(tr["mean"], mean.cpu()), rel(tr["value"], value.cpu()),
                                 rel(tr["log_std"], log_std.expand_as(mean).cpu()),
                                 rel(tr["log_prob"], logp.cpu()),
                                 rel(tr["next_value"], next_value.cpu()))
        eps = ((action - mean) * torch.exp(-log_std)).double()
        n = eps.numel()
        nums["noise_z"] = max(abs(float(eps.mean())) * math.sqrt(n),
                              abs(float(eps.var(unbiased=False)) - 1.0) / math.sqrt(2.0 / n))
        # the carry handed on: the chunk's last min(T, m) steps in their slots,
        # the other slots as they were; the validity; the clock
        after = cap["carry_after"]
        faults += int(int(after["t"]) != t0 + T)
        written = [(t0 + s) % m for s in range(max(T - m, 0), T)]
        kept = sorted(set(range(m)) - set(written))
        faults += _count((after["memory"][:, :, kept] != tr["memory"][:, :, kept]).any(-1))
        ring = after["memory"][:, :, written]  # (L, B, w, d)
        nums["carry_gap"] = max(rel(ring[:, i:i + block], inputs[:, i:i + block,
                                                                  max(T - m, 0):].cpu())
                                for i in range(0, B, block))
        key_time = torch.arange(T - m, T, device=device)  # the ring after, oldest first
        keep_old = torch.cat([valid_t[:, T:].to(device),
                              torch.ones(B, min(T, m), dtype=torch.bool, device=device)], -1)
        want = (key_time[None] >= starts[:, T:]) & keep_old
        got = gtrxl.time_ordered(after["valid"], t0 + T, 1).to(device)
        faults += _count(got != want)
        adv, vtarg = gtrxl_ppo.update_rows(cfg, tr["reward"].to(device), done, value, next_value)
        rows = {"obs_n": obs_n, "action": action, "logp_old": logp, "adv": adv, "vtarg": vtarg,
                "v_old": value, "done": done, "memory_t": memory_t, "valid_t": valid_t}
    nums["wiring_faults"] += faults
    del inputs
    ref = gtrxl_ppo.first_steps(spec, cfg, {**start, "lr": lr}, rows, cap["perms"].to(device), 3)
    nums.update(_update_numbers(cap, ref, start, weights, device))
    if zf0 is not None:
        zf_ref = ppo.zfilter_update(zf0, tr["obs"].to(device))
        nums["zfilter_gap"] = max(judge._rel(a.to(device).reshape(-1), b.reshape(-1))
                                  for a, b in zip(cap["zf_after"], zf_ref))
    if details is not None:
        details["losses"] = (list(cap["losses"]), ref["losses"])
    return nums


def _update_numbers(cap: dict, ref: dict, start: dict, weights: dict, device) -> dict:
    """loss_gap, grad_gap, step1_change_gap, change_gap and its median leaf,
    leaves_left_out: as `judge.py` computes them."""
    nums = {}
    med_loss = sorted(abs(b) for b in ref["losses"])[len(ref["losses"]) // 2]
    nums["loss_gap"] = max(abs(a - b) / max(abs(b), med_loss, 1e-12)
                           for a, b in zip(cap["losses"], ref["losses"]))
    g_prog = {n: (mu.to(device) - ppo.ADAM_B1 * start["mu"][n]) / (1.0 - ppo.ADAM_B1)
              for n, mu in cap["mu1"].items()}
    nums["grad_gap"] = max(judge._leaf_gaps(g_prog, ref["grads1"], list(ref["grads1"])).values())
    gn = {n: float(g.double().norm()) for n, g in ref["grads1"].items()}
    med = sorted(gn.values())[len(gn) // 2]
    keep = [n for n in gn if gn[n] >= 1e-3 * med]
    change = lambda params: {n: params[n].to(device) - weights[n] for n in keep}
    nums["step1_change_gap"] = max(judge._leaf_gaps(change(cap["params1"]),
                                                    change(ref["params1"]), keep).values())
    gaps = judge._leaf_gaps(change(cap["params3"]), change(ref["params"]), keep)
    nums["change_gap"] = max(gaps.values())
    nums["change_gap_median"] = sorted(gaps.values())[len(gaps) // 2]
    nums["leaves_left_out"] = len(gn) - len(keep)
    return nums
