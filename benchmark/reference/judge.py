"""Judges what training iterations of the program produced against the
reference, and returns the numbers that decide `correct`.

A capture holds the program's outputs of one iteration: every env step's
state in and out, action, observations, reward and done flag; the
trajectory the update consumed; the first three optimizer steps' losses
and learning rates, Adam's first moment and the parameters after the
first step and the parameters after the third; the observation filter
before and after; and the learner's state at the iteration's start
(parameters, Adam's moments and count, the filter, the LR scale).

A run judges two iterations: the first, which starts from the benchmark's
own start (the weights and start states it made from the seed, a fresh
optimizer and filter, which the program's state is checked against
exactly); and one after the measured window, which starts from the state
that the window's updates left. The rollout cannot be replayed by the
reference on its own: its action noise and reset draws come from the
program's generator. So the reference follows it step by step from the
program's own state: each control step is recomputed from the state the
program stepped from, and each policy output from the observation the
program fed. After the window, the learner's state at the iteration's
start is the program's too (the window's iterations between are not
judged: the first iteration checks the start and the path from it). The
update is the reference's own from there: its own values, GAE, losses,
gradients and Adam on the rollout's observations, actions, rewards and
done flags.

Numbers (each the worst of both iterations; the counts summed):
- env_gap: env step, |program - reference| / (1 + |reference|) over
  states, observations and rewards of envs that did not diverge;
- wiring_faults: exact checks that count: done flags, step counters,
  resets to a start-pool state, the observation carried to the next step,
  the trajectory against the env steps, the start, the learner's state
  handed on (filter, Adam's count, the learning rate);
- policy_gap: the policy's mean, log-std, value, log-probability and the
  bootstrap values, relative as env_gap;
- noise_z: the action noise's mean and variance against a standard normal,
  in standard errors;
- loss_gap: the first three steps' losses, each gap against the larger of
  the reference's loss and the median of its three (a loss of terms that
  cancel can lie near 0);
- grad_gap: the first gradient as the optimizer got it (from Adam's first
  moment before and after the step), the worst leaf's gap of norms against
  the larger of its reference norm and the median leaf's;
- step1_change_gap: the parameters' change over the first step, likewise
  (the worst leaf), over the leaves whose reference gradient is at least a
  thousandth of the median leaf's;
- change_gap_median: the change over the three steps, the median of those
  leaves' gaps; change_gap, their worst (not compared: from the second step
  on, a minibatch row whose probability ratio lies within rounding of the
  clip's edge takes either branch of the clipped surrogate, whose gradient
  jumps there, and moves the leaf it lands in most, the mean head's, by
  one row's share; see PERF.md);
- zfilter_gap: the filter after the update.
"""

from __future__ import annotations

import math

import torch

from . import ppo, steps

SUMMED = ("wiring_faults", "skipped_envs", "leaves_left_out")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def _leaf_gaps(prog: dict, ref: dict, keep: list[str]) -> dict[str, float]:
    """Per leaf: the gap of the norms against the larger of the reference's
    norm of that leaf and of the median leaf."""
    pn = {n: float(prog[n].double().norm()) for n in keep}
    rn = {n: float(ref[n].double().norm()) for n in keep}
    med = sorted(rn.values())[len(rn) // 2]
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in keep}


def _differ(a: torch.Tensor, b: torch.Tensor, lead: int) -> int:
    """Rows (over the first `lead` axes) in which a and b differ anywhere."""
    return _count((a != b).reshape(*a.shape[:lead], -1).any(-1))


def env_numbers(cap: dict, task, device, block: int) -> dict:
    """Each recorded control step recomputed from the state the program
    stepped from: env_gap, wiring faults, envs skipped as diverged."""
    R = cap["records"]
    env_gap, faults, skipped = 0.0, 0, 0
    rows = {k: v.reshape(-1, *v.shape[2:]) for k, v in R.items()}
    n = rows["reward"].shape[0]
    for i in range(0, n, block):
        r = {k: v[i:i + block].to(device) for k, v in rows.items()}
        q2, qd2, t2, rew, done, div = task.step(r["q_in"], r["qd_in"], r["t_in"], r["action"])
        ok = ~div
        skipped += _count(div)
        faults += _count((r["done"] != done) & ok)
        nd, d = ok & ~done, ok & done
        env_gap = max(env_gap, _rel(r["q_out"][nd], q2[nd]), _rel(r["qd_out"][nd], qd2[nd]),
                      float((r["reward"][ok] - rew[ok]).abs().max()) if ok.any() else 0.0,
                      _rel(r["obs"][ok], task.obs_flat(q2, qd2)[ok]))
        faults += _count(r["t_out"][nd] != t2[nd]) + _count(r["t_out"][d] != 0)
        faults += _count(~task.pool_row_of(r["q_out"][d], r["qd_out"][d]))
        faults += _count((r["carry"][nd] != r["obs"][nd]).any(-1))
        faults += _count((r["carry"][d] != task.obs_flat(r["q_out"][d], r["qd_out"][d])
                          ).any(-1))
    if "start" in cap:  # the benchmark's states, its own first observation
        q0, qd0 = task.start(cap["start"]["rows"].to(device))
        faults += _count((R["q_in"][0].to(device) != q0).any(-1))
        faults += _count((R["qd_in"][0].to(device) != qd0).any(-1))
        faults += _count(R["t_in"][0] != cap["start"]["t"])
    # state continuity between steps
    for a, b in (("q_in", "q_out"), ("qd_in", "qd_out"), ("t_in", "t_out")):
        faults += _differ(R[a][1:], R[b][:-1], 2)
    return {"env_gap": env_gap, "skipped_envs": skipped, "wiring_faults": faults}


def learner_start(cap: dict, cfg: dict, obs_dim: int, device) -> tuple[dict, int]:
    """The learner's state the reference starts the update from, and the
    faults of the program's state against it. The first iteration starts
    from the benchmark's weights, a fresh optimizer and filter and the
    LR's scale 1; a later one from the program's state."""
    prog = cap["learner"]
    to = lambda d: {n: v.to(device) for n, v in d.items()}
    if "start" not in cap:
        zf = tuple(x.to(device) for x in prog["zf"]) if cfg["use_zfilter"] else None
        return {"params": to(prog["params"]), "mu": to(prog["mu"]), "nu": to(prog["nu"]),
                "count": prog["count"], "lr_scale": prog["lr_scale"], "zf": zf}, 0
    weights = to(cap["start"]["weights"])
    zeros = {n: torch.zeros_like(w) for n, w in weights.items()}
    ref = {"params": weights, "mu": zeros, "nu": zeros, "count": 0, "lr_scale": 1.0,
           "zf": ppo.zfilter_init(obs_dim, device) if cfg["use_zfilter"] else None}
    faults = sum(_count(prog["params"][n].to(device) != weights[n]) for n in weights)
    faults += sum(_count(prog[k][n] != 0) for k in ("mu", "nu") for n in prog[k])
    faults += int(prog["count"] != 0) + int(prog["lr_scale"] != 1.0)
    if ref["zf"] is not None:
        faults += sum(_count(a.to(device) != b) for a, b in zip(prog["zf"], ref["zf"]))
    return ref, faults


def judge_all(caps: list[dict], spec: dict, cfg: dict, task, device, block: int = 16384,
              details: dict | None = None) -> dict:
    """The numbers of several captured iterations: each number the worst of
    them, the counts summed."""
    out: dict = {}
    for i, cap in enumerate(caps):
        d = {} if details is not None else None
        nums = judge(cap, spec, cfg, task, device, block, d)
        if details is not None:
            details[i] = {"numbers": nums, **d}
        for k, v in nums.items():
            out[k] = out.get(k, 0) + v if k in SUMMED else max(v, out.get(k, v))
    return out


def judge(cap: dict, spec: dict, cfg: dict, task, device, block: int = 16384,
          details: dict | None = None) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        nums = env_numbers(cap, task, device, block)
    tr = {k: v.to(device) for k, v in cap["traj"].items()}
    R = cap["records"]
    T, B = tr["reward"].shape
    start, faults = learner_start(cap, cfg, tr["obs"].shape[-1], device)
    # the trajectory the update consumed against the env steps
    faults += _count((tr["obs"][1:].cpu() != R["carry"][:-1]).reshape(T - 1, B, -1).any(-1))
    start_obs = task.obs_flat(R["q_in"][0], R["qd_in"][0])
    faults += _count((tr["obs"][0].cpu() != start_obs).reshape(B, -1).any(-1))
    for k in ("action", "reward", "done"):
        faults += _count((tr[k].cpu() != R[k]).reshape(T, B, -1).any(-1))
    faults += _count(tr["discount"] != 1.0)
    # the learner's state handed on: Adam's count, the filter, the LR
    faults += int(cap["count1"] != start["count"] + 1)
    zf0 = start["zf"]
    if zf0 is not None:
        faults += sum(_count(a.to(device) != b) for a, b in zip(cap["zf_before"], zf0))
    lr = float(torch.tensor(start["lr_scale"], dtype=torch.float32) * cfg["lr"])
    faults += sum(int(abs(x - lr) > 1e-6 * lr) for x in cap["lrs"])
    nums["wiring_faults"] += faults
    weights = start["params"]

    with torch.no_grad():
        obs_n = steps.normalized_obs(tr["obs"], zf0)
        mean, log_std, value = steps.policy_outputs(spec, weights, obs_n, block // 8)
        logp = ppo.log_prob(mean, log_std, tr["action"])
        last = steps.normalized_obs(R["carry"][-1].to(device), zf0)
        next_value = torch.cat([value[1:], ppo.forward_rows(weights, last, spec, block // 8)[2][None]])
        done = tr["done"]
        if done.any():
            term = steps.normalized_obs(R["obs"].to(device)[done], zf0)
            next_value[done] = ppo.forward_rows(weights, term, spec, block // 8)[2]
        nums["policy_gap"] = max(_rel(tr["mean"], mean), _rel(tr["value"], value),
                                 _rel(tr["log_std"], log_std.expand_as(mean)),
                                 _rel(tr["log_prob"], logp), _rel(tr["next_value"], next_value))
        eps = ((tr["action"] - mean) * torch.exp(-log_std)).double()
        n = eps.numel()
        nums["noise_z"] = max(abs(float(eps.mean())) * math.sqrt(n),
                              abs(float(eps.var(unbiased=False)) - 1.0) / math.sqrt(2.0 / n))
        rows = steps.update_rows(cfg, tr["obs"], tr["action"], tr["reward"], done, value,
                                 next_value, logp, zf0)
    ref = steps.first_steps(spec, cfg, {**start, "lr": lr}, rows, cap["perms"].to(device), 3)
    med_loss = sorted(abs(b) for b in ref["losses"])[len(ref["losses"]) // 2]
    nums["loss_gap"] = max(abs(a - b) / max(abs(b), med_loss, 1e-12)
                           for a, b in zip(cap["losses"], ref["losses"]))
    g_prog = {n: (m.to(device) - ppo.ADAM_B1 * start["mu"][n]) / (1.0 - ppo.ADAM_B1)
              for n, m in cap["mu1"].items()}
    nums["grad_gap"] = max(_leaf_gaps(g_prog, ref["grads1"], list(ref["grads1"])).values())
    gn = {n: float(g.double().norm()) for n, g in ref["grads1"].items()}
    med = sorted(gn.values())[len(gn) // 2]
    keep = [n for n in gn if gn[n] >= 1e-3 * med]
    change = lambda params: {n: params[n].to(device) - weights[n] for n in keep}
    nums["step1_change_gap"] = max(_leaf_gaps(change(cap["params1"]), change(ref["params1"]),
                                              keep).values())
    gaps = _leaf_gaps(change(cap["params3"]), change(ref["params"]), keep)
    nums["change_gap"] = max(gaps.values())
    nums["change_gap_median"] = sorted(gaps.values())[len(gaps) // 2]
    if details is not None:
        details["change_gaps"] = gaps
        details["grad_norms"] = gn
        details["losses"] = (list(cap["losses"]), ref["losses"])
        details["lr"] = lr
    nums["leaves_left_out"] = len(gn) - len(keep)
    if zf0 is not None:
        zf_ref = ppo.zfilter_update(zf0, tr["obs"])
        nums["zfilter_gap"] = max(_rel(a.to(device).reshape(-1), b.reshape(-1))
                                  for a, b in zip(cap["zf_after"], zf_ref))
    return nums
