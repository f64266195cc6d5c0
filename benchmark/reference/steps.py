"""The reference's first optimizer steps of a PPO update, on a trajectory
whose observations, actions, rewards and done flags it is given: its own
forward (values, log-probabilities), its own GAE and advantage
normalisation, the minibatches the given permutations cut, and for each
step the clipped loss, autograd's gradients, the global-norm clip and
Adam."""

from __future__ import annotations

import torch

from . import ppo


def normalized_obs(obs: torch.Tensor, zf) -> torch.Tensor:
    return ppo.zfilter_normalize(zf, obs) if zf is not None else obs


def policy_outputs(spec: dict, weights: dict, obs_n: torch.Tensor, block: int):
    """The forward over (T, B, ...) observations: mean (T, B, A), log_std
    (A,), value (T, B)."""
    T, B = obs_n.shape[:2]
    mean, log_std, value = ppo.forward_rows(weights, obs_n.reshape(T * B, *obs_n.shape[2:]),
                                            spec, block)
    return mean.reshape(T, B, -1), log_std, value.reshape(T, B)


def first_steps(spec: dict, cfg: dict, start: dict, rows: dict, perms: torch.Tensor,
                steps: int, fault: str | None = None) -> dict:
    """`rows` holds the flat (N, ...) obs_n, action, logp_old, adv, vtarg and
    v_old; `start` the learner's state to start from (`params`, Adam's
    `mu`, `nu` and `count`) and the learning rate `lr`. Returns the losses,
    the first step's clipped gradients, Adam's first moment, count and the
    parameters after the first step, and the parameters after `steps`. Faults (a planted
    program fault, for the benchmark's own checks): 'frozen' leaves the
    parameters and Adam as they were; 'half_batch' takes each minibatch's
    loss over its first half."""
    N = rows["action"].shape[0]
    mb = N // cfg["num_minibatches"]
    params = {n: w.detach().clone().requires_grad_(True) for n, w in start["params"].items()}
    adam = ppo.Adam(start["mu"], start["nu"], start["count"])
    out = {"losses": []}
    for j in range(steps):
        e, k = divmod(j, cfg["num_minibatches"])
        idx = perms[e][k * mb:(k + 1) * mb]
        if fault == "half_batch":
            idx = idx[: mb // 2]
        b = {n: x[idx] for n, x in rows.items()}
        mean, log_std, value = ppo.forward(params, b["obs_n"], spec)
        loss = ppo.clip_loss(cfg, mean, log_std, value, b["action"], b["logp_old"], b["adv"],
                             b["vtarg"], b["v_old"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads = ppo.clip_by_global_norm(grads, cfg["max_grad_norm"])
        out["losses"].append(float(loss.detach()))
        if j == 0:
            out["grads1"] = {n: g.detach() for n, g in grads.items()}
        if fault != "frozen":
            direction = adam.direction(grads)
            with torch.no_grad():
                for n, p in params.items():
                    p.sub_(start["lr"] * direction[n])
        if j == 0:
            out["mu1"] = {n: m.clone() for n, m in adam.mu.items()}
            out["count1"] = adam.count
            out["params1"] = {n: p.detach().clone() for n, p in params.items()}
    out["params"] = {n: p.detach() for n, p in params.items()}
    return out


def update_rows(cfg: dict, traj_obs, action, reward, done, value, next_value,
                logp, zf) -> dict:
    """The flat minibatch rows of an update: GAE on the given rewards and
    done flags with the reference's values, the advantages normalised."""
    T, B = reward.shape
    adv, vtarg = ppo.gae(reward, value, next_value, torch.ones_like(reward), done,
                         cfg["gamma"], cfg["lam"])
    if cfg["normalize_adv"]:
        adv = ppo.normalize_advantages(adv)
    obs_n = normalized_obs(traj_obs, zf)
    N = T * B
    return {"obs_n": obs_n.reshape(N, *obs_n.shape[2:]), "action": action.reshape(N, -1),
            "logp_old": logp.reshape(N), "adv": adv.reshape(N), "vtarg": vtarg.reshape(N),
            "v_old": value.reshape(N)}
