"""Plain PyTorch reference of the GTrXL actor-critic (Parisotto et al.,
"Stabilizing Transformers for Reinforcement Learning", ICML 2020,
arXiv:1910.06764; the attention of Transformer-XL, Dai et al.,
arXiv:1901.02860) and of its PPO: float32, TF32 off, imports nothing of the
measured program.

Written from the paper's equations, position by position: every query
lists its keys explicitly, each with the time it was taken at, and a key
is seen where it lies at most m steps before the query, not after it, and
inside the query's episode. Nothing is cached and there is no ring: the
memory is kept in time order, oldest first, and each output is recomputed
through every layer from the stored layer inputs. Work is cut into blocks
of envs so that it fits.

Parameters are a dict of tensors under the names the measured network
uses. `spec` holds obs_dim, action_dim, layers, width, heads, memory,
mlp_width.

For layer l, with E^0 = W_in obs + b_in and M^(l-1) the layer's inputs of
the previous m steps:
    Y_bar = RelMHA(LN1([M, E])), Y = g1(E, relu(Y_bar)),
    E^l = g2(Y, relu(MLP(LN2(Y)))),
    g(x, y) = (1 - z) x + z tanh(W_g y + U_g (r x)),
    r = sigmoid(W_r y + U_r x), z = sigmoid(W_z y + U_z x - b_g),
    score(i, j) = ((q_i + u) . k_j + (q_i + v) . W_R R_(t_i - t_j)) / sqrt(d_head).
The heads read E^L: mean W_mu E + b_mu, value W_v E + b_v, and a
state-independent log-std clipped to [-8, 2]."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

LN_EPS = 1e-6
GATE_BIAS = 2.0  # b_g's initial value, the paper's
NEG = float("-inf")


def param_shapes(spec: dict) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter, in the network's order."""
    d, f, D = spec["width"], spec["mlp_width"], spec["obs_dim"]
    H = spec["heads"]
    shapes: dict[str, tuple[int, ...]] = {"gtrxl.embed.weight": (d, D), "gtrxl.embed.bias": (d,)}
    for i in range(spec["layers"]):
        p = f"gtrxl.layers.{i}."
        layer = {
            "ln1.weight": (d,), "ln1.bias": (d,), "q.weight": (d, d), "kv.weight": (2 * d, d),
            "r.weight": (d, d), "u": (H, d // H), "v": (H, d // H), "o.weight": (d, d),
            "gate1.wy.weight": (3 * d, d), "gate1.ux.weight": (2 * d, d),
            "gate1.ug.weight": (d, d), "gate1.bg": (d,),
            "ln2.weight": (d,), "ln2.bias": (d,), "mlp1.weight": (f, d), "mlp1.bias": (f,),
            "mlp2.weight": (d, f), "mlp2.bias": (d,),
            "gate2.wy.weight": (3 * d, d), "gate2.ux.weight": (2 * d, d),
            "gate2.ug.weight": (d, d), "gate2.bg": (d,)}
        shapes.update({p + k: s for k, s in layer.items()})
    A = spec["action_dim"]
    shapes.update({"mean_head.weight": (A, d), "mean_head.bias": (A,),
                   "value_head.weight": (1, d), "value_head.bias": (1,), "log_std": (A,)})
    return shapes


def make_weights(spec: dict, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Seeded weights, drawn on `device` in one call: matrices normal with
    variance gain^2 / fan_in (gain 0.01 on the mean head), u and v normal
    with variance 1 / d_head, the layer norms' scales 1, b_g `GATE_BIAS`,
    the other biases and the log-std 0."""
    shapes = param_shapes(spec)
    drawn = {n: s for n, s in shapes.items()
             if n.endswith("weight") and ".ln" not in n or n.endswith((".u", ".v"))}
    draw = torch.randn(sum(math.prod(s) for s in drawn.values()), generator=generator,
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            n = math.prod(shape)
            gain = 0.01 if name.startswith("mean_head") else 1.0
            out[name] = draw[at:at + n].view(shape) * (gain / math.sqrt(shape[-1]))
            at += n
        elif ".ln" in name and name.endswith("weight"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith(".bg"):
            out[name] = torch.full(shape, GATE_BIAS, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def sinusoid(n: int, width: int, device) -> torch.Tensor:
    """R_r = [sin(r w_i), cos(r w_i)], w_i = 10000^(-2i/width), r = 0..n-1."""
    w = 1.0 / (10000.0 ** (torch.arange(0, width, 2, dtype=torch.float32, device=device)
                           / width))
    a = torch.arange(n, dtype=torch.float32, device=device)[:, None] * w[None]
    return torch.cat([torch.sin(a), torch.cos(a)], -1)


def _gate(p: dict, pre: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    W_r, W_z, W_g = p[pre + ".wy.weight"].chunk(3, 0)
    U_r, U_z = p[pre + ".ux.weight"].chunk(2, 0)
    r = torch.sigmoid(y @ W_r.T + x @ U_r.T)
    z = torch.sigmoid(y @ W_z.T + x @ U_z.T - p[pre + ".bg"])
    h = torch.tanh(y @ W_g.T + (r * x) @ p[pre + ".ug.weight"].T)
    return (1.0 - z) * x + z * h


def layer(p: dict, i: int, spec: dict, x: torch.Tensor, keys_in: torch.Tensor,
          dist: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """Layer i for queries x (Q, S, d) over keys whose layer inputs are
    keys_in (Q, n, d): dist (S, n) or (Q, S, n) the query's time less the
    key's (any value where unseen), seen (Q, S, n) bool. Returns E^i
    (Q, S, d)."""
    pre = f"gtrxl.layers.{i}."
    d, H, m = spec["width"], spec["heads"], spec["memory"]
    dh = d // H
    ln1 = lambda z: F.layer_norm(z, (d,), p[pre + "ln1.weight"], p[pre + "ln1.bias"], LN_EPS)
    q = (ln1(x) @ p[pre + "q.weight"].T).unflatten(-1, (H, dh))  # (Q, S, H, dh)
    W_k, W_v = p[pre + "kv.weight"].chunk(2, 0)
    kn = ln1(keys_in)
    k = (kn @ W_k.T).unflatten(-1, (H, dh))  # (Q, n, H, dh)
    v = (kn @ W_v.T).unflatten(-1, (H, dh))
    rel = (sinusoid(m + 1, d, x.device) @ p[pre + "r.weight"].T).unflatten(-1, (H, dh))
    rel_k = rel[dist.clamp(0, m)]  # (S, n, H, dh) or (Q, S, n, H, dh)
    content = torch.einsum("qshd,qnhd->qsnh", q + p[pre + "u"], k)
    sub = "snhd" if dist.dim() == 2 else "qsnhd"
    position = torch.einsum(f"qshd,{sub}->qsnh", q + p[pre + "v"], rel_k)
    score = (content + position) / math.sqrt(dh)
    score = score.masked_fill(~seen[..., None], NEG)
    w = torch.softmax(score, dim=2)
    att = torch.einsum("qsnh,qnhd->qshd", w, v).flatten(-2)
    y = _gate(p, pre + "gate1", x, torch.relu(att @ p[pre + "o.weight"].T))
    hidden = torch.relu(F.layer_norm(y, (d,), p[pre + "ln2.weight"], p[pre + "ln2.bias"],
                                     LN_EPS) @ p[pre + "mlp1.weight"].T + p[pre + "mlp1.bias"])
    return _gate(p, pre + "gate2", y,
                 torch.relu(hidden @ p[pre + "mlp2.weight"].T + p[pre + "mlp2.bias"]))


def embed(p: dict, obs: torch.Tensor) -> torch.Tensor:
    return obs @ p["gtrxl.embed.weight"].T + p["gtrxl.embed.bias"]


def heads(p: dict, e: torch.Tensor):
    mean = e @ p["mean_head.weight"].T + p["mean_head.bias"]
    value = (e @ p["value_head.weight"].T + p["value_head.bias"])[..., 0]
    return mean, torch.clamp(p["log_std"], -8.0, 2.0), value


BEFORE = -(1 << 40)  # an episode that began before the chunk


def episode_starts(done: torch.Tensor) -> torch.Tensor:
    """(B, T + 1): the chunk step at which the episode of each step began (a
    done at step s starts one at s + 1), BEFORE where it began before the
    chunk; column T is the episode in force after the chunk."""
    T, B = done.shape
    out = torch.full((B, T + 1), BEFORE, dtype=torch.int64, device=done.device)
    for s in range(T):
        out[:, s + 1] = torch.where(done[s], torch.full_like(out[:, s], s + 1), out[:, s])
    return out


def _seen(key_time, query_time, ep_start, key_ok, m: int):
    """A key is seen where it is taken at most m steps before the query and
    not after it, in the query's episode, and holds a step (key_ok)."""
    dist = query_time - key_time
    return (dist >= 0) & (dist <= m) & (key_time >= ep_start) & key_ok


def chain(p: dict, spec: dict, memory: torch.Tensor, mem_valid: torch.Tensor,
          obs_n: torch.Tensor, done: torch.Tensor):
    """The chunk's T positions of B envs recomputed through every layer.
    memory (L, B, m, d): each layer's inputs of the m steps before the
    chunk, oldest first; mem_valid (B, m) whether each belongs to the
    env's episode at the chunk's start; obs_n (T, B, D) the normalised
    observations; done (T, B). Times count from the chunk's start: memory
    key k was taken at k - m, chunk position s at s. Returns (E^L (T, B, d),
    the layer inputs (L, B, T, d))."""
    T, B = done.shape
    m = spec["memory"]
    dev = obs_n.device
    s = torch.arange(T, device=dev)
    key_time = torch.cat([torch.arange(-m, 0, device=dev), s])  # (m + T,)
    key_ok = torch.cat([mem_valid, torch.ones(B, T, dtype=torch.bool, device=dev)], -1)
    ep_start = episode_starts(done)[:, :T]  # (B, T)
    seen = _seen(key_time[None, None, :], s[None, :, None], ep_start[:, :, None],
                 key_ok[:, None, :], m)  # (B, T, m + T)
    dist = s[:, None] - key_time[None, :]
    e = embed(p, obs_n).transpose(0, 1)  # (B, T, d)
    inputs = []
    for i in range(spec["layers"]):
        inputs.append(e)
        e = layer(p, i, spec, e, torch.cat([memory[i], e], 1), dist, seen)
    return e.transpose(0, 1), torch.stack(inputs)


def probe(p: dict, spec: dict, memory: torch.Tensor, mem_valid: torch.Tensor,
          inputs: torch.Tensor, obs_n: torch.Tensor, env: torch.Tensor,
          query_time: torch.Tensor, ep_start: torch.Tensor) -> torch.Tensor:
    """Outputs E^L (Q, d) of Q extra positions, the q-th of env `env[q]` at
    chunk time `query_time[q]`, fed obs_n (Q, D), in the episode that began
    at `ep_start[q]` (`episode_starts`' count), over the memory, the chunk's
    positions before it and itself; nothing attends to them (a terminal
    value's probe, the bootstrap after the chunk). memory and mem_valid as
    `chain` takes them, inputs (L, B, T, d) as it returns them. Returns
    (E^L (Q, d), the positions' own layer inputs (L, Q, d))."""
    T = inputs.shape[2]
    m = spec["memory"]
    dev = obs_n.device
    Q = env.shape[0]
    key_time = torch.cat([torch.arange(-m, T, device=dev)[None, :].expand(Q, -1),
                          query_time[:, None]], 1)  # (Q, m + T + 1)
    # a chunk position at the query's own time is another one (after a reset)
    own = torch.zeros(Q, m + T + 1, dtype=torch.bool, device=dev)
    own[:, -1] = True
    key_ok = torch.cat([mem_valid[env], torch.ones(Q, T + 1, dtype=torch.bool, device=dev)], -1)
    key_ok &= own | (key_time < query_time[:, None])
    seen = _seen(key_time, query_time[:, None], ep_start[:, None], key_ok, m)
    dist = query_time[:, None] - key_time
    e = embed(p, obs_n)[:, None]  # (Q, 1, d)
    own_inputs = []
    for i in range(spec["layers"]):
        own_inputs.append(e[:, 0])
        keys = torch.cat([memory[i][env], inputs[i][env], e], 1)
        e = layer(p, i, spec, e, keys, dist[:, None], seen[:, None])
    return e[:, 0], torch.stack(own_inputs)


def time_ordered(ring: torch.Tensor, t: int, dim: int) -> torch.Tensor:
    """The program's ring (slot j holds time j mod m) at clock t, oldest
    first along `dim`: index k holds time t - m + k."""
    return torch.roll(ring, -(t % ring.shape[dim]), dim)
