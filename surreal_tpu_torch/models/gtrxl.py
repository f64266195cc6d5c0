"""The Gated Transformer-XL torso (GTrXL; Parisotto et al., "Stabilizing
Transformers for Reinforcement Learning", ICML 2020, arXiv:1910.06764):
Transformer-XL relative-position attention (Dai et al., arXiv:1901.02860)
over a memory of the last `memory` steps, pre-layer-norm, and GRU-type
gates in place of both residual additions. A port-only torso: the JAX
package has none.

For layer l = 1..L, with E^0 = embed(obs) and M^(l-1) the layer's inputs
E^(l-1) of the previous m steps (no gradient flows into them):

    Y_bar = RelMHA(LN1([M^(l-1), E^(l-1)])), queries from E^(l-1) only
    Y     = gate1(E^(l-1), relu(Y_bar))
    E^l   = gate2(Y, relu(MLP(LN2(Y))))

with gate(x, y) = (1 - z) x + z h, r = sigmoid(W_r y + U_r x),
z = sigmoid(W_z y + U_z x - b_g), h = tanh(W_g y + U_g (r x)). The score
of query i against key j is ((q_i + u)^T k_j + (q_i + v)^T W_R R_(t_i - t_j))
/ sqrt(d_head), R the sinusoid table; a key later than the query, more than
m steps before it, before the env's episode start or in an empty slot is
masked. A query always sees its own key.

The lockstep envs share one clock `t` and so one write pointer: the step at
time t writes ring slot t % m, and slot j then holds the step at distance
((t - j - 1) mod m) + 1 of the next query. Only the validity of the slots
differs by env.

Entry points:
- `prefill(memory)`: the keys and values of every slot of the ring, and
  each layer's projected relative positions W_R R_r, r = 0..m, under the
  current weights (once per rollout: the weights do not change within it);
- `step(x, cache, t, valid)`: one position per env against the cache, then
  (unless `write=False`, a probe) its keys, values and layer inputs written
  into slot t % m;
- `segment(x_seq, memory, valid, done, t0)`: a chunk of T positions over the
  memory as it stood at the chunk's start, causal and masked, with
  gradients into the weights; it computes what T calls of `step` compute.

`compute_dtype` is the torso's, as the other blocks': parameters stay
float32, inputs and weights are cast (`blocks.linear`, `blocks.layer_norm`),
and the softmax runs in float32."""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from surreal_tpu_torch.models.blocks import layer_norm, lecun_normal_, linear
from surreal_tpu_torch.utils.profiling import span

Tensor = torch.Tensor
LN_EPS = 1e-6  # flax's LayerNorm epsilon, as the other blocks use
GATE_BIAS = 2.0  # b_g's initial value, the paper's


def sinusoid_table(n: int, width: int, device=None) -> Tensor:
    """R_r for r = 0..n-1, (n, width): Transformer-XL's [sin(r w_i), cos(r w_i)],
    w_i = 10000^(-2i / width)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, width, 2, dtype=torch.float32, device=device)
                             / width))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def slot_distances(t: int, memory: int, device=None) -> Tensor:
    """(memory,) int64: the distance from a query at time t to each ring
    slot, ((t - j - 1) mod m) + 1, in 1..m."""
    j = torch.arange(memory, device=device)
    return torch.remainder(t - 1 - j, memory) + 1


class Gate(nn.Module):
    """GTrXL's GRU-type gate g(x, y): W_r, W_z, W_g stacked in `wy`, U_r, U_z
    in `ux`, U_g in `ug`, the bias b_g (initialised to `GATE_BIAS`) that
    holds z near 0, so that a fresh layer passes x through."""

    def __init__(self, width: int, generator=None):
        super().__init__()
        self.wy = nn.Linear(width, 3 * width, bias=False)
        self.ux = nn.Linear(width, 2 * width, bias=False)
        self.ug = nn.Linear(width, width, bias=False)
        self.bg = nn.Parameter(torch.full((width,), GATE_BIAS))
        for layer in (self.wy, self.ux, self.ug):
            lecun_normal_(layer.weight, generator)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        wr, wz, wg = linear(self.wy, y).chunk(3, -1)
        ur, uz = linear(self.ux, x).chunk(2, -1)
        r = torch.sigmoid(wr + ur)
        z = torch.sigmoid(wz + uz - self.bg.to(x.dtype))
        h = torch.tanh(wg + linear(self.ug, r * x))
        return (1.0 - z) * x + z * h


class GTrXLLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp_width: int, generator=None):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of heads {heads}")
        self.heads, self.head_dim = heads, width // heads
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.q = nn.Linear(width, width, bias=False)
        self.kv = nn.Linear(width, 2 * width, bias=False)
        self.r = nn.Linear(width, width, bias=False)  # W_R
        self.u = nn.Parameter(torch.zeros(heads, self.head_dim))
        self.v = nn.Parameter(torch.zeros(heads, self.head_dim))
        self.o = nn.Linear(width, width, bias=False)
        self.gate1 = Gate(width, generator)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp1 = nn.Linear(width, mlp_width)
        self.mlp2 = nn.Linear(mlp_width, width)
        self.gate2 = Gate(width, generator)
        for layer in (self.q, self.kv, self.r, self.o, self.mlp1, self.mlp2):
            lecun_normal_(layer.weight, generator)
        nn.init.zeros_(self.mlp1.bias)
        nn.init.zeros_(self.mlp2.bias)

    def split(self, x: Tensor) -> Tensor:
        return x.reshape(*x.shape[:-1], self.heads, self.head_dim)

    def keys_values(self, x_ln: Tensor) -> tuple[Tensor, Tensor]:
        """(..., d) normalised inputs -> keys and values (..., H, d_head)."""
        k, v = linear(self.kv, x_ln).chunk(2, -1)
        return self.split(k), self.split(v)

    def positions(self, table: Tensor) -> Tensor:
        """W_R R_r for the table's rows: (m + 1, H, d_head)."""
        return self.split(linear(self.r, table))

    def finish(self, x: Tensor, attended: Tensor) -> Tensor:
        """The attention's heads (..., d) -> the layer's output E^l."""
        y = self.gate1(x, torch.relu(linear(self.o, attended)))
        mlp = linear(self.mlp2, torch.relu(linear(self.mlp1, layer_norm(self.ln2, y))))
        return self.gate2(y, torch.relu(mlp))


@dataclasses.dataclass
class GTrXLCache:
    """The decode's state within a rollout: keys and values of every ring
    slot, (L, B, H, m, d_head) each; the ring of layer inputs it was built
    from, (L, B, m, d), written in place by `step`; each layer's projected
    positions (L, m + 1, H, d_head)."""

    k: Tensor
    v: Tensor
    memory: Tensor
    pos: Tensor


class GTrXL(nn.Module):
    def __init__(self, in_dim: int, layers: int = 12, width: int = 256, heads: int = 8,
                 memory: int = 512, mlp_width: int = 1024,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.width, self.memory = layers, width, memory
        self.heads, self.head_dim = heads, width // heads
        self.compute_dtype = compute_dtype
        self.embed = nn.Linear(in_dim, width)
        lecun_normal_(self.embed.weight, generator)
        nn.init.zeros_(self.embed.bias)
        self.layers = nn.ModuleList(GTrXLLayer(width, heads, mlp_width, generator)
                                    for _ in range(layers))
        self.out_dim = width

    # ---- the ring ----
    def empty_memory(self, batch: int, device=None) -> Tensor:
        """An empty ring of layer inputs, (L, B, m, d), in the compute dtype."""
        return torch.zeros(self.num_layers, batch, self.memory, self.width,
                           dtype=self.compute_dtype, device=device)

    def _table(self, device) -> Tensor:
        return sinusoid_table(self.memory + 1, self.width, device).to(self.compute_dtype)

    @torch.no_grad()
    def prefill(self, memory: Tensor) -> GTrXLCache:
        """Keys and values of every slot of `memory` (L, B, m, d) under the
        current weights, and the projected positions."""
        with span("gtrxl.prefill"):
            L, B, m, _ = memory.shape
            H, dh = self.heads, self.head_dim
            k = torch.empty(L, B, H, m, dh, dtype=self.compute_dtype, device=memory.device)
            v = torch.empty_like(k)
            table = self._table(memory.device)
            pos = []
            for i, layer in enumerate(self.layers):
                ki, vi = layer.keys_values(layer_norm(layer.ln1, memory[i]))
                k[i].copy_(ki.transpose(1, 2))
                v[i].copy_(vi.transpose(1, 2))
                pos.append(layer.positions(table))
            return GTrXLCache(k=k, v=v, memory=memory, pos=torch.stack(pos))

    def _attend_one(self, layer: GTrXLLayer, q: Tensor, k_new: Tensor, v_new: Tensor,
                    k: Tensor, v: Tensor, pos: Tensor, dist: Tensor, valid: Tensor) -> Tensor:
        """One query per env (B, H, dh) over the layer's m cached keys (B, H,
        m, dh) and its own: the heads' outputs (B, H, dh)."""
        m = k.shape[2]
        qu, qv = q + layer.u.to(q.dtype), q + layer.v.to(q.dtype)
        content = torch.matmul(qu[:, :, None, :], k.transpose(-1, -2))[:, :, 0]  # (B, H, m)
        own = (qu * k_new).sum(-1, keepdim=True)  # (B, H, 1)
        rel = torch.einsum("bhd,rhd->bhr", qv, pos)  # (B, H, m + 1), by distance
        scores = torch.cat([content + rel[..., dist], own + rel[..., :1]], -1)
        scores = scores.to(torch.float32) / math.sqrt(self.head_dim)
        scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
        probs = torch.softmax(scores, -1).to(q.dtype)
        out = torch.matmul(probs[:, :, None, :m], v)[:, :, 0]
        return out + probs[..., m:] * v_new

    def step(self, x: Tensor, cache: GTrXLCache, t: int, valid: Tensor,
             write: bool = True) -> Tensor:
        """One position a env at time t: x (B, D) -> E^L (B, d). `valid`
        (B, m) bool: which ring slots belong to the env's episode. With
        `write`, the position's keys, values and layer inputs go into slot
        t % m (the slot of time t - m, which this query was the last to
        see)."""
        with span("gtrxl.decode"):
            B = x.shape[0]
            dist = slot_distances(t, self.memory, x.device)
            seen = torch.cat([valid, valid.new_ones(B, 1)], -1)
            e = linear(self.embed, x.to(self.compute_dtype))
            inputs, keys, values = [], [], []
            for i, layer in enumerate(self.layers):
                xn = layer_norm(layer.ln1, e)
                q = layer.split(linear(layer.q, xn))
                k_new, v_new = layer.keys_values(xn)
                with span("gtrxl.attention"):
                    att = self._attend_one(layer, q, k_new, v_new, cache.k[i], cache.v[i],
                                           cache.pos[i], dist, seen)
                inputs.append(e)
                keys.append(k_new)
                values.append(v_new)
                e = layer.finish(e, att.reshape(B, self.width))
            if write:
                with span("gtrxl.cache_write"):
                    p = t % self.memory
                    cache.k[:, :, :, p] = torch.stack(keys)
                    cache.v[:, :, :, p] = torch.stack(values)
                    cache.memory[:, :, p] = torch.stack(inputs)
            return e

    def segment(self, x_seq: Tensor, memory: Tensor, valid: Tensor, done: Tensor,
                t0: int) -> Tensor:
        """A chunk's T positions at times t0..t0+T-1, recomputed over the ring
        as it stood at time t0: x_seq (T, B, D), memory (L, B, m, d) (a
        constant: no gradient flows into it), valid (B, m) the slots' validity
        at t0, done (T, B) the chunk's episode ends (a done at step s starts a
        new episode at s + 1). Returns E^L (T, B, d), with gradients into the
        weights."""
        with span("gtrxl.segment"):
            T, B = x_seq.shape[:2]
            m, dev = self.memory, x_seq.device
            # the episode each position belongs to, counted from the chunk's start
            episode = torch.cumsum(done.to(torch.int64), 0) - done.to(torch.int64)  # (T, B)
            s = torch.arange(T, device=dev)
            mem_dist = slot_distances(t0, m, dev)[None, :] + s[:, None]  # (T, m)
            own_dist = s[:, None] - s[None, :]  # (T, T)
            dist = torch.cat([mem_dist, own_dist], -1).clamp(0, m)  # (T, m + T)
            in_window = torch.cat([mem_dist <= m, (own_dist >= 0) & (own_dist <= m)], -1)
            same = episode.T[:, :, None] == episode.T[:, None, :]  # (B, T, T)
            first = (episode.T == 0)[:, :, None] & valid[:, None, :]  # (B, T, m)
            mask = torch.cat([first, same], -1) & in_window  # (B, T, m + T)
            table = self._table(dev)
            e = linear(self.embed, x_seq.to(self.compute_dtype)).transpose(0, 1)  # (B, T, d)
            memory = memory.detach()
            for i, layer in enumerate(self.layers):
                xn = layer_norm(layer.ln1, e)
                q = layer.split(linear(layer.q, xn))  # (B, T, H, dh)
                k, v = layer.keys_values(torch.cat([layer_norm(layer.ln1, memory[i]), xn], 1))
                pos = layer.positions(table)  # (m + 1, H, dh)
                with span("gtrxl.attention"):
                    qu, qv = q + layer.u.to(q.dtype), q + layer.v.to(q.dtype)
                    content = torch.einsum("bthd,bjhd->bhtj", qu, k)
                    rel = torch.einsum("bthd,rhd->bhtr", qv, pos)
                    rel = torch.gather(rel, -1, dist.expand(*rel.shape[:2], *dist.shape))
                    scores = (content + rel).to(torch.float32) / math.sqrt(self.head_dim)
                    scores = scores.masked_fill(~mask[:, None], float("-inf"))
                    probs = torch.softmax(scores, -1).to(q.dtype)
                    att = torch.einsum("bhtj,bjhd->bthd", probs, v)
                e = layer.finish(e, att.reshape(B, T, self.width))
            return e.transpose(0, 1)
