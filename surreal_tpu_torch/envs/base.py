"""Batched environment API (port of surreal_tpu/envs/base.py).

The reference writes one env as pure functions and `vmap`s it; here an
`Environment` steps a whole batch of envs held in one `EnvState` of
(B, ...) tensors. Conventions are the reference's:
- episodes are fixed-length; `discount` stays 1.0 at the time limit;
- `Timestep.done` marks the step after which the env auto-reset: `obs` is
  the terminal observation (the bootstrap target) and `carry_obs` the
  observation of the returned, already reset state (the next policy input).

Every env draws the random part of a new episode's start state with
`draw_reset(batch, generator)`: a dict of named (batch, ...) tensors holding
the sampled values, in the reference's ranges. `_init(draw)` builds
(q, qd) from them (any rejection step runs there). `reset` and `step` take
an injected `reset_draw` in place of a fresh one (tests inject the
reference's draws, recomputed from its keys, that way).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Any, Mapping

import torch

from surreal_tpu_torch.envs.physics.model import HINGE, PlanarModel
from surreal_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

# The baked assets are data files of the reference package, read in place.
ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "surreal_tpu", "envs", "assets",
)


@dataclasses.dataclass(frozen=True)
class EnvState:
    q: Tensor  # (B, nq)
    qd: Tensor  # (B, nv)
    t: Tensor  # (B,) int32 steps taken this episode

    def to_dict(self) -> dict:
        """The tensors by field name, for a checkpoint's full state."""
        return {"q": self.q, "qd": self.qd, "t": self.t}

    @classmethod
    def from_dict(cls, d: dict) -> EnvState:
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Timestep:
    obs: Mapping[str, Tensor]
    carry_obs: Mapping[str, Tensor]
    reward: Tensor  # (B,)
    discount: Tensor  # (B,)
    done: Tensor  # (B,) bool


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    shape: tuple[int, ...]
    dtype: Any
    minimum: float | None = None
    maximum: float | None = None


class Environment:
    """Subclasses implement `draw_reset`, `_init`, `_physics_step`, `_obs`,
    `_reward`, each over a batch."""

    episode_steps: int = 1000
    model: PlanarModel
    device: torch.device  # where the env batch lives
    dtype: torch.dtype

    def obs_spec(self) -> Mapping[str, ArraySpec]:
        raise NotImplementedError

    def action_spec(self) -> ArraySpec:
        raise NotImplementedError

    @property
    def action_dim(self) -> int:
        return self.action_spec().shape[0]

    def draw_reset(self, batch: int, generator: torch.Generator) -> dict[str, Tensor]:
        """The random values that `_init` turns into start states."""
        raise NotImplementedError

    def _init(self, draw: Mapping[str, Tensor]) -> tuple[Tensor, Tensor]:
        """Start state (q, qd) of new episodes from a reset draw."""
        raise NotImplementedError

    def _physics_step(self, q: Tensor, qd: Tensor, action: Tensor) -> tuple[Tensor, Tensor]:
        raise NotImplementedError

    def _obs(self, q: Tensor, qd: Tensor) -> Mapping[str, Tensor]:
        raise NotImplementedError

    def _reward(self, q: Tensor, qd: Tensor, action: Tensor) -> Tensor:
        raise NotImplementedError

    def _joint_range(self) -> Tensor:
        """The model's joint ranges (nv, 2) on the env's device and dtype."""
        return self.model.tensor("joint_range", torch.empty(0, device=self.device,
                                                            dtype=self.dtype))

    def _uniform(self, shape, generator: torch.Generator, lo=0.0, hi=1.0) -> Tensor:
        """U(lo, hi) of `shape` on the env's device; lo and hi broadcast."""
        u = torch.rand(shape, generator=generator, device=self.device, dtype=self.dtype)
        return lo + u * (hi - lo)

    def _normal(self, shape, generator: torch.Generator) -> Tensor:
        return torch.randn(shape, generator=generator, device=self.device, dtype=self.dtype)

    def reset(self, batch: int, generator: torch.Generator | None = None,
              reset_draw: Mapping[str, Tensor] | None = None) -> tuple[EnvState, Timestep]:
        if reset_draw is None:
            reset_draw = self.draw_reset(batch, generator)
        q, qd = self._init(reset_draw)
        state = EnvState(q=q, qd=qd, t=torch.zeros(batch, dtype=torch.int32, device=q.device))
        obs = self._obs(q, qd)
        ts = Timestep(obs=obs, carry_obs=obs, reward=q.new_zeros(batch),
                      discount=q.new_ones(batch),
                      done=torch.zeros(batch, dtype=torch.bool, device=q.device))
        return state, ts

    def step(self, state: EnvState, action: Tensor, generator: torch.Generator | None = None,
             reset_draw: Mapping[str, Tensor] | None = None) -> tuple[EnvState, Timestep]:
        """Steps physics; auto-resets the envs whose episode ended (the
        returned Timestep carries their terminal obs and reward).

        On a CUDA card, with no injected draw and no input that requires
        grad, the step replays CUDA graphs captured at the first call of its
        input signature (`_StepGraphs`); otherwise, and on the CPU, it runs
        op by op."""
        with span("env.step"):
            if reset_draw is None and _graphable(state, action):
                return self._step_graphs(state, action, generator).step(state, action)
            return self._step_ops(state, action, generator, reset_draw)

    def _step_ops(self, state: EnvState, action: Tensor, generator: torch.Generator | None,
                  reset_draw: Mapping[str, Tensor] | None) -> tuple[EnvState, Timestep]:
        """The step op by op."""
        with span("env.physics"):
            q, qd = self._physics_step(state.q, state.qd, action)
        with span("env.reward_obs"):
            q, qd, t, reward, obs, done, diverged = self._reward_obs(q, qd, state.t, action)
        with span("env.reset"):
            if reset_draw is None:
                reset_draw = self.draw_reset(q.shape[0], generator)
            new_state, obs, carry_obs = self._auto_reset(q, qd, t, obs, done, diverged,
                                                         reset_draw)
        return new_state, Timestep(obs=obs, carry_obs=carry_obs, reward=reward,
                                   discount=torch.ones_like(reward), done=done)

    def _reward_obs(self, q: Tensor, qd: Tensor, t: Tensor, action: Tensor):
        """(q, qd, t, reward, obs, done, diverged) after the physics."""
        t = t + 1
        # Divergence guard: a diverged env (non-finite or |x| >= 1e8)
        # scores reward 0, ends its episode and exposes the fresh
        # episode's obs.
        def finite(x):
            return torch.isfinite(x).all(-1) & (torch.amax(torch.abs(x), -1) < 1e8)

        diverged = ~(finite(q) & finite(qd))
        q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
        qd = torch.where(torch.isfinite(qd), qd, torch.zeros_like(qd))
        reward = self._reward(q, qd, action)
        obs = self._obs(q, qd)
        done = (t >= self.episode_steps) | diverged
        reward = torch.where(diverged, torch.zeros_like(reward), reward)
        return q, qd, t, reward, obs, done, diverged

    def _auto_reset(self, q, qd, t, obs, done, diverged, reset_draw):
        """(new state, obs, carry obs): the fresh state is computed for
        every env and selected by `done`, as in the reference."""
        q0, qd0 = self._init(reset_draw)
        new_state = EnvState(q=_pick(done, q0, q), qd=_pick(done, qd0, qd),
                             t=torch.where(done, torch.zeros_like(t), t))
        obs0 = self._obs(q0, qd0)
        carry_obs = {k: _pick(done, obs0[k], obs[k]) for k in obs}
        obs = {k: _pick(diverged, obs0[k], obs[k]) for k in obs}
        return new_state, obs, carry_obs

    def _step_graphs(self, state: EnvState, action: Tensor,
                     generator: torch.Generator | None) -> _StepGraphs:
        """This env's graphs for the step's input signature, captured at its
        first call. The generator and `episode_steps` are part of the
        signature: a graph holds both as they were at its capture."""
        key = (state.q.shape, state.qd.shape, state.t.shape, state.q.dtype, state.t.dtype,
               state.q.device, action.shape, action.dtype, generator, self.episode_steps)
        graphs = self.__dict__.setdefault("_graphs", {})
        if key not in graphs:
            graphs[key] = _StepGraphs(self, state, action, generator)
        return graphs[key]


def _graphable(state: EnvState, action: Tensor) -> bool:
    """The step may replay CUDA graphs: its tensors are on a card and none
    requires grad."""
    return state.q.is_cuda and not (state.q.requires_grad or state.qd.requires_grad
                                    or action.requires_grad)


class _StepGraphs:
    """An env step of one input signature as three CUDA graphs, one a span
    (`env.physics`, `env.reward_obs`, `env.reset`), sharing one memory pool
    (safe because they always replay in the order they were captured).

    Built at the signature's first call: one op-by-op step on the capture
    stream first (it fills the model's tensor caches, the allocator's pool
    and cuBLAS's workspace), the generator's state put back after it, then
    the captures. The reset graph draws from the step's generator (the
    default CUDA generator for None), so a replay advances it as the
    op-by-op step does. A call copies its inputs into the graphs' static
    inputs, replays the three graphs, and returns clones of the outputs:
    the graphs pack them into one buffer a dtype, so a call clones three,
    and what it returns is left as it is by the next replay."""

    def __init__(self, env: Environment, state: EnvState, action: Tensor,
                 generator: torch.Generator | None):
        dev = state.q.device
        self.q, self.qd, self.t, self.action = (
            x.clone() for x in (state.q, state.qd, state.t, action))
        rng = generator if generator is not None else torch.cuda.default_generators[dev.index]
        self.graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        if generator is not None:
            self.graphs[2].register_generator_state(generator)
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            saved = rng.get_state()
            with torch.cuda.stream(stream):
                env._step_ops(EnvState(self.q, self.qd, self.t), self.action, generator, None)
            rng.set_state(saved)

            def capture(i):
                return torch.cuda.graph(self.graphs[i], pool=pool, stream=stream,
                                        capture_error_mode="thread_local")

            with capture(0):
                q, qd = env._physics_step(self.q, self.qd, self.action)
            with capture(1):
                q, qd, t, reward, obs, done, diverged = env._reward_obs(q, qd, self.t,
                                                                        self.action)
            with capture(2):
                draw = env.draw_reset(q.shape[0], generator)
                new_state, obs, carry_obs = env._auto_reset(q, qd, t, obs, done, diverged, draw)
                outs = [("state", "q", new_state.q), ("state", "qd", new_state.qd),
                        ("state", "t", new_state.t), ("ts", "reward", reward),
                        ("ts", "discount", torch.ones_like(reward)), ("ts", "done", done),
                        *[("obs", k, v) for k, v in obs.items()],
                        *[("carry_obs", k, v) for k, v in carry_obs.items()]]
                by_dtype: dict[torch.dtype, list] = {}
                for part, name, v in outs:
                    by_dtype.setdefault(v.dtype, []).append((part, name, v))
                self.buffers = [torch.cat([v.reshape(-1) for _, _, v in group])
                                for group in by_dtype.values()]
            torch.cuda.current_stream().wait_stream(stream)
        # (part, name, start, end, shape) of each output in its dtype's buffer
        self.layouts = []
        for group in by_dtype.values():
            ends = list(itertools.accumulate(v.numel() for _, _, v in group))
            self.layouts.append([(part, name, end - v.numel(), end, v.shape)
                                 for (part, name, v), end in zip(group, ends)])

    def step(self, state: EnvState, action: Tensor) -> tuple[EnvState, Timestep]:
        with span("env.physics"):
            self.q.copy_(state.q)
            self.qd.copy_(state.qd)
            self.action.copy_(action)
            self.graphs[0].replay()
        with span("env.reward_obs"):
            self.t.copy_(state.t)
            self.graphs[1].replay()
        with span("env.reset"):
            self.graphs[2].replay()
        out: dict[str, dict[str, Tensor]] = {"state": {}, "ts": {}, "obs": {}, "carry_obs": {}}
        for buf, layout in zip(self.buffers, self.layouts):
            copy = buf.clone()
            for part, name, start, end, shape in layout:
                out[part][name] = copy[start:end].view(shape)
        return EnvState(**out["state"]), Timestep(obs=out["obs"], carry_obs=out["carry_obs"],
                                                  **out["ts"])


def _pick(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """Per env: a where mask (B,) is set, else b; a and b are (B, ...)."""
    return torch.where(mask.view(-1, *[1] * (a.ndim - 1)), a, b)


def flatten_obs(obs: Mapping[str, Tensor]) -> Tensor:
    """Concatenates the low-dim obs entries in sorted key order; a (B,)
    entry counts as one feature."""
    parts = [v for k, v in sorted(obs.items()) if k != "pixel"]
    max_rank = max(p.ndim for p in parts)
    parts = [p[..., None] if p.ndim < max_rank else p for p in parts]
    return torch.cat(parts, dim=-1)


def obs_flat_dim(env: Environment) -> int:
    spec = env.obs_spec()
    total = 0
    for k in sorted(spec.keys()):
        if k == "pixel":
            continue
        shape = spec[k].shape
        total += shape[0] if shape else 1
    return total


def draw_limited_and_rotational(env: Environment, batch: int,
                                generator: torch.Generator) -> dict[str, Tensor]:
    """dm_control's `randomize_limited_and_rotational_joints` draw (walker,
    hopper): every dof's U(joint range) and U(−π, π); `init_limited_and_
    rotational` keeps the first on limited joints, the second on unlimited
    hinges and 0 on unlimited slides."""
    rng, nv = env._joint_range(), env.model.nv
    return {"u_lim": env._uniform((batch, nv), generator, rng[:, 0], rng[:, 1]),
            "u_rot": env._uniform((batch, nv), generator, -math.pi, math.pi)}


def init_limited_and_rotational(env: Environment, draw: Mapping[str, Tensor]):
    m = env.model
    like = draw["u_lim"]
    limited = m.tensor("limited", like).bool()
    is_hinge = m.tensor("is_hinge_dof", like, lambda: [t == HINGE for t in m.dof_type]).bool()
    q = torch.where(limited, draw["u_lim"],
                    torch.where(is_hinge, draw["u_rot"], torch.zeros_like(like)))
    return q, torch.zeros_like(q)


def first_free(candidates, depths, *others):
    """Per env, the first of K candidates (B, K, ...) whose penetration depth
    (B, K) is ≤ 0, else the shallowest one; `others` (B, K, ...) are
    gathered at the same index. The reference's rejection step."""
    free = depths <= 0.0
    idx = torch.where(free.any(1), torch.argmax(free.to(torch.int32), 1),
                      torch.argmin(depths, 1))
    rows = torch.arange(depths.shape[0], device=depths.device)
    picked = [x[rows, idx] for x in (candidates, *others)]
    return picked[0] if not others else picked
