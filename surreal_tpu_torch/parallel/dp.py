"""Data-parallel train steps over the `data` mesh axis (port of
surreal_tpu/parallel/dp.py).

The reference `shard_map`s one jitted step over the data axis. Here each
rank is a process that holds its slice of the env batch (with its LSTM
carry, OU noise and replay shard) and calls the algorithm's step with
`axis=mesh`. The train state is replicated: every rank starts from rank
0's and applies the same averaged gradients, so it stays bitwise equal.

Each step reduces its metrics as the reference's does: `psum` of
`episodes_done` and `episode_return_sum`, `pmean` of the rest.

The train state is replicated but for ZeRO's Adam moments
(`parallel.zero`), which are split over the data axis: `replicate` leaves a
`ZeroAdamState` as it is, each rank's chunk its own. Its type says so, where
the reference's `shard_map` needs a spec of the state.

Randomness. The reference folds the shard's data index into the step's key
(`fold_in(key, axis_index(DATA_AXIS))`). Here each rank draws from its own
`torch.Generator`, made by `fold_in(generator, seed, d)` with d its index on
the data axis: data index 0 keeps the trainer's generator as it is, so a
1-rank mesh draws exactly what the one-device trainer draws; d > 0 reseeds
it with the first 64-bit word of numpy's `SeedSequence([seed, d])`. So the
time and model ranks of one data index draw alike and hold the same envs.
As the reference's trainers do ("reset all, then shard"), the starting env
states are drawn for the whole batch, on every rank, from the shared seed,
before the fold; each rank keeps its data index's slice. The steps take
`noise=` / `perms=` (and DDPG's `eps=`, `indices=`, `target_eps=`,
`aug_offsets=`) so tests can feed each rank the reference's per-shard
draws.

The algorithm modules are imported inside the makers: they import
`parallel.param_sync`, and so this package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from surreal_tpu_torch.parallel import zero
from surreal_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, data_axis_size, reduce_metrics


def fold_in(generator: torch.Generator, seed: int, index: int) -> torch.Generator:
    """The stream of data index `index`: `generator` itself for 0; else
    `generator` reseeded with SeedSequence([seed, index])'s first 64-bit
    word."""
    if index > 0:
        word = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
        generator.manual_seed(int(word))
    return generator


def _map_tensors(fn: Callable, tree):
    """`fn` over the tensors of a tree of dicts, tuples, lists and env
    states (anything with to_dict / from_dict); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if hasattr(tree, "to_dict"):
        return type(tree).from_dict(_map_tensors(fn, tree.to_dict()))
    return tree


def shard_env_batch(mesh: Mesh, tree):
    """This rank's slice of a (B, ...)-leading tree over the data axis: rows
    [d·B/S, (d+1)·B/S) for data index d of S, so env j of the rank is env
    d·B/S + j of the whole batch (the reference's P(DATA_AXIS))."""
    shards, r = data_axis_size(mesh), mesh.index[DATA_AXIS]

    def take(x):
        b = x.shape[0] // shards
        return x[r * b:(r + 1) * b].clone()

    return _map_tensors(take, tree)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, zero.ZeroAdamState):
        return []  # each data rank's chunk of the moments is its own
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    return []


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree` (modules, dataclasses, dicts, lists) set to
    rank 0's, in place, but for ZeRO's moment chunks; returns `tree`."""
    if mesh.group is not None:
        import torch.distributed as dist

        with torch.no_grad():
            for t in _tensors(tree):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


def make_sharded_ppo_step(cfg, env, flatten_obs: Callable, mesh: Mesh):
    """The data-parallel PPO step: step(state, env_state, obs, ep_ret,
    generator, noise=None, perms=None) -> (state, env_state, obs, ep_ret,
    metrics), on this rank's slice of the envs; the metrics are equal on
    every rank. Minibatches are cut from the rank's T·B/S rows, with
    `num_minibatches` unchanged."""
    from surreal_tpu_torch.algos import ppo

    def step(state, env_state, obs, ep_ret, generator, noise=None, perms=None):
        state, env_state, obs, ep_ret, metrics = ppo.train_step(
            cfg, env, flatten_obs, state, env_state, obs, ep_ret, generator, noise, perms,
            axis=mesh)
        return state, env_state, obs, ep_ret, reduce_metrics(metrics, mesh)

    return step


def make_sharded_ppo_lstm_step(cfg, env, flatten_obs: Callable, mesh: Mesh):
    """LSTM-PPO's: step(state, env_state, obs, carry, ep_ret, generator,
    noise=None, perms=None); the carry is sharded with the envs (each rank
    owns its envs' hidden state), and minibatches of whole sequences are cut
    from the rank's B/S envs."""
    from surreal_tpu_torch.algos import ppo_lstm

    def step(state, env_state, obs, carry, ep_ret, generator, noise=None, perms=None):
        state, env_state, obs, carry, ep_ret, metrics = ppo_lstm.train_step(
            cfg, env, flatten_obs, state, env_state, obs, carry, ep_ret, generator, noise,
            perms, axis=mesh)
        return state, env_state, obs, carry, ep_ret, reduce_metrics(metrics, mesh)

    return step


def make_sharded_ppo_overlap_step(cfg, env, flatten_obs: Callable, mesh: Mesh):
    """The double-buffered step (ppo.train_step_overlapped), sharded: the
    pending trajectory is the rank's own, (T, B/S, ...). Returns
    (train_step, prime): train_step(state, env_state, obs, ep_ret, pending,
    generator, noise=None, perms=None) -> (state, env_state, obs, ep_ret,
    traj, metrics); prime(state, env_state, obs, ep_ret, generator,
    noise=None) -> (traj, env_state, obs, ep_ret)."""
    from surreal_tpu_torch.algos import ppo

    def step(state, env_state, obs, ep_ret, pending, generator, noise=None, perms=None):
        state, env_state, obs, ep_ret, traj, metrics = ppo.train_step_overlapped(
            cfg, env, flatten_obs, state, env_state, obs, ep_ret, pending, generator, noise,
            perms, axis=mesh)
        return state, env_state, obs, ep_ret, traj, reduce_metrics(metrics, mesh)

    def prime(state, env_state, obs, ep_ret, generator, noise=None):
        traj, env_state, obs, ep_ret, _ = ppo.rollout(
            cfg, env, flatten_obs, state, env_state, obs, ep_ret, generator, noise)
        return traj, env_state, obs, ep_ret

    return step, prime


def make_sharded_ddpg_step(cfg, env, flatten_obs: Callable, mesh: Mesh):
    """The data-parallel DDPG step. Each rank's replay shard holds its own
    envs (`ddpg.init_replay(..., shards=S)`: the global ring's depth, B/S
    envs wide), so insert and sampling stay on the rank, and the warm-up
    gate counts the shard's transitions, as the reference's do. Returns a
    function of the ring, as the reference's does: build(replay) ->
    step(state, replay, env_state, obs, ou_state, sigma, ep_ret, generator,
    eps=None, indices=None, target_eps=None, aug_offsets=None) -> (state,
    replay, env_state, obs, ou_state, ep_ret, metrics); `sigma` is the
    rank's slice of the global noise ladder."""
    from surreal_tpu_torch.algos import ddpg

    def step(state, replay, env_state, obs, ou_state, sigma, ep_ret, generator, eps=None,
             indices=None, target_eps=None, aug_offsets=None):
        state, replay, env_state, obs, ou_state, ep_ret, metrics = ddpg.train_step(
            cfg, env, flatten_obs, state, replay, env_state, obs, ou_state, sigma, ep_ret,
            generator, eps, indices, target_eps, aug_offsets, axis=mesh)
        return state, replay, env_state, obs, ou_state, ep_ret, reduce_metrics(metrics, mesh)

    def build(replay_example):
        # the ring is the rank's own tensors: nothing to lay out
        return step

    return build
