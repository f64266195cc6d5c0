"""Versioned parameter snapshots (port of surreal_tpu/parallel/param_sync.py,
single device).

Training on one device has no staleness by default: the rollout acts on the
learner's own parameters. With `publish_every > 1` the rollout acts on a
snapshot that adopts the learner's parameters only once `publish_every`
updates have gone by since its version, which restores the lag of a
learner that publishes to separate actors.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class ParamSyncState:
    actor_params: nn.Module  # the snapshot the rollouts act on
    version: int  # learner update step at snapshot time


def param_sync_init(module: nn.Module) -> ParamSyncState:
    return ParamSyncState(actor_params=copy.deepcopy(module).requires_grad_(False), version=0)


def param_sync_refresh(sync: ParamSyncState, learner: nn.Module, learner_step: int,
                       publish_every: int = 1) -> ParamSyncState:
    """Adopts the learner's parameters, in place, when `publish_every`
    updates have elapsed since the snapshot's version."""
    if learner_step - sync.version >= publish_every:
        with torch.no_grad():
            for snap, live in zip(sync.actor_params.parameters(), learner.parameters()):
                snap.copy_(live)
        sync.version = learner_step
    return sync
