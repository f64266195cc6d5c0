"""Launches inside the profiled update's `ppo.update.optimizer` spans (the
gradients' global norm, the clip, Adam and the in-place apply), per
minibatch step (the number of `ppo.update.minibatch` spans). None where
the program records no such span. Launches and spans as in
physics_launches_per_step.py."""

from benchmark.metrics.physics_launches_per_step import launches_per


def read(ctx):
    return launches_per(ctx, "update", "ppo.update.optimizer", "ppo.update.minibatch")
