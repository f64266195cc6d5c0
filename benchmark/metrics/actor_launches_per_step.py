"""Launches inside the profiled rollout's `ppo.rollout.step` spans but
outside their `env.step` spans, per rollout step: the policy's forward and
sampling, the done check and its terminal-value forward, the step's
bookkeeping. None where the program records no such span. Launches and
spans as in physics_launches_per_step.py."""

from benchmark.metrics.physics_launches_per_step import launches_per


def read(ctx):
    return launches_per(ctx, "rollout", "ppo.rollout.step", "ppo.rollout.step",
                        outside="env.step")
