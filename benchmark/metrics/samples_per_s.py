"""Transitions collected and learned from in the window, over the window's
whole time on the host clock (whole iterations, a synchronise at each end):
the trainer's steps_per_iteration x iterations."""


def read(ctx):
    w = ctx["window"]
    return w["samples"] / w["seconds"]
