"""Seconds from the start of benchmark/run.py until the window opens:
imports, kernel build or load, trainer build, weights and start states, the
captured first iteration and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
