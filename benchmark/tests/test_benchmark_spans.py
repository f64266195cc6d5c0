"""The readers of the program's spans, on event lists built by hand: each
(name, start ns, duration ns), as a traced run's profile holds them."""

from __future__ import annotations

import pytest

from benchmark.metrics import (
    actor_launches_per_step,
    optimizer_launches_per_minibatch,
    physics_launches_per_step,
    rollout_transfers_per_step,
)

READERS = (actor_launches_per_step, optimizer_launches_per_minibatch,
           physics_launches_per_step, rollout_transfers_per_step)


def _step(t0: int) -> tuple[list, list]:
    """One rollout step at t0 (its span 100 ns long): host events and the
    device's, with the policy's two launches and its done check's copy
    outside `env.step`, the physics' three and the reset's one inside it."""
    host = [("ppo.rollout.step", t0, 100),
            ("ppo.rollout.policy", t0 + 1, 10),
            ("cudaLaunchKernel", t0 + 2, 1), ("cuLaunchKernel", t0 + 5, 1),
            ("env.step", t0 + 20, 50),
            ("env.physics", t0 + 21, 30),
            ("aten::mul", t0 + 22, 5), ("cudaLaunchKernel", t0 + 23, 1),
            ("cudaMemcpyAsync", t0 + 30, 2), ("cudaLaunchKernelExC", t0 + 40, 1),
            ("env.reset", t0 + 55, 10), ("cudaMemsetAsync", t0 + 56, 1),
            ("ppo.rollout.done_check", t0 + 80, 15),
            ("cudaMemcpyAsync", t0 + 81, 3), ("cudaStreamSynchronize", t0 + 84, 5)]
    device = [("void at::native::kernel_a", t0 + 4, 2), ("void at::native::kernel_b", t0 + 7, 2),
              ("void at::native::mul", t0 + 26, 2),
              ("Memcpy HtoD (Pageable -> Device)", t0 + 33, 1),
              ("void at::native::kernel_c", t0 + 42, 2),
              ("Memset (Device)", t0 + 58, 1),
              ("Memcpy DtoH (Device -> Pageable)", t0 + 86, 1)]
    return host, device


def _profile(steps: int = 2, extra_host=(), extra_device=()) -> dict:
    host, device = list(extra_host), list(extra_device)
    for k in range(steps):
        h, d = _step(1000 + 200 * k)
        host += h
        device += d
    update_host = [("ppo.update.advantages", 10, 20), ("cudaLaunchKernel", 11, 1)]
    for k in range(4):  # four minibatch steps, 3 optimizer launches each
        t0 = 100 + 100 * k
        update_host += [("ppo.update.minibatch", t0, 90),
                        ("ppo.update.loss", t0 + 1, 20), ("cudaLaunchKernel", t0 + 2, 1),
                        ("ppo.update.backward", t0 + 30, 20), ("cudaLaunchKernel", t0 + 31, 1),
                        ("ppo.update.optimizer", t0 + 60, 20),
                        *[("cudaLaunchKernel", t0 + 61 + i, 1) for i in range(3)]]
    return {"steps": steps, "horizon": 128,
            "rollout": {"host": host, "device": device, "wall_s": 1.0},
            "update": {"host": update_host, "device": [], "wall_s": 1.0}}


def test_each_reader_counts_per_step():
    ctx = {"profile": _profile()}
    assert physics_launches_per_step.read(ctx) == 3  # two kernels and the actuation copy
    assert actor_launches_per_step.read(ctx) == 3  # policy 2, done check 1
    assert rollout_transfers_per_step.read(ctx) == 2  # one HtoD, one DtoH
    assert optimizer_launches_per_minibatch.read(ctx) == 3


def test_launches_nested_in_env_step_are_not_the_actors():
    ctx = {"profile": _profile()}
    # every launch of a step: policy 2 + physics 3 + reset 1 + done check 1
    p = ctx["profile"]
    per_step = actor_launches_per_step.launches_per(ctx, "rollout", "ppo.rollout.step",
                                                    "ppo.rollout.step")
    assert per_step == 7
    assert actor_launches_per_step.read(ctx) == per_step - 3 - 1
    assert len(p["rollout"]["device"]) / p["steps"] == per_step


def test_copies_within_the_device_are_not_transfers():
    dtod = [("Memcpy DtoD (Device -> Device)", 1000 + 200 * k + 50, 1) for k in range(2)]
    ctx = {"profile": _profile(extra_device=dtod)}
    assert rollout_transfers_per_step.read(ctx) == 2


def test_a_copy_that_starts_outside_a_step_does_not_count():
    outside = [("Memcpy HtoD (Pageable -> Device)", 990, 1),
               ("Memcpy DtoH (Device -> Pageable)", 1150, 1),  # between the steps
               ("Memcpy DtoH (Device -> Pageable)", 5000, 1)]  # after the rollout
    launches = [("cudaMemcpyAsync", 989, 1), ("cudaLaunchKernel", 1120, 1)]
    ctx = {"profile": _profile(extra_host=launches, extra_device=outside)}
    assert rollout_transfers_per_step.read(ctx) == 2
    assert actor_launches_per_step.read(ctx) == 3


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_with_no_spans_a_reader_returns_none(reader):
    p = _profile()
    names = ("ppo.", "env.", "physics.")
    for part in ("rollout", "update"):
        p[part]["host"] = [e for e in p[part]["host"] if not e[0].startswith(names)]
    assert reader.read({"profile": p}) is None
    assert reader.read({"trace": False}) is None
    empty = {k: {"host": [], "device": [], "wall_s": 1.0} for k in ("rollout", "update")}
    assert reader.read({"profile": {"steps": 16, "horizon": 128, **empty}}) is None
