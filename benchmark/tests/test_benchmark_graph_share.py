"""`env_graph_share` on host events built by hand: each (name, start ns,
duration ns), as a traced run's profile holds them."""

from __future__ import annotations

from benchmark.metrics import env_graph_share


def _rollout(steps: int, graphed) -> dict:
    """`steps` rollout steps, 100 ns apart; step k's `env.step` holds a graph
    launch when graphed(k), else two kernel launches. Each step's policy
    launches a kernel outside `env.step`."""
    host = []
    for k in range(steps):
        t0 = 1000 + 100 * k
        host += [("ppo.rollout.step", t0, 90), ("ppo.rollout.policy", t0 + 1, 10),
                 ("cudaLaunchKernel", t0 + 2, 1), ("env.step", t0 + 20, 50),
                 ("env.physics", t0 + 21, 20)]
        host += ([("cudaMemcpyAsync", t0 + 22, 1), ("cudaGraphLaunch", t0 + 25, 2)]
                 if graphed(k) else
                 [("cudaLaunchKernel", t0 + 22, 1), ("cudaLaunchKernelExC", t0 + 30, 1)])
    return {"profile": {"steps": steps, "rollout": {"host": host, "device": [], "wall_s": 1.0},
                        "update": {"host": [], "device": [], "wall_s": 1.0}}}


def test_no_graph_launch_reads_0():
    assert env_graph_share.read(_rollout(4, lambda k: False)) == 0


def test_a_graph_launch_in_every_env_step_reads_100():
    assert env_graph_share.read(_rollout(4, lambda k: True)) == 100


def test_the_share_counts_steps_not_launches():
    ctx = _rollout(4, lambda k: k % 2 == 0)
    host = ctx["profile"]["rollout"]["host"]
    host.append(("cudaGraphLaunch_v10000", 1000 + 48, 1))  # a second launch in step 0
    assert env_graph_share.read(ctx) == 50


def test_a_graph_launch_outside_env_step_does_not_count():
    ctx = _rollout(2, lambda k: False)
    ctx["profile"]["rollout"]["host"].append(("cudaGraphLaunch", 1000 + 5, 2))  # the policy's
    assert env_graph_share.read(ctx) == 0


def test_without_env_step_spans_or_a_profile_it_reads_none():
    ctx = _rollout(2, lambda k: True)
    ctx["profile"]["rollout"]["host"] = [e for e in ctx["profile"]["rollout"]["host"]
                                         if e[0] != "env.step"]
    assert env_graph_share.read(ctx) is None
    assert env_graph_share.read({}) is None
