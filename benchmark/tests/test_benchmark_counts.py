"""The operation and byte counts of benchmark/flops.py against counts made by
hand at the configuration's shapes and at the tests' tiny ones."""

from __future__ import annotations

import pytest

from benchmark import flops, profile

MLP = {"obs_dim": 17, "action_dim": 6, "hidden": [256, 256]}
TINY = {"obs_dim": 17, "action_dim": 6, "hidden": [16, 16]}


def test_mlp_counts_by_hand():
    actor = 17 * 256 + 256 * 256 + 256 * 6  # 71,424 multiply-adds
    critic = 17 * 256 + 256 * 256 + 256 * 1  # 70,144
    assert flops.forward_flops(MLP) == 2 * (actor + critic) == 283_136
    # weights' gradients: all; inputs' gradients: all but the two first layers
    assert flops.backward_flops(MLP) == 283_136 + 2 * (256 * 256 + 256 * 6 + 256 * 256 + 256)
    per_iter = flops.ppo_iteration_flops(MLP, 128, 2048, 4)
    assert per_iter == 129 * 2048 * 283_136 + 4 * 128 * 2048 * (283_136 + 548_864)
    assert abs(per_iter / 1e12 - 0.9476) < 1e-3


def test_tiny_counts_by_hand():
    actor = 17 * 16 + 16 * 16 + 16 * 6  # 624 multiply-adds
    critic = 17 * 16 + 16 * 16 + 16 * 1  # 544
    fwd = 2 * (actor + critic)
    assert fwd == 2_336 and flops.forward_flops(TINY) == fwd
    assert flops.backward_flops(TINY) == fwd + 2 * (16 * 16 + 16 * 6 + 16 * 16 + 16)
    assert flops.ppo_iteration_flops(TINY, 8, 8, 2) == 9 * 8 * fwd + 2 * 8 * 8 * (fwd + 3_584)


def test_loss_kernel_bytes_and_bounds_by_hand():
    # N = 4096, A = 6, per-row old log-std: chip_smoke.py's 475,184 and 393,268
    assert flops.loss_fwd_cost(4096, 6) == (475_184, (23 * 6 + 29) * 4096)
    assert flops.loss_bwd_cost(4096, 6) == (393_268, (22 * 6 + 40) * 4096)
    moved, ops = flops.loss_fwd_cost(32768, 6)
    assert moved == 4 * (3 * 32768 * 6 + 6 + 32768 * 6 + 5 * 32768 + 6)
    assert abs(profile.bound(moved, ops) - moved / 3.35e12) < 1e-18  # bytes bind
    assert flops.loss_fwd_cost(2048, 6, per_row_log_std_old=False)[0] == 4 * (
        3 * 2048 * 6 + 6 + 6 + 5 * 2048 + 6)


def test_busy_time_is_the_union_of_intervals():
    ev = [("a", 0, 10), ("b", 5, 10), ("c", 30, 5), ("d", 31, 1)]
    assert abs(profile.busy_seconds(ev) - 20e-9) < 1e-18
    gaps = profile.idle_gaps(ev, [("aten::step", 14, 20), ("outer", 0, 100)])
    assert gaps[0][0] == "aten::step" and gaps[0][1] == pytest.approx(15e-9) and len(gaps) == 1
