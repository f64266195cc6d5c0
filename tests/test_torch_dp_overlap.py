"""The port's sharded overlapped PPO step against the reference's
`make_sharded_ppo_overlap_step`: the priming rollout and two chained steps,
by 2 gloo ranks against 2 of the 8 virtual CPU devices, with the
reference's per-shard draws and tests/test_torch_dp.py's checks and bars
(a file of its own to keep each file's run short)."""

import pytest

from test_torch_dp import (
    build_case,
    check_bitwise_equal_learners,
    check_local_kls_straddle,
    check_matches_reference,
)


@pytest.fixture(scope="module")
def overlap_case(tmp_path_factory):
    return build_case("overlap", tmp_path_factory)


def test_sharded_overlap_steps_match_the_reference(overlap_case):
    check_matches_reference(overlap_case)


def test_overlap_local_kls_straddle_the_threshold(overlap_case):
    check_local_kls_straddle(overlap_case)


def test_overlap_learner_is_bitwise_equal_across_ranks(overlap_case):
    check_bitwise_equal_learners(overlap_case)
