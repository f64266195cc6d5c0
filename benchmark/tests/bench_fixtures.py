"""Shared fixtures of the benchmark's own tests: tiny cells (a few envs, a
short horizon, narrow networks) made from the real configurations, for the
CPU. Run with `python -m pytest benchmark/tests` from the repo root."""

from __future__ import annotations

import json

import pytest

TINY = {"ppo_mlp": ("ppo_mlp.cheetah_e2048", 8)}


@pytest.fixture
def tiny_cells(tmp_path, monkeypatch):
    """The harness pointed at a folder of tiny cells, one per configuration
    (`tiny_ppo_mlp.t`), with the real cells' limits."""
    from benchmark import harness

    (tmp_path / "configs").mkdir()
    (tmp_path / "workloads").mkdir()
    for name, (cell, envs) in TINY.items():
        c = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
        c["name"] = f"tiny_{name}"
        c["hidden"] = [16, 16]
        c["ppo"].update(horizon=8, epochs=2, num_minibatches=2)
        (tmp_path / "configs" / f"tiny_{name}.json").write_text(json.dumps(c))
        w = json.loads((harness.HERE / "workloads" / f"{cell}.json").read_text())
        w["name"], w["config"] = f"tiny_{name}.t", f"tiny_{name}"
        w["traffic"].update(num_envs=envs, steps_to_episode_end=4)
        (tmp_path / "workloads" / f"tiny_{name}.t.json").write_text(json.dumps(w))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    return tmp_path
