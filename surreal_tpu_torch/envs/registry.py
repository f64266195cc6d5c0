"""`make_env` dispatch (port of surreal_tpu/envs/registry.py; cheetah-run
only so far, the other domains are queued in ROADMAP.md)."""

from __future__ import annotations

from surreal_tpu_torch.envs.base import Environment


def make_env(name: str, **kwargs) -> Environment:
    """Names accept "domain-task" and the "dm_control:domain-task" form."""
    key = name.split(":", 1)[-1]
    if key == "cheetah-run":
        from surreal_tpu_torch.envs.cheetah import CheetahRun

        return CheetahRun(**kwargs)
    raise KeyError(f"Unknown env {name!r}; the port has: ['cheetah-run']")
