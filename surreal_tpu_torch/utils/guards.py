"""NaN / Inf guards (port of surreal_tpu/utils/guards.py).

The reference makes a non-finite value escaping a kernel loud through
`jax.experimental.checkify`; eager torch checks on the host instead:

- ``enable_checks()`` / ``checks_enabled()``: the process-wide debug switch
  (also set by the ``SURREAL_TPU_CHECKS=1`` environment variable).
- ``assert_finite(x, name)`` / ``assert_finite_tree(tree, name)``: the hook
  that hot code calls unconditionally. With checks off it returns at once
  and reads nothing from the device; with checks on it reads one flag per
  tensor and raises ``FloatingPointError`` naming the first non-finite one.
- ``checking()``: checks on for a block, the previous setting restored
  after it; the trainers' ``debug_checks=True`` runs every iteration so
  (the reference's `jit_checked`) and also checks every floating tensor of
  their state (the counterpart of checkify's float checks).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Mapping

import torch

_ENABLED = os.environ.get("SURREAL_TPU_CHECKS", "0") not in ("", "0", "false")


def enable_checks(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def checks_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def checking():
    """Checks on inside the block; the previous setting is restored after."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, True
    try:
        yield
    finally:
        _ENABLED = prev


def assert_finite(x: torch.Tensor, name: str) -> None:
    """Raises FloatingPointError if a floating `x` holds a NaN or an Inf.
    No-op (no device read) when checks are off."""
    if not _ENABLED:
        return
    if x.is_floating_point() and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite values in {name}")


def assert_finite_tree(tree, name: str) -> None:
    """assert_finite over every tensor leaf of nested dicts, lists, tuples
    and dataclasses, each named by its path as jax.tree_util.keystr writes
    it (`name['key'][0].field`)."""
    if not _ENABLED:
        return
    for path, leaf in _leaves(tree, name):
        assert_finite(leaf, path)


def _leaves(tree, path: str):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
