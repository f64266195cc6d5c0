"""Config system (the port's own copy of surreal_tpu/config.py).

A nested attribute-access dict (`Config`), plus `extend_config(user,
base)`, which overlays user settings on a base config, rejects keys the
base does not have and enforces required-key placeholders. Configs come in
three parts (learner / env / session) built from the BASE_* defaults of
`cli/configs.py`.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Iterator, Mapping


class _Required:
    """Placeholder marking a key the user MUST supply (reference's `_req_`)."""

    def __init__(self, hint: str = ""):
        self.hint = hint

    def __repr__(self):
        return f"REQUIRED({self.hint})"


def REQUIRED(hint: str = "") -> Any:
    return _Required(hint)


class ConfigError(ValueError):
    pass


class Config(dict):
    """Nested dict with attribute access; values that are mappings are
    converted to Config recursively. JSON/YAML-free core (YAML optional)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        merged: dict = {}
        for a in args:
            if a is None:
                continue
            if not isinstance(a, Mapping):
                raise ConfigError(f"Config positional args must be mappings, got {type(a)}")
            merged.update(a)
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = v

    # -- dict/attr duality ---------------------------------------------------
    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                Config(v) if isinstance(v, Mapping) and not isinstance(v, Config) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    # -- utilities -----------------------------------------------------------
    def deepcopy(self) -> "Config":
        return copy.deepcopy(self)

    def flatten(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        for k, v in self.items():
            key = f"{prefix}{k}"
            if isinstance(v, Config):
                yield from v.flatten(key + ".")
            else:
                yield key, v

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=repr)

    @classmethod
    def loads(cls, s: str) -> "Config":
        return cls(json.loads(s))

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        """`cfg.set_dotted("algo.lr", 3e-4)` — used by CLI `--set` overrides."""
        parts = dotted_key.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = _parse_scalar(value)


def _parse_scalar(v: Any) -> Any:
    if not isinstance(v, str):
        return v
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    if v[:1] in ("[", "{"):
        try:
            return json.loads(v)
        except json.JSONDecodeError:
            return v
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def extend_config(user: Mapping | None, base: Mapping) -> Config:
    """Overlay `user` onto `base`, recursively; validate that every REQUIRED
    placeholder in `base` has been filled and that user keys exist in base
    (catching typos), mirroring the reference's extend_config semantics."""
    user = Config(user or {})
    base = Config(base)
    out = _merge(user, base, path="")
    _check_required(out, path="")
    return out


def _merge(user: Config, base: Config, path: str) -> Config:
    out = base.deepcopy()
    for k, v in user.items():
        kpath = f"{path}.{k}" if path else k
        if k not in base:
            raise ConfigError(f"Unknown config key: {kpath!r} (not in base config)")
        bv = base[k]
        if isinstance(bv, Config) and isinstance(v, Mapping):
            out[k] = _merge(Config(v), bv, kpath)
        elif isinstance(bv, Config) and not isinstance(v, Mapping) and v is not None:
            raise ConfigError(f"Config key {kpath!r} expects a nested section, got {v!r}")
        else:
            out[k] = v
    return out


def _check_required(cfg: Config, path: str) -> None:
    for k, v in cfg.items():
        kpath = f"{path}.{k}" if path else k
        if isinstance(v, _Required):
            raise ConfigError(f"Missing required config key: {kpath!r} ({v.hint})")
        if isinstance(v, Config):
            _check_required(v, kpath)
