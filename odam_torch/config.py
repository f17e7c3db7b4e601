"""Layered YAML configuration (counterpart of ``odam_tpu/config.py``).

Merge a list of YAML files or dicts left to right with type-coercing
updates and expose the result with attribute access (the part of the JAX
package's module that the CLIs use).
"""
from __future__ import annotations

import os
from typing import Any

import yaml


class AttrDict(dict):
    """dict with attribute access (recursive)."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return AttrDict(v) if isinstance(v, dict) and not isinstance(v, AttrDict) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get(self, key, default=None):
        v = super().get(key, default)
        return AttrDict(v) if isinstance(v, dict) and not isinstance(v, AttrDict) else v


def read_yaml(path: str | None) -> dict:
    if path is None:
        return {}
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def update_dict(base: dict, new: dict) -> dict:
    """Type-coercing recursive merge (configs.py:40-58): when the base holds
    a value of some type, the incoming value is coerced to that type
    (strings "true"/"false" to bool)."""
    for key, val in new.items():
        if key in base and base[key] is not None:
            if isinstance(base[key], dict):
                base[key] = update_dict(base[key], val)
            else:
                if isinstance(base[key], bool) and isinstance(val, str):
                    val = val.lower() in ("true",)
                base[key] = type(base[key])(val)
        else:
            base[key] = val
    return base


def merge_cfg(cfg_files: list) -> AttrDict:
    """Merge YAML paths and/or dicts left-to-right (configs.py:60-76)."""
    cfg: dict = {}
    for f in cfg_files:
        if f is None:
            continue
        if isinstance(f, str):
            assert os.path.isfile(f), f"config file not found: {f}"
            cfg = update_dict(cfg, read_yaml(f))
        elif isinstance(f, dict):
            cfg = update_dict(cfg, f)
    return AttrDict(cfg)
