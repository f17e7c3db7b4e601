"""Layered YAML configuration (counterpart of ``odam_tpu/config.py``).

Merge a list of YAML files or dicts left to right with type-coercing
updates, apply ``key.subkey:value`` CLI overrides, snapshot the result to
YAML, and expose it with attribute access (the reference's ConfigLoader
contract, src/config/configs.py).
"""
from __future__ import annotations

import copy
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


def _nested(keys: list[str], value: Any) -> dict:
    if len(keys) == 1:
        return {keys[0]: value}
    return {keys[0]: _nested(keys[1:], value)}


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


def merge_args(cfg: dict, opts: list[str] | None) -> AttrDict:
    """Apply ``key.subkey:value`` CLI overrides (configs.py:78-95)."""
    cfg = copy.deepcopy(dict(cfg))
    if opts:
        for opt in opts:
            keys, value = opt.split(":", 1)
            cfg = update_dict(cfg, _nested(keys.split("."), value))
    return AttrDict(cfg)


def save_cfg(cfg: dict, path: str) -> None:
    """Snapshot the merged config to a YAML file (configs.py:141-163)."""
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg), f, sort_keys=False)


class ConfigLoader:
    """Drop-in class facade matching the reference API surface."""

    def merge_cfg(self, cfg_files: list) -> AttrDict:
        return merge_cfg(cfg_files)

    def merge_args(self, cfg: dict, opts: list[str] | None) -> AttrDict:
        return merge_args(cfg, opts)

    def save_cfg(self, cfg_files: list, path: str) -> None:
        save_cfg(merge_cfg(cfg_files), path)
