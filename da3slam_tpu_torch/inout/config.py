"""YAML config loading with recursive inheritance (counterpart of
``da3slam_tpu/inout/config.py``): a config may name a parent via
``inherit_from``; parents load first and children deep-merge over them."""

from __future__ import annotations

from pathlib import Path

import yaml


def load_config(path: str | Path, default_path: str | Path | None = None) -> dict:
    with open(path) as f:
        cfg_special = yaml.full_load(f) or {}

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        # relative inherit paths resolve against the child config's directory
        parent = Path(inherit_from)
        if not parent.is_absolute():
            candidate = Path(path).parent / parent
            parent = candidate if candidate.exists() else parent
        cfg = load_config(parent, default_path)
    elif default_path is not None:
        with open(default_path) as f:
            cfg = yaml.full_load(f) or {}
    else:
        cfg = {}

    update_recursive(cfg, cfg_special)
    return cfg


def update_recursive(dst: dict, src: dict) -> dict:
    """Deep-merge ``src`` over ``dst`` in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            if not isinstance(dst.get(k), dict):
                dst[k] = {}
            update_recursive(dst[k], v)
        else:
            dst[k] = v
    return dst
