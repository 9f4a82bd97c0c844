"""YAML config loading with ``inherit_from`` chains.

A config may name a parent file through ``inherit_from`` (relative to its
own directory); parents load recursively and the child's keys override the
parent's, dictionaries merged key by key. PyYAML is imported by
``load_config`` only, so the package imports where it is not installed.
"""

from __future__ import annotations

import os
from typing import Any, Dict


def merge_config(child: Dict[str, Any],
                 parent: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``child`` over ``parent`` (child wins)."""
    out = dict(parent)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_config(v, out[k])
        else:
            out[k] = v
    return out


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parent_path = cfg.pop("inherit_from", None)
    if parent_path:
        if not os.path.isabs(parent_path):
            parent_path = os.path.join(os.path.dirname(path), parent_path)
        cfg = merge_config(cfg, load_config(parent_path))
    return cfg
