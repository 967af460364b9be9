"""YAML configs with recursive ``inherit_from`` chains.

Counterpart of ``glorie_slam_tpu/config.py``: a scene YAML inherits from a
dataset YAML, which seeds itself from the global defaults
(``DEFAULT_CONFIG_PATH``); child keys deep-merge over their parents.
PyYAML is imported where a file is read or written, not at import.
"""

import os
from typing import Any, Dict, Optional

DEFAULT_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "mono_point_slam.yaml")


def update_recursive(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> None:
    """Deep-merge ``dict2`` into ``dict1`` in place."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = dict()
        if isinstance(v, dict):
            if not isinstance(dict1[k], dict):
                dict1[k] = dict()
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def _read(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        return yaml.full_load(f)


def load_config(path: str, default_path: Optional[str] = None
                ) -> Dict[str, Any]:
    """Load a YAML config, following its ``inherit_from`` chain: the leaf
    wins; without ``inherit_from`` the ``default_path`` seeds the dict. A
    relative ``inherit_from`` resolves against the working directory first,
    then against the directory of the file that names it."""
    cfg_special = _read(path)
    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        if not os.path.exists(inherit_from):
            candidate = os.path.join(os.path.dirname(path), inherit_from)
            if os.path.exists(candidate):
                inherit_from = candidate
        cfg = load_config(inherit_from, default_path)
    elif default_path is not None:
        cfg = _read(default_path)
    else:
        cfg = dict()
    update_recursive(cfg, cfg_special)
    return cfg


def save_config(cfg: Dict[str, Any], path: str) -> None:
    """Write the merged config as YAML."""
    import yaml
    with open(path, "w") as fp:
        yaml.dump(cfg, fp)
