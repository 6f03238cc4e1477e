"""Config system: YAML files + dotted-key command-line overrides.

Port of the JAX package's config module, unchanged in behaviour: a
command's defaults are a nested dict, optionally overlaid by a YAML file
(`--config path`) and then by KEY.SUBKEY=VALUE overrides, each value
parsed as JSON where it parses (else kept as a string). `yaml` is imported
only where a file is read or written, so a run driven by overrides alone
needs no YAML package.
"""

from __future__ import annotations

import copy
import json
import os
import os.path as osp
from typing import Any, Optional


def _parse_value(text: str) -> Any:
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


def set_by_dotted(cfg: dict, key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def get_by_dotted(cfg: dict, key: str, default=None):
    node = cfg
    for p in key.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node


def deep_update(base: dict, overlay: dict) -> dict:
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(
    defaults: dict,
    config_file: Optional[str] = None,
    overrides: Optional[list[str]] = None,
) -> dict:
    """defaults (deep-copied) <- the YAML file <- the K=V overrides."""
    cfg = copy.deepcopy(defaults)
    if config_file:
        import yaml

        with open(config_file) as f:
            deep_update(cfg, yaml.safe_load(f) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be KEY=VALUE, got {ov!r}")
        key, value = ov.split("=", 1)
        set_by_dotted(cfg, key, _parse_value(value))
    return cfg


def format_config_tree(cfg: dict, indent: int = 0) -> str:
    """The resolved config as an indented tree, keys sorted."""
    lines = []
    pad = "  " * indent
    for key in sorted(cfg, key=str):
        val = cfg[key]
        if isinstance(val, dict):
            lines.append(f"{pad}{key}:")
            lines.append(format_config_tree(val, indent + 1))
        else:
            lines.append(f"{pad}{key}: {val!r}")
    return "\n".join(line for line in lines if line)


def print_config(cfg: dict) -> None:
    print(format_config_tree(cfg))


def snapshot_config(cfg: dict, run_dir: str) -> str:
    """Write the resolved config to <run_dir>/config.yaml."""
    import yaml

    os.makedirs(run_dir, exist_ok=True)
    path = osp.join(run_dir, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path
