"""Copy of the parts of ``deeplearningexamples_tpu/core/config.py`` that the
CLI uses: dataclass configs, the YAML layers and CLI overrides.

- configs are plain ``@dataclass`` trees, one per model family
- YAML layers (``--config-file``) compose in the reference's order,
  ``precision x platform x model x mode`` (reference
  ``PyTorch/Classification/ConvNets/launch.py:35-45``), read with the
  port's own ``core/yaml_subset.py``
- CLI values are parsed with ``parse_value`` and applied with ``merge``
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import fields, is_dataclass
from typing import Any, Mapping

from . import yaml_subset

__all__ = ["load_yaml_layers", "merge", "parse_value", "resolve", "to_dict"]


def to_dict(cfg: Any) -> dict:
    """Recursively convert a dataclass config to a plain dict (for logging)."""
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(to_dict(v) for v in cfg)
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def merge(cfg: Any, overrides: Mapping[str, Any]) -> Any:
    """Return a copy of dataclass ``cfg`` with a nested dict of overrides applied."""
    if not overrides:
        return cfg
    updates = {}
    field_map = {f.name: f for f in fields(cfg)}
    for k, v in overrides.items():
        if k not in field_map:
            raise KeyError(
                f"unknown config key {k!r} for {type(cfg).__name__}; "
                f"valid: {sorted(field_map)}"
            )
    for name, f in field_map.items():
        if name not in overrides:
            continue
        cur = getattr(cfg, name)
        v = overrides[name]
        if is_dataclass(cur) and isinstance(v, Mapping):
            updates[name] = merge(cur, v)
        else:
            updates[name] = v
    return dataclasses.replace(cfg, **updates)


def parse_value(s: str) -> Any:
    """Parse a CLI string into bool/int/float/list/str (YAML-subset semantics)."""
    try:
        return json.loads(s)
    except (json.JSONDecodeError, ValueError):
        pass
    low = s.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "none"):
        return None
    return s


def load_yaml_layers(
    path: str,
    *,
    precision: str | None = None,
    platform: str | None = None,
    model: str | None = None,
    mode: str | None = None,
) -> dict:
    """Compose override layers from a configs.yml-style file.

    The file holds top-level sections ``precision``, ``platform``, ``models``
    (keyed by model, then platform, then precision), and ``mode``; they merge
    in that order, later layers winning.
    """
    doc = yaml_subset.load(path) or {}
    out: dict = {}

    def deep_update(dst: dict, src: Mapping) -> None:
        for k, v in src.items():
            if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
                deep_update(dst[k], v)
            else:
                dst[k] = v if not isinstance(v, Mapping) else dict(v)

    if precision and precision in doc.get("precision", {}):
        deep_update(out, doc["precision"][precision])
    if platform and platform in doc.get("platform", {}):
        deep_update(out, doc["platform"][platform])
    if model and model in doc.get("models", {}):
        node = doc["models"][model]
        # model section may itself be layered by platform then precision
        if platform and platform in node:
            node = node[platform]
        if precision and isinstance(node, Mapping) and precision in node:
            node = node[precision]
        if isinstance(node, Mapping):
            deep_update(out, node)
    if mode and mode in doc.get("mode", {}):
        deep_update(out, doc["mode"][mode])
    return out


def resolve(
    cfg: Any,
    *,
    yaml_path: str | None = None,
    precision: str | None = None,
    platform: str | None = None,
    model: str | None = None,
    mode: str | None = None,
) -> Any:
    """``cfg`` with the YAML layers of ``yaml_path`` merged over it; the CLI
    applies its flags on top."""
    if yaml_path:
        cfg = merge(
            cfg,
            load_yaml_layers(
                yaml_path, precision=precision, platform=platform, model=model,
                mode=mode,
            ),
        )
    return cfg
