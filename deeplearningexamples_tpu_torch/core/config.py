"""Copy of the parts of ``deeplearningexamples_tpu/core/config.py`` that the
CLI uses: dataclass configs and CLI overrides. The YAML layers
(``--config-file``) are not ported yet.

- configs are plain ``@dataclass`` trees, one per model family
- CLI values are parsed with ``parse_value`` and applied with ``merge``
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import fields, is_dataclass
from typing import Any, Mapping

__all__ = ["merge", "parse_value", "to_dict"]


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
