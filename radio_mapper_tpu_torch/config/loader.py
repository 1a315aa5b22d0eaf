"""YAML config loading: env expansion, deep merge, dataclass hydration.

Behavior parity with the reference (`config_manager.py`):
- ``${VAR}`` / ``${VAR:-default}`` expansion anywhere in the YAML, with
  numeric coercion of the result (`config_manager.py:19-56`);
- user file deep-merged over defaults (`config_manager.py:113-137,217-227`);
- validation raises on out-of-range values (`config_manager.py:229-259`);
- module-level singleton accessor (`config_manager.py:448-462`);
- example-config generation (`config_manager.py:438-446`).

Port of ``radio_mapper_tpu/config/loader.py``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import typing
from typing import Any, Dict, Optional

from radio_mapper_tpu_torch.config import schema

try:
    import yaml
except ImportError:  # pragma: no cover - a host without PyYAML still imports
    yaml = None

_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::-(.*?))?\}")


def _coerce(value: str) -> Any:
    """Numeric/bool coercion of an expanded env string."""
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        return value


def expand_env(obj: Any) -> Any:
    """Recursively expand ``${VAR:-default}`` in strings; coerce full-string
    matches to numbers/bools."""
    if isinstance(obj, dict):
        return {k: expand_env(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [expand_env(v) for v in obj]
    if isinstance(obj, str):
        full = _ENV_RE.fullmatch(obj.strip())
        if full:
            var, default = full.group(1), full.group(2)
            raw = os.environ.get(var, default if default is not None else "")
            return _coerce(raw)
        return _ENV_RE.sub(
            lambda m: os.environ.get(m.group(1), m.group(2) or ""), obj
        )
    return obj


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge; override wins (`config_manager.py:217-227`)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _hydrate(cls, data: Any):
    """Build a dataclass from a (possibly partial) dict, recursively."""
    if data is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        return data
    if not isinstance(data, dict):
        raise TypeError(f"expected mapping for {cls.__name__}, got {type(data).__name__}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        ftype = hints.get(f.name, f.type)
        origin = typing.get_origin(ftype)
        if dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _hydrate(ftype, value)
        elif origin in (list, typing.List) and value is not None:
            (elem_t,) = typing.get_args(ftype) or (Any,)
            if dataclasses.is_dataclass(elem_t):
                kwargs[f.name] = [_hydrate(elem_t, v) for v in value]
            else:
                kwargs[f.name] = list(value)
        elif origin in (tuple, typing.Tuple) and value is not None:
            kwargs[f.name] = tuple(value)
        elif origin in (dict, typing.Dict) and value is not None:
            kwargs[f.name] = {
                k: tuple(v) if isinstance(v, list) else v for k, v in value.items()
            }
        else:
            kwargs[f.name] = value
    return cls(**kwargs)


def config_to_dict(cfg: schema.Config) -> Dict:
    return dataclasses.asdict(cfg)


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Dict] = None,
    *,
    validate: bool = True,
) -> schema.Config:
    """Load defaults, deep-merge a YAML file and explicit overrides."""
    data: Dict = {}
    if path is not None:
        if yaml is None:
            raise RuntimeError("pyyaml not available; cannot read YAML config")
        with open(path) as f:
            file_data = yaml.safe_load(f) or {}
        data = deep_merge(data, expand_env(file_data))
    if overrides:
        data = deep_merge(data, expand_env(overrides))
    cfg = _hydrate(schema.Config, data)
    return cfg.validate() if validate else cfg


def generate_example_yaml(path: str) -> None:
    """Write a fully-populated example config (`config_manager.py:438-446`)."""
    if yaml is None:
        raise RuntimeError("pyyaml not available")
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(schema.Config()), f, sort_keys=False)


_GLOBAL: Optional[schema.Config] = None


def get_config(path: Optional[str] = None) -> schema.Config:
    """Global singleton accessor (`config_manager.py:448-462`)."""
    global _GLOBAL
    if _GLOBAL is None:
        if path is None:
            for candidate in ("config.yaml", "config.yml"):
                if os.path.exists(candidate):
                    path = candidate
                    break
        _GLOBAL = load_config(path)
    return _GLOBAL


def reset_config() -> None:
    global _GLOBAL
    _GLOBAL = None
