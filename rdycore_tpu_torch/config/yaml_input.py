"""YAML -> Config loader (the ReadConfigFile replacement,
src/yaml_input.c:1594-1632)."""

from __future__ import annotations

import dataclasses
import os
import typing
from typing import Any, Dict, get_args, get_origin

from .schema import Config, ConfigError


def load_config(path: str, overrides: Dict[str, Any] | None = None) -> Config:
    # PyYAML is imported here, not with the module: a deck built in code
    # (config_from_dict) needs no YAML parser
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    cfg = config_from_dict(raw)
    cfg.config_dir = os.path.dirname(os.path.abspath(path))
    if not cfg.output.prefix:
        cfg.output.prefix = os.path.splitext(os.path.basename(path))[0]
    if overrides:
        _apply_overrides(cfg, overrides)
    return cfg.validate()


def config_from_dict(raw: Dict[str, Any]) -> Config:
    return _build(Config, raw, "")


def _apply_overrides(cfg, overrides: Dict[str, Any]):
    """Apply dotted-path overrides (the analogue of the reference's
    -dt / -ceed / -restart PETSc options, rdysetup.c:106-132)."""
    for key, value in overrides.items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], value)


_SYNONYMS = {
    # accepted spellings in reference yaml files
    "well_balancing": {"hr": "hydrostatic_reconstruction"},
}


def _build(cls, raw: Any, path: str):
    if raw is None:
        return cls()
    if not isinstance(raw, dict):
        raise ConfigError(f"config section '{path or cls.__name__}' must be a mapping")
    hints = typing.get_type_hints(cls)
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        k = key.replace("-", "_")
        if k not in fields:
            raise ConfigError(
                f"unknown key '{key}' in section '{path or 'root'}' "
                f"(valid: {sorted(fields)})"
            )
        kwargs[k] = _coerce(hints[k], value, f"{path}.{k}" if path else k)
    return cls(**kwargs)


def _coerce(ftype, value, path):
    origin = get_origin(ftype)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in get_args(ftype) if a is not type(None)]
        if value is None:
            return None
        return _coerce(args[0], value, path)
    if origin in (list, typing.List):
        (elem,) = get_args(ftype)
        if value is None:
            return []
        if not isinstance(value, list):
            raise ConfigError(f"'{path}' must be a list")
        return [_coerce(elem, v, f"{path}[{i}]") for i, v in enumerate(value)]
    if origin in (dict, typing.Dict):
        kt, vt = get_args(ftype)
        if value is None:
            return {}
        return {
            str(k): _coerce(vt, v, f"{path}.{k}") for k, v in value.items()
        }
    if dataclasses.is_dataclass(ftype):
        return _build(ftype, value, path)
    if ftype is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() in ("true", "yes", "on", "1")
        return bool(value)
    if ftype is int:
        return int(value)
    if ftype is float:
        return float(value)
    if ftype is str:
        s = str(value)
        return s
    if ftype is object or ftype == "object":
        return value  # number-or-expression fields keep raw type
    return value
