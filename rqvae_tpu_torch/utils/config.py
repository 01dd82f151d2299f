"""Typed dataclass configs and their JSON loader (counterpart of
rqvae_tpu/utils/config.py; the port keeps its own copy).

Every train() kwarg is a field of a frozen dataclass; config files are the
repository's JSON dicts under ``configs/`` (enums by name, keys starting
with ``_`` are comments), and any field can be overridden with ``key=value``:

    cfg = load_config(DecoderTrainConfig, "configs/decoder_ml32m.json",
                      ["batch_size=256"])
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _coerce(value: Any, field_type: Any) -> Any:
    """Best-effort coercion of JSON/CLI values into dataclass field types."""
    if field_type is Any or value is None:
        return value
    origin = getattr(field_type, "__origin__", None)
    if origin in (tuple, list):
        args = getattr(field_type, "__args__", ())
        inner = args[0] if args else Any
        if isinstance(value, str):
            value = json.loads(value)
        return origin(_coerce(v, inner) for v in value)
    if isinstance(field_type, type) and issubclass(field_type, enum.Enum):
        if isinstance(value, field_type):
            return value
        if isinstance(value, str):
            return field_type[value.rsplit(".", 1)[-1]]
        return field_type(value)
    if field_type is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    if field_type in (int, float, str):
        return field_type(value)
    # Optional[...] and other typing constructs: try the args
    args = getattr(field_type, "__args__", None)
    if args:
        for a in args:
            if a is type(None):
                continue
            try:
                return _coerce(value, a)
            except (ValueError, KeyError, TypeError):
                continue
    return value


def from_dict(cls: Type[T], data: dict) -> T:
    """Build a dataclass from a dict, coercing field types; unknown keys are
    an error (catching config drift, which gin would silently allow)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    data = {k: v for k, v in data.items() if not k.startswith("_")}  # comments
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        f = fields[name]
        ftype = f.type
        if isinstance(ftype, str):  # postponed annotations
            ftype = _resolve_annotation(cls, name)
        kwargs[name] = _coerce(value, ftype)
    return cls(**kwargs)


def _resolve_annotation(cls, name):
    import typing

    hints = typing.get_type_hints(cls)
    return hints.get(name, Any)


def apply_overrides(data: dict, overrides: list[str]) -> dict:
    """key=value CLI overrides (dots reach into nested dicts)."""
    out = dict(data)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got: {item}")
        key, value = item.split("=", 1)
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass  # keep raw string
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def load_config(cls: Type[T], path: str | None, overrides: list[str] = ()) -> T:
    data = {}
    if path:
        with open(path) as f:
            data = json.load(f)
    data = apply_overrides(data, list(overrides))
    return from_dict(cls, data)


def config_to_dict(cfg) -> dict:
    """JSON-serializable dict (enums by name) for checkpoints/logs."""

    def conv(v):
        if isinstance(v, enum.Enum):
            return v.name
        if isinstance(v, tuple):
            return list(v)
        if dataclasses.is_dataclass(v):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
        return v

    return {f.name: conv(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
