"""Dataclass configs from and to JSON.

The port's copy of ``adascale/utils/config.py``: ``load_config`` hydrates a
dataclass from None (the defaults), a dict, a JSON document or the path of a
JSON file (``~`` and environment variables expanded), with nested
dataclasses, tuples, lists, dicts, Optional fields and enums;
``config_to_dict`` / ``dump_config`` write one back. The port's sizes and
neck types are plain strings where the JAX package's are enums whose values
are those strings, so a JSON written by either package loads into the
other's config with the same fields.
"""
from __future__ import annotations

import dataclasses
import json
import os
import typing
from enum import Enum
from pathlib import Path
from typing import Any, Type, TypeVar, Union

T = TypeVar("T")


def _structure(value: Any, typ: Any) -> Any:
    origin = typing.get_origin(typ)
    args = typing.get_args(typ)
    if typ is Any or value is None:
        return value
    if origin is Union:
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == 1:
            return _structure(value, non_none[0])
        for candidate in non_none:
            try:
                return _structure(value, candidate)
            except (TypeError, ValueError):
                continue
        raise TypeError(f"Cannot structure {value!r} as {typ}")
    if dataclasses.is_dataclass(typ) and isinstance(typ, type):
        if isinstance(value, typ):
            return value
        if not isinstance(value, dict):
            raise TypeError(f"Expected dict for {typ}, got {type(value)}")
        fields = {f.name for f in dataclasses.fields(typ)}
        hints = typing.get_type_hints(typ)
        kwargs = {}
        for key, val in value.items():
            if key not in fields:
                raise TypeError(f"Unknown field {key!r} for {typ.__name__}")
            kwargs[key] = _structure(val, hints[key])
        return typ(**kwargs)
    if isinstance(typ, type) and issubclass(typ, Enum):
        return value if isinstance(value, typ) else typ(value)
    if origin is list:
        return [_structure(v, args[0] if args else Any) for v in value]
    if origin is tuple:
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_structure(v, args[0]) for v in value)
        if args:
            return tuple(_structure(v, a) for v, a in zip(value, args))
        return tuple(value)
    if origin is dict:
        kt = args[0] if args else Any
        vt = args[1] if len(args) > 1 else Any
        return {_structure(k, kt): _structure(v, vt) for k, v in value.items()}
    if typ in (int, float, str, bool):
        return typ(value)
    return value


def load_config(source: Union[None, str, Path, dict, Any], cls: Type[T]) -> T:
    """A ``cls`` from None (its defaults), an instance (returned as it is), a
    dict, a ``Path`` of a JSON file, or a string: the path of a JSON file if
    the path (``~`` and environment variables expanded) exists, else a JSON
    document."""
    if source is None:
        return cls()
    if isinstance(source, cls):
        return source
    if isinstance(source, Path):
        source = json.loads(source.read_text())
    elif isinstance(source, str):
        expanded = expand_path(source)
        if os.path.exists(expanded):
            with open(expanded) as fin:
                source = json.load(fin)
        else:
            source = json.loads(source)
    if not isinstance(source, dict):
        raise TypeError(f"Cannot load {cls.__name__} from {type(source)}")
    return _structure(source, cls)


def _unstructure(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _unstructure(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return [_unstructure(v) for v in value]
    if isinstance(value, dict):
        return {k: _unstructure(v) for k, v in value.items()}
    if isinstance(value, Path):
        return str(value)
    return value


def config_to_dict(config: Any) -> dict:
    """A dataclass config as plain JSON types (tuples as lists, enums as
    their values)."""
    return _unstructure(config)


def dump_config(config: Any, path: Union[str, Path]) -> None:
    """Write ``config_to_dict(config)`` to ``path`` as indented JSON."""
    with open(path, "w") as fout:
        json.dump(config_to_dict(config), fout, indent=2)
        fout.write("\n")


def expand_path(path: Union[str, Path]) -> str:
    """``path`` with ``~`` and environment variables expanded."""
    return os.path.expandvars(os.path.expanduser(str(path)))
