"""Dataclass <-> JSON reflection matching the reference's Boost.PFR layer
(reference: include/calib/io/json.h).

Writing emits BOTH positional keys ``field_N`` and member-name keys;
reading prefers named keys and falls back to positional (legacy format,
json.h:48-149; tested at tests/unit/json_test.cpp:95-104). ``Optional`` /
``None`` fields are omitted on write and reset on null/missing
(json.h:61-69, 99-116). numpy arrays serialize like the Eigen adl_serializers
(vectors -> flat arrays, matrices -> nested arrays,
include/calib/io/serialization.h:11-61).

A copy of ``calibration_tpu/io/jsonio.py``, which is JAX-free but cannot be
imported without importing JAX (``calibration_tpu/__init__.py`` imports it).
One addition: a ``torch.Tensor`` serializes through ``.detach().cpu()``.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import typing
from typing import Any, get_args, get_origin

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _class_layout(cls):
    """(fields, resolved type hints) for a dataclass — get_type_hints
    re-evaluates every annotation string on each call (measured 10%+ of the
    5P pipeline's host walk), so cache per class."""
    hints = typing.get_type_hints(cls)
    return tuple(dataclasses.fields(cls)), hints


def _is_optional(tp):
    return get_origin(tp) is typing.Union and type(None) in get_args(tp)


def _optional_inner(tp):
    args = [a for a in get_args(tp) if a is not type(None)]
    return args[0] if args else Any


def to_jsonable(value: Any) -> Any:
    """Value -> plain JSON-compatible structure."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer, np.bool_)):
        return value.item()
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out = {}
        for idx, f in enumerate(dataclasses.fields(value)):
            v = getattr(value, f.name)
            if v is None and _is_optional(f.type if not isinstance(f.type, str) else Any):
                continue
            if v is None:
                continue
            j = to_jsonable(v)
            out[f"field_{idx}"] = j
            out[f.name] = j
        return out
    if isinstance(value, dict):
        return {str(k): to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    # tensors come to the host first (np.asarray raises on a CUDA tensor)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().tolist()
    # anything else array-like
    if hasattr(value, "tolist"):
        return np.asarray(value).tolist()
    raise TypeError(f"cannot serialize {type(value)!r}")


def _coerce(j: Any, tp: Any) -> Any:
    return _coercer(tp)(j)


def _coercer(tp: Any):
    """JSON-value -> typed-value function for a type expression, built ONCE
    per distinct type (typing introspection — get_origin/get_args/issubclass
    — measured as the dominant cost of the old per-call _coerce: ~6% of the
    64-rig pipeline wall was re-walking the same annotations per value)."""
    try:
        return _coercer_cached(tp)
    except TypeError:  # unhashable type expression — build uncached
        return _build_coercer(tp)


@functools.lru_cache(maxsize=None)
def _coercer_cached(tp: Any):
    return _build_coercer(tp)


def _identity(j: Any) -> Any:
    return j


def _build_coercer(tp: Any):
    if tp is Any or tp is None:
        return _identity
    if isinstance(tp, str):
        return _identity  # unresolved forward ref; accept as-is
    if _is_optional(tp):
        inner = _coercer(_optional_inner(tp))
        return lambda j: None if j is None else inner(j)
    origin = get_origin(tp)
    if origin in (list, tuple):
        args = get_args(tp)
        inner = _coercer(args[0] if args else Any)
        if origin is tuple:
            return lambda j: tuple(inner(v) for v in j)
        return lambda j: [inner(v) for v in j]
    if origin is dict:
        args = get_args(tp)
        vt = _coercer(args[1] if len(args) == 2 else Any)
        return lambda j: {k: vt(v) for k, v in j.items()}
    if isinstance(tp, type):
        if issubclass(tp, enum.Enum):
            return tp
        if dataclasses.is_dataclass(tp):
            return functools.partial(from_jsonable, cls=tp)
        if tp is np.ndarray:
            return lambda j: np.asarray(j, dtype=np.float64)
        if tp in (int, float, str, bool):
            return tp
    return _identity


@functools.lru_cache(maxsize=None)
def _class_plan(cls):
    """Per-field read plan: (name, positional key, coercer, is_optional,
    has_default) — everything from_jsonable needs with zero typing calls at
    read time (named-first / field_N-fallback semantics, json.h:94-141)."""
    fields, hints = _class_layout(cls)
    plan = []
    for idx, f in enumerate(fields):
        tp = hints.get(f.name, Any)
        has_default = (
            f.default is not dataclasses.MISSING
            or f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
        )
        plan.append((f.name, f"field_{idx}", _coercer(tp), _is_optional(tp), has_default))
    return tuple(plan)


def from_jsonable(j: dict, cls):
    """JSON dict -> dataclass instance; named keys first, then field_N
    (json.h:94-141)."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    kwargs = {}
    for name, pos_key, coerce, optional, has_default in _class_plan(cls):
        slot_present = True
        if name in j:
            slot = j[name]
        elif pos_key in j:
            slot = j[pos_key]
        else:
            slot, slot_present = None, False

        if optional:
            kwargs[name] = None if (not slot_present or slot is None) else coerce(slot)
            continue
        if not slot_present:
            if has_default:
                continue
            raise KeyError(f"missing required field '{name}' for {cls.__name__}")
        kwargs[name] = coerce(slot)
    return cls(**kwargs)


def dumps(value: Any, **kw) -> str:
    import json

    return json.dumps(to_jsonable(value), **kw)


def loads(text: str, cls):
    import json

    return from_jsonable(json.loads(text), cls)
