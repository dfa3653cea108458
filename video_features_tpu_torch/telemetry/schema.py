"""Checked-in JSON Schemas of the telemetry records and a dependency-free
validator (port of ``video_features_tpu/telemetry/schema.py``).

:func:`validate` implements exactly the Draft-7 subset the span and health
schemas use: ``type`` (union lists and ``null`` included), ``enum``,
``required``, ``properties``, ``additionalProperties`` (bool or schema) and
``items``. An unsupported keyword raises: ignoring a constraint silently
would make the check vacuous. The schema files are copies of the JAX
package's.
"""
from __future__ import annotations

import json
import os
from typing import Any, List

SPAN_SCHEMA_PATH = os.path.join(os.path.dirname(__file__),
                                "video_span.schema.json")

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "integer": int,
    "boolean": bool,
    "null": type(None),
}

_HANDLED = {"$schema", "title", "description", "type", "enum", "required",
            "properties", "additionalProperties", "items"}


def load_span_schema() -> dict:
    with open(SPAN_SCHEMA_PATH, encoding="utf-8") as f:
        return json.load(f)


def _type_ok(value: Any, t: str) -> bool:
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    py = _TYPES[t]
    if py is int:
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, py)


def validate(value: Any, schema: dict, path: str = "$") -> List[str]:
    """The violations of ``schema`` by ``value``, one string each with its
    path (``$.stages.s``); an empty list means valid."""
    errs: List[str] = []
    unknown = set(schema) - _HANDLED
    if unknown:
        raise NotImplementedError(
            f"schema at {path} uses unsupported keywords {sorted(unknown)}; "
            "extend telemetry/schema.py before using them")
    if "enum" in schema:
        if value not in schema["enum"]:
            errs.append(f"{path}: {value!r} not in enum {schema['enum']}")
        return errs
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, tt) for tt in types):
            errs.append(f"{path}: {type(value).__name__} is not {t}")
            return errs
    if isinstance(value, dict):
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in value:
                errs.append(f"{path}: missing required key {req!r}")
        extra = schema.get("additionalProperties", True)
        for k, v in value.items():
            if k in props:
                errs.extend(validate(v, props[k], f"{path}.{k}"))
            elif extra is False:
                errs.append(f"{path}: unexpected key {k!r}")
            elif isinstance(extra, dict):
                errs.extend(validate(v, extra, f"{path}.{k}"))
    if isinstance(value, list) and "items" in schema:
        for i, v in enumerate(value):
            errs.extend(validate(v, schema["items"], f"{path}[{i}]"))
    return errs

