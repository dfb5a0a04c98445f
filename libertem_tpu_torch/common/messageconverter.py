"""JSON parameter validation for the web API's parameters (counterpart
of ``libertem_tpu/common/messageconverter.py``): a dependency-free
structural validator of the schema subset the converters use (type,
properties, required, items, const, minItems/maxItems, minimum) and
the :class:`MessageConverter` base.
"""
from __future__ import annotations

from typing import Any


class ValidationError(ValueError):
    pass


_TYPES = {
    "object": dict,
    "array": (list, tuple),
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
}


def validate_schema(data: Any, schema: dict, path: str = "$"):
    typ = schema.get("type")
    if typ is not None:
        expected = _TYPES.get(typ)
        if expected is not None and not isinstance(data, expected):
            raise ValidationError(
                f"{path}: expected {typ}, got {type(data).__name__}"
            )
        if typ in ("number", "integer") and isinstance(data, bool):
            # bool is an int subclass; schemas asking for numbers
            # must not accept True/False
            raise ValidationError(f"{path}: expected {typ}")
    if "const" in schema and data != schema["const"]:
        raise ValidationError(
            f"{path}: expected const {schema['const']!r}"
        )
    if isinstance(data, dict):
        for key in schema.get("required", ()):
            if key not in data:
                raise ValidationError(f"{path}: missing key {key!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in data:
                validate_schema(data[key], sub, f"{path}.{key}")
    if isinstance(data, (list, tuple)):
        if "minItems" in schema and len(data) < schema["minItems"]:
            raise ValidationError(f"{path}: too few items")
        if "maxItems" in schema and len(data) > schema["maxItems"]:
            raise ValidationError(f"{path}: too many items")
        items = schema.get("items")
        if items:
            for i, item in enumerate(data):
                validate_schema(item, items, f"{path}[{i}]")
    if isinstance(data, (int, float)) and not isinstance(data, bool):
        if "minimum" in schema and data < schema["minimum"]:
            raise ValidationError(
                f"{path}: {data} < minimum {schema['minimum']}"
            )


class MessageConverter:
    SCHEMA: dict = {}

    def validate(self, raw_data: dict):
        if self.SCHEMA:
            validate_schema(raw_data, self.SCHEMA)

    def convert_to_python(self, raw_data: dict) -> dict:
        return dict(raw_data)

    def to_python(self, raw_data: dict) -> dict:
        self.validate(raw_data)
        return self.convert_to_python(raw_data)
