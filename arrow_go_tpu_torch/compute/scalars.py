"""Scalar values (reference arrow/scalar: Scalar at scalar.go:48,
MakeArrayFromScalar :794, parse.go, compare.go).

Port of arrow_go_tpu/compute/scalars.py. A Scalar is a Python value
with its type, inferred as the JAX package's array builder infers it
(`infer_type`: int -> int64, float -> float64, Decimal ->
decimal128(38, scale), datetime -> timestamp[us], date -> date32, ...;
no value -> the null type). `make_array_from_scalar` broadcasts one to
a HostArray with np.full of its storage value (a date as days, a
timestamp as ticks, a decimal as its unscaled value or limbs, a string
of any binary-like type as one dictionary entry, an interval as its
numpy value). A typeless null broadcasts to a column of the null type,
as in the JAX package; a union or extension scalar raises
ArrowNotImplemented, as the JAX package's builders have none for them.
"""
from __future__ import annotations

import datetime
import decimal as pydec
from typing import Any, Optional

import numpy as np

from .. import dtypes as dt
from ..device.block import (HostArray, ListViewArray, dictionary_values,
                            factorize, nested_array, null_array)
from ..ops.decimal import from_ints
from .errors import ArrowInvalid, ArrowNotImplemented

_EPOCH_DATE = datetime.date(1970, 1, 1)


def infer_type(values: list) -> dt.DataType:
    """The type the JAX package's builders infer for a Python list (the
    first non-null value decides; arrow_go_tpu/array/builders.py)."""
    v = next((x for x in values if x is not None), None)
    if v is None:
        return dt.null
    if isinstance(v, (bool, np.bool_)):
        return dt.bool_
    if isinstance(v, (int, np.integer)):
        return dt.int64
    if isinstance(v, (float, np.floating)):
        return dt.float64
    if isinstance(v, str):
        return dt.string
    if isinstance(v, (bytes, bytearray)):
        return dt.binary
    non_null = [x for x in values if x is not None]
    if isinstance(v, pydec.Decimal):
        scale = max(-x.as_tuple().exponent for x in non_null
                    if isinstance(x, pydec.Decimal))
        return dt.decimal128(38, max(scale, 0))
    if isinstance(v, datetime.datetime):
        return dt.timestamp("us")
    if isinstance(v, datetime.date):
        return dt.date32
    if isinstance(v, dict):
        keys = {}
        for item in non_null:
            for k, x in item.items():
                if k not in keys or keys[k].id == dt.TypeId.NULL:
                    keys[k] = infer_type([x])
        return dt.struct(keys)
    if isinstance(v, (list, tuple, np.ndarray)):
        return dt.list_(infer_type([x for item in non_null for x in item]))
    raise ValueError(f"cannot infer arrow type for {type(v)}")


def _unscaled(v, scale: int) -> int:
    """A decimal's unscaled value, as the JAX DecimalBuilder takes it: a
    Decimal scaled exactly (ValueError if it does not fit the scale), a
    float rounded, an int as it is."""
    if isinstance(v, pydec.Decimal):
        sign, digits, exp = v.as_tuple()
        mag = int("".join(map(str, digits)))
        shift = exp + scale
        if shift >= 0:
            mag *= 10 ** shift
        else:
            mag, r = divmod(mag, 10 ** (-shift))
            if r:
                raise ValueError(f"{v} does not fit scale {scale}")
        return -mag if sign else mag
    if isinstance(v, float):
        return int(round(v * 10 ** scale))
    return int(v)


def storage_value(v, t: dt.DataType):
    """A valid Python value of flat type t as the number its column
    stores: a date as days, a datetime as ticks of t's unit, a decimal
    as its unscaled value."""
    if t.is_decimal:
        return _unscaled(v, t.scale)
    if t.id == dt.TypeId.DATE32 and isinstance(v, datetime.date):
        return (v - _EPOCH_DATE).days
    if t.id == dt.TypeId.TIMESTAMP and isinstance(v, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
        return int((v - epoch).total_seconds() * t.unit.multiplier)
    return v


def array_of(values: list, t: dt.DataType) -> HostArray:
    """A HostArray of type t holding Python `values` (None = null):
    the children of a nested scalar's broadcast."""
    n = len(values)
    ok = np.array([v is not None for v in values], np.bool_)
    mask = None if ok.all() else ok
    if t.id == dt.TypeId.NULL:
        return null_array(n)
    if t.id in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        lens = np.array([len(v) if v is not None else 0 for v in values],
                        np.int64)
        off = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=off[1:])
        flat = [x for v in values if v is not None for x in v]
        return ListViewArray(t, mask, off, lens,
                             array_of(flat, t.value_type))
    if t.id in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST):
        lens = [len(v) if v is not None else 0 for v in values]
        off = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        flat = [x for v in values if v is not None for x in v]
        return nested_array(t, n, mask, [array_of(flat, t.value_type)],
                            off)
    if t.id == dt.TypeId.STRUCT:
        return nested_array(t, n, mask, [
            array_of([None if v is None else v.get(f.name)
                       for v in values], f.type) for f in t.fields()])
    if t.is_nested or t.id == dt.TypeId.EXTENSION:
        raise ArrowNotImplemented(f"an array of {t} from Python values")
    if t.codes_on_device:
        codes, d = factorize(dictionary_values(
            ["" if v is None else v for v in values], t), mask)
        return HostArray(codes, mask, t, d)
    if t.np_dtype is not None and t.np_dtype.names:      # an interval
        zero = (0,) * len(t.np_dtype.names)
        return HostArray(np.array([zero if v is None else tuple(v)
                                   for v in values], t.np_dtype), mask, t)
    stored = [storage_value(v, t) if v is not None else 0 for v in values]
    if t.limbs:
        return HostArray(from_ints(stored, t.limbs), mask, t)
    return HostArray(np.array(stored, dtype=t.np_dtype), mask, t)


class Scalar:
    """A single typed value (possibly null)."""

    __slots__ = ("type", "_value", "is_valid")

    def __init__(self, value: Any, type: Optional[dt.DataType] = None):
        if type is None:
            type = infer_type([value]) if value is not None else dt.null
        self.type = type
        self._value = value
        self.is_valid = value is not None

    @property
    def value(self):
        return self._value

    def as_py(self):
        return self._value

    def cast(self, to: dt.DataType, device=None) -> "Scalar":
        """The value cast to `to` through the registry's cast (a
        fixed-width cast runs on `device`, the card unless named)."""
        if self._value is None:
            return Scalar(None, to)
        from .registry import call_function
        out = call_function("cast", [make_array_from_scalar(self, 1)],
                            {"to_type": to, "options": None}, device=device)
        return Scalar(out.to_pylist()[0], to)

    def equals(self, other: "Scalar") -> bool:
        return self.type == other.type and self._value == other._value

    def __eq__(self, other):
        if isinstance(other, Scalar):
            return self.equals(other)
        return self._value == other

    def __hash__(self):
        return hash((self.type, self._value))

    def __repr__(self):
        return f"Scalar({self._value!r}: {self.type})"


def scalar(value, type: Optional[dt.DataType] = None) -> Scalar:
    return Scalar(value, type)


def make_array_from_scalar(s: Scalar, length: int) -> HostArray:
    """The scalar broadcast to `length` rows (reference
    MakeArrayFromScalar)."""
    t = s.type
    if t.id == dt.TypeId.NULL:
        return null_array(length)
    if t.is_nested or t.id == dt.TypeId.EXTENSION or (
            t.np_dtype is not None and t.np_dtype.names):
        return array_of([s.value] * length, t)
    mask = None if s.is_valid else np.zeros(length, np.bool_)
    if t.codes_on_device:
        d = dictionary_values([s.value] if s.is_valid else [], t)
        return HostArray(np.zeros(length, np.int32), mask, t, d)
    v = storage_value(s.value, t) if s.is_valid else 0
    if t.limbs:
        return HostArray(np.tile(from_ints([v], t.limbs), (length, 1)),
                         mask, t)
    return HostArray(np.full(length, v, dtype=t.np_dtype), mask, t)


def parse_scalar(t: dt.DataType, text: str) -> Scalar:
    """String -> typed scalar (reference scalar/parse.go)."""
    if t.id == dt.TypeId.BOOL:
        low = text.lower()
        if low in ("true", "1"):
            return Scalar(True, t)
        if low in ("false", "0"):
            return Scalar(False, t)
        raise ArrowInvalid(f"cannot parse {text!r} as bool")
    if t.is_integer:
        return Scalar(int(text), t)
    if t.is_floating:
        return Scalar(float(text), t)
    if t.is_decimal:
        return Scalar(pydec.Decimal(text), t)
    if t.id == dt.TypeId.DATE32:
        return Scalar(datetime.date.fromisoformat(text), t)
    if t.id == dt.TypeId.TIMESTAMP:
        return Scalar(datetime.datetime.fromisoformat(text), t)
    if t.is_binary_like:
        return Scalar(text, t)
    raise ArrowInvalid(f"cannot parse scalar of type {t}")
