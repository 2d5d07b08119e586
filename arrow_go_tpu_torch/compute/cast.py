"""Cast kernels.

Port of arrow_go_tpu/compute/cast.py (reference arrow/compute/cast.go:80
and internal/kernels/{numeric_cast,boolean_cast,string_casts,
cast_temporal}.go). `cast_device` runs on the column's device:
numeric <-> numeric, bool <-> numeric, temporal rescaling by a constant
factor, and the decode of a numeric-valued dictionary; each safety
check is one device reduction read once on the host. `cast_host` runs
the casts with a binary-like side over HostArrays (strings live on the
host by design): among them string <-> decimal, the only decimal casts
the JAX package has (every other cast to or from a decimal raises
ArrowNotImplemented there and here), the casts among the six
binary-like types (a re-typed dictionary: the JAX package rebuilds
every row where the layout changes) and among list, large_list,
list_view, large_list_view and fixed_size_list (one gather of the kept
child rows).

The values convert as the JAX package's `astype` does (ops/convert.py):
integers wrap, and with the checks off a float becomes an integer by
truncation, NaN as 0 and an out-of-range value as the target's minimum
or maximum. As in the JAX package, only two types with a time unit
rescale: date32 and date64 have none, so a cast between them and a
timestamp keeps the stored number.
"""
from __future__ import annotations

import datetime as _dt
import decimal as pydec
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..device.block import DeviceColumn, HostArray, factorize, valid_rows
from ..ops.convert import convert, int_range, storage_view
from ..ops.decimal import from_ints
from .errors import ArrowInvalid, ArrowNotImplemented


@dataclass
class CastOptions:
    """Safety toggles (reference compute.CastOptions)."""

    allow_int_overflow: bool = False
    allow_time_truncate: bool = False
    allow_float_truncate: bool = False
    allow_invalid_utf8: bool = False

    @staticmethod
    def safe() -> "CastOptions":
        return CastOptions()

    @staticmethod
    def unsafe() -> "CastOptions":
        return CastOptions(True, True, True, True)


LIST_KINDS = (dt.TypeId.LIST, dt.TypeId.LARGE_LIST,
              dt.TypeId.FIXED_SIZE_LIST, dt.TypeId.LIST_VIEW,
              dt.TypeId.LARGE_LIST_VIEW)
_LIST_VIEWS = (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW)


def _fixed(t: dt.DataType) -> bool:
    """bool, numeric and temporal types stored one number a row (not
    the structured day_time / month_day_nano intervals)."""
    return (t.is_numeric or t == dt.bool_ or t.is_temporal) and \
        t.torch_dtype is not None


def can_cast(from_t: dt.DataType, to_t: dt.DataType) -> bool:
    if from_t == to_t or _fixed(from_t) and _fixed(to_t):
        return True
    if from_t.id == dt.TypeId.DICTIONARY:
        return can_cast(from_t.value_type, to_t)
    if from_t.is_binary_like and (to_t.is_binary_like or to_t.is_numeric):
        return True
    if from_t.id in LIST_KINDS and to_t.id in LIST_KINDS:
        return can_cast(from_t.value_type, to_t.value_type)
    return to_t.is_binary_like and (from_t.is_numeric or from_t == dt.bool_)


def _valid(col: DeviceColumn) -> torch.Tensor:
    return valid_rows(col.validity, col.padded, col.length, col.device)


def _narrowing(a: dt.DataType, b: dt.DataType) -> bool:
    if a.is_floating and b.is_integer:
        return True
    if a.is_integer and b.is_integer:
        return a.bit_width > b.bit_width or (
            a.is_signed_integer != b.is_signed_integer)
    return False


def _rescale(col: DeviceColumn, to_t: dt.DataType,
             options: CastOptions) -> DeviceColumn:
    """Temporal -> temporal: the int64 ticks times or floor-divided by
    the ratio of the units when both types have one."""
    from_t = col.type
    v = col.values.to(torch.int64)
    f_unit, t_unit = getattr(from_t, "unit", None), getattr(to_t, "unit",
                                                            None)
    if f_unit is not None and t_unit is not None:
        fm, tm = f_unit.multiplier, t_unit.multiplier
        if tm >= fm:
            v = v * (tm // fm)
        else:
            q = fm // tm
            if not options.allow_time_truncate and bool(
                    ((torch.remainder(v, q) != 0) & _valid(col)).any()):
                raise ArrowInvalid(
                    f"casting {from_t} -> {to_t} would lose data")
            v = torch.div(v, q, rounding_mode="floor")
    return DeviceColumn(v.to(to_t.torch_dtype), col.validity, col.length,
                        to_t)


def _check_numeric(col: DeviceColumn, out: torch.Tensor, to_t: dt.DataType,
                   options: CastOptions) -> None:
    """The float-truncation and integer-overflow checks of a numeric
    cast, over the valid rows."""
    from_t, v = col.type, col.values
    valid = _valid(col)
    if from_t.is_floating and to_t.is_integer and \
            not options.allow_float_truncate:
        back = convert(out, to_t, from_t)
        if bool(((back != v) & valid & ~torch.isnan(v)).any()):
            raise ArrowInvalid(f"float value truncated casting to {to_t}")
    if options.allow_int_overflow or not _narrowing(from_t, to_t):
        return
    if from_t.is_floating:
        lo, hi = (float(x) for x in int_range(to_t))
        bad = (v < lo) | (v > hi) | torch.isnan(v)
    else:
        bad = convert(out, to_t, from_t) != v
        if from_t.is_signed_integer and to_t.is_unsigned_integer:
            bad = bad | (v < 0)
        if from_t.is_unsigned_integer and to_t.is_signed_integer:
            bad = bad | (out < 0)
    if bool((bad & valid).any()):
        raise ArrowInvalid(f"integer value out of bounds casting "
                           f"{from_t} -> {to_t}")


def cast_device(col: DeviceColumn, to_t: dt.DataType,
                options: Optional[CastOptions] = None) -> DeviceColumn:
    """A device column as `to_t`, on its device."""
    options = options or CastOptions()
    from_t = col.type
    if from_t == to_t:
        return col
    if from_t.id == dt.TypeId.DICTIONARY:
        # decode: gather the dictionary's values through the codes, for
        # a numeric or bool dictionary; a string dictionary stays put
        vt = from_t.value_type
        if not (vt.is_numeric or vt == dt.bool_):
            raise ArrowNotImplemented(f"device cast from {from_t}")
        table = torch.from_numpy(storage_view(np.ascontiguousarray(
            col.dict_values, vt.np_dtype), vt))
        if not len(table):
            table = torch.zeros(1, dtype=vt.torch_dtype)
        codes = col.values.to(torch.int64).clamp(0, table.shape[0] - 1)
        decoded = table.to(col.device).index_select(0, codes)
        return cast_device(DeviceColumn(decoded, col.validity, col.length,
                                        vt), to_t, options)
    if from_t.is_temporal and to_t.is_temporal:
        if not (_fixed(from_t) and _fixed(to_t)):
            # a day_time / month_day_nano interval is no number a row:
            # the JAX package's jnp cast fails on it with TypeError
            raise TypeError(f"device cast {from_t} -> {to_t}")
        return _rescale(col, to_t, options)
    if not (_fixed(from_t) and _fixed(to_t)):
        raise ArrowNotImplemented(f"device cast {from_t} -> {to_t}")
    out = convert(col.values, from_t, to_t)
    if from_t != dt.bool_ and to_t != dt.bool_:
        _check_numeric(col, out, to_t, options)
    return DeviceColumn(out, col.validity, col.length, to_t)


# ---------------------------------------------------------------------------
# host casts with a binary-like side
# ---------------------------------------------------------------------------

_EPOCH = _dt.datetime(1970, 1, 1)


def _format_value(v, t: dt.DataType) -> str:
    """Arrow cast-to-string formatting (reference string_casts.go: bool
    -> true/false, integers decimal, floats shortest-repr, temporals
    ISO)."""
    if t == dt.bool_:
        return "true" if v else "false"
    if t.is_floating:
        f = float(v)
        if f != f:
            return "nan"
        if f in (float("inf"), float("-inf")):
            return "inf" if f > 0 else "-inf"
        if f == int(f) and abs(f) < 1e16:
            return str(int(f))
        return repr(f)
    if t.is_integer:
        return str(int(v))
    if t.is_decimal:
        return str(v)
    if t.id == dt.TypeId.DATE32:
        return (_dt.date(1970, 1, 1) + _dt.timedelta(days=int(v))).isoformat()
    if t.id == dt.TypeId.DATE64:
        return (_EPOCH + _dt.timedelta(milliseconds=int(v))).date(
        ).isoformat()
    if t.id in (dt.TypeId.TIMESTAMP, dt.TypeId.TIME32, dt.TypeId.TIME64):
        at = _EPOCH + _dt.timedelta(
            microseconds=int(v) * 10**6 // t.unit.multiplier)
        if t.id != dt.TypeId.TIMESTAMP:
            return at.time().isoformat()
        return at.isoformat().replace("T", " ")
    return str(int(v))


def _parse_value(s, to_t: dt.DataType):
    """String -> typed value (reference string_casts.go parse kernels)."""
    if isinstance(s, (bytes, bytearray)):
        s = bytes(s).decode("utf-8")
    s = s.strip()
    if to_t.is_integer:
        return int(s, 10)
    if to_t.is_floating:
        return float(s)
    if to_t == dt.bool_:
        low = s.lower()
        if low in ("true", "1"):
            return True
        if low in ("false", "0"):
            return False
        raise ValueError(f"cannot parse {s!r} as bool")
    if to_t.is_decimal:
        return pydec.Decimal(s)
    # temporal values as their ticks
    if to_t.id == dt.TypeId.DATE32:
        return (_dt.date.fromisoformat(s) - _dt.date(1970, 1, 1)).days
    if to_t.id == dt.TypeId.TIMESTAMP:
        return _ticks(_dt.datetime.fromisoformat(s.replace(" ", "T"))
                      - _EPOCH, to_t)
    if to_t.id in (dt.TypeId.TIME32, dt.TypeId.TIME64):
        t = _dt.time.fromisoformat(s)
        return _ticks(_dt.timedelta(hours=t.hour, minutes=t.minute,
                                    seconds=t.second,
                                    microseconds=t.microsecond), to_t)
    raise ArrowNotImplemented(f"parse string -> {to_t}")


def _ticks(delta: _dt.timedelta, t: dt.DataType) -> int:
    us = (delta.days * 86_400 + delta.seconds) * 10**6 + delta.microseconds
    return us * t.unit.multiplier // 10**6


def _string_array(strs, valid, to_t: dt.DataType) -> HostArray:
    """Python str values (None where not valid) as a coded HostArray of
    `to_t` (a string type, or a binary type of their UTF-8 bytes)."""
    vals = np.empty(len(strs), dtype=object)
    vals[:] = [s if to_t.is_utf8 or s is None else s.encode()
               for s in strs]
    codes, dictionary = factorize(vals, valid)
    return HostArray(codes, None if valid.all() else valid, to_t,
                     dictionary)


def _decimal_array(values, valid, to_t: dt.DataType) -> HostArray:
    """Parsed Decimals (None where not valid) as a decimal HostArray; a
    value with more digits than the scale raises ArrowInvalid (a
    ValueError, the JAX package's DecimalBuilder error)."""
    unscaled = []
    for v in values:
        if v is None:
            unscaled.append(0)
            continue
        q = v.scaleb(to_t.scale, pydec.Context(prec=80))
        if q != q.to_integral_value():
            raise ArrowInvalid(f"{v} does not fit scale {to_t.scale}")
        unscaled.append(int(q))
    if to_t.limbs:
        out = from_ints(unscaled, to_t.limbs)
    else:
        out = np.array(unscaled, dtype=object).astype(to_t.np_dtype)
    return HostArray(out, None if valid.all() else valid, to_t)


def _typed_array(values, valid, to_t: dt.DataType) -> HostArray:
    """Parsed Python values (None where not valid) as a HostArray of
    `to_t`; a value outside its range raises ArrowInvalid."""
    if to_t.is_decimal:
        return _decimal_array(values, valid, to_t)
    out = np.zeros(len(values), to_t.np_dtype)
    for i, v in enumerate(values):
        if v is not None:
            try:
                out[i] = v
            except OverflowError as e:
                raise ArrowInvalid(f"cast to {to_t}: {e}") from None
            if to_t.is_integer and int(out[i]) != v:
                raise ArrowInvalid(f"cast to {to_t}: {v} out of range")
    return HostArray(out, None if valid.all() else valid, to_t)


def _cast_child(child: HostArray, to_t: dt.DataType,
                options: Optional[CastOptions]) -> HostArray:
    """A list's child cast to its new value type: on the host, a fixed-
    width cast through the plain device cast on the CPU."""
    if child.type.id == dt.TypeId.DICTIONARY:
        child = child.decode()
    t = child.type
    if t == to_t:
        return child
    if _fixed(t) and _fixed(to_t):
        from ..device.block import column_to_host, host_array_to_device
        return column_to_host(cast_device(host_array_to_device(
            child, torch.device("cpu")), to_t, options))
    return cast_host(child, to_t, options)


def _cast_list(arr: HostArray, to_t: dt.DataType,
               options: Optional[CastOptions]) -> HostArray:
    """list <-> large_list <-> list_view <-> large_list_view <->
    fixed_size_list with the child cast (the JAX package rebuilds each
    valid row into the target's builder; here one gather of the kept
    child rows): a null row keeps no child rows, or list_size null ones
    in a fixed_size_list; a fixed_size_list target takes only rows of
    its size; a list view target's rows are in order."""
    from ..device.block import ListViewArray, nested_array
    from .nested_selection import expand_runs, take_host_vec
    n = len(arr)
    valid = arr.validity_bools()
    if arr.type.id == dt.TypeId.FIXED_SIZE_LIST:
        k = arr.type.list_size
        starts = np.arange(n, dtype=np.int64) * k
        lens = np.full(n, k, np.int64)
    elif arr.type.id in _LIST_VIEWS:
        starts, lens = arr.offsets.astype(np.int64), arr.sizes.astype(
            np.int64)
    else:
        off = arr.offsets.astype(np.int64)
        starts, lens = off[:-1], np.diff(off)
    lens = np.where(valid, lens, 0)
    if to_t.id == dt.TypeId.FIXED_SIZE_LIST:
        k = to_t.list_size
        if (lens[valid] != k).any():
            raise ArrowInvalid(f"cast to {to_t}: a row's length is not {k}")
        child_idx = np.where(np.repeat(valid, k), (
            starts[:, None] + np.arange(k)).reshape(-1), -1)
        child = take_host_vec(arr.children[0], child_idx)
        return nested_array(to_t, n, arr.mask, [
            _cast_child(child, to_t.value_type, options)])
    child = take_host_vec(arr.children[0], expand_runs(starts, lens))
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1] > np.iinfo(to_t.offset_dtype).max:
        raise ArrowInvalid(f"cast to {to_t}: offsets overflow")
    child = _cast_child(child, to_t.value_type, options)
    if to_t.id in _LIST_VIEWS:
        return ListViewArray(to_t, arr.mask, offsets[:-1], lens, child)
    return nested_array(to_t, n, arr.mask, [child], offsets)


def _as_text(v) -> str:
    return v if isinstance(v, str) else bytes(v).decode("utf-8")


def _as_bytes(v) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)


def cast_host(arr: HostArray, to_t: dt.DataType,
              options: Optional[CastOptions] = None) -> HostArray:
    """The host cast path: any cast with a binary-like side, and the
    list casts. A string or binary result (of any of the six binary-like
    types) is a coded HostArray (codes and values); a cast among them
    re-types the dictionary and keeps the codes, so its cost is the
    dictionary's, not the column's. A dictionary column casts as its
    decoded values."""
    from_t = arr.type
    if from_t == to_t:
        return arr
    if from_t.id in LIST_KINDS and to_t.id in LIST_KINDS:
        return _cast_list(arr, to_t, options)
    if from_t.is_nested or to_t.is_nested:
        raise ArrowNotImplemented(f"cast {from_t} -> {to_t}")
    if from_t.id == dt.TypeId.DICTIONARY:
        arr = arr.decode()
        from_t = arr.type
        if from_t == to_t:
            return arr
    if from_t.is_binary_like and to_t.is_binary_like:
        # a re-typed dictionary: the codes and the mask stay as they are
        values = np.empty(len(arr.dict_values), dtype=object)
        values[:] = [_as_text(v) if to_t.is_utf8 else _as_bytes(v)
                     for v in arr.dict_values]
        return HostArray(arr.values, arr.mask, to_t, values)
    valid = arr.validity_bools()
    if from_t.is_binary_like:
        vt = from_t
        out = []
        for code, ok in zip(arr.values.tolist(), valid.tolist()):
            if not ok:
                out.append(None)
                continue
            try:
                out.append(_parse_value(arr.dict_values[code], to_t))
            except (ValueError, ArithmeticError) as e:
                raise ArrowInvalid(f"cast {vt} -> {to_t}: {e}") from None
        return _typed_array(out, valid, to_t)
    if to_t.is_binary_like:
        values = arr.to_pylist() if from_t.is_decimal else \
            arr.values.tolist()
        strs = [_format_value(v, from_t) if ok else None
                for v, ok in zip(values, valid.tolist())]
        return _string_array(strs, valid, to_t)
    raise ArrowNotImplemented(f"host cast {from_t} -> {to_t}")
