"""Parquet <-> port schema conversion for flat columns.

Port of the flat-column part of arrow_go_tpu/parquet/schema.py
(reference parquet/schema + parquet/pqarrow/schema.go): BOOLEAN, INT32,
INT64, FLOAT and DOUBLE leaves, and BYTE_ARRAY leaves (string and
large_string with the STRING / UTF8 annotation, binary and large_binary
without one; each reads back as string or binary), required or
optional, directly under the root. An extension column is written as
its storage type and reads back as it, as in the JAX package; the view,
interval, null, list view and union types have no physical type. INT32 and INT64 leaves take the logical and
converted annotations of the JAX package: DATE, TIME, TIMESTAMP and
INTEGER(8/16/32/64, signed or not), or INT_8/16, UINT_8..64, DATE,
TIME_* and TIMESTAMP_*. DECIMAL (logical or converted) maps by physical
type and precision, as the JAX package's `_decimal_for` does: INT32 to
decimal32 (precision <= 9), INT64 to decimal64 (<= 18), either to
decimal128 above that, and FIXED_LEN_BYTE_ARRAY to decimal128 (<= 38)
or decimal256. A FIXED_LEN_BYTE_ARRAY leaf is float16 with the FLOAT16
annotation, else fixed_size_binary(type_length); an INT96 leaf is
timestamp("ns").

Nested columns convert both ways as the JAX package's do
(arrow_go_tpu/parquet/schema.py): a struct is a group of its fields; a
list or large_list a LIST-annotated group holding a repeated group
"list" of one "element" (a fixed_size_list is written as a list, and a
large_list reads back as a list); a map a MAP-annotated group holding a
repeated group "key_value" of "key" and "value". A repeated field
outside such a group (the legacy two-level lists) raises
ArrowNotImplemented. A struct group annotated VARIANT reads as the
parquet.variant extension type over its struct (extensions.VariantType),
and that type's storage is written as such a group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..compute.errors import ArrowNotImplemented
from . import format as fmt


@dataclass
class ColumnDescriptor:
    """Leaf column: physical type + levels info
    (reference parquet/schema/column.go)."""

    path: Tuple[str, ...]
    physical_type: fmt.Type
    type_length: int
    max_def_level: int
    max_rep_level: int
    arrow_type: dt.DataType
    schema_elements: List[fmt.SchemaElement]  # root-to-leaf elements


_INT32_TYPES = (dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32,
                dt.TypeId.UINT8, dt.TypeId.UINT16, dt.TypeId.UINT32,
                dt.TypeId.DATE32, dt.TypeId.TIME32)
_INT64_TYPES = (dt.TypeId.INT64, dt.TypeId.UINT64, dt.TypeId.TIMESTAMP,
                dt.TypeId.TIME64, dt.TypeId.DATE64, dt.TypeId.DURATION)
_PHYSICAL = {dt.TypeId.BOOL: fmt.Type.BOOLEAN,
             dt.TypeId.FLOAT32: fmt.Type.FLOAT,
             dt.TypeId.FLOAT64: fmt.Type.DOUBLE,
             dt.TypeId.STRING: fmt.Type.BYTE_ARRAY,
             dt.TypeId.BINARY: fmt.Type.BYTE_ARRAY,
             dt.TypeId.LARGE_STRING: fmt.Type.BYTE_ARRAY,
             dt.TypeId.LARGE_BINARY: fmt.Type.BYTE_ARRAY,
             **{i: fmt.Type.INT32 for i in _INT32_TYPES},
             **{i: fmt.Type.INT64 for i in _INT64_TYPES}}
_PLAIN = {fmt.Type.BOOLEAN: dt.bool_, fmt.Type.INT32: dt.int32,
          fmt.Type.INT64: dt.int64, fmt.Type.FLOAT: dt.float32,
          fmt.Type.DOUBLE: dt.float64, fmt.Type.BYTE_ARRAY: dt.binary,
          fmt.Type.INT96: dt.timestamp("ns")}
_PHYSICAL_NP = {fmt.Type.INT32: np.int32, fmt.Type.INT64: np.int64}


def physical_for(t: dt.DataType, store_decimal_as_integer: bool = False
                 ) -> Tuple[fmt.Type, int]:
    """(physical type, type_length) of a port type (the JAX package's
    physical_for): decimal32 / decimal64 on INT32 / INT64, decimal128 /
    decimal256 on FIXED_LEN_BYTE_ARRAY of 16 / 32 bytes (with
    `store_decimal_as_integer`, a decimal of precision <= 9 / <= 18 on
    INT32 / INT64, reference WithStoreDecimalAsInteger), float16 on
    FIXED_LEN_BYTE_ARRAY(2), fixed_size_binary on its byte width, the
    string and binary types and their large forms on BYTE_ARRAY. The
    view, interval, null, union and list view types have none and raise
    ArrowNotImplemented, as in the JAX package."""
    if t.is_decimal:
        if store_decimal_as_integer and t.precision <= 9 or \
                t.id == dt.TypeId.DECIMAL32:
            return fmt.Type.INT32, 0
        if store_decimal_as_integer and t.precision <= 18 or \
                t.id == dt.TypeId.DECIMAL64:
            return fmt.Type.INT64, 0
        return fmt.Type.FIXED_LEN_BYTE_ARRAY, t.bit_width // 8
    if t.id == dt.TypeId.FLOAT16:
        return fmt.Type.FIXED_LEN_BYTE_ARRAY, 2
    if t.id == dt.TypeId.FIXED_SIZE_BINARY:
        return fmt.Type.FIXED_LEN_BYTE_ARRAY, t.byte_width
    try:
        return _PHYSICAL[t.id], 0
    except KeyError:
        raise ArrowNotImplemented(
            f"no parquet physical type for {t}") from None


def physical_np_dtype(t: dt.DataType) -> np.dtype:
    """The numpy dtype of a non-string type's physical values: int32 or
    int64 for every integer and temporal type, else the type's own."""
    return np.dtype(_PHYSICAL_NP.get(physical_for(t)[0], t.np_dtype))


_UNITS = {dt.TimeUnit.MILLISECOND: ("MILLIS", fmt.MilliSeconds),
          dt.TimeUnit.MICROSECOND: ("MICROS", fmt.MicroSeconds),
          dt.TimeUnit.NANOSECOND: ("NANOS", fmt.NanoSeconds)}


def _unit_of(unit: dt.TimeUnit) -> Optional[fmt.TimeUnitU]:
    if unit not in _UNITS:
        return None
    field, cls = _UNITS[unit]
    return fmt.TimeUnitU(**{field: cls()})


_INT_ANNOTATIONS = {
    dt.TypeId.UINT8: (8, False, fmt.ConvertedType.UINT_8),
    dt.TypeId.UINT16: (16, False, fmt.ConvertedType.UINT_16),
    dt.TypeId.UINT32: (32, False, fmt.ConvertedType.UINT_32),
    dt.TypeId.UINT64: (64, False, fmt.ConvertedType.UINT_64),
    dt.TypeId.INT8: (8, True, fmt.ConvertedType.INT_8),
    dt.TypeId.INT16: (16, True, fmt.ConvertedType.INT_16)}


def _logical_for(t: dt.DataType) -> Tuple[Optional[fmt.LogicalType],
                                          Optional[int]]:
    """(LogicalType, converted_type) annotations, as the JAX writer
    gives them (arrow_go_tpu/parquet/schema.py:_logical_for): a
    timestamp in seconds, date64 and duration go unannotated."""
    C = fmt.ConvertedType
    tid = t.id
    if tid in (dt.TypeId.STRING, dt.TypeId.LARGE_STRING):
        return fmt.LogicalType(STRING=fmt.StringType()), int(C.UTF8)
    if tid == dt.TypeId.DATE32:
        return fmt.LogicalType(DATE=fmt.DateLType()), int(C.DATE)
    if tid == dt.TypeId.TIMESTAMP:
        u = _unit_of(t.unit)
        if u is None:
            return None, None
        conv = {dt.TimeUnit.MILLISECOND: C.TIMESTAMP_MILLIS,
                dt.TimeUnit.MICROSECOND: C.TIMESTAMP_MICROS}.get(t.unit)
        return fmt.LogicalType(TIMESTAMP=fmt.TimestampLType(
            isAdjustedToUTC=bool(t.tz), unit=u)), \
            None if conv is None else int(conv)
    if tid in (dt.TypeId.TIME32, dt.TypeId.TIME64):
        # a time32 is written in ms whatever its unit, as the JAX writer
        # writes it
        unit = dt.TimeUnit.MILLISECOND if tid == dt.TypeId.TIME32 \
            else t.unit
        conv = {dt.TimeUnit.MILLISECOND: C.TIME_MILLIS,
                dt.TimeUnit.MICROSECOND: C.TIME_MICROS}.get(unit)
        return fmt.LogicalType(TIME=fmt.TimeLType(
            isAdjustedToUTC=False, unit=_unit_of(unit))), \
            None if conv is None else int(conv)
    if tid in _INT_ANNOTATIONS:
        width, signed, conv = _INT_ANNOTATIONS[tid]
        return fmt.LogicalType(INTEGER=fmt.IntLType(
            bitWidth=width, isSigned=signed)), int(conv)
    if t.is_decimal:
        return fmt.LogicalType(DECIMAL=fmt.DecimalLType(
            scale=t.scale, precision=t.precision)), int(C.DECIMAL)
    if tid == dt.TypeId.FLOAT16:
        return fmt.LogicalType(FLOAT16=fmt.Float16LType()), None
    return None, None


def schema_to_elements(schema: dt.Schema,
                       store_decimal_as_integer: bool = False,
                       int96_timestamps: bool = False
                       ) -> Tuple[List[fmt.SchemaElement],
                                  List[ColumnDescriptor]]:
    """Port schema -> flat SchemaElement list (depth first) + leaf
    columns. With `int96_timestamps` a timestamp column is an
    unannotated INT96 leaf (reference WithDeprecatedInt96Timestamps). An
    extension column is written as its storage type, as the JAX writer
    writes it (and reads back as that type)."""
    elements = [fmt.SchemaElement(name="schema", num_children=len(schema))]
    leaves: List[ColumnDescriptor] = []

    def group(name, rep, n, conv=None, logical=None):
        el = fmt.SchemaElement(name=name, repetition_type=int(rep),
                               num_children=n, converted_type=conv,
                               logicalType=logical)
        elements.append(el)
        return el

    def walk(f: dt.Field, path, max_def, max_rep, ancestry):
        t = f.type
        variant = None
        if t.id == dt.TypeId.EXTENSION:
            # parquet.variant's group carries the VARIANT annotation
            # (reference pqarrow/schema.go, schema/logical_types.go:1120)
            if t.extension_name == "parquet.variant":
                variant = fmt.LogicalType(
                    VARIANT=fmt.VariantLType(specification_version=1))
            t = t.storage_type
        rep = fmt.Repetition.OPTIONAL if f.nullable else \
            fmt.Repetition.REQUIRED
        d = max_def + (1 if f.nullable else 0)
        if t.id == dt.TypeId.STRUCT:
            el = group(f.name, rep, t.num_fields, logical=variant)
            for cf in t.fields():
                walk(cf, path + (f.name,), d, max_rep, ancestry + [el])
            return
        if t.id == dt.TypeId.MAP:
            el = group(f.name, rep, 1, int(fmt.ConvertedType.MAP),
                       fmt.LogicalType(MAP=fmt.MapLType()))
            mid = group("key_value", fmt.Repetition.REPEATED, 2)
            for cf in (dt.Field("key", t.key_type, False),
                       dt.Field("value", t.item_type, t.item_field.nullable)):
                walk(cf, path + (f.name, "key_value"), d + 1, max_rep + 1,
                     ancestry + [el, mid])
            return
        if t.id in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST,
                    dt.TypeId.FIXED_SIZE_LIST):
            el = group(f.name, rep, 1, int(fmt.ConvertedType.LIST),
                       fmt.LogicalType(LIST=fmt.ListLType()))
            mid = group("list", fmt.Repetition.REPEATED, 1)
            walk(dt.Field("element", t.value_type, t.value_field.nullable),
                 path + (f.name, "list"), d + 1, max_rep + 1,
                 ancestry + [el, mid])
            return
        storage = t.value_type if t.id == dt.TypeId.DICTIONARY else t
        int96 = int96_timestamps and storage.id == dt.TypeId.TIMESTAMP
        phys, tlen = (fmt.Type.INT96, 12) if int96 else physical_for(
            storage, store_decimal_as_integer)
        logical, conv = (None, None) if int96 else _logical_for(storage)
        el = fmt.SchemaElement(name=f.name, type=int(phys),
                               type_length=tlen if phys ==
                               fmt.Type.FIXED_LEN_BYTE_ARRAY else None,
                               repetition_type=int(rep),
                               converted_type=conv, logicalType=logical)
        if storage.is_decimal:
            el.scale, el.precision = storage.scale, storage.precision
        elements.append(el)
        leaves.append(ColumnDescriptor(path + (f.name,), phys, tlen, d,
                                       max_rep, storage, ancestry + [el]))

    for f in schema.fields:
        walk(f, (), 0, 0, [])
    return elements, leaves


_CONVERTED = {
    fmt.ConvertedType.UTF8: dt.string, fmt.ConvertedType.DATE: dt.date32,
    fmt.ConvertedType.TIME_MILLIS: dt.time32("ms"),
    fmt.ConvertedType.TIME_MICROS: dt.time64("us"),
    fmt.ConvertedType.TIMESTAMP_MILLIS: dt.timestamp("ms"),
    fmt.ConvertedType.TIMESTAMP_MICROS: dt.timestamp("us"),
    fmt.ConvertedType.UINT_8: dt.uint8, fmt.ConvertedType.UINT_16: dt.uint16,
    fmt.ConvertedType.UINT_32: dt.uint32,
    fmt.ConvertedType.UINT_64: dt.uint64,
    fmt.ConvertedType.INT_8: dt.int8, fmt.ConvertedType.INT_16: dt.int16,
    fmt.ConvertedType.INT_32: dt.int32, fmt.ConvertedType.INT_64: dt.int64}
_INTEGERS = {(8, True): dt.int8, (16, True): dt.int16, (32, True): dt.int32,
             (64, True): dt.int64, (8, False): dt.uint8,
             (16, False): dt.uint16, (32, False): dt.uint32,
             (64, False): dt.uint64}


def _annotated(el: fmt.SchemaElement) -> Optional[dt.DataType]:
    """The type a leaf's logical annotation, else its converted type,
    names (the JAX reader's precedence), or None for a plain leaf."""
    lt = el.logicalType
    if lt is not None:
        if lt.STRING is not None:
            return dt.string
        if lt.DATE is not None:
            return dt.date32
        if lt.TIMESTAMP is not None:
            return dt.timestamp(lt.TIMESTAMP.unit.unit_str,
                                "UTC" if lt.TIMESTAMP.isAdjustedToUTC
                                else None)
        if lt.TIME is not None:
            unit = lt.TIME.unit.unit_str
            return dt.time32(unit) if unit == "ms" else dt.time64(unit)
        if lt.INTEGER is not None:
            return _INTEGERS[(lt.INTEGER.bitWidth, bool(lt.INTEGER.isSigned))]
        if lt.DECIMAL is not None:
            return _decimal_for(el, lt.DECIMAL.precision, lt.DECIMAL.scale)
        if lt.FLOAT16 is not None:
            return dt.float16
    if el.converted_type is not None:
        conv = fmt.ConvertedType(el.converted_type)
        if conv in _CONVERTED:
            return _CONVERTED[conv]
        if conv == fmt.ConvertedType.DECIMAL:
            return _decimal_for(el, el.precision, el.scale)
    return None


def _decimal_for(el: fmt.SchemaElement, p: int, s: int) -> dt.DataType:
    phys = fmt.Type(el.type)
    if phys == fmt.Type.INT32:
        return dt.decimal32(p, s) if p <= 9 else dt.decimal128(p, s)
    if phys == fmt.Type.INT64:
        return dt.decimal64(p, s) if p <= 18 else dt.decimal128(p, s)
    if phys == fmt.Type.FIXED_LEN_BYTE_ARRAY:
        return dt.decimal128(p, s) if p <= 38 else dt.decimal256(p, s)
    raise ArrowNotImplemented(
        f"column {el.name!r}: DECIMAL on physical {phys.name}")


def _type_of(el: fmt.SchemaElement) -> dt.DataType:
    phys = fmt.Type(el.type)
    if phys not in _PLAIN and phys != fmt.Type.FIXED_LEN_BYTE_ARRAY:
        raise ArrowNotImplemented(
            f"column {el.name!r}: physical {phys.name} is not ported")
    t = _annotated(el)
    if t is None:
        return dt.fixed_size_binary(el.type_length or 0) if phys == \
            fmt.Type.FIXED_LEN_BYTE_ARRAY else _PLAIN[phys]
    if t.is_decimal:
        return t
    if (phys == fmt.Type.BYTE_ARRAY) != t.is_binary_like or (
            not t.is_binary_like and physical_for(t)[0] != phys):
        raise ArrowNotImplemented(
            f"column {el.name!r}: {t} on physical {phys.name}")
    return t


def elements_to_schema(elements: List[fmt.SchemaElement]
                       ) -> Tuple[dt.Schema, List[ColumnDescriptor]]:
    """Parquet SchemaElement list -> port schema + leaf descriptors."""
    pos = [1]
    leaves: List[ColumnDescriptor] = []

    def read_node(path, max_def, max_rep, ancestry) -> dt.Field:
        el = elements[pos[0]]
        pos[0] += 1
        rep = fmt.Repetition(el.repetition_type or 0)
        if rep == fmt.Repetition.REPEATED:
            raise ArrowNotImplemented(
                f"repeated field {el.name!r} outside a LIST or MAP group "
                f"is not ported")
        nullable = rep == fmt.Repetition.OPTIONAL
        d = max_def + (1 if nullable else 0)
        if not el.num_children:
            t = _type_of(el)
            leaves.append(ColumnDescriptor(
                path + (el.name,), fmt.Type(el.type), el.type_length or 0,
                d, max_rep, t, ancestry + [el]))
            return dt.Field(el.name, t, nullable)
        conv, lt = el.converted_type, el.logicalType
        is_map = conv in (int(fmt.ConvertedType.MAP),
                          int(fmt.ConvertedType.MAP_KEY_VALUE)) or (
            lt is not None and lt.MAP is not None)
        is_list = conv == int(fmt.ConvertedType.LIST) or (
            lt is not None and lt.LIST is not None)
        if is_map or is_list:
            mid = elements[pos[0]]
            pos[0] += 1
            inner = path + (el.name, mid.name)
            kids = [read_node(inner, d + 1, max_rep + 1, ancestry + [el, mid])
                    for _ in range(2 if is_map else 1)]
            if is_map:
                t = dt.map_(kids[0].type, kids[1].type)
            else:
                t = dt.list_(dt.Field("element", kids[0].type,
                                      kids[0].nullable))
            return dt.Field(el.name, t, nullable)
        fields = [read_node(path + (el.name,), d, max_rep, ancestry + [el])
                  for _ in range(el.num_children)]
        if lt is not None and lt.VARIANT is not None:
            from ..extensions import VariantType
            return dt.Field(el.name, VariantType(dt.struct(fields)),
                            nullable)
        return dt.Field(el.name, dt.struct(fields), nullable)

    root = elements[0]
    fields = [read_node((), 0, 0, []) for _ in range(root.num_children or 0)]
    return dt.Schema(fields), leaves
