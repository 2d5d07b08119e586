"""Arrow format metadata: the Schema, Field and Type tables, encoded and
decoded.

Port of arrow_go_tpu/ipc/metadata.py (spec: arrow format/Schema.fbs, its
slot ids stable by spec). Every type the port carries maps to its Type
union member; an extension type travels as its storage type with the
`ARROW:extension:name` / `ARROW:extension:metadata` pair in the field's
metadata, and a dictionary type as its value type with a
DictionaryEncoding (id, index type, ordered). As in the JAX package, an
extension type reads back as a plain ExtensionType of that name (equal to
the registered one, whose name, storage and serialization it has).
"""
from __future__ import annotations

from typing import List, Optional

from .. import dtypes as dt
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from .fb import Builder, Reader

# Type union discriminants (format/Schema.fbs union Type)
T_NULL, T_INT, T_FLOAT, T_BINARY, T_UTF8, T_BOOL, T_DECIMAL, T_DATE, \
    T_TIME, T_TIMESTAMP, T_INTERVAL, T_LIST, T_STRUCT, T_UNION, T_FSB, \
    T_FSL, T_MAP, T_DURATION, T_LARGE_BINARY, T_LARGE_UTF8, T_LARGE_LIST, \
    T_REE, T_BINARY_VIEW, T_UTF8_VIEW, T_LIST_VIEW, T_LARGE_LIST_VIEW = \
    range(1, 27)

MSG_SCHEMA, MSG_DICTIONARY_BATCH, MSG_RECORD_BATCH, MSG_TENSOR = 1, 2, 3, 4
METADATA_V5 = 4

COMPRESS_LZ4 = 0
COMPRESS_ZSTD = 1

_EMPTY = {dt.TypeId.NULL: T_NULL, dt.TypeId.BOOL: T_BOOL,
          dt.TypeId.BINARY: T_BINARY, dt.TypeId.STRING: T_UTF8,
          dt.TypeId.LARGE_BINARY: T_LARGE_BINARY,
          dt.TypeId.LARGE_STRING: T_LARGE_UTF8, dt.TypeId.LIST: T_LIST,
          dt.TypeId.LARGE_LIST: T_LARGE_LIST, dt.TypeId.STRUCT: T_STRUCT,
          dt.TypeId.RUN_END_ENCODED: T_REE,
          dt.TypeId.BINARY_VIEW: T_BINARY_VIEW,
          dt.TypeId.STRING_VIEW: T_UTF8_VIEW,
          dt.TypeId.LIST_VIEW: T_LIST_VIEW,
          dt.TypeId.LARGE_LIST_VIEW: T_LARGE_LIST_VIEW}
_INTERVALS = {dt.TypeId.INTERVAL_MONTHS: 0, dt.TypeId.INTERVAL_DAY_TIME: 1,
              dt.TypeId.INTERVAL_MONTH_DAY_NANO: 2}


# ---------------------------------------------------------------------------
# type encode
# ---------------------------------------------------------------------------

def _int_table(b: Builder, it: dt.DataType) -> int:
    b.start_object(2)
    b.add(0, "<i", it.bit_width, 0)
    b.add(1, "<B", it.is_signed_integer, False)
    return b.end_object()


def write_type(b: Builder, t: dt.DataType):
    """(the Type union's discriminant, the offset of its table)."""
    tid = t.id
    if tid in _EMPTY:
        b.start_object(0)
        return _EMPTY[tid], b.end_object()
    if t.is_integer or tid == dt.TypeId.DICTIONARY:
        return T_INT, _int_table(
            b, t.index_type if tid == dt.TypeId.DICTIONARY else t)
    if t.is_floating:
        b.start_object(1)
        b.add(0, "<h", {dt.TypeId.FLOAT16: 0, dt.TypeId.FLOAT32: 1,
                        dt.TypeId.FLOAT64: 2}[tid], 0)
        return T_FLOAT, b.end_object()
    if t.is_decimal:
        b.start_object(3)
        b.add(0, "<i", t.precision, 0)
        b.add(1, "<i", t.scale, 0)
        b.add(2, "<i", t.bit_width, 128)
        return T_DECIMAL, b.end_object()
    if tid in (dt.TypeId.DATE32, dt.TypeId.DATE64):
        b.start_object(1)
        # the spec's default is MILLISECOND: always written
        b.add(0, "<h", 0 if tid == dt.TypeId.DATE32 else 1, -1)
        return T_DATE, b.end_object()
    if tid in (dt.TypeId.TIME32, dt.TypeId.TIME64):
        b.start_object(2)
        b.add(0, "<h", int(t.unit), -1)
        b.add(1, "<i", t.bit_width, 32)
        return T_TIME, b.end_object()
    if tid == dt.TypeId.TIMESTAMP:
        tz = b.create_string(t.tz) if t.tz else None
        b.start_object(2)
        b.add(0, "<h", int(t.unit), 0)
        if tz is not None:
            b.add_offset(1, tz)
        return T_TIMESTAMP, b.end_object()
    if tid == dt.TypeId.DURATION:
        b.start_object(1)
        b.add(0, "<h", int(t.unit), -1)
        return T_DURATION, b.end_object()
    if tid in _INTERVALS:
        b.start_object(1)
        b.add(0, "<h", _INTERVALS[tid], 0)
        return T_INTERVAL, b.end_object()
    if tid == dt.TypeId.FIXED_SIZE_BINARY:
        b.start_object(1)
        b.add(0, "<i", t.byte_width, 0)
        return T_FSB, b.end_object()
    if tid == dt.TypeId.FIXED_SIZE_LIST:
        b.start_object(1)
        b.add(0, "<i", t.list_size, 0)
        return T_FSL, b.end_object()
    if tid == dt.TypeId.MAP:
        b.start_object(1)
        b.add(0, "<B", t.keys_sorted, False)
        return T_MAP, b.end_object()
    if tid in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        b.start_vector(4, len(t.type_codes), 4)
        for c in reversed(t.type_codes):
            b.prepend("<i", c)
        codes = b.end_vector()
        b.start_object(2)
        b.add(0, "<h", 0 if tid == dt.TypeId.SPARSE_UNION else 1, 0)
        b.add_offset(1, codes)
        return T_UNION, b.end_object()
    raise ArrowNotImplemented(f"IPC write of type {t}")


def write_kv_vector(b: Builder, md: dt.Metadata) -> Optional[int]:
    if not md:
        return None
    offs = []
    for k, v in zip(md.keys, md.values):
        ko = b.create_string(k)
        vo = b.create_string(v)
        b.start_object(2)
        b.add_offset(0, ko)
        b.add_offset(1, vo)
        offs.append(b.end_object())
    return b.offsets_vector(offs)


def write_field(b: Builder, f: dt.Field, dict_ids: dict) -> int:
    t = f.type
    field_md = f.metadata
    if t.id == dt.TypeId.EXTENSION:
        # an extension type travels as its storage type, its name and
        # serialization in the field's metadata (reference
        # arrow/datatype_extension.go)
        keys = list(field_md.keys) + ["ARROW:extension:name"]
        vals = list(field_md.values) + [t.extension_name]
        if t.serialized:
            keys.append("ARROW:extension:metadata")
            vals.append(t.serialized.decode("utf-8", "surrogateescape"))
        field_md = dt.Metadata(keys=keys, values=vals)
        t = t.storage_type
    storage = t
    dict_off = None
    if t.id == dt.TypeId.DICTIONARY:
        # a DictionaryEncoding table; the children and type describe the
        # value type
        int_off = _int_table(b, t.index_type)
        b.start_object(4)
        b.add(0, "<q", dict_ids[id(f)], 0)
        b.add_offset(1, int_off)
        b.add(2, "<B", t.ordered, False)
        dict_off = b.end_object()
        storage = t.value_type
    child_vec = b.offsets_vector([write_field(b, cf, dict_ids)
                                  for cf in storage.fields()])
    disc, type_off = write_type(b, storage)
    name_off = b.create_string(f.name)
    md_off = write_kv_vector(b, field_md)
    b.start_object(7)
    b.add_offset(0, name_off)
    b.add(1, "<B", f.nullable, False)
    b.add(2, "<B", disc, 0)
    b.add_offset(3, type_off)
    if dict_off is not None:
        b.add_offset(4, dict_off)
    b.add_offset(5, child_vec)
    if md_off is not None:
        b.add_offset(6, md_off)
    return b.end_object()


def write_schema(b: Builder, schema: dt.Schema, dict_ids: dict,
                 endianness: int = 0) -> int:
    fvec = b.offsets_vector([write_field(b, f, dict_ids)
                             for f in schema.fields])
    md_off = write_kv_vector(b, schema.metadata)
    b.start_object(4)
    b.add(0, "<h", endianness, 0)            # 0 little, 1 big
    b.add_offset(1, fvec)
    if md_off is not None:
        b.add_offset(2, md_off)
    return b.end_object()


# ---------------------------------------------------------------------------
# type decode
# ---------------------------------------------------------------------------

def read_kv_vector(r: Reader, slot: int) -> dt.Metadata:
    n = r.vector_len(slot)
    keys, vals = [], []
    for i in range(n):
        kv = r.vector_table(slot, i)
        keys.append(kv.string(0) or "")
        vals.append(kv.string(1) or "")
    return dt.Metadata(keys=keys, values=vals) if n else dt.EMPTY_METADATA


_INT_TYPES = {(8, True): dt.int8, (16, True): dt.int16, (32, True): dt.int32,
              (64, True): dt.int64, (8, False): dt.uint8,
              (16, False): dt.uint16, (32, False): dt.uint32,
              (64, False): dt.uint64}
_UNITS = ("s", "ms", "us", "ns")
_FLAT_READ = {T_NULL: dt.null, T_BOOL: dt.bool_, T_BINARY: dt.binary,
              T_UTF8: dt.string, T_LARGE_BINARY: dt.large_binary,
              T_LARGE_UTF8: dt.large_string, T_BINARY_VIEW: dt.binary_view,
              T_UTF8_VIEW: dt.string_view}


def _pick(table, i: int, what: str):
    if not 0 <= i < len(table):
        raise ArrowInvalid(f"IPC {what} {i} is out of range")
    return table[i]


def _int_type(r: Reader) -> dt.DataType:
    key = (r.i32(0), r.bool_(1))
    if key not in _INT_TYPES:
        raise ArrowInvalid(f"IPC integer of {key[0]} bits")
    return _INT_TYPES[key]


def read_type(disc: int, tr: Reader, children: List[dt.Field]
              ) -> dt.DataType:
    if disc in _FLAT_READ:
        return _FLAT_READ[disc]
    if tr is None:
        raise ArrowInvalid(f"IPC field of type {disc} without its table")
    if disc == T_INT:
        return _int_type(tr)
    if disc == T_FLOAT:
        return _pick((dt.float16, dt.float32, dt.float64), tr.i16(0),
                     "float precision")
    if disc == T_DECIMAL:
        ctor = {32: dt.decimal32, 64: dt.decimal64, 128: dt.decimal128,
                256: dt.decimal256}.get(tr.i32(2, 128))
        if ctor is None:
            raise ArrowInvalid(f"IPC decimal of {tr.i32(2, 128)} bits")
        return ctor(tr.i32(0), tr.i32(1))
    if disc == T_DATE:
        return dt.date32 if tr.i16(0, 1) == 0 else dt.date64
    if disc == T_TIME:
        unit = _pick(_UNITS, tr.i16(0, 1), "time unit")
        return dt.time32(unit) if tr.i32(1, 32) == 32 else dt.time64(unit)
    if disc == T_TIMESTAMP:
        return dt.timestamp(_pick(_UNITS, tr.i16(0), "time unit"),
                            tr.string(1))
    if disc == T_DURATION:
        return dt.duration(_pick(_UNITS, tr.i16(0, 1), "time unit"))
    if disc == T_INTERVAL:
        return _pick((dt.month_interval, dt.day_time_interval,
                      dt.month_day_nano_interval), tr.i16(0),
                     "interval unit")
    if disc == T_FSB:
        return dt.fixed_size_binary(tr.i32(0))
    if disc in (T_LIST, T_LARGE_LIST, T_LIST_VIEW, T_LARGE_LIST_VIEW,
                T_FSL, T_MAP) and len(children) != 1:
        raise ArrowInvalid(f"IPC list type {disc} with {len(children)} "
                           f"children")
    if disc == T_LIST:
        return dt.ListType(children[0])
    if disc == T_LARGE_LIST:
        return dt.LargeListType(children[0])
    if disc == T_FSL:
        return dt.FixedSizeListType(children[0], tr.i32(0))
    if disc == T_STRUCT:
        return dt.StructType(children)
    if disc == T_MAP:
        entries = children[0].type
        return dt.MapType(entries.field(0).type, entries.field(1).type,
                          tr.bool_(0), entries.field(1).nullable)
    if disc == T_UNION:
        n = tr.vector_len(1)
        codes = [tr.vector_i32(1, i) for i in range(n)] or None
        return (dt.sparse_union if tr.i16(0) == 0 else dt.dense_union)(
            children, codes)
    if disc == T_REE:
        return dt.run_end_encoded(children[0].type, children[1].type)
    if disc == T_LIST_VIEW:
        return dt.ListViewType(children[0])
    if disc == T_LARGE_LIST_VIEW:
        return dt.LargeListViewType(children[0])
    raise ArrowNotImplemented(f"IPC read of type discriminant {disc}")


def read_field(r: Reader, dict_memo: dict) -> dt.Field:
    name = r.string(0) or ""
    nullable = r.bool_(1)
    disc = r.u8(2)
    children = [read_field(r.vector_table(5, i), dict_memo)
                for i in range(r.vector_len(5))]
    t = read_type(disc, r.table(3), children)
    enc = r.table(4)
    md = read_kv_vector(r, 6)
    did = None
    if enc is not None:
        did = enc.i64(0)
        it = enc.table(1)
        t = dt.DictionaryType(_int_type(it) if it else dt.int32, t,
                              enc.bool_(2))
    ext_name = md.get("ARROW:extension:name")
    if ext_name:
        serialized = (md.get("ARROW:extension:metadata") or "").encode(
            "utf-8", "surrogateescape")
        t = dt.ExtensionType(t, ext_name, serialized)
        keep = [(k, v) for k, v in zip(md.keys, md.values)
                if not k.startswith("ARROW:extension:")]
        md = dt.Metadata(keys=[k for k, _ in keep],
                         values=[v for _, v in keep])
    f = dt.Field(name, t, nullable, md)
    if did is not None:
        dict_memo[did] = f
    return f


def read_schema(r: Reader, dict_memo: dict) -> dt.Schema:
    fields = [read_field(r.vector_table(1, i), dict_memo)
              for i in range(r.vector_len(1))]
    return dt.Schema(fields, read_kv_vector(r, 2))
