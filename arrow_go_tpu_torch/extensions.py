"""Canonical extension types and the extension type registry.

Port of arrow_go_tpu/extensions.py (reference arrow/extensions: Bool8,
JSON, UUID, Opaque, TimestampWithOffset; arrow/datatype_extension.go
RegisterExtensionType). An extension column is its storage column under
the extension type (device/block.py ExtensionArray): a take or filter
selects its storage, and a bool8 column (int8 storage) lives on the
device as its storage does. As in the JAX package, `uuid`, `json_`,
`bool8`, `variant` (parquet.variant) and `timestamp_with_offset` are
registered at import. A variant column's storage is struct<metadata:
binary, value: binary[, typed_value]> (parquet/variant.py encodes the
two binaries); `shred_variant` and `unshred_variant` move values
between the residual `value` and a natively typed `typed_value`, row by
row in Python as in the JAX package.
"""
from __future__ import annotations

import datetime as _dt
import json
import threading
import uuid as _uuid
from typing import Dict, Optional

from . import dtypes as dt
from .compute.errors import ArrowInvalid, ArrowKeyError

_registry: Dict[str, dt.ExtensionType] = {}
_lock = threading.Lock()


def register_extension_type(ext: dt.ExtensionType) -> None:
    """Register `ext` under its extension name; a second registration of
    the name raises ArrowKeyError."""
    with _lock:
        if ext.extension_name in _registry:
            raise ArrowKeyError(
                f"extension {ext.extension_name!r} already registered")
        _registry[ext.extension_name] = ext


def unregister_extension_type(name: str) -> None:
    with _lock:
        _registry.pop(name, None)


def get_extension_type(name: str) -> Optional[dt.ExtensionType]:
    return _registry.get(name)


class UuidType(dt.ExtensionType):
    """arrow.uuid: fixed_size_binary(16) storage."""

    def __init__(self):
        super().__init__(dt.fixed_size_binary(16), "arrow.uuid")

    @staticmethod
    def to_uuid(b: bytes) -> _uuid.UUID:
        return _uuid.UUID(bytes=b)


class JsonType(dt.ExtensionType):
    """arrow.json: string storage holding JSON documents."""

    def __init__(self, storage: dt.DataType = dt.string):
        if not storage.is_binary_like:
            raise ArrowInvalid("arrow.json requires string storage")
        super().__init__(storage, "arrow.json")


class Bool8Type(dt.ExtensionType):
    """arrow.bool8: int8 storage, one byte a boolean."""

    def __init__(self):
        super().__init__(dt.int8, "arrow.bool8")


class OpaqueType(dt.ExtensionType):
    """arrow.opaque: an unknown producer's type, passed through."""

    def __init__(self, storage: dt.DataType, type_name: str,
                 vendor_name: str):
        super().__init__(storage, "arrow.opaque",
                         json.dumps({"type_name": type_name,
                                     "vendor_name": vendor_name}).encode())
        self.type_name = type_name
        self.vendor_name = vendor_name


class TimestampWithOffsetType(dt.ExtensionType):
    """arrow.timestamp_with_offset: a timestamp column carrying a
    timezone offset a row (reference
    arrow/extensions/timestamp_with_offset.go:36). Storage:
    struct<timestamp: timestamp[unit, tz=UTC] not null, offset_minutes:
    int16 | dictionary(int16) | run_end_encoded(int16) not null>."""

    def __init__(self, unit: str = "s",
                 offset_type: Optional[dt.DataType] = None):
        if offset_type is None:
            offset_type = dt.int16
        if not self._offset_type_ok(offset_type):
            raise ArrowInvalid(
                f"invalid offset type {offset_type} for "
                "arrow.timestamp_with_offset")
        storage = dt.struct([
            dt.Field("timestamp", dt.timestamp(unit, "UTC"), False),
            dt.Field("offset_minutes", offset_type, False),
        ])
        super().__init__(storage, "arrow.timestamp_with_offset")
        self.unit = unit
        self.offset_type = offset_type

    @staticmethod
    def _offset_type_ok(t: dt.DataType) -> bool:
        # int16, a dictionary of int16 values or run-end encoded int16
        # (reference timestamp_with_offset.go:40 isOffsetTypeOk)
        if t.id == dt.TypeId.INT16:
            return True
        if t.id == dt.TypeId.DICTIONARY:
            return t.value_type.id == dt.TypeId.INT16
        if t.id == dt.TypeId.RUN_END_ENCODED:
            return t.values_type.id == dt.TypeId.INT16
        return False

    @classmethod
    def from_storage(cls, storage: dt.DataType) -> "TimestampWithOffsetType":
        """Check and wrap a storage type (isDataTypeCompatible)."""
        if storage.id != dt.TypeId.STRUCT or len(storage.fields()) != 2:
            raise ArrowInvalid("storage must be a 2-field struct")
        ts_f, off_f = storage.fields()
        if (ts_f.name != "timestamp" or ts_f.nullable
                or ts_f.type.id != dt.TypeId.TIMESTAMP
                or ts_f.type.tz != "UTC"):
            raise ArrowInvalid(
                "field 0 must be non-null timestamp[*, tz=UTC]")
        if (off_f.name != "offset_minutes" or off_f.nullable
                or not cls._offset_type_ok(off_f.type)):
            raise ArrowInvalid(
                "field 1 must be non-null offset_minutes int16")
        return cls(ts_f.type.unit, off_f.type)



class VariantType(dt.ExtensionType):
    """parquet.variant: struct<metadata: binary, value: binary
    [, typed_value: ...]> storage (reference
    arrow/extensions/variant.go:159 NewVariantType rules; shredded
    typed_value schemas per variant.go:66 createShreddedField /
    :127 NewShreddedVariantType)."""

    def __init__(self, storage: Optional[dt.DataType] = None):
        if storage is None:
            storage = dt.struct([dt.Field("metadata", dt.binary, False),
                                 dt.Field("value", dt.binary, False)])
        if storage.id != dt.TypeId.STRUCT:
            raise ArrowInvalid("parquet.variant storage must be a struct")
        names = [f.name for f in storage.fields()]
        if "metadata" not in names:
            raise ArrowInvalid(
                "parquet.variant storage needs a metadata field")
        if "value" not in names and "typed_value" not in names:
            raise ArrowInvalid(
                "parquet.variant storage needs value or typed_value")
        if len(names) > 3:
            raise ArrowInvalid("parquet.variant storage has too many fields")
        md = storage.fields()[names.index("metadata")]
        if md.nullable:
            raise ArrowInvalid("variant metadata field must be non-null")
        self.shred_type: Optional[dt.DataType] = None
        if "typed_value" in names:
            tv = storage.fields()[names.index("typed_value")]
            if not tv.nullable:
                raise ArrowInvalid("variant typed_value must be nullable")
            self.shred_type = _unshredded_field_type(tv.type)
        super().__init__(storage, "parquet.variant")

    @property
    def shredded(self) -> bool:
        return self.shred_type is not None


# -- variant shredding (reference arrow/extensions/variant.go:66,99,127;
# Parquet Variant Shredding spec: each shredded value group is
# struct<value: binary?, typed_value: T?>, value holding the residual
# variant-encoded part, typed_value the natively typed part) ----------

_LISTY = (dt.TypeId.LIST, dt.TypeId.LARGE_LIST)


def _value_group(typed: dt.DataType) -> dt.DataType:
    return dt.struct([dt.Field("value", dt.binary, True),
                      dt.Field("typed_value", typed, True)])


def _shredded_field_type(t: dt.DataType) -> dt.DataType:
    """createShreddedField (variant.go:66): lists and structs recurse
    into value groups; primitives shred as themselves."""
    if t.id in _LISTY:
        elem = _value_group(_shredded_field_type(t.fields()[0].type))
        return dt.list_(dt.Field("element", elem, False))
    if t.id == dt.TypeId.STRUCT:
        return dt.struct([
            dt.Field(f.name, _value_group(_shredded_field_type(f.type)),
                     False)
            for f in t.fields()])
    return t


def _unshredded_field_type(t: dt.DataType) -> dt.DataType:
    """The inverse of _shredded_field_type (the shred type of a
    storage)."""
    if t.id in _LISTY:
        elem = t.fields()[0].type            # the value group struct
        return dt.list_(_unshredded_field_type(elem.fields()[1].type))
    if t.id == dt.TypeId.STRUCT and t.fields() and all(
            f.type.id == dt.TypeId.STRUCT
            and [c.name for c in f.type.fields()] == ["value", "typed_value"]
            for f in t.fields()):
        return dt.struct([
            dt.Field(f.name, _unshredded_field_type(f.type.fields()[1].type))
            for f in t.fields()])
    return t


def shredded_variant_type(t: Optional[dt.DataType] = None) -> VariantType:
    """NewShreddedVariantType (variant.go:127): a variant type whose
    typed_value shreds values of `t`."""
    if t is None:
        return VariantType()
    storage = dt.struct([
        dt.Field("metadata", dt.binary, False),
        dt.Field("value", dt.binary, True),
        dt.Field("typed_value", _shredded_field_type(t), True)])
    return VariantType(storage)


_MISSING = object()


def _prim_match(obj, t: dt.DataType):
    """A Python value as a typed_value scalar of primitive shred type t,
    or _MISSING when it stays in the residual."""
    tid = t.id
    if obj is None:
        return _MISSING                     # a variant null stays in value
    if tid == dt.TypeId.BOOL:
        return obj if isinstance(obj, bool) else _MISSING
    if t.is_integer:
        return obj if isinstance(obj, int) and not isinstance(obj, bool) \
            else _MISSING
    if t.is_floating:
        return obj if isinstance(obj, float) else _MISSING
    if tid in (dt.TypeId.STRING, dt.TypeId.LARGE_STRING):
        return obj if isinstance(obj, str) else _MISSING
    if tid in (dt.TypeId.BINARY, dt.TypeId.LARGE_BINARY):
        return obj if isinstance(obj, bytes) else _MISSING
    if tid == dt.TypeId.DATE32:
        return obj if (isinstance(obj, _dt.date)
                       and not isinstance(obj, _dt.datetime)) else _MISSING
    if tid == dt.TypeId.TIMESTAMP:
        return obj if isinstance(obj, _dt.datetime) else _MISSING
    return _MISSING


def _shred_one(obj, t: dt.DataType, b) -> dict:
    """One decoded Python value as its value-group dict for shred type t."""
    if t.id == dt.TypeId.STRUCT:
        if isinstance(obj, dict):
            shredded_names = [f.name for f in t.fields()]
            typed = {}
            for f in t.fields():
                if f.name in obj:
                    typed[f.name] = _shred_one(obj[f.name], f.type, b)
                else:
                    typed[f.name] = {"value": None, "typed_value": None}
            residual = {k: v for k, v in obj.items()
                        if k not in shredded_names}
            val = b.encode_value(residual) if residual else None
            return {"value": val, "typed_value": typed}
        return {"value": b.encode_value(obj), "typed_value": None}
    if t.id in _LISTY:
        if isinstance(obj, list):
            elem_t = t.fields()[0].type
            return {"value": None,
                    "typed_value": [_shred_one(x, elem_t, b) for x in obj]}
        return {"value": b.encode_value(obj), "typed_value": None}
    v = _prim_match(obj, t)
    if v is _MISSING:
        return {"value": b.encode_value(obj), "typed_value": None}
    return {"value": None, "typed_value": v}


def _storage(arr):
    return arr.storage if arr.type.id == dt.TypeId.EXTENSION else arr


def shred_variant(arr, shred_t: dt.DataType):
    """A non-shredded variant column as a shredded one for `shred_t`
    (the writer side of the Parquet Variant Shredding spec; reference
    variant.go:99). Values that do not match the shredded schema stay in
    the residual `value` field, so nothing is lost."""
    from .device.block import ExtensionArray, from_pylist
    from .parquet import variant as pv
    st = shredded_variant_type(shred_t)
    rows = []
    for row in _storage(arr).to_pylist():
        if row is None:
            rows.append(None)
            continue
        obj = pv.decode(row["metadata"], row["value"])
        bb = pv.Builder()
        group = _shred_one(obj, shred_t, bb)
        rows.append({"metadata": bb.metadata().data, **group})
    return ExtensionArray(st, from_pylist(rows, st.storage_type))


def _unshred_one(group, t: dt.DataType, meta: bytes):
    from .parquet import variant as pv
    val = group.get("value")
    tv = group.get("typed_value")
    if t.id == dt.TypeId.STRUCT and isinstance(tv, dict):
        obj = {}
        for f in t.fields():
            r = _unshred_one(tv[f.name], f.type, meta)
            if r is not _MISSING:
                obj[f.name] = r
        if val is not None:
            residual = pv.decode(meta, val)
            if isinstance(residual, dict):
                obj.update(residual)
        return obj
    if t.id in _LISTY and isinstance(tv, list):
        elem_t = t.fields()[0].type
        return [_unshred_one(g, elem_t, meta) for g in tv]
    if tv is not None:
        return _from_typed_scalar(tv, t)
    if val is not None:
        return pv.decode(meta, val)
    return _MISSING


def _from_typed_scalar(v, t: dt.DataType):
    if t.id == dt.TypeId.DATE32 and isinstance(v, int):
        return _dt.date(1970, 1, 1) + _dt.timedelta(days=v)
    if t.id == dt.TypeId.TIMESTAMP and isinstance(v, int):
        base = _dt.datetime(1970, 1, 1,
                            tzinfo=_dt.timezone.utc if t.tz else None)
        scale = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[str(t.unit)]
        return base + _dt.timedelta(microseconds=v * 10**6 // scale)
    return v


def unshred_variant(arr):
    """A shredded variant column as a non-shredded struct<metadata,
    value> variant column (the reader side: typed_value merged with the
    residual value, per the shredding spec)."""
    from .device.block import ExtensionArray, from_pylist
    from .parquet import variant as pv
    t = arr.type
    shred_t = t.shred_type if isinstance(t, VariantType) else None
    if shred_t is None:
        raise ArrowInvalid("unshred_variant needs a shredded variant")
    out_t = VariantType()
    rows = []
    for row in _storage(arr).to_pylist():
        if row is None:
            rows.append(None)
            continue
        obj = _unshred_one(row, shred_t, row["metadata"])
        if obj is _MISSING:
            obj = None
        meta, val = pv.encode(obj)
        rows.append({"metadata": meta, "value": val})
    return ExtensionArray(out_t, from_pylist(rows, out_t.storage_type))

uuid = UuidType()
json_ = JsonType()
bool8 = Bool8Type()
variant = VariantType()
timestamp_with_offset = TimestampWithOffsetType()

for _e in (uuid, json_, bool8, variant, timestamp_with_offset):
    register_extension_type(_e)
