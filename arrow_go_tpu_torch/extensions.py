"""Canonical extension types and the extension type registry.

Port of arrow_go_tpu/extensions.py (reference arrow/extensions: Bool8,
JSON, UUID, Opaque, TimestampWithOffset; arrow/datatype_extension.go
RegisterExtensionType). An extension column is its storage column under
the extension type (device/block.py ExtensionArray): a take or filter
selects its storage, and a bool8 column (int8 storage) lives on the
device as its storage does. As in the JAX package, `uuid`, `json_`,
`bool8` and `timestamp_with_offset` are registered at import. The
variant type (parquet.variant) and its shredding are not ported yet.
"""
from __future__ import annotations

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


uuid = UuidType()
json_ = JsonType()
bool8 = Bool8Type()
timestamp_with_offset = TimestampWithOffsetType()

for _e in (uuid, json_, bool8, timestamp_with_offset):
    register_extension_type(_e)
