"""Parquet VARIANT binary format: the metadata dictionary and the value
encoding.

Port of arrow_go_tpu/parquet/variant.py (reference parquet/variant/:
variant.go:61 primitive type codes, variant.go:735 object and array
layouts, builder.go). Self-describing binary values per the Parquet
Variant spec, in plain Python as in the JAX package, whose bytes these
are bit for bit:

- metadata: header byte (version | sorted<<4 | (offset_size-1)<<6), dict
  size, offsets, key bytes
- value: header byte (basic_type in low 2 bits, type info above); basic
  types: 0 primitive, 1 short string, 2 object, 3 array
"""
from __future__ import annotations

import datetime as _dt
import decimal as _pydec
import json as _json
import struct
import uuid as _uuid
from typing import Any, Dict, List, Optional, Tuple

from ..compute.errors import ArrowInvalid

# basic types (low 2 header bits)
BASIC_PRIMITIVE = 0
BASIC_SHORT_STRING = 1
BASIC_OBJECT = 2
BASIC_ARRAY = 3

# primitive type codes (header >> 2)
P_NULL = 0
P_TRUE = 1
P_FALSE = 2
P_INT8 = 3
P_INT16 = 4
P_INT32 = 5
P_INT64 = 6
P_DOUBLE = 7
P_DECIMAL4 = 8
P_DECIMAL8 = 9
P_DECIMAL16 = 10
P_DATE = 11
P_TIMESTAMP_MICROS = 12
P_TIMESTAMP_MICROS_NTZ = 13
P_FLOAT = 14
P_BINARY = 15
P_STRING = 16
P_TIME_MICROS_NTZ = 17
P_TIMESTAMP_NANOS = 18
P_TIMESTAMP_NANOS_NTZ = 19
P_UUID = 20

EMPTY_METADATA = b"\x01\x00\x00"
_EPOCH = _dt.date(1970, 1, 1)
_UTC = _dt.timezone.utc


def _uint_le(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _min_offset_size(max_value: int) -> int:
    for n in (1, 2, 3):
        if max_value < (1 << (8 * n)):
            return n
    return 4


class Metadata:
    """Variant metadata: the key dictionary (reference variant.go:148)."""

    def __init__(self, data: bytes = EMPTY_METADATA):
        data = bytes(data)
        if not data:
            raise ArrowInvalid("empty variant metadata")
        hdr = data[0]
        if hdr & 0x0F != 1:
            raise ArrowInvalid(f"unsupported variant version {hdr & 0x0F}")
        self.data = data
        self.sorted_and_unique = bool(hdr & 0b10000)
        off_sz = ((hdr >> 6) & 0b11) + 1
        self.offset_size = off_sz
        n = _uint_le(data[1:1 + off_sz])
        pos = 1 + off_sz
        offsets = [_uint_le(data[pos + i * off_sz: pos + (i + 1) * off_sz])
                   for i in range(n + 1)]
        base = pos + (n + 1) * off_sz
        self.keys: List[str] = [
            data[base + offsets[i]: base + offsets[i + 1]].decode("utf-8")
            for i in range(n)]
        self._index = {k: i for i, k in enumerate(self.keys)}

    @property
    def dictionary_size(self) -> int:
        return len(self.keys)

    def key_at(self, i: int) -> str:
        return self.keys[i]

    def id_for(self, key: str) -> Optional[int]:
        return self._index.get(key)

    @staticmethod
    def build(keys: List[str], sorted_and_unique: bool = False) -> "Metadata":
        blob = b"".join(k.encode("utf-8") for k in keys)
        offsets = [0]
        for k in keys:
            offsets.append(offsets[-1] + len(k.encode("utf-8")))
        off_sz = _min_offset_size(max(offsets[-1], len(keys)))
        hdr = 1 | (0b10000 if sorted_and_unique else 0) | ((off_sz - 1) << 6)
        out = bytearray([hdr])
        out += len(keys).to_bytes(off_sz, "little")
        for o in offsets:
            out += o.to_bytes(off_sz, "little")
        out += blob
        return Metadata(bytes(out))


class Value:
    """A variant value bound to its metadata (reference variant.go:505)."""

    def __init__(self, metadata: Metadata, value: bytes):
        self.metadata = metadata
        self.value = bytes(value)
        if not self.value:
            raise ArrowInvalid("empty variant value")

    @property
    def basic_type(self) -> int:
        return self.value[0] & 0b11

    def to_python(self) -> Any:
        return _decode(self.metadata, self.value, 0)[0]

    def to_json(self) -> str:
        return _json.dumps(self.to_python(), default=_json_default)


def _json_default(o):
    if isinstance(o, (_dt.datetime, _dt.date, _dt.time)):
        return o.isoformat()
    if isinstance(o, _pydec.Decimal):
        return str(o)
    if isinstance(o, _uuid.UUID):
        return str(o)
    if isinstance(o, bytes):
        import base64
        return base64.b64encode(o).decode()
    raise TypeError(type(o))


def _decode(meta: Metadata, v: bytes, pos: int) -> Tuple[Any, int]:
    """Decode the value at v[pos:], returning (python value, end pos)."""
    hdr = v[pos]
    basic = hdr & 0b11
    info = hdr >> 2
    if basic == BASIC_SHORT_STRING:
        n = info
        return v[pos + 1: pos + 1 + n].decode("utf-8"), pos + 1 + n
    if basic == BASIC_PRIMITIVE:
        return _decode_primitive(info, v, pos + 1)
    if basic == BASIC_OBJECT:
        off_sz = (info & 0b11) + 1
        id_sz = ((info >> 2) & 0b11) + 1
        large = (info >> 4) & 1
        nsz = 4 if large else 1
        n = _uint_le(v[pos + 1: pos + 1 + nsz])
        id_start = pos + 1 + nsz
        off_start = id_start + n * id_sz
        data_start = off_start + (n + 1) * off_sz
        out: Dict[str, Any] = {}
        for i in range(n):
            fid = _uint_le(v[id_start + i * id_sz: id_start + (i + 1) * id_sz])
            o = _uint_le(v[off_start + i * off_sz: off_start + (i + 1) * off_sz])
            val, _ = _decode(meta, v, data_start + o)
            out[meta.key_at(fid)] = val
        end_off = _uint_le(v[off_start + n * off_sz:
                             off_start + (n + 1) * off_sz])
        return out, data_start + end_off
    # BASIC_ARRAY
    off_sz = (info & 0b11) + 1
    large = (info >> 2) & 1
    if large:
        n = _uint_le(v[pos + 1: pos + 5])
        off_start = pos + 5
    else:
        n = v[pos + 1]
        off_start = pos + 2
    data_start = off_start + (n + 1) * off_sz
    items = []
    for i in range(n):
        o = _uint_le(v[off_start + i * off_sz: off_start + (i + 1) * off_sz])
        val, _ = _decode(meta, v, data_start + o)
        items.append(val)
    end_off = _uint_le(v[off_start + n * off_sz: off_start + (n + 1) * off_sz])
    return items, data_start + end_off


def _decode_primitive(code: int, v: bytes, pos: int) -> Tuple[Any, int]:
    if code == P_NULL:
        return None, pos
    if code == P_TRUE:
        return True, pos
    if code == P_FALSE:
        return False, pos
    if code == P_INT8:
        return struct.unpack_from("<b", v, pos)[0], pos + 1
    if code == P_INT16:
        return struct.unpack_from("<h", v, pos)[0], pos + 2
    if code == P_INT32:
        return struct.unpack_from("<i", v, pos)[0], pos + 4
    if code == P_INT64:
        return struct.unpack_from("<q", v, pos)[0], pos + 8
    if code == P_DOUBLE:
        return struct.unpack_from("<d", v, pos)[0], pos + 8
    if code == P_FLOAT:
        return struct.unpack_from("<f", v, pos)[0], pos + 4
    if code in (P_DECIMAL4, P_DECIMAL8, P_DECIMAL16):
        scale = v[pos]
        width = {P_DECIMAL4: 4, P_DECIMAL8: 8, P_DECIMAL16: 16}[code]
        unscaled = int.from_bytes(v[pos + 1: pos + 1 + width], "little",
                                  signed=True)
        return (_pydec.Decimal(unscaled).scaleb(-scale), pos + 1 + width)
    if code == P_DATE:
        days = struct.unpack_from("<i", v, pos)[0]
        return _EPOCH + _dt.timedelta(days=days), pos + 4
    if code in (P_TIMESTAMP_MICROS, P_TIMESTAMP_MICROS_NTZ):
        us = struct.unpack_from("<q", v, pos)[0]
        ts = (_dt.datetime(1970, 1, 1, tzinfo=_UTC)
              + _dt.timedelta(microseconds=us))
        if code == P_TIMESTAMP_MICROS_NTZ:
            ts = ts.replace(tzinfo=None)
        return ts, pos + 8
    if code in (P_TIMESTAMP_NANOS, P_TIMESTAMP_NANOS_NTZ):
        ns = struct.unpack_from("<q", v, pos)[0]
        ts = (_dt.datetime(1970, 1, 1, tzinfo=_UTC)
              + _dt.timedelta(microseconds=ns / 1000))
        if code == P_TIMESTAMP_NANOS_NTZ:
            ts = ts.replace(tzinfo=None)
        return ts, pos + 8
    if code == P_TIME_MICROS_NTZ:
        us = struct.unpack_from("<q", v, pos)[0]
        return ((_dt.datetime(1970, 1, 1)
                 + _dt.timedelta(microseconds=us)).time(), pos + 8)
    if code == P_BINARY:
        n = struct.unpack_from("<I", v, pos)[0]
        return bytes(v[pos + 4: pos + 4 + n]), pos + 4 + n
    if code == P_STRING:
        n = struct.unpack_from("<I", v, pos)[0]
        return v[pos + 4: pos + 4 + n].decode("utf-8"), pos + 4 + n
    if code == P_UUID:
        return _uuid.UUID(bytes=bytes(v[pos: pos + 16])), pos + 16
    raise ArrowInvalid(f"unknown variant primitive type {code}")


class Builder:
    """Builds variant (metadata, value) pairs from Python values
    (reference builder.go, dictionary accumulation + offset sizing)."""

    def __init__(self):
        self._keys: List[str] = []
        self._key_ids: Dict[str, int] = {}

    def _key_id(self, key: str) -> int:
        if key not in self._key_ids:
            self._key_ids[key] = len(self._keys)
            self._keys.append(key)
        return self._key_ids[key]

    def build(self, obj: Any) -> Value:
        val = self._encode(obj)
        meta = Metadata.build(self._keys)
        return Value(meta, val)

    def metadata(self) -> Metadata:
        return Metadata.build(self._keys)

    def encode_value(self, obj: Any) -> bytes:
        """Value bytes only — call metadata() after encoding all values
        (shared-dictionary usage for variant columns)."""
        return self._encode(obj)

    def _encode(self, o: Any) -> bytes:
        if o is None:
            return bytes([P_NULL << 2])
        if isinstance(o, bool):
            return bytes([(P_TRUE if o else P_FALSE) << 2])
        if isinstance(o, int):
            for code, fmtc, lo, hi in ((P_INT8, "<b", -2**7, 2**7),
                                       (P_INT16, "<h", -2**15, 2**15),
                                       (P_INT32, "<i", -2**31, 2**31),
                                       (P_INT64, "<q", -2**63, 2**63)):
                if lo <= o < hi:
                    return bytes([code << 2]) + struct.pack(fmtc, o)
            raise ArrowInvalid("int out of int64 range for variant")
        if isinstance(o, float):
            return bytes([P_DOUBLE << 2]) + struct.pack("<d", o)
        if isinstance(o, _pydec.Decimal):
            sign, digits, exp = o.as_tuple()
            if exp > 0:
                o = o.quantize(_pydec.Decimal(1))
                sign, digits, exp = o.as_tuple()
            scale = -exp
            unscaled = int(o.scaleb(scale))
            for code, width, prec in ((P_DECIMAL4, 4, 9), (P_DECIMAL8, 8, 18),
                                      (P_DECIMAL16, 16, 38)):
                if abs(unscaled) < 10 ** prec and scale <= prec:
                    return (bytes([code << 2, scale])
                            + unscaled.to_bytes(width, "little", signed=True))
            raise ArrowInvalid("decimal exceeds variant decimal16 range")
        if isinstance(o, str):
            raw = o.encode("utf-8")
            if len(raw) <= 0x3F:
                return bytes([(len(raw) << 2) | BASIC_SHORT_STRING]) + raw
            return (bytes([P_STRING << 2]) + struct.pack("<I", len(raw))
                    + raw)
        if isinstance(o, (bytes, bytearray, memoryview)):
            raw = bytes(o)
            return (bytes([P_BINARY << 2]) + struct.pack("<I", len(raw))
                    + raw)
        if isinstance(o, _uuid.UUID):
            return bytes([P_UUID << 2]) + o.bytes
        if isinstance(o, _dt.datetime):
            us = _timestamp_micros(o)
            code = (P_TIMESTAMP_MICROS if o.tzinfo is not None
                    else P_TIMESTAMP_MICROS_NTZ)
            return bytes([code << 2]) + struct.pack("<q", us)
        if isinstance(o, _dt.date):
            return (bytes([P_DATE << 2])
                    + struct.pack("<i", (o - _EPOCH).days))
        if isinstance(o, _dt.time):
            us = ((o.hour * 60 + o.minute) * 60 + o.second) * 10**6 \
                + o.microsecond
            return bytes([P_TIME_MICROS_NTZ << 2]) + struct.pack("<q", us)
        if isinstance(o, (list, tuple)):
            return self._encode_array([self._encode(x) for x in o])
        if isinstance(o, dict):
            fields = [(self._key_id(str(k)), self._encode(vv))
                      for k, vv in o.items()]
            return self._encode_object(fields)
        raise ArrowInvalid(f"cannot encode {type(o)} as variant")

    def _encode_array(self, items: List[bytes]) -> bytes:
        offsets = [0]
        for it in items:
            offsets.append(offsets[-1] + len(it))
        off_sz = _min_offset_size(offsets[-1])
        large = len(items) > 0xFF
        info = (off_sz - 1) | (0b100 if large else 0)
        out = bytearray([(info << 2) | BASIC_ARRAY])
        out += len(items).to_bytes(4 if large else 1, "little")
        for o in offsets:
            out += o.to_bytes(off_sz, "little")
        for it in items:
            out += it
        return bytes(out)

    def _encode_object(self, fields: List[Tuple[int, bytes]]) -> bytes:
        # fields sorted by key name per spec
        fields = sorted(fields, key=lambda f: self._keys[f[0]])
        offsets = [0]
        for _, fv in fields:
            offsets.append(offsets[-1] + len(fv))
        max_id = max((fid for fid, _ in fields), default=0)
        id_sz = _min_offset_size(max_id)
        off_sz = _min_offset_size(offsets[-1])
        large = len(fields) > 0xFF
        info = (off_sz - 1) | ((id_sz - 1) << 2) | (0b10000 if large else 0)
        out = bytearray([(info << 2) | BASIC_OBJECT])
        out += len(fields).to_bytes(4 if large else 1, "little")
        for fid, _ in fields:
            out += fid.to_bytes(id_sz, "little")
        for o in offsets:
            out += o.to_bytes(off_sz, "little")
        for _, fv in fields:
            out += fv
        return bytes(out)


def _timestamp_micros(ts: _dt.datetime) -> int:
    if ts.tzinfo is not None:
        delta = ts - _dt.datetime(1970, 1, 1, tzinfo=_UTC)
    else:
        delta = ts - _dt.datetime(1970, 1, 1)
    return (delta.days * 86400 + delta.seconds) * 10**6 + delta.microseconds


def encode(obj: Any) -> Tuple[bytes, bytes]:
    """Python value -> (metadata bytes, value bytes)."""
    v = Builder().build(obj)
    return v.metadata.data, v.value


def decode(metadata: bytes, value: bytes) -> Any:
    """(metadata bytes, value bytes) -> Python value."""
    return Value(Metadata(metadata), value).to_python()
