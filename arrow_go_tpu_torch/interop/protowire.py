"""The protobuf wire format by hand (varints, tags, length-delimited and
fixed fields, zigzag): an own copy of arrow_go_tpu/interop/protowire.py,
which the Substrait bridge (compute/substrait.py) writes and reads its
messages with. No generated code and no protobuf package, as the IPC
FlatBuffers and the parquet thrift codecs of the port. Only the wire
types Substrait messages need.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

WT_VARINT = 0
WT_FIXED64 = 1
WT_BYTES = 2
WT_FIXED32 = 5


def put_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v &= (1 << 64) - 1
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def get_varint(b: bytes, p: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        c = b[p]
        p += 1
        out |= (c & 0x7F) << shift
        if not c & 0x80:
            return out, p
        shift += 7


def tag(out: bytearray, field: int, wire_type: int) -> None:
    put_varint(out, (field << 3) | wire_type)


def put_field_varint(out: bytearray, field: int, v: int) -> None:
    tag(out, field, WT_VARINT)
    put_varint(out, v)


def put_field_bytes(out: bytearray, field: int, data: bytes) -> None:
    tag(out, field, WT_BYTES)
    put_varint(out, len(data))
    out.extend(data)


def put_field_str(out: bytearray, field: int, s: str) -> None:
    put_field_bytes(out, field, s.encode("utf-8"))


def put_field_msg(out: bytearray, field: int, msg: bytearray) -> None:
    put_field_bytes(out, field, bytes(msg))


def put_field_double(out: bytearray, field: int, v: float) -> None:
    tag(out, field, WT_FIXED64)
    out.extend(struct.pack("<d", v))


def put_field_float(out: bytearray, field: int, v: float) -> None:
    tag(out, field, WT_FIXED32)
    out.extend(struct.pack("<f", v))


def fields(b: bytes) -> Iterator[Tuple[int, int, object]]:
    """Iterate (field_number, wire_type, value). bytes for WT_BYTES,
    int for varint, raw 4/8 bytes for fixed."""
    p = 0
    n = len(b)
    while p < n:
        key, p = get_varint(b, p)
        fid, wt = key >> 3, key & 7
        if wt == WT_VARINT:
            v, p = get_varint(b, p)
            yield fid, wt, v
        elif wt == WT_BYTES:
            ln, p = get_varint(b, p)
            yield fid, wt, b[p:p + ln]
            p += ln
        elif wt == WT_FIXED64:
            yield fid, wt, b[p:p + 8]
            p += 8
        elif wt == WT_FIXED32:
            yield fid, wt, b[p:p + 4]
            p += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def to_dict(b: bytes) -> Dict[int, List[object]]:
    """Collect all fields into {field_number: [values...]}."""
    out: Dict[int, List[object]] = {}
    for fid, _, v in fields(b):
        out.setdefault(fid, []).append(v)
    return out


def first(d: Dict[int, List[object]], fid: int, default=None):
    vs = d.get(fid)
    return vs[0] if vs else default


def zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)
