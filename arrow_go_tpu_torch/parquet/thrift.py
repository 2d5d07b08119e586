"""Thrift compact-protocol codec (self-contained; no thrift dependency).

The port's own copy of arrow_go_tpu/parquet/thrift.py.

The reference uses thrift-generated Go (parquet/internal/gen-go) plus thin
serializer helpers (parquet/internal/thrift). Here a declarative struct
spec drives one generic reader/writer for the compact wire protocol used
by parquet footers and page headers.

Wire format: structs are sequences of field headers
((delta<<4)|type nibble, long-form field id as zigzag varint when delta
is 0), ints are zigzag varints, binary is varint length + bytes,
lists are (size<<4)|elem_type with varint overflow, doubles are 8-byte LE.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

# compact type nibbles
CT_STOP = 0
CT_TRUE = 1
CT_FALSE = 2
CT_BYTE = 3
CT_I16 = 4
CT_I32 = 5
CT_I64 = 6
CT_DOUBLE = 7
CT_BINARY = 8
CT_LIST = 9
CT_SET = 10
CT_MAP = 11
CT_STRUCT = 12


class Spec:
    """Field spec: {field_id: (name, kind)} where kind is one of
    'bool','i8','i16','i32','i64','double','binary','string','struct:<cls>',
    'list:<kind>'."""


class ThriftStruct:
    """Base for declarative thrift structs: subclasses set FIELDS."""

    FIELDS: Dict[int, Tuple[str, Any]] = {}

    def __init__(self, **kwargs):
        for fid, (name, _kind) in self.FIELDS.items():
            setattr(self, name, kwargs.get(name))

    def __repr__(self):
        vals = {name: getattr(self, name)
                for _, (name, _) in self.FIELDS.items()
                if getattr(self, name) is not None}
        return f"{type(self).__name__}({vals})"

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return all(getattr(self, n) == getattr(other, n)
                   for _, (n, _) in self.FIELDS.items())


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class CompactReader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def double(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    def binary(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return bytes(out)

    def skip(self, ctype: int) -> None:
        if ctype in (CT_TRUE, CT_FALSE):
            return
        if ctype == CT_BYTE:
            self.pos += 1
        elif ctype in (CT_I16, CT_I32, CT_I64):
            self.varint()
        elif ctype == CT_DOUBLE:
            self.pos += 8
        elif ctype == CT_BINARY:
            self.pos += self.varint()
        elif ctype in (CT_LIST, CT_SET):
            head = self.buf[self.pos]
            self.pos += 1
            size = head >> 4
            et = head & 0x0F
            if size == 15:
                size = self.varint()
            for _ in range(size):
                self.skip(et)
        elif ctype == CT_STRUCT:
            last_fid = 0
            while True:
                b = self.buf[self.pos]
                self.pos += 1
                if b == CT_STOP:
                    return
                delta = b >> 4
                ft = b & 0x0F
                if delta:
                    last_fid += delta
                else:
                    last_fid = self.zigzag()
                self.skip(ft)
        elif ctype == CT_MAP:
            size = self.varint()
            if size:
                kv = self.buf[self.pos]
                self.pos += 1
                for _ in range(size):
                    self.skip(kv >> 4)
                    self.skip(kv & 0x0F)
        else:
            raise ValueError(f"bad thrift compact type {ctype}")

    def read_struct(self, cls):
        obj = cls()
        fid = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            if b == CT_STOP:
                return obj
            delta = b >> 4
            ctype = b & 0x0F
            if delta:
                fid += delta
            else:
                fid = self.zigzag()
            spec = cls.FIELDS.get(fid)
            if spec is None:
                self.skip(ctype)
                continue
            name, kind = spec
            setattr(obj, name, self._read_value(ctype, kind))

    def _read_value(self, ctype: int, kind):
        if ctype == CT_TRUE:
            return True
        if ctype == CT_FALSE:
            return False
        if isinstance(kind, str):
            if kind == "i8":  # compact BYTE is a raw byte, not a varint
                b = self.buf[self.pos]
                self.pos += 1
                return b - 256 if b >= 128 else b
            if kind in ("i16", "i32", "i64"):
                return self.zigzag()
            if kind == "double":
                return self.double()
            if kind == "binary":
                return self.binary()
            if kind == "string":
                return self.binary().decode("utf-8", "replace")
            raise ValueError(kind)
        if isinstance(kind, type) and issubclass(kind, ThriftStruct):
            return self.read_struct(kind)
        if isinstance(kind, tuple) and kind[0] == "list":
            head = self.buf[self.pos]
            self.pos += 1
            size = head >> 4
            et = head & 0x0F
            if size == 15:
                size = self.varint()
            if et in (CT_TRUE, CT_FALSE):  # list elems carry a value byte
                out = []
                for _ in range(size):
                    out.append(self.buf[self.pos] == CT_TRUE)
                    self.pos += 1
                return out
            return [self._read_value(et, kind[1]) for _ in range(size)]
        raise ValueError(f"unhandled kind {kind}")


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

class CompactWriter:
    __slots__ = ("out",)

    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> None:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63))

    def binary(self, b: bytes) -> None:
        self.varint(len(b))
        self.out.extend(b)

    def write_struct(self, obj: ThriftStruct) -> None:
        last_fid = 0
        for fid in sorted(obj.FIELDS):
            name, kind = obj.FIELDS[fid]
            v = getattr(obj, name)
            if v is None:
                continue
            ctype = self._ctype_of(kind, v)
            delta = fid - last_fid
            if 0 < delta <= 15:
                self.out.append((delta << 4) | ctype)
            else:
                self.out.append(ctype)
                self.zigzag(fid)
            last_fid = fid
            self._write_value(kind, v, top=True)
        self.out.append(CT_STOP)

    @staticmethod
    def _ctype_of(kind, v) -> int:
        if kind == "bool" or isinstance(v, bool) and kind == "bool":
            return CT_TRUE if v else CT_FALSE
        if isinstance(kind, str):
            return {"i8": CT_BYTE, "i16": CT_I16, "i32": CT_I32,
                    "i64": CT_I64, "double": CT_DOUBLE, "binary": CT_BINARY,
                    "string": CT_BINARY}[kind]
        if isinstance(kind, type):
            return CT_STRUCT
        if isinstance(kind, tuple) and kind[0] == "list":
            return CT_LIST
        raise ValueError(kind)

    def _write_value(self, kind, v, top=False) -> None:
        if kind == "bool":
            if not top:
                self.out.append(CT_TRUE if v else CT_FALSE)
            return
        if kind == "i8":
            self.out.append(v & 0xFF)
            return
        if kind in ("i16", "i32", "i64"):
            self.zigzag(v)
            return
        if kind == "double":
            self.out.extend(struct.pack("<d", v))
            return
        if kind == "binary":
            self.binary(v)
            return
        if kind == "string":
            self.binary(v.encode("utf-8"))
            return
        if isinstance(kind, type) and issubclass(kind, ThriftStruct):
            self.write_struct(v)
            return
        if isinstance(kind, tuple) and kind[0] == "list":
            ekind = kind[1]
            et = (CT_TRUE if ekind == "bool" else
                  self._ctype_of(ekind, v[0] if v else None))
            n = len(v)
            if n < 15:
                self.out.append((n << 4) | et)
            else:
                self.out.append(0xF0 | et)
                self.varint(n)
            for item in v:
                self._write_value(ekind, item)
            return
        raise ValueError(kind)
