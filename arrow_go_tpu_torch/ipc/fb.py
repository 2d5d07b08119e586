"""The port's own FlatBuffers reader and builder for the Arrow format's
metadata.

Port of arrow_go_tpu/ipc/fb.py, which drives the `flatbuffers` package;
the card machine has none, so this module reads and builds the buffers
itself, in plain Python over `bytes` / `bytearray` and `struct`, with the
stable slot ids of the Arrow format spec (format/*.fbs): slot n lives at
vtable offset 4 + 2n.

`Builder` is the subset of `flatbuffers.Builder` that ipc/metadata.py and
ipc/core.py use (tables, vtables with the same deduplication, vectors,
strings, inline structs, `Finish`), laid out by the same rules (built
back to front, each scalar aligned to its size), so its buffers are the
ones that package builds, byte for byte. A read past the buffer raises
ArrowInvalid.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional

from ..compute.errors import ArrowInvalid


def vt(slot: int) -> int:
    return 4 + 2 * slot


def _unpack(fmt: str, buf, pos: int):
    try:
        return struct.unpack_from(fmt, buf, pos)[0]
    except struct.error as e:
        raise ArrowInvalid(f"flatbuffer read past its end: {e}") from None


class Reader:
    """Cursor over one flatbuffers table: its buffer, its position and
    its vtable."""

    __slots__ = ("buf", "pos", "_vt", "_vt_len")

    def __init__(self, buf, pos: int):
        self.buf = buf
        self.pos = pos
        if pos < 0:
            raise ArrowInvalid("flatbuffer table before its buffer")
        self._vt = pos - _unpack("<i", buf, pos)
        self._vt_len = _unpack("<H", buf, self._vt)

    @staticmethod
    def root(buf) -> "Reader":
        return Reader(buf, _unpack("<I", buf, 0))

    def _off(self, slot: int) -> int:
        o = vt(slot)
        return _unpack("<H", self.buf, self._vt + o) if o < self._vt_len \
            else 0

    def _scalar(self, fmt: str, slot: int, default):
        o = self._off(slot)
        return _unpack(fmt, self.buf, self.pos + o) if o else default

    def bool_(self, slot: int, default: bool = False) -> bool:
        return bool(self._scalar("<B", slot, default))

    def i8(self, slot: int, default: int = 0) -> int:
        return self._scalar("<b", slot, default)

    def u8(self, slot: int, default: int = 0) -> int:
        return self._scalar("<B", slot, default)

    def i16(self, slot: int, default: int = 0) -> int:
        return self._scalar("<h", slot, default)

    def i32(self, slot: int, default: int = 0) -> int:
        return self._scalar("<i", slot, default)

    def i64(self, slot: int, default: int = 0) -> int:
        return self._scalar("<q", slot, default)

    def _indirect(self, at: int) -> int:
        return at + _unpack("<I", self.buf, at)

    def string(self, slot: int) -> Optional[str]:
        o = self._off(slot)
        if not o:
            return None
        at = self._indirect(self.pos + o)
        n = _unpack("<I", self.buf, at)
        raw = bytes(self.buf[at + 4: at + 4 + n])
        if len(raw) != n:
            raise ArrowInvalid("flatbuffer string past its buffer")
        return raw.decode("utf-8", "surrogateescape")

    def table(self, slot: int) -> Optional["Reader"]:
        o = self._off(slot)
        return Reader(self.buf, self._indirect(self.pos + o)) if o else None

    def _vector(self, slot: int) -> int:
        """The position of a vector's first element."""
        return self._indirect(self.pos + self._off(slot)) + 4

    def vector_len(self, slot: int) -> int:
        o = self._off(slot)
        return _unpack("<I", self.buf, self._indirect(self.pos + o)) if o \
            else 0

    def vector_table(self, slot: int, i: int) -> "Reader":
        return Reader(self.buf, self._indirect(self._vector(slot) + i * 4))

    def vector_i64(self, slot: int, i: int) -> int:
        return _unpack("<q", self.buf, self._vector(slot) + i * 8)

    def vector_i32(self, slot: int, i: int) -> int:
        return _unpack("<i", self.buf, self._vector(slot) + i * 4)

    def vector_struct_pos(self, slot: int, i: int, struct_size: int) -> int:
        return self._vector(slot) + i * struct_size

    def get(self, fmt: str, pos: int):
        """One scalar at an absolute position (a struct's member)."""
        return _unpack(fmt, self.buf, pos)


class Builder:
    """Builds one flatbuffer back to front (the flatbuffers package's
    Builder algorithm): `head` is where the data written so far begins,
    offsets count from the buffer's end."""

    def __init__(self, initial_size: int = 1024):
        self.buf = bytearray(initial_size)
        self.head = initial_size
        self.minalign = 1
        self.vtable: Optional[List[int]] = None
        self.object_end = 0
        self.vtables: Dict[tuple, int] = {}
        self.vector_len = 0

    def offset(self) -> int:
        return len(self.buf) - self.head

    def _grow(self, needed: int) -> None:
        while self.head < needed:
            old = len(self.buf)
            size = max(old * 2, 1)
            self.buf = bytearray(size - old) + self.buf
            self.head += size - old

    def pad(self, n: int) -> None:
        if n > 0:
            self.head -= n
            self.buf[self.head:self.head + n] = b"\0" * n

    def prep(self, size: int, additional: int) -> None:
        """Align so that a `size`-byte scalar can follow `additional`
        bytes written next."""
        self.minalign = max(self.minalign, size)
        align = (-(self.offset() + additional)) & (size - 1)
        self._grow(align + size + additional)
        self.pad(align)

    def place(self, fmt: str, x) -> None:
        n = struct.calcsize(fmt)
        self.head -= n
        struct.pack_into(fmt, self.buf, self.head, x)

    def prepend(self, fmt: str, x) -> None:
        self.prep(struct.calcsize(fmt), 0)
        self.place(fmt, x)

    def prepend_uoffset(self, off: int) -> None:
        self.prep(4, 0)
        if off > self.offset():
            raise ValueError("flatbuffers: offset arithmetic error")
        self.place("<I", self.offset() - off + 4)

    # tables ---------------------------------------------------------------
    def start_object(self, n: int) -> None:
        self.vtable = [0] * n
        self.object_end = self.offset()

    def slot(self, i: int) -> None:
        self.vtable[i] = self.offset()

    def add(self, i: int, fmt: str, x, default) -> None:
        """A scalar field, written only when it is not its default."""
        if x != default:
            self.prepend(fmt, x)
            self.slot(i)

    def add_offset(self, i: int, off: int) -> None:
        self.prepend_uoffset(off)
        self.slot(i)

    def end_object(self) -> int:
        self.prepend("<i", 0)                # the vtable offset, set below
        obj = self.offset()
        fields = list(self.vtable)
        while fields and fields[-1] == 0:
            fields.pop()
        rel = [obj - f if f else 0 for f in fields]
        size = obj - self.object_end
        key = tuple(reversed(rel)) + (size,)
        at = self.vtables.get(key)
        if at is None:
            for r in reversed(rel):
                self.prepend("<H", r)
            self.prepend("<H", size)
            self.prepend("<H", (len(rel) + 2) * 2)
            struct.pack_into("<i", self.buf, len(self.buf) - obj,
                             self.offset() - obj)
            self.vtables[key] = self.offset()
        else:
            self.head = len(self.buf) - obj
            struct.pack_into("<i", self.buf, self.head, at - obj)
        self.vtable = None
        return obj

    # vectors and strings ----------------------------------------------------
    def start_vector(self, elem_size: int, n: int, alignment: int) -> None:
        self.vector_len = n
        self.prep(4, elem_size * n)
        self.prep(alignment, elem_size * n)

    def end_vector(self) -> int:
        self.place("<I", self.vector_len)
        return self.offset()

    def create_string(self, s: str) -> int:
        raw = s.encode("utf-8", "surrogateescape")
        self.prep(4, len(raw) + 1)
        self.place("<B", 0)
        self.head -= len(raw)
        self.buf[self.head:self.head + len(raw)] = raw
        self.vector_len = len(raw)
        return self.end_vector()

    def offsets_vector(self, offs: List[int]) -> int:
        self.start_vector(4, len(offs), 4)
        for o in reversed(offs):
            self.prepend_uoffset(o)
        return self.end_vector()

    def finish(self, root: int) -> bytes:
        self.prep(self.minalign, 4)
        self.prepend_uoffset(root)
        return bytes(self.buf[self.head:])
