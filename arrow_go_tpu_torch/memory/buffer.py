"""Host buffers and allocators: the port's own copy of
arrow_go_tpu/memory/buffer.py (numpy only).

Counterpart of the reference's arrow/memory (Allocator at
arrow/memory/allocator.go:23, Buffer at arrow/memory/buffer.go:26,
CheckedAllocator at checked_allocator.go:33). The port's columns hold
numpy arrays (device/block.HostArray) and torch tensors on the card, so
nothing in the port allocates through these; they keep the reference's
buffer type and its leak-accounting test hook (`TrackedAllocator.
assert_size`) for code that manages its own host bytes. Python's garbage
collector replaces the reference's Retain/Release refcounting.
"""
from __future__ import annotations

import threading
import traceback
from typing import Dict, Optional, Tuple

import numpy as np

ALIGNMENT = 64


class Buffer:
    """Immutable-by-convention byte buffer over numpy memory, 64-byte aligned."""

    __slots__ = ("_data", "_length", "_allocator")

    def __init__(self, data: Optional[np.ndarray] = None,
                 length: Optional[int] = None,
                 allocator: Optional["Allocator"] = None):
        if data is None:
            data = np.zeros(0, dtype=np.uint8)
        if not isinstance(data, np.ndarray):
            data = np.frombuffer(bytes(data), dtype=np.uint8)
        data = data.view(np.uint8).ravel()
        self._data = data
        self._length = len(data) if length is None else int(length)
        self._allocator = allocator

    @staticmethod
    def from_bytes(b) -> "Buffer":
        return Buffer(np.frombuffer(bytes(b), dtype=np.uint8).copy())

    @staticmethod
    def wrap(arr: np.ndarray) -> "Buffer":
        """Zero-copy wrap of an existing numpy array's memory."""
        return Buffer(np.ascontiguousarray(arr).view(np.uint8).ravel())

    @property
    def data(self) -> np.ndarray:
        return self._data[: self._length]

    @property
    def raw(self) -> np.ndarray:
        """Whole capacity, including any padding."""
        return self._data

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    @property
    def capacity(self) -> int:
        return len(self._data)

    def view(self, dtype) -> np.ndarray:
        d = np.dtype(dtype)
        n = self._length // d.itemsize
        return self._data[: n * d.itemsize].view(d)

    def slice(self, offset: int, length: Optional[int] = None) -> "Buffer":
        """Zero-copy sub-window (reference SliceBuffer, buffer.go:62)."""
        if length is None:
            length = self._length - offset
        return Buffer(self._data[offset: offset + length], length)

    def to_bytes(self) -> bytes:
        return self.data.tobytes()

    def equals(self, other: "Buffer") -> bool:
        return self._length == other._length and bool(
            np.array_equal(self.data, other.data))

    def __repr__(self):
        return f"Buffer(len={self._length})"


class Allocator:
    """Allocation source for host buffers (reference memory.Allocator)."""

    def allocate(self, size: int) -> Buffer:
        cap = _round_up(size, ALIGNMENT)
        return Buffer(np.zeros(cap, dtype=np.uint8), size, self)

    def reallocate(self, buf: Buffer, size: int) -> Buffer:
        if size <= buf.capacity:
            return Buffer(buf.raw, size, self)
        nb = self.allocate(size)
        nb.raw[: buf.length] = buf.data
        return nb

    def free(self, buf: Buffer) -> None:  # GC handles memory; hook for tracking
        pass


class TrackedAllocator(Allocator):
    """Leak/size-accounting allocator (reference CheckedAllocator,
    arrow/memory/checked_allocator.go:33-154): tracks live bytes, the
    peak, and with `record_stacks` each live allocation's call site;
    assert_size() is the test hook."""

    def __init__(self, record_stacks: bool = False):
        self._lock = threading.Lock()
        self._live: Dict[int, Tuple[int, Optional[str]]] = {}
        self._bytes = 0
        self._peak = 0
        self._record_stacks = record_stacks

    def allocate(self, size: int) -> Buffer:
        buf = super().allocate(size)
        stack = "".join(traceback.format_stack(limit=8)) \
            if self._record_stacks else None
        with self._lock:
            self._live[id(buf)] = (size, stack)
            self._bytes += size
            self._peak = max(self._peak, self._bytes)
        return buf

    def free(self, buf: Buffer) -> None:
        with self._lock:
            rec = self._live.pop(id(buf), None)
            if rec is None:
                raise RuntimeError("free of buffer not allocated by this "
                                   "allocator (double free or foreign "
                                   "buffer)")
            self._bytes -= rec[0]

    @property
    def allocated_bytes(self) -> int:
        return self._bytes

    @property
    def peak_bytes(self) -> int:
        return self._peak

    def assert_size(self, expected: int = 0) -> None:
        if self._bytes != expected:
            sites = [s for _, s in self._live.values() if s]
            msg = (f"allocator size mismatch: live={self._bytes} "
                   f"expected={expected}")
            if sites:
                msg += "\nleaked allocation sites:\n" + \
                    "\n---\n".join(sites[:5])
            raise AssertionError(msg)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


default_allocator = Allocator()
