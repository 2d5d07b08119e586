"""Bitmap utilities of the port (Arrow LSB bit order), numpy-vectorized:
its own copy of arrow_go_tpu/memory/bitutil.py.

Host-side counterpart of the reference's arrow/bitutil (bit get/set/count,
bitmap AND/OR — reference arrow/bitutil/bitutil.go:50-158 and
bitmap_ops_*.s SIMD ops), on numpy uint8 bitmaps with the same bit order
and offsets as the JAX module. The device-side words (int32 carrying u32
bit patterns, one word per 32 rows) are in ops/bitmap.py.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)

# Little-endian bit masks within a byte (Arrow spec: LSB numbering).
_BIT = np.left_shift(np.uint8(1), np.arange(8, dtype=np.uint8))


def bytes_for_bits(n: int) -> int:
    return (int(n) + 7) >> 3


def ceil_byte(n: int) -> int:
    return (int(n) + 7) & ~7


def get_bit(buf, i: int) -> bool:
    b = np.frombuffer(buf, dtype=np.uint8, count=(i >> 3) + 1) if isinstance(buf, (bytes, bytearray, memoryview)) else buf
    return bool((b[i >> 3] >> (i & 7)) & 1)


def set_bit(buf: np.ndarray, i: int) -> None:
    buf[i >> 3] |= np.uint8(1 << (i & 7))


def clear_bit(buf: np.ndarray, i: int) -> None:
    buf[i >> 3] &= np.uint8(~(1 << (i & 7)) & 0xFF)


def set_bit_to(buf: np.ndarray, i: int, v: bool) -> None:
    if v:
        set_bit(buf, i)
    else:
        clear_bit(buf, i)


def pack_bits(bools: np.ndarray, length: Optional[int] = None) -> np.ndarray:
    """bool array -> LSB-ordered packed bitmap bytes (padding bits zero)."""
    bools = np.asarray(bools, dtype=np.bool_).ravel()
    if length is not None:
        bools = bools[:length]
    return np.packbits(bools, bitorder="little")


def unpack_bits(bitmap: np.ndarray, length: int, offset: int = 0) -> np.ndarray:
    """LSB-ordered packed bitmap -> bool array of `length` starting at `offset` bits."""
    if length == 0:
        return np.zeros(0, dtype=np.bool_)
    bitmap = np.frombuffer(bitmap, dtype=np.uint8) if isinstance(bitmap, (bytes, bytearray, memoryview)) else np.asarray(bitmap, dtype=np.uint8)
    start_byte = offset >> 3
    bit_off = offset & 7
    nbytes = bytes_for_bits(bit_off + length)
    u = np.unpackbits(bitmap[start_byte:start_byte + nbytes], bitorder="little")
    return u[bit_off:bit_off + length].astype(np.bool_)


def count_set_bits(bitmap, offset: int = 0, length: Optional[int] = None) -> int:
    """Popcount of `length` bits starting at bit `offset` (reference CountSetBits)."""
    b = np.frombuffer(bitmap, dtype=np.uint8) if isinstance(bitmap, (bytes, bytearray, memoryview)) else np.asarray(bitmap, dtype=np.uint8)
    if length is None:
        length = b.size * 8 - offset
    if length <= 0:
        return 0
    start_byte, start_bit = offset >> 3, offset & 7
    end = offset + length
    end_byte, end_bit = end >> 3, end & 7
    if start_byte == end_byte or (start_byte == end_byte - (1 if end_bit == 0 else 0) and start_bit == 0 and end_bit == 0):
        pass
    if start_bit == 0 and end_bit == 0:
        return int(_POPCOUNT8[b[start_byte:end_byte]].sum())
    if start_byte == end_byte:
        mask = ((1 << end_bit) - 1) & ~((1 << start_bit) - 1) if end_bit else (0xFF & ~((1 << start_bit) - 1))
        return int(_POPCOUNT8[b[start_byte] & mask])
    total = 0
    if start_bit:
        total += int(_POPCOUNT8[b[start_byte] & (0xFF & ~((1 << start_bit) - 1))])
        start_byte += 1
    total += int(_POPCOUNT8[b[start_byte:end_byte]].sum())
    if end_bit:
        total += int(_POPCOUNT8[b[end_byte] & ((1 << end_bit) - 1)])
    return total


def set_bits_to(buf: np.ndarray, offset: int, length: int, value: bool) -> None:
    """Set a run of bits (reference SetBitsTo, arrow/bitutil/bitutil.go:158)."""
    if length <= 0:
        return
    bools = unpack_bits(buf, buf.size * 8)
    bools[offset:offset + length] = value
    buf[:] = np.packbits(bools, bitorder="little")[:buf.size]


def _aligned_view(a: np.ndarray, b: np.ndarray, nbytes: int) -> Tuple[np.ndarray, np.ndarray]:
    return a[:nbytes], b[:nbytes]


def bitmap_and(a, b, length_bits: int, offset_a: int = 0, offset_b: int = 0) -> np.ndarray:
    """AND two bitmaps over [0, length_bits), honoring bit offsets; returns packed bytes."""
    if offset_a == 0 and offset_b == 0:
        n = bytes_for_bits(length_bits)
        a8 = np.frombuffer(a, dtype=np.uint8, count=n) if isinstance(a, (bytes, bytearray, memoryview)) else np.asarray(a, np.uint8)[:n]
        b8 = np.frombuffer(b, dtype=np.uint8, count=n) if isinstance(b, (bytes, bytearray, memoryview)) else np.asarray(b, np.uint8)[:n]
        return np.bitwise_and(a8, b8)
    ab = unpack_bits(a, length_bits, offset_a)
    bb = unpack_bits(b, length_bits, offset_b)
    return pack_bits(ab & bb)


def bitmap_or(a, b, length_bits: int, offset_a: int = 0, offset_b: int = 0) -> np.ndarray:
    if offset_a == 0 and offset_b == 0:
        n = bytes_for_bits(length_bits)
        a8 = np.frombuffer(a, dtype=np.uint8, count=n) if isinstance(a, (bytes, bytearray, memoryview)) else np.asarray(a, np.uint8)[:n]
        b8 = np.frombuffer(b, dtype=np.uint8, count=n) if isinstance(b, (bytes, bytearray, memoryview)) else np.asarray(b, np.uint8)[:n]
        return np.bitwise_or(a8, b8)
    ab = unpack_bits(a, length_bits, offset_a)
    bb = unpack_bits(b, length_bits, offset_b)
    return pack_bits(ab | bb)


def bitmap_xor(a, b, length_bits: int) -> np.ndarray:
    n = bytes_for_bits(length_bits)
    return np.bitwise_xor(np.asarray(a, np.uint8)[:n], np.asarray(b, np.uint8)[:n])


def bitmap_not(a, length_bits: int) -> np.ndarray:
    n = bytes_for_bits(length_bits)
    out = np.bitwise_not(np.asarray(a, np.uint8)[:n])
    # zero the padding bits in the last byte
    rem = length_bits & 7
    if rem and n:
        out[-1] &= np.uint8((1 << rem) - 1)
    return out


def bits_to_indices(bitmap, length: int, offset: int = 0) -> np.ndarray:
    """Set-bit positions (the host analog of getTakeIndices,
    reference arrow/compute/internal/kernels/vector_selection.go:102)."""
    return np.nonzero(unpack_bits(bitmap, length, offset))[0].astype(np.int64)


class BitRun:
    __slots__ = ("value", "length")

    def __init__(self, value: bool, length: int):
        self.value = value
        self.length = length

    def __repr__(self):
        return f"BitRun({self.value}, {self.length})"


def bit_runs(bitmap, length: int, offset: int = 0):
    """Iterate runs of equal bits (reference internal/bitutils/bit_run_reader.go:43)."""
    bools = unpack_bits(bitmap, length, offset)
    if length == 0:
        return
    change = np.nonzero(np.diff(bools))[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [length]))
    for s, e in zip(starts, ends):
        yield BitRun(bool(bools[s]), int(e - s))
