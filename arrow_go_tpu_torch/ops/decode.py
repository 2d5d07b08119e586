"""Parquet page decoding on the device.

Port of arrow_go_tpu/ops/decode.py (the device analog of the reference's
SIMD decode tier: the bit-unpack of parquet/internal/utils/_lib, the
RLE/bit-packed hybrid of internal/utils/rle.go, BYTE_STREAM_SPLIT,
DELTA_BINARY_PACKED of parquet/internal/encoding/delta_bit_packing.go).

The host parses the control stream (page headers, RLE run headers) into
flat segment tables; the bulk bytes go to the device once and every
value is decoded there by plain tensor code with no data-dependent
control flow:

  out[i]:  seg    = searchsorted(seg_starts, i)          (one gather)
           RLE    -> seg_value[seg]                       (one gather)
           packed -> the two u32 words holding bits
                     [bit0, bit0 + width) of the stream   (two gathers)

These are plain PyTorch (XLA programs in the JAX package, no Pallas).
The JAX package's power-of-two padding of the segment tables was a
guard against recompiles and has no counterpart here; PLAIN values come
out of the byte tensor by `Tensor.view`. Words travel as int32 tensors
carrying u32 bits and are widened to int64 before any shift, so no
shift touches a sign bit but the one that places a 64-bit DELTA
value's high half. Gathers clamp their indices, as JAX gathers
do, so a corrupt stream cannot index past a buffer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import native
from .sort import lexsort_stable, sortable

_U32 = 0xFFFFFFFF
_TORCH_OF = {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
             np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
             np.dtype(np.int64): torch.int64,
             np.dtype(np.float16): torch.float16,
             np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}


def torch_dtype(np_dtype) -> torch.dtype:
    return _TORCH_OF[np.dtype(np_dtype)]


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx.clamp(0, max(t.shape[0] - 1, 0)))


# ---------------------------------------------------------------------------
# bit-unpack: LSB-first packed integers of width 1..32
# ---------------------------------------------------------------------------

def bitunpack_device(words: torch.Tensor, bit_width: int, n: int,
                     bit_offsets=None) -> torch.Tensor:
    """Unpack n LSB-first bit-packed values from int32 words carrying u32
    bits; returns int64 values in [0, 2**bit_width).

    bit_offsets: optional int64[n] absolute starting bit of each value
    (defaults to i * bit_width, the contiguous case). `words` carries one
    trailing guard word (words_from_bytes) so the second word of a value
    exists.
    """
    if bit_width == 0:
        return torch.zeros(n, dtype=torch.int64, device=words.device)
    if bit_offsets is None:
        bit_offsets = torch.arange(n, dtype=torch.int64,
                                   device=words.device) * bit_width
    w64 = words.to(torch.int64) & _U32
    wi = bit_offsets >> 5
    off = bit_offsets & 31
    lo = _take(w64, wi) >> off
    # off == 0 would take the whole next word: guard to no contribution.
    # Otherwise the next word shifts left by at most 31 and stays < 2**63.
    hi = torch.where(off > 0, _take(w64, wi + 1) << torch.where(
        off > 0, 32 - off, 0), 0)
    mask = _U32 if bit_width >= 32 else (1 << bit_width) - 1
    return (lo | hi) & mask


def words_from_bytes(data) -> np.ndarray:
    """Host helper: little-endian byte stream -> uint32 words with one
    trailing guard word (the form bitunpack_device consumes)."""
    pad = (-len(data)) % 4
    buf = bytes(data) + b"\0" * (pad + 4)
    return np.frombuffer(buf, dtype="<u4")


# ---------------------------------------------------------------------------
# RLE/bit-packed hybrid (parquet levels + dictionary indices)
# ---------------------------------------------------------------------------

def parse_rle_segments(data, n: int, bit_width: int, alloc=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Host control-stream parse of an RLE/bit-packed hybrid stream.

    Returns (seg_starts, seg_is_run, seg_payload, words), the tables of
    the JAX package's parse_rle_segments:
      seg_starts[s]  first output index of segment s (int32, ascending)
      seg_is_run[s]  1 if segment s is an RLE run else bit-packed (uint32)
      seg_payload[s] run: the repeated value; packed: the absolute bit
                     offset of the segment's first value in `words`
      words          uint32 bit stream of ALL packed groups, concatenated
                     byte-aligned per group (+ guard word)
    The run headers are walked in the host codec library (native.py): a
    stream of short runs (string codes) has a header every few bytes.
    `alloc(nbytes)` gives the uint8 array that the walk copies the packed
    bodies into and `words` views (np.empty by default; the scan passes
    its pinned staging memory, so the bodies are copied once).
    """
    st, ir, pay, packed, _ = native.rle_parse(data, n, bit_width,
                                              alloc or _empty_u8)
    if not len(st):
        st, ir, pay = np.zeros(1, np.int64), np.ones(1, np.uint32), \
            np.zeros(1, np.int64)
    return st.astype(np.int32), ir, pay, packed.view("<u4")


def _empty_u8(nbytes: int) -> np.ndarray:
    return np.empty(nbytes, np.uint8)


def rle_hybrid_decode_device(seg_starts: torch.Tensor,
                             seg_is_run: torch.Tensor,
                             seg_payload: torch.Tensor, words: torch.Tensor,
                             bit_width: int, n: int) -> torch.Tensor:
    """Decode the segment-table form of parse_rle_segments on the device
    (tables as int64 / bool / int64 / int32-word tensors); int64 out."""
    dev = words.device
    if bit_width == 0:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(seg_starts, i, right=True) - 1
    run = _take(seg_is_run, seg)
    pay = _take(seg_payload, seg)
    rel = i - _take(seg_starts, seg)
    # run segments carry a VALUE in pay, not a bit offset: point their
    # (discarded) unpack at bit 0
    bit0 = torch.where(run, 0, pay + rel * bit_width)
    packed_vals = bitunpack_device(words, bit_width, n, bit_offsets=bit0)
    return torch.where(run, pay, packed_vals)


# ---------------------------------------------------------------------------
# PLAIN, BYTE_STREAM_SPLIT, dictionary
# ---------------------------------------------------------------------------

def plain_decode_device(raw: torch.Tensor, np_dtype, n: int) -> torch.Tensor:
    """PLAIN little-endian fixed-width values from a uint8 byte tensor,
    by a view of its bytes (a copy first when the bytes do not start at
    a multiple of the item size)."""
    t = torch_dtype(np_dtype)
    k = np.dtype(np_dtype).itemsize
    b = raw[: n * k]
    if b.storage_offset() % k:
        b = b.clone()
    return b.view(t)


def byte_stream_split_rows_device(raw: torch.Tensor, width: int,
                                  n: int) -> torch.Tensor:
    """BYTE_STREAM_SPLIT of any width: `width` planes of n bytes -> the
    (n, width) uint8 matrix of the n values' little-endian bytes."""
    return raw[: n * width].reshape(width, n).t().contiguous()


def byte_stream_split_decode_device(raw: torch.Tensor, np_dtype,
                                    n: int) -> torch.Tensor:
    """BYTE_STREAM_SPLIT of a numeric type: its rows viewed as values."""
    k = np.dtype(np_dtype).itemsize
    return byte_stream_split_rows_device(raw, k, n).view(
        torch_dtype(np_dtype)).reshape(-1)


def dict_decode_device(indices: torch.Tensor,
                       dictionary: torch.Tensor) -> torch.Tensor:
    """RLE_DICTIONARY: gather decoded dictionary values by code (zeros
    when the dictionary is empty: every row of such a chunk is null)."""
    if dictionary.shape[0] == 0:
        return dictionary.new_zeros((indices.shape[0],)
                                    + dictionary.shape[1:])
    return _take(dictionary, indices.to(torch.int64))


# ---------------------------------------------------------------------------
# FIXED_LEN_BYTE_ARRAY and INT96: a page's values are rows of `width`
# bytes; each type turns its byte matrix into its values
# ---------------------------------------------------------------------------

_JULIAN_EPOCH = 2440588              # the Julian day of 1970-01-01
_NS_PER_DAY = 86_400 * 10**9


class FixedRows:
    """Callable (raw uint8 bytes, m) -> the m values of a FIXED_LEN_BYTE_
    ARRAY or INT96 column, `width` bytes each."""

    def __init__(self, width: int, fn):
        self.width = width
        self.of_rows = fn        # (m, width) byte matrix -> m values

    def __call__(self, raw: torch.Tensor, m: int) -> torch.Tensor:
        return self.of_rows(raw[: m * self.width].reshape(m, self.width))


_BYTE_PAIRS = 0x00FF00FF00FF00FF
_HALF_PAIRS = 0x0000FFFF0000FFFF


def bswap64(x: torch.Tensor) -> torch.Tensor:
    """The bytes of each int64 reversed (a big-endian word read as
    little-endian and back): three shift-and-mask rounds, each right
    shift masked, so the sign bit spreads nowhere."""
    x = ((x & _BYTE_PAIRS) << 8) | ((x >> 8) & _BYTE_PAIRS)
    x = ((x & _HALF_PAIRS) << 16) | ((x >> 16) & _HALF_PAIRS)
    return (x << 32) | ((x >> 32) & _U32)


def _words(rows: torch.Tensor) -> torch.Tensor:
    """(m, 8j) bytes as (m, j) int64 words, read little-endian."""
    return rows.contiguous().view(torch.int64)


def decimal_limbs(rows: torch.Tensor, k: int) -> torch.Tensor:
    """(m, L) big-endian two's-complement bytes -> (m, k) little-endian
    int64 limbs. L == 8k (the usual 16 or 32 bytes): each big-endian
    word byte-swapped, the words in reverse order. Otherwise the bytes
    reversed and sign-extended from L to 8k bytes (the high bytes
    dropped when L > 8k), viewed as int64."""
    m, width = rows.shape
    if width == 8 * k:
        return bswap64(_words(rows).flip(1))
    le = rows.flip(1)
    if width > 8 * k:
        le = le[:, : 8 * k]
    else:
        sign = (rows[:, :1] >= 0x80).to(torch.uint8) * 0xFF
        le = torch.cat([le, sign.expand(m, 8 * k - width)], dim=1)
    return _words(le)


def int96_nanos(rows: torch.Tensor) -> torch.Tensor:
    """(m, 12) INT96 rows (nanoseconds of the day as int64, then the
    Julian day as int32, little-endian) -> int64 ns since the epoch, as
    the JAX package's host reader computes it (reader.py)."""
    nanos = rows[:, :8].contiguous().view(torch.int64).reshape(-1)
    days = rows[:, 8:].contiguous().view(torch.int32).reshape(-1)
    return (days.to(torch.int64) - _JULIAN_EPOCH) * _NS_PER_DAY + nanos


def fixed_size_codes(rows: torch.Tensor, present):
    """(int32 codes, host dictionary of bytes) of an (m, width) byte
    matrix: codes over the distinct rows in byte order, null rows
    counted as zero bytes (the JAX package's np.unique of the rows).
    Each row sorts as its big-endian 64-bit words (zero-padded), read
    unsigned: one stable sort pass per word."""
    m, width = rows.shape
    if present is not None:
        rows = torch.where(present.unsqueeze(1), rows, 0)
    if m == 0:
        return torch.zeros(0, dtype=torch.int32, device=rows.device), \
            np.empty(0, dtype=object)
    pad = -width % 8
    if pad:
        rows = torch.cat([rows, rows.new_zeros(m, pad)], dim=1)
    words = sortable(bswap64(_words(rows)))
    order = lexsort_stable(list(words.unbind(1)))
    sw = words.index_select(0, order)
    start = torch.ones(m, dtype=torch.bool, device=rows.device)
    start[1:] = (sw[1:] != sw[:-1]).any(dim=1)
    codes = torch.empty(m, dtype=torch.int32, device=rows.device)
    codes[order] = (torch.cumsum(start, 0) - 1).to(torch.int32)
    uniq = rows.index_select(0, order[start])[:, :width].cpu().numpy()
    dictionary = np.empty(len(uniq), dtype=object)
    dictionary[:] = [r.tobytes() for r in uniq]
    return codes, dictionary


# ---------------------------------------------------------------------------
# DELTA_BINARY_PACKED: the host walks the block / miniblock headers (in
# the host codec library: each block's length depends on its widths);
# the device unpacks each delta at its miniblock's width, adds the
# block's min delta and takes a prefix sum
# ---------------------------------------------------------------------------

def _uvarint(data, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def delta_count(data) -> int:
    """The value count of a DELTA_BINARY_PACKED stream: its header's
    third varint, after the block size and the miniblocks per block."""
    pos = 0
    for _ in range(3):
        count, pos = _uvarint(data, pos)
    return count


def parse_delta_segments(data):
    """Host control parse of a DELTA_BINARY_PACKED stream. Returns
    (mb_starts, mb_bit0, mb_width, mb_min, words, first, total): per
    miniblock that holds deltas, the index of its first delta (int64),
    the bit offset of its packed values in `words` (int64), its width
    (int32, 0 to 64) and its block's min delta (int64); `words` is the
    stream itself as uint32 words (+ guard word), so the packed values
    are not copied out of it; then the first value and the value count.
    A width over 64 raises ArrowInvalid. The JAX package's device read
    refuses widths over 32 (its TPU decode reads a two-word window); the
    port decodes every width, as the JAX package's host read does."""
    data = memoryview(data)
    block_size, pos = _uvarint(data, 0)
    miniblocks, pos = _uvarint(data, pos)
    total, pos = _uvarint(data, pos)
    z, pos = _uvarint(data, pos)
    first = (z >> 1) ^ -(z & 1)
    st, b0, wd, mn = native.delta_parse(data, pos, total,
                                        block_size // miniblocks, miniblocks)
    if not len(st):
        st, b0, wd, mn = (np.zeros(1, np.int64), np.zeros(1, np.int64),
                          np.zeros(1, np.int32), np.zeros(1, np.int64))
    return st, b0, wd, mn, words_from_bytes(data), first, total


def _half(a: torch.Tensor, b: torch.Tensor, off: torch.Tensor
          ) -> torch.Tensor:
    """The 32 bits of the word pair (a, b) (u32 values in int64) that
    start at bit `off` (0..31) of a."""
    return ((a >> off) | torch.where(off > 0, b << torch.where(
        off > 0, 32 - off, 0), 0)) & _U32


def delta_decode_device(mb_starts: torch.Tensor, mb_bit0: torch.Tensor,
                        mb_width: torch.Tensor, mb_min: torch.Tensor,
                        words: torch.Tensor, first: int, n: int,
                        wide: bool = True) -> torch.Tensor:
    """n int64 values from the tables of parse_delta_segments (as int64 /
    int64 / int32-or-int64 / int64 / int32-word tensors). A delta of
    width w at bit `off` of its first u32 word spans up to three words:
    its low 32 bits are read from words 0 and 1, its high 32 bits (w >
    32) from words 1 and 2, each half masked to its share of w (so no
    mask is 2**64 - 1), the high half shifted into bits 32-63 as the
    int64 carries u64 bits. `wide` False (every width at most 32, as the
    host parse shows) skips the high half. Deltas and the prefix sum
    wrap in int64, as the format and the JAX package do."""
    dev = words.device
    if n <= 1:
        return torch.full((n,), first, dtype=torch.int64, device=dev)
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(mb_starts, i, right=True) - 1
    w = _take(mb_width, seg).to(torch.int64)
    bit0 = _take(mb_bit0, seg) + (i - _take(mb_starts, seg)) * w
    w64 = words.to(torch.int64) & _U32
    wi = bit0 >> 5
    off = bit0 & 31
    w1 = _take(w64, wi + 1)
    raw = _half(_take(w64, wi), w1, off) & ((1 << w.clamp(max=32)) - 1)
    if wide:
        hi = _half(w1, _take(w64, wi + 2), off) & (
            (1 << (w - 32).clamp(min=0)) - 1)
        raw = raw | (hi << 32)
    deltas = raw + _take(mb_min, seg)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    out[0] = first
    torch.cumsum(deltas, 0, out=out[1:])
    out[1:] += first
    return out
