"""Parquet page decoding on the device.

Port of arrow_go_tpu/ops/decode.py (the device analog of the reference's
SIMD decode tier: the bit-unpack of parquet/internal/utils/_lib, the
RLE/bit-packed hybrid of internal/utils/rle.go, BYTE_STREAM_SPLIT).

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
shift touches a sign bit. Gathers clamp their indices, as JAX gathers
do, so a corrupt stream cannot index past a buffer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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

def parse_rle_segments(data, n: int, bit_width: int
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
    Only headers are touched in Python; packed group bytes are sliced
    wholesale. A bit-packed run followed by runs of the same header and
    length (an encoder's full runs: 512 values each in Arrow's and this
    port's writer) is taken in one numpy step: the next runs' headers
    sit at fixed strides, so they are checked and their bodies copied
    together.
    """
    data = memoryview(data)
    raw = np.frombuffer(data, np.uint8)
    L = len(data)
    # the packed bodies, never longer than the stream; `words` views it
    packed = np.empty(L + 8, np.uint8)
    o = 0
    chunks = []                          # (starts, is_run, payload) arrays
    starts, is_run, payload = [], [], []  # segments since the last chunk

    def flush():
        chunks.append((np.asarray(starts, np.int64),
                       np.asarray(is_run, np.uint32),
                       np.asarray(payload, np.int64)))
        starts.clear()
        is_run.clear()
        payload.clear()

    got = 0
    pos = 0
    nbytes = (bit_width + 7) // 8
    while got < n and pos < L:
        head = pos
        header = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if header & 1:                      # bit-packed group of 8s
            count = (header >> 1) * 8
            need = (count * bit_width + 7) // 8
            hlen = pos - head
            step = hlen + need
            # runs k = 0..K-1 at head + k * step: whole in the data,
            # starting before n, each with this run's header bytes
            K = min((L - head) // step, -(-(n - got) // count)) if count \
                else 1
            if K > 1:
                runs = raw[head:head + K * step].reshape(K, step)
                same = np.all(runs[:, :hlen] == runs[0, :hlen], axis=1)
                if not same.all():
                    K = int(np.argmin(same))
            if K > 1:
                flush()
                k = np.arange(K, dtype=np.int64)
                chunks.append((got + k * count, np.zeros(K, np.uint32),
                               (o + k * need) * 8))
                packed[o:o + K * need].reshape(K, need)[...] = \
                    runs[:K, hlen:]
                o += K * need
                pos = head + K * step
            else:
                body = raw[pos:pos + need]
                starts.append(got)
                is_run.append(0)
                payload.append(o * 8)        # bit offset into `words`
                packed[o:o + len(body)] = body
                o += len(body)
                pos += need
                K = 1
            got = min(got + K * count, n)
        else:                               # RLE run
            count = header >> 1
            starts.append(got)
            is_run.append(1)
            payload.append(int.from_bytes(data[pos:pos + nbytes], "little"))
            pos += nbytes
            got += min(count, n - got)
    flush()
    st, ir, pay = (np.concatenate(c) for c in zip(*chunks))
    if not len(st):
        st, ir, pay = np.zeros(1, np.int64), np.ones(1, np.uint32), \
            np.zeros(1, np.int64)
    # words_from_bytes without its copies: zero padding + a guard word
    end = o + (-o) % 4 + 4
    packed[o:end] = 0
    return st.astype(np.int32), ir, pay, packed[:end].view("<u4")


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


def byte_stream_split_decode_device(raw: torch.Tensor, np_dtype,
                                    n: int) -> torch.Tensor:
    """BYTE_STREAM_SPLIT: k planes of n bytes -> n k-byte values."""
    k = np.dtype(np_dtype).itemsize
    interleaved = raw[: n * k].reshape(k, n).t().contiguous().reshape(-1)
    return plain_decode_device(interleaved, np_dtype, n)


def dict_decode_device(indices: torch.Tensor,
                       dictionary: torch.Tensor) -> torch.Tensor:
    """RLE_DICTIONARY: gather decoded dictionary values by code (zeros
    when the dictionary is empty: every row of such a chunk is null)."""
    if dictionary.shape[0] == 0:
        return dictionary.new_zeros(indices.shape[0])
    return _take(dictionary, indices.to(torch.int64))
