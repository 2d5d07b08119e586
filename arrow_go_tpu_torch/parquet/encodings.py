"""Parquet encodings on the host: PLAIN and the RLE/bit-packed hybrid.

Port of the parts of arrow_go_tpu/parquet/encodings.py that the port's
writer and the dictionary page read need (reference
parquet/internal/encoding plain_encoding_types.go, internal/utils/rle.go).
Bit packing is vectorised numpy (the JAX package calls its native
library for it). The hybrid encoder writes its bit-packed runs as
Arrow's RleEncoder does: at most 512 values (64 groups of 8) per run, so
a run header fits one varint of two bytes, and constant runs of 8 or
more values become RLE runs.
"""
from __future__ import annotations

import struct

import numpy as np

from . import format as fmt

_PHYS_NP = {
    fmt.Type.INT32: np.dtype("<i4"),
    fmt.Type.INT64: np.dtype("<i8"),
    fmt.Type.FLOAT: np.dtype("<f4"),
    fmt.Type.DOUBLE: np.dtype("<f8"),
}

MIN_RLE_RUN = 8            # shortest constant run written as an RLE run
MAX_PACKED_GROUPS = 64     # groups of 8 values per bit-packed run (512)


def plain_encode(phys: fmt.Type, values) -> bytes:
    if phys in _PHYS_NP:
        return np.ascontiguousarray(values, dtype=_PHYS_NP[phys]).tobytes()
    if phys == fmt.Type.BOOLEAN:
        return np.packbits(np.asarray(values, dtype=np.bool_),
                           bitorder="little").tobytes()
    raise NotImplementedError(phys)


def plain_decode(phys: fmt.Type, data, n: int) -> np.ndarray:
    if phys in _PHYS_NP:
        return np.frombuffer(data, dtype=_PHYS_NP[phys], count=n)
    if phys == fmt.Type.BOOLEAN:
        return np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                             bitorder="little")[:n].astype(np.bool_)
    raise NotImplementedError(phys)


def pack_bits(values: np.ndarray, w: int) -> bytes:
    """LSB-first bit-pack of values < 2**w at width w (0..32): value i
    takes bits [i*w, (i+1)*w) of the stream. 64 values fill exactly w
    u64 words, so each of the 64 positions in a block has a fixed word
    and shift; the loop runs over those positions, numpy over blocks."""
    n = len(values)
    if w == 0 or n == 0:
        return b""
    nb = -(-n // 64)
    blk = np.zeros(nb * 64, np.uint64)
    blk[:n] = values
    blk = np.ascontiguousarray(blk.reshape(nb, 64).T)     # (64, nb)
    out = np.zeros((w, nb), np.uint64)
    for j in range(64):
        wi, sh = divmod(j * w, 64)
        out[wi] |= blk[j] << np.uint64(sh)
        if sh + w > 64:
            out[wi + 1] |= blk[j] >> np.uint64(64 - sh)
    return np.ascontiguousarray(out.T).tobytes()[: (n * w + 7) // 8]


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _emit_packed(out: bytearray, vals: np.ndarray, w: int) -> None:
    """Bit-packed runs of at most MAX_PACKED_GROUPS groups; the last
    group is zero-padded to 8 values."""
    groups = -(-len(vals) // 8)
    if not groups:
        return
    padded = np.zeros(groups * 8, np.uint32)
    padded[:len(vals)] = vals
    body = np.frombuffer(pack_bits(padded, w), np.uint8)
    full, rest = divmod(groups, MAX_PACKED_GROUPS)
    run_bytes = MAX_PACKED_GROUPS * w
    if full:
        hdr = np.frombuffer(_uvarint((MAX_PACKED_GROUPS << 1) | 1), np.uint8)
        runs = np.empty((full, len(hdr) + run_bytes), np.uint8)
        runs[:, :len(hdr)] = hdr
        runs[:, len(hdr):] = body[:full * run_bytes].reshape(full, run_bytes)
        out += runs.tobytes()
    if rest:
        out += _uvarint((rest << 1) | 1)
        out += body[full * run_bytes:].tobytes()


def rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    """uint32 values < 2**bit_width -> RLE/bit-packed hybrid stream.

    A constant run becomes an RLE run when, after lending the values the
    pending literal needs to end on a group of 8, at least MIN_RLE_RUN
    of it remain; everything else is bit-packed. Only the long runs are
    visited in Python; literal stretches pack in bulk."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    n = len(values)
    out = bytearray()
    if n == 0:
        return b""
    nbytes = (bit_width + 7) // 8
    change = np.flatnonzero(values[1:] != values[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    pos = 0                        # first value not yet written
    for r in np.flatnonzero(ends - starts >= MIN_RLE_RUN).tolist():
        s, e = int(starts[r]), int(ends[r])
        lend = (pos - s) % 8       # values the pending literal borrows
        if e - s - lend < MIN_RLE_RUN:
            continue
        _emit_packed(out, values[pos:s + lend], bit_width)
        out += _uvarint((e - s - lend) << 1)
        out += int(values[s]).to_bytes(nbytes, "little")
        pos = e
    _emit_packed(out, values[pos:], bit_width)
    return bytes(out)


def bit_width_for(max_value: int) -> int:
    """ceil(log2(max+1)): 0 -> 0 bits (all-zero stream)."""
    return int(max_value).bit_length()


def levels_encode_v1(levels: np.ndarray, bit_width: int) -> bytes:
    """V1 data page levels: int32 byte length prefix + hybrid stream."""
    enc = rle_encode(levels, bit_width)
    return struct.pack("<I", len(enc)) + enc
