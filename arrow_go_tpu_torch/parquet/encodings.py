"""Parquet encodings on the host: PLAIN, the RLE/bit-packed hybrid, the
DELTA_BINARY_PACKED encoder, BYTE_STREAM_SPLIT of every width and the
byte-array encodings DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY (of
string and binary values, or of a FIXED_LEN_BYTE_ARRAY column's rows).

Port of the parts of arrow_go_tpu/parquet/encodings.py that the port's
writer and the host decode of dictionary and string pages need
(reference parquet/internal/encoding plain_encoding_types.go,
delta_bit_packing.go, delta_length_byte_array.go, delta_byte_array.go,
internal/utils/rle.go). A string page decodes in the host codec
library (native.py) to (ends, data): value i is the bytes
[ends[i - 1], ends[i]) of data. Bit packing is vectorised numpy (the
JAX package calls its native library for it). The hybrid encoder
writes its bit-packed runs as Arrow's RleEncoder does: at most 512
values (64 groups of 8) per run, so a run header fits one varint of two
bytes, and constant runs of 8 or more values become RLE runs. The DELTA
encoder writes the JAX package's bytes with numpy over all blocks at
once, where the JAX encoder loops in Python over blocks and miniblocks.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from .. import native
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..ops.decode import delta_count
from . import format as fmt

_PHYS_NP = {
    fmt.Type.INT32: np.dtype("<i4"),
    fmt.Type.INT64: np.dtype("<i8"),
    fmt.Type.FLOAT: np.dtype("<f4"),
    fmt.Type.DOUBLE: np.dtype("<f8"),
}

MIN_RLE_RUN = 8            # shortest constant run written as an RLE run
MAX_PACKED_GROUPS = 64     # groups of 8 values per bit-packed run (512)


def _byte_array_encode(values) -> bytes:
    """PLAIN BYTE_ARRAY: <u32 length><bytes> per value, built by one
    scatter of the length words and one of the value bytes."""
    values = [bytes(v) for v in values]
    if not values:
        return b""
    lens = np.fromiter(map(len, values), np.int64, len(values))
    starts = np.concatenate(([0], np.cumsum(lens + 4)[:-1]))
    out = np.empty(int(lens.sum()) + 4 * len(values), np.uint8)
    out[starts[:, None] + np.arange(4)] = \
        lens.astype("<u4").view(np.uint8).reshape(-1, 4)
    body = np.frombuffer(b"".join(values), np.uint8)
    # byte k of value i lands at starts[i] + 4 + k
    out[np.repeat(starts + 4 - (np.cumsum(lens) - lens), lens)
        + np.arange(len(body))] = body
    return out.tobytes()


def plain_encode(phys: fmt.Type, values) -> bytes:
    if phys in _PHYS_NP:
        return np.ascontiguousarray(values, dtype=_PHYS_NP[phys]).tobytes()
    if phys == fmt.Type.BOOLEAN:
        return np.packbits(np.asarray(values, dtype=np.bool_),
                           bitorder="little").tobytes()
    if phys == fmt.Type.BYTE_ARRAY:
        return _byte_array_encode(values)
    if phys in (fmt.Type.FIXED_LEN_BYTE_ARRAY, fmt.Type.INT96):
        # rows of type_length (or 12) bytes, as an (n, width) uint8 matrix
        return np.ascontiguousarray(values, dtype=np.uint8).tobytes()
    raise NotImplementedError(phys)


def plain_decode(phys: fmt.Type, data, n: int):
    """PLAIN values: a numpy array, or a list of bytes for BYTE_ARRAY."""
    if phys in _PHYS_NP:
        return np.frombuffer(data, dtype=_PHYS_NP[phys], count=n)
    if phys == fmt.Type.BOOLEAN:
        return np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                             bitorder="little")[:n].astype(np.bool_)
    if phys == fmt.Type.BYTE_ARRAY:
        ends, body = byte_array_decode(fmt.Encoding.PLAIN, data, n)
        raw = body.tobytes()
        return [raw[a:b] for a, b in zip([0] + ends[:-1].tolist(),
                                         ends.tolist())]
    raise NotImplementedError(phys)


def pack_bits(values: np.ndarray, w: int) -> bytes:
    """LSB-first bit-pack of values < 2**w at width w (0..64): value i
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


def _emit_packed(out: bytearray, body: np.ndarray, groups: int,
                 w: int) -> None:
    """`groups` groups of 8 bit-packed values (`body`, groups * w bytes)
    as bit-packed runs of at most MAX_PACKED_GROUPS groups."""
    if not groups:
        return
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
    visited in Python. Every literal stretch, zero-padded to whole
    groups, packs in ONE pack_bits call: a group of 8 values fills
    exactly bit_width bytes, so each stretch's bytes start on a byte of
    the whole."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    n = len(values)
    if n == 0:
        return b""
    nbytes = (bit_width + 7) // 8
    change = np.flatnonzero(values[1:] != values[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    lit_a, lit_b, rle = [], [], []   # literal stretches, then an RLE run
    pos = 0                          # first value not yet written
    for r in np.flatnonzero(ends - starts >= MIN_RLE_RUN).tolist():
        s, e = int(starts[r]), int(ends[r])
        lend = (pos - s) % 8         # values the pending literal borrows
        if e - s - lend < MIN_RLE_RUN:
            continue
        lit_a.append(pos)
        lit_b.append(s + lend)
        rle.append((e - s - lend, int(values[s])))
        pos = e
    lit_a.append(pos)
    lit_b.append(n)
    a, b = np.array(lit_a, np.int64), np.array(lit_b, np.int64)
    lens = b - a
    groups = -(-lens // 8)
    dst0 = np.concatenate(([0], np.cumsum(groups * 8)))
    padded = np.zeros(int(dst0[-1]), np.uint32)
    # value k of stretch i lands at dst0[i] + k
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
    padded[np.repeat(dst0[:-1], lens) + within] = \
        values[np.repeat(a, lens) + within]
    body = np.frombuffer(pack_bits(padded, bit_width), np.uint8)
    byte0 = dst0 // 8 * bit_width
    out = bytearray()
    for i, g in enumerate(groups.tolist()):
        _emit_packed(out, body[byte0[i]:byte0[i + 1]], g, bit_width)
        if i < len(rle):
            count, value = rle[i]
            out += _uvarint(count << 1)
            out += value.to_bytes(nbytes, "little")
    return bytes(out)


def bit_width_for(max_value: int) -> int:
    """ceil(log2(max+1)): 0 -> 0 bits (all-zero stream)."""
    return int(max_value).bit_length()


def levels_encode_v1(levels: np.ndarray, bit_width: int) -> bytes:
    """V1 data page levels: int32 byte length prefix + hybrid stream."""
    enc = rle_encode(levels, bit_width)
    return struct.pack("<I", len(enc)) + enc


# ---------------------------------------------------------------------------
# DELTA_BINARY_PACKED encoder
# ---------------------------------------------------------------------------

_U64 = np.uint64


def _bit_lengths(x: np.ndarray) -> np.ndarray:
    """Bit length of each uint64 (0 for 0), by halving."""
    x = x.astype(_U64)
    w = np.zeros(len(x), np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        hi = (x >> _U64(s)) != 0
        x = np.where(hi, x >> _U64(s), x)
        w += hi * s
    return w + (x != 0)


def _uvarints(z: np.ndarray):
    """ULEB128 varints of uint64 values: ((k, 10) byte matrix, (k, 10)
    mask of the bytes each varint uses)."""
    z = z.astype(_U64)
    k = np.arange(10)
    length = 1 + sum(((z >> _U64(7 * j)) != 0).astype(np.int64)
                     for j in range(1, 10))
    groups = (z[:, None] >> (_U64(7) * k.astype(_U64))) & _U64(0x7F)
    cont = (k[None, :] < (length - 1)[:, None]).astype(_U64) << _U64(7)
    return (groups | cont).astype(np.uint8), k[None, :] < length[:, None]


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.int64)
    return (v.astype(_U64) << _U64(1)) ^ (v >> 63).astype(_U64)


def delta_binary_packed_encode(values, block_size: int = 128,
                               miniblocks: int = 4) -> bytes:
    """DELTA_BINARY_PACKED bytes of int values, the bytes the JAX
    package's encoder writes (default geometry 128 / 4, as the reference
    writer): a header (block size, miniblocks per block, count, zigzag
    first value), then per block a zigzag min delta, one width byte per
    miniblock and the bit-packed (delta - min) of each miniblock that
    holds deltas, padded to whole miniblocks. Deltas wrap in int64."""
    v = np.ascontiguousarray(values, dtype=np.int64)
    total = len(v)
    vpm = block_size // miniblocks
    if vpm % 32 or block_size % miniblocks:
        raise ValueError("miniblocks must hold a multiple of 32 values")
    head, used = _uvarints(np.array([block_size, miniblocks, total], _U64))
    hz, hu = _uvarints(_zigzag(v[:1] if total else np.zeros(1, np.int64)))
    header = np.concatenate([head[used], hz[hu]])
    if total <= 1:
        return header.tobytes()
    deltas = v[1:] - v[:-1]
    nd = len(deltas)
    nb = -(-nd // block_size)
    mins = np.minimum.reduceat(deltas, np.arange(0, nd, block_size))
    adjusted = deltas.view(_U64) - np.repeat(mins.view(_U64),
                                             block_size)[:nd]
    n_mb = -(-nd // vpm)             # miniblocks that hold deltas
    widths = np.zeros(nb * miniblocks, np.int64)
    widths[:n_mb] = _bit_lengths(np.maximum.reduceat(
        adjusted, np.arange(0, nd, vpm)))
    sizes = (widths * vpm // 8).reshape(nb, miniblocks)
    vz, vu = _uvarints(_zigzag(mins))
    vlen = vu.sum(1)
    block_len = vlen + miniblocks + sizes.sum(1)
    block_off = len(header) + np.concatenate(([0], np.cumsum(block_len)))
    out = np.zeros(int(block_off[-1]), np.uint8)
    out[:len(header)] = header
    rows = np.broadcast_to(block_off[:-1, None], vu.shape)
    out[(rows + np.arange(10))[vu]] = vz[vu]
    wpos = (block_off[:-1] + vlen)[:, None] + np.arange(miniblocks)
    out[wpos] = widths.reshape(nb, miniblocks)
    mb_off = ((block_off[:-1] + vlen + miniblocks)[:, None]
              + np.cumsum(sizes, 1) - sizes).reshape(-1)[:n_mb]
    padded = np.zeros(n_mb * vpm, _U64)
    padded[:nd] = adjusted
    padded = padded.reshape(n_mb, vpm)
    w_of = widths[:n_mb]
    for w in np.unique(w_of[w_of > 0]).tolist():
        idx = np.flatnonzero(w_of == w)
        nbytes = vpm * w // 8
        body = np.frombuffer(pack_bits(padded[idx].reshape(-1), w), np.uint8)
        out[mb_off[idx][:, None] + np.arange(nbytes)] = body.reshape(
            len(idx), nbytes)
    return out.tobytes()


# ---------------------------------------------------------------------------
# byte-array encodings (arrow_go_tpu/parquet/encodings.py:307-328,392-414)
# ---------------------------------------------------------------------------

def _ends_data(values) -> Tuple[np.ndarray, np.ndarray]:
    """A list of byte strings, or an (n, width) uint8 matrix of rows, as
    (int64 ends, uint8 data)."""
    if isinstance(values, np.ndarray) and values.ndim == 2:
        n, width = values.shape
        return np.arange(1, n + 1, dtype=np.int64) * width, \
            np.ascontiguousarray(values, np.uint8).reshape(-1)
    values = [bytes(v) for v in values]
    ends = np.cumsum(np.fromiter(map(len, values), np.int64, len(values)),
                     dtype=np.int64)
    return ends, np.frombuffer(b"".join(values), np.uint8)


def _common_prefixes(ends: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Length of the prefix value i shares with value i - 1 (0 for the
    first), over a zero-padded matrix of the values, in slices of rows."""
    n = len(ends)
    out = np.zeros(n, np.int64)
    if n < 2:
        return out
    lens = np.diff(ends, prepend=0)
    starts = ends - lens
    width = int(lens.max())
    if width and (lens == width).all():
        # values of one length (a FIXED_LEN_BYTE_ARRAY column's rows): the
        # first column where a row differs from the one before, or width
        rows = data.reshape(n, width)
        same = rows[1:] == rows[:-1]
        out[1:] = np.where(same.all(1), width, np.argmin(same, 1))
        return out
    step = max(1, (1 << 24) // max(width, 1))
    for a in range(1, n, step):
        b = min(a + step, n)
        rows = np.arange(a - 1, b)
        col = np.arange(width)
        inside = col[None, :] < lens[rows][:, None]
        idx = np.where(inside, starts[rows][:, None] + col[None, :], 0)
        mat = np.where(inside, data[idx] if len(data) else 0, -1).astype(
            np.int16)
        same = mat[1:] == mat[:-1]
        same &= col[None, :] < np.minimum(lens[rows[1:]], lens[rows[:-1]]
                                          )[:, None]
        # the first column that differs, or the shorter length
        out[a:b] = np.where(same.all(1), np.minimum(
            lens[rows[1:]], lens[rows[:-1]]), np.argmin(same, 1))
    return out


def delta_length_byte_array_encode(values) -> bytes:
    """DELTA_LENGTH_BYTE_ARRAY: the lengths DELTA_BINARY_PACKED, then the
    values' bytes back to back."""
    ends, data = _ends_data(values)
    return delta_binary_packed_encode(np.diff(ends, prepend=0)) + \
        data.tobytes()


def delta_byte_array_encode(values) -> bytes:
    """DELTA_BYTE_ARRAY: each value's prefix length shared with the value
    before it (DELTA_BINARY_PACKED), then the suffixes as
    DELTA_LENGTH_BYTE_ARRAY. `values` may be an (n, width) uint8 matrix of
    a FIXED_LEN_BYTE_ARRAY column's rows."""
    ends, data = _ends_data(values)
    prefix = _common_prefixes(ends, data)
    lens = np.diff(ends, prepend=0)
    starts = ends - lens
    keep = np.repeat(starts + prefix, lens - prefix) + (
        np.arange(int((lens - prefix).sum()))
        - np.repeat(np.cumsum(lens - prefix) - (lens - prefix),
                    lens - prefix))
    suffix_lens = lens - prefix
    return delta_binary_packed_encode(prefix) + \
        delta_binary_packed_encode(suffix_lens) + data[keep].tobytes()


def byte_array_decode(encoding: fmt.Encoding, data, n: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The n values of a PLAIN, DELTA_LENGTH_BYTE_ARRAY or
    DELTA_BYTE_ARRAY page as (ends, data). The DELTA lengths and
    prefixes decode on the host in full (any width up to 64 bits); a
    DELTA stream of another count raises ArrowInvalid."""
    if encoding == fmt.Encoding.PLAIN:
        ends, out, _ = native.plain_byte_array(data, n)
        return ends, out
    if encoding == fmt.Encoding.DELTA_LENGTH_BYTE_ARRAY:
        return _delta_lengths(memoryview(data), n)[:2]
    if encoding == fmt.Encoding.DELTA_BYTE_ARRAY:
        mv = memoryview(data)
        prefix, used = native.delta_decode(mv, n)
        suffix_ends, suffixes, _ = _delta_lengths(mv[used:], len(prefix))
        if len(prefix) < n:
            raise ArrowInvalid(f"DELTA_BYTE_ARRAY page holds {len(prefix)} "
                               f"values, not {n}")
        return native.delta_byte_array_rebuild(prefix[:n], suffix_ends[:n],
                                               suffixes)
    raise ArrowNotImplemented(f"byte-array decode of {encoding.name}")


def fixed_delta_byte_array_decode(data, nv: int, width: int) -> np.ndarray:
    """The values of a FIXED_LEN_BYTE_ARRAY page in DELTA_BYTE_ARRAY (at
    most nv: its stream's count), their bytes back to back (uint8), the
    prefixes and suffixes rebuilt by the codec library; a value of
    another length than `width` raises ArrowInvalid."""
    n = min(delta_count(data), nv)
    ends, out = byte_array_decode(fmt.Encoding.DELTA_BYTE_ARRAY, data, n)
    if (np.diff(ends, prepend=0) != width).any():
        raise ArrowInvalid(f"a DELTA_BYTE_ARRAY value of a "
                           f"FIXED_LEN_BYTE_ARRAY({width}) column is not "
                           f"{width} bytes")
    return out


def _delta_lengths(mv: memoryview, n: int):
    lens, used = native.delta_decode(mv, n)
    if len(lens) < n or (len(lens) and lens.min() < 0):
        raise ArrowInvalid("DELTA_LENGTH_BYTE_ARRAY lengths do not cover "
                           "the page")
    ends = np.cumsum(lens[:n], dtype=np.int64)
    total = int(ends[-1]) if n else 0
    body = np.frombuffer(mv[used:], np.uint8)
    if total > len(body):
        raise ArrowInvalid("DELTA_LENGTH_BYTE_ARRAY values pass the page")
    return ends, body[:total], used + total


# ---------------------------------------------------------------------------
# BYTE_STREAM_SPLIT (arrow_go_tpu/parquet/encodings.py:329,415; reference
# parquet/internal/encoding/byte_stream_split.go)
# ---------------------------------------------------------------------------

def byte_stream_split_encode(rows: np.ndarray) -> bytes:
    """An (n, width) uint8 matrix of values' little-endian bytes (a
    FIXED_LEN_BYTE_ARRAY column's rows, or a numeric column viewed as
    bytes) -> its `width` planes of n bytes, byte j of every value in
    plane j."""
    return np.ascontiguousarray(np.asarray(rows, np.uint8).T).tobytes()


def byte_stream_split_decode(data, n: int, width: int) -> np.ndarray:
    """`width` planes of n bytes -> the (n, width) uint8 matrix of the
    values' bytes (byte_stream_split_encode's input); a page shorter
    than its planes raises ArrowInvalid."""
    if len(data) < n * width:
        raise ArrowInvalid(f"BYTE_STREAM_SPLIT page of {len(data)} bytes "
                           f"holds no {n} values of {width} bytes")
    planes = np.frombuffer(data, np.uint8, count=n * width)
    return np.ascontiguousarray(planes.reshape(width, n).T)


# ---------------------------------------------------------------------------
# the JAX module's host decoders (arrow_go_tpu/parquet/encodings.py:68-327),
# on the codec library's walks
# ---------------------------------------------------------------------------

def byte_array_decode_vectorized(data, n: int
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """A PLAIN BYTE_ARRAY page of n values -> (int64 offsets (n + 1),
    uint8 data)."""
    return native.byte_array_unpack(data, n)


def rle_decode(data, n: int, bit_width: int) -> np.ndarray:
    """n values of an RLE / bit-packed hybrid stream, as uint32."""
    if bit_width == 0:
        return np.zeros(n, np.uint32)
    return native.rle_decode(data, n, bit_width)


def levels_decode_v1(data, n: int, bit_width: int) -> Tuple[np.ndarray, int]:
    """V1 data page levels (a u32 byte length, then the hybrid stream):
    (levels, bytes used)."""
    (ln,) = struct.unpack_from("<I", data, 0)
    return rle_decode(memoryview(data)[4:4 + ln], n, bit_width), 4 + ln


def delta_binary_packed_decode(data, n: Optional[int] = None
                               ) -> Tuple[np.ndarray, int]:
    """A DELTA_BINARY_PACKED stream -> (int64 values, its first n when n
    is given; bytes the whole stream uses)."""
    values, used = native.delta_decode(data, delta_count(data))
    return (values if n is None else values[:n]), used


def delta_length_byte_array_decode(data, n: int) -> list:
    """The first n values of a DELTA_LENGTH_BYTE_ARRAY page, as bytes."""
    ends, body, _ = _delta_lengths(memoryview(data), n)
    return _rows(ends, body)


def delta_byte_array_decode(data, n: int) -> list:
    """The first n values of a DELTA_BYTE_ARRAY page, as bytes."""
    return _rows(*byte_array_decode(fmt.Encoding.DELTA_BYTE_ARRAY, data, n))


def _rows(ends: np.ndarray, data: np.ndarray) -> list:
    raw = data.tobytes()
    starts = np.concatenate([[0], ends[:-1]]).tolist() if len(ends) else []
    return [raw[a:b] for a, b in zip(starts, ends.tolist())]
