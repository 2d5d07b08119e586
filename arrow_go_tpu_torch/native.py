"""The port's host codec library: csrc/codecs.cc, built with g++.

Snappy, LZ4 raw, the LZ4 frame format and zstd (compress, decompress),
XXH64 and XXH32, AES in CTR and GCM modes (AES-NI and PCLMULQDQ; a CPU
without them raises ArrowNotImplemented), the header walks
of the RLE/bit-packed hybrid and of DELTA_BINARY_PACKED streams, and the
byte-array walks of string pages (PLAIN, the DELTA lengths and prefixes
decoded in full, DELTA_BYTE_ARRAY rebuilt row by row, a first-occurrence
memo table), in C++ with a plain C interface loaded with ctypes. The
library is built at its first use into `arrow_go_tpu_torch/build/`
(beside the CUDA kernels, ignored by git), named by a hash of the source
and the flags, so an unchanged source is reused. Nothing is built when
the package is imported.

There is no pure-Python fallback and no switch to turn the library off:
a failed build raises with the compiler's output. (A Python snappy
would turn a sub-second decompress of a large scan into minutes.)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .compute.errors import ArrowInvalid, ArrowNotImplemented
from .cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "codecs.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_SIZE = ctypes.c_size_t
_I64 = ctypes.c_int64
_SIGNATURES = {
    "agt_snappy_max_compressed_length": (_SIZE, [_SIZE]),
    "agt_snappy_compress": (_I64, [_P, _SIZE, _P, _SIZE]),
    "agt_snappy_uncompressed_length": (_I64, [_P, _SIZE]),
    "agt_snappy_decompress": (_I64, [_P, _SIZE, _P, _SIZE]),
    "agt_lz4_max_compressed_length": (_SIZE, [_SIZE]),
    "agt_lz4_compress": (_I64, [_P, _SIZE, _P, _SIZE]),
    "agt_lz4_decompress": (_I64, [_P, _SIZE, _P, _SIZE]),
    "agt_rle_parse": (_I64, [_P, _SIZE, _I64, ctypes.c_int32, _I64, _P, _P,
                             _P, _P, _P]),
    "agt_delta_parse": (_I64, [_P, _SIZE, _SIZE, _I64, _I64, _I64, _I64,
                               _P, _P, _P, _P, _P]),
    "agt_xxh64": (ctypes.c_uint64, [_P, _SIZE, ctypes.c_uint64]),
    "agt_zstd_decompress": (_I64, [_P, _SIZE, _P, _SIZE]),
    "agt_zstd_content_size": (_I64, [_P, _SIZE]),
    "agt_zstd_compress_bound": (_SIZE, [_SIZE]),
    "agt_zstd_compress": (_I64, [_P, _SIZE, _P, _SIZE, ctypes.c_int32]),
    "agt_plain_byte_array": (_I64, [_P, _SIZE, _I64, _P, _P, _SIZE]),
    "agt_delta_decode": (_I64, [_P, _SIZE, _I64, _P, _P]),
    "agt_delta_byte_array_rebuild": (_I64, [_P, _P, _P, _I64, _P, _P,
                                            _SIZE]),
    "agt_rle_decode": (_I64, [_P, _SIZE, _I64, ctypes.c_int32, _P]),
    "agt_gather_rows": (None, [_P, _P, _P, _I64, _P]),
    "agt_factorize": (_I64, [_P, _P, _I64, _P, _P]),
    "agt_varint_lanes": (None, [_P, _I64, _P, _P]),
    "agt_avro_flat_walk": (_I64, [_P, _P, _I64, _I64, ctypes.c_int32, _P,
                                  _P, _P]),
    "agt_xxh64_rows": (None, [_P, _P, _I64, _P]),
    "agt_xxh32": (ctypes.c_uint32, [_P, _SIZE, ctypes.c_uint32]),
    "agt_lz4_frame_bound": (_SIZE, [_SIZE, _SIZE]),
    "agt_lz4_frame_compress": (_I64, [_P, _SIZE, _SIZE, _P, _SIZE]),
    "agt_lz4_frame_decompress": (_I64, [_P, _SIZE, _P, _SIZE]),
    "agt_aes_ctr": (_I64, [_P, _SIZE, _P, _P, _SIZE, _P]),
    "agt_aes_gcm_encrypt": (_I64, [_P, _SIZE, _P, _P, _SIZE, _P, _SIZE,
                                   _P]),
    "agt_aes_gcm_decrypt": (_I64, [_P, _SIZE, _P, _P, _SIZE, _P, _SIZE,
                                   _P]),
}


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcodecs-{h}.so"


def build() -> Path:
    """Compile csrc/codecs.cc unless its library is current; raises with
    g++'s output if the compile fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"host codec build failed (g++ exit "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded codec library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = res
                fn.argtypes = args
            _lib = handle
        return _lib


def _in(data) -> Tuple[np.ndarray, int]:
    """A byte buffer as a uint8 array (no copy) and its address."""
    a = np.frombuffer(data, np.uint8)
    return a, a.ctypes.data


def _run(fn, data, cap: int, what: str) -> memoryview:
    src, ptr = _in(data)
    out = np.empty(max(cap, 1), np.uint8)
    n = fn(ptr, len(src), out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"{what} failed")
    return memoryview(out)[:n]


def snappy_compress(data) -> memoryview:
    lb = lib()
    return _run(lb.agt_snappy_compress, data,
                lb.agt_snappy_max_compressed_length(len(data)),
                "snappy compression")


def snappy_decompress(data) -> memoryview:
    lb = lib()
    src, ptr = _in(data)
    ulen = lb.agt_snappy_uncompressed_length(ptr, len(src))
    if ulen < 0:
        raise ValueError("bad snappy stream")
    return _run(lb.agt_snappy_decompress, data, ulen,
                "snappy decompression")


def lz4_compress(data) -> memoryview:
    lb = lib()
    return _run(lb.agt_lz4_compress, data,
                lb.agt_lz4_max_compressed_length(len(data)),
                "lz4 compression")


def lz4_decompress(data, uncompressed_size: int) -> memoryview:
    return _run(lib().agt_lz4_decompress, data, uncompressed_size,
                "lz4 decompression")


def rle_parse(data, n: int, bit_width: int, alloc):
    """Run tables of an RLE/bit-packed hybrid stream covering n values:
    (first output index int64, is-RLE uint32, RLE value or bit offset
    into `packed` int64) per run, then `packed` and its used length.
    `packed` = alloc(k), a uint8 array of k >= used length + 4 bytes
    (a multiple of 4), holds the bit-packed bodies back to back from
    byte 0 and zeros after them. A first walk counts the runs and the
    body bytes, so every buffer is allocated at its size. A run header
    that runs past the stream raises ArrowInvalid."""
    src, ptr = _in(data)
    fn = lib().agt_rle_parse
    packed_len = np.zeros(1, np.int64)
    rows = fn(ptr, len(src), n, bit_width, 0, None, None, None, None,
              packed_len.ctypes.data)
    if rows < 0:
        raise ArrowInvalid("RLE/bit-packed stream ends inside a run header")
    o = int(packed_len[0])
    starts = np.empty(rows, np.int64)
    is_run = np.empty(rows, np.uint32)
    payload = np.empty(rows, np.int64)
    packed = alloc(o + (-o) % 4 + 4)
    packed[o:] = 0
    fn(ptr, len(src), n, bit_width, rows, starts.ctypes.data,
       is_run.ctypes.data, payload.ctypes.data, packed.ctypes.data,
       packed_len.ctypes.data)
    return starts, is_run, payload, packed, o


def delta_parse(data, pos: int, total: int, values_per_miniblock: int,
                miniblocks: int):
    """Per-miniblock tables of a DELTA_BINARY_PACKED stream whose header
    ends at `pos`: (first delta index, bit offset into `data`, width,
    min delta) as int64 / int64 / int32 / int64 arrays, every width from
    0 to 64. A miniblock wider than 64 bits (a corrupt stream) or a
    stream that ends early raises ArrowInvalid."""
    cap = max(-(-(total - 1) // values_per_miniblock), 0)
    starts = np.empty(max(cap, 1), np.int64)
    bit0 = np.empty_like(starts)
    width = np.empty(max(cap, 1), np.int32)
    mins = np.empty_like(starts)
    bad = np.zeros(1, np.int32)
    src, ptr = _in(data)
    rows = lib().agt_delta_parse(
        ptr, len(src), pos, total, values_per_miniblock, miniblocks, cap,
        starts.ctypes.data, bit0.ctypes.data, width.ctypes.data,
        mins.ctypes.data, bad.ctypes.data)
    if rows == -2:
        raise ArrowInvalid(f"DELTA_BINARY_PACKED miniblock width "
                           f"{int(bad[0])} passes 64 bits")
    if rows < 0:
        raise ArrowInvalid("DELTA_BINARY_PACKED stream ends early")
    return starts[:rows], bit0[:rows], width[:rows], mins[:rows]


def lz4_frame_compress(data, block_size: int = 1 << 20) -> memoryview:
    """One LZ4 frame of `data` (the Arrow IPC body codec "lz4"), laid out
    as the JAX package's lz4_frame_compress writes it: no checksums and
    no content size, blocks of `block_size` bytes each compressed alone
    (stored raw where that does not shrink them)."""
    lb = lib()
    return _run(lambda src, n, dst, cap: lb.agt_lz4_frame_compress(
        src, n, block_size, dst, cap), data,
        lb.agt_lz4_frame_bound(len(data), block_size), "lz4 frame compression")


def lz4_frame_decompress(data, uncompressed_size: int) -> memoryview:
    """The content of one LZ4 frame, independent or linked blocks, which
    must be `uncompressed_size` bytes. A bad magic, a truncated or
    malformed frame, or another size raises ArrowInvalid."""
    src, ptr = _in(data)
    out = np.empty(max(uncompressed_size, 1), np.uint8)
    n = lib().agt_lz4_frame_decompress(ptr, len(src), out.ctypes.data,
                                       uncompressed_size)
    if n < 0:
        raise ArrowInvalid("corrupt or truncated lz4 frame")
    if n != uncompressed_size:
        raise ArrowInvalid(f"lz4 frame holds {n} bytes, not "
                           f"{uncompressed_size}")
    return memoryview(out)[:n]


def xxh32(data, seed: int = 0) -> int:
    """XXH32 of a byte buffer (the LZ4 frame's checksums)."""
    src, ptr = _in(data)
    return int(lib().agt_xxh32(ptr, len(src), seed))


# ---------------------------------------------------------------------------
# XXH64 and zstd
# ---------------------------------------------------------------------------

_ZSTD_DICTIONARY, _ZSTD_TOO_SMALL, _ZSTD_UNKNOWN = -2, -3, -4


def xxh64(data) -> int:
    """XXH64 (seed 0) of a byte buffer: the parquet bloom filter's hash."""
    src, ptr = _in(data)
    return int(lib().agt_xxh64(ptr, len(src), 0))


def xxh64_rows(ends: np.ndarray, data: np.ndarray) -> np.ndarray:
    """XXH64 (seed 0) of each row of (ends, data), as uint64."""
    ends = np.ascontiguousarray(ends, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    out = np.empty(max(len(ends), 1), np.uint64)
    lib().agt_xxh64_rows(data.ctypes.data, ends.ctypes.data, len(ends),
                         out.ctypes.data)
    return out[:len(ends)]


def zstd_compress(data, level: int = 3) -> memoryview:
    """One zstd frame (RFC 8878) of `data`: content size in the header,
    greedy hash-chain matches searched deeper as `level` rises, raw
    literals and sequences in the predefined FSE mode."""
    lb = lib()
    src, ptr = _in(data)
    cap = lb.agt_zstd_compress_bound(len(src))
    out = np.empty(cap, np.uint8)
    n = lb.agt_zstd_compress(ptr, len(src), out.ctypes.data, cap,
                             int(level))
    if n < 0:
        raise ArrowInvalid(f"zstd compression of {len(src)} bytes failed")
    return memoryview(out)[:n]


def zstd_content_size(data) -> Optional[int]:
    """The content size that every frame's header of a zstd stream
    gives, summed (None when a frame's header gives none); a malformed or
    truncated stream raises ArrowInvalid."""
    src, ptr = _in(data)
    n = lib().agt_zstd_content_size(ptr, len(src))
    if n == _ZSTD_UNKNOWN:
        return None
    if n < 0:
        raise ArrowInvalid("corrupt zstd stream")
    return int(n)


def zstd_decompress(data, uncompressed_size: Optional[int],
                    max_size: int = 1 << 31) -> memoryview:
    """Every frame of a zstd stream (skippable frames skipped), whose
    content must be `uncompressed_size` bytes. With None, the size is
    the frame headers' content size where each header gives it;
    otherwise the stream decodes into a buffer that doubles, from four
    times the input, up to `max_size` bytes. A corrupt or truncated
    stream, a failed checksum, another size or more than `max_size`
    bytes raises ArrowInvalid; a frame that names a dictionary
    ArrowNotImplemented."""
    exact = uncompressed_size is not None
    cap = uncompressed_size if exact else zstd_content_size(data)
    if cap is not None:
        exact = True
        if uncompressed_size is None and cap > max_size:
            raise ArrowInvalid(f"zstd stream holds {cap} bytes, past "
                               f"{max_size}")
    else:
        cap = min(max(4 * len(data), 1 << 16), max_size)
    while True:
        src, ptr = _in(data)
        out = np.empty(max(cap, 1), np.uint8)
        n = lib().agt_zstd_decompress(ptr, len(src), out.ctypes.data, cap)
        if n != _ZSTD_TOO_SMALL or exact or cap >= max_size:
            break
        cap = min(2 * cap, max_size)
    if n == _ZSTD_DICTIONARY:
        raise ArrowNotImplemented("zstd frames with a dictionary are not "
                                  "ported")
    if n == _ZSTD_TOO_SMALL:
        raise ArrowInvalid(f"zstd stream holds more than {cap} bytes")
    if n < 0:
        raise ArrowInvalid("corrupt zstd stream")
    if exact and n != cap:
        raise ArrowInvalid(f"zstd stream holds {n} bytes, not {cap}")
    return memoryview(out)[:n]


# ---------------------------------------------------------------------------
# byte-array walks: a column of byte strings is (ends, data), value i the
# bytes [ends[i - 1], ends[i]) of data (ends[-1] = 0)
# ---------------------------------------------------------------------------

def plain_byte_array(data, n: int):
    """n PLAIN BYTE_ARRAY values -> (int64 ends, uint8 data, stream bytes
    used). A stream that ends inside a value raises ArrowInvalid."""
    src, ptr = _in(data)
    ends = np.empty(max(n, 1), np.int64)
    out = np.empty(max(len(src) - 4 * n, 1), np.uint8)
    used = lib().agt_plain_byte_array(ptr, len(src), n, ends.ctypes.data,
                                      out.ctypes.data, len(out))
    if used < 0:
        raise ArrowInvalid("PLAIN BYTE_ARRAY page ends inside a value")
    total = int(ends[n - 1]) if n else 0
    return ends[:n], out[:total], int(used)


def delta_decode(data, max_count: int):
    """A DELTA_BINARY_PACKED stream of at most `max_count` values decoded
    in full on the host (widths up to 64 bits): (int64 values, stream
    bytes used). A malformed or truncated stream, or one that holds more
    values, raises ArrowInvalid."""
    src, ptr = _in(data)
    used = np.zeros(1, np.int64)
    out = np.empty(max(max_count, 1), np.int64)
    n = lib().agt_delta_decode(ptr, len(src), max_count, out.ctypes.data,
                               used.ctypes.data)
    if n == -2:
        raise ArrowInvalid(f"DELTA_BINARY_PACKED stream holds more than "
                           f"{max_count} values")
    if n < 0:
        raise ArrowInvalid("malformed DELTA_BINARY_PACKED stream")
    return out[:n], int(used[0])


def delta_byte_array_rebuild(prefix: np.ndarray, suffix_ends: np.ndarray,
                             suffixes: np.ndarray):
    """DELTA_BYTE_ARRAY rows from their prefix lengths and suffixes:
    (int64 ends, uint8 data). A prefix longer than the value before it
    raises ArrowInvalid."""
    n = len(prefix)
    prefix = np.ascontiguousarray(prefix, np.int64)
    suffix_ends = np.ascontiguousarray(suffix_ends, np.int64)
    suffixes = np.ascontiguousarray(suffixes, np.uint8)
    if len(suffix_ends) != n:
        raise ArrowInvalid(f"{n} prefix lengths for {len(suffix_ends)} "
                           f"suffixes")
    cap = int(prefix.sum()) + len(suffixes) if n else 0
    if n and prefix.min() < 0:
        raise ArrowInvalid("negative DELTA_BYTE_ARRAY prefix length")
    ends = np.empty(max(n, 1), np.int64)
    out = np.empty(max(cap, 1), np.uint8)
    got = lib().agt_delta_byte_array_rebuild(
        prefix.ctypes.data, suffix_ends.ctypes.data, suffixes.ctypes.data, n,
        ends.ctypes.data, out.ctypes.data, cap)
    if got < 0:
        raise ArrowInvalid("DELTA_BYTE_ARRAY prefix passes the value "
                           "before it")
    return ends[:n], out[:got]


def rle_decode(data, n: int, bit_width: int) -> np.ndarray:
    """The n values of an RLE/bit-packed hybrid stream (bit_width <= 32)
    on the host, as uint32. A stream that ends early raises
    ArrowInvalid."""
    src, ptr = _in(data)
    out = np.empty(max(n, 1), np.uint32)
    if lib().agt_rle_decode(ptr, len(src), n, bit_width,
                            out.ctypes.data) != n:
        raise ArrowInvalid("RLE/bit-packed stream ends early")
    return out[:n]


def gather_rows(ends: np.ndarray, data: np.ndarray, idx: np.ndarray):
    """Rows idx of (ends, data) as a new (ends, data)."""
    ends = np.ascontiguousarray(ends, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    idx = np.ascontiguousarray(idx, np.int32)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(ends)):
        raise ArrowInvalid("row index outside the values")
    lens = np.diff(ends, prepend=0)[idx]
    out_ends = np.cumsum(lens, dtype=np.int64)
    out = np.empty(max(int(out_ends[-1]) if len(idx) else 0, 1), np.uint8)
    lib().agt_gather_rows(data.ctypes.data, ends.ctypes.data,
                          idx.ctypes.data, len(idx), out.ctypes.data)
    return out_ends, out[:int(out_ends[-1]) if len(idx) else 0]


def factorize(ends: np.ndarray, data: np.ndarray):
    """First-occurrence codes of the rows of (ends, data): (int32 codes,
    int64 row of each distinct value's first appearance)."""
    ends = np.ascontiguousarray(ends, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(ends)
    codes = np.empty(max(n, 1), np.int32)
    first = np.empty(max(n, 1), np.int64)
    k = lib().agt_factorize(data.ctypes.data, ends.ctypes.data, n,
                            codes.ctypes.data, first.ctypes.data)
    if k < 0:
        raise MemoryError("factorize memo table")
    return codes[:n], first[:k]


def varint_lanes(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(vlen, val): int32 a byte of an Avro block, the length and the
    zigzag value cut to 32 bits of the varint starting there (a byte past
    the end read as 0; see codecs.cc)."""
    buf = np.ascontiguousarray(buf, np.uint8)
    vlen = np.empty(len(buf), np.int32)
    val = np.empty(len(buf), np.int32)
    lib().agt_varint_lanes(buf.ctypes.data, len(buf), vlen.ctypes.data,
                           val.ctypes.data)
    return vlen, val


def avro_flat_walk(vlen: np.ndarray, val: np.ndarray, count: int,
                   kinds, null_branches) -> np.ndarray:
    """(count, fields) int64 start of each field of each record of a flat
    Avro block, walked over its varint lanes (`vlen`, `val`: int32 a
    byte); `kinds` a field (0 null, 1 boolean, 2 varint, 3 float, 4
    double, 5 bytes or string), `null_branches` (-1 when the field is no
    union). A lane read from an empty block raises IndexError, as the
    array walk it replaces does."""
    vlen = np.ascontiguousarray(vlen, np.int32)
    val = np.ascontiguousarray(val, np.int32)
    kinds = np.ascontiguousarray(kinds, np.int32)
    nbs = np.ascontiguousarray(null_branches, np.int32)
    nf = len(kinds)
    out = np.empty((count, nf), np.int64)
    if lib().agt_avro_flat_walk(vlen.ctypes.data, val.ctypes.data, len(vlen),
                                count, nf, kinds.ctypes.data,
                                nbs.ctypes.data, out.ctypes.data) < 0:
        raise IndexError("an Avro field read from an empty block")
    return out


# ---------------------------------------------------------------------------
# AES-CTR and AES-GCM (parquet modular encryption)
# ---------------------------------------------------------------------------

_AES_BAD_KEY, _AES_NO_CPU, _AES_BAD_TAG, _AES_SHORT = -1, -2, -3, -4


def _aes_check(n: int) -> int:
    if n == _AES_BAD_KEY:
        raise ArrowInvalid("AES keys must be 16/24/32 bytes")
    if n == _AES_NO_CPU:
        raise ArrowNotImplemented("AES needs a CPU with AES-NI, PCLMULQDQ "
                                  "and SSE4.1")
    if n == _AES_BAD_TAG:
        raise ArrowInvalid("AES-GCM tag mismatch (wrong key or corrupt "
                           "module)")
    if n == _AES_SHORT:
        raise ArrowInvalid("AES-GCM input shorter than its tag")
    return n


def aes_ctr(key, iv, data, out=None) -> memoryview:
    """`data` xor the AES keystream of the counter blocks iv, iv + 1, ...
    (iv a 16-byte block whose last four bytes are a big-endian count,
    incremented mod 2**32): CTR encryption and decryption alike. With
    `out` (a uint8 array of len(data) bytes) the result is written
    there."""
    k, kp = _in(key)
    v, vp = _in(iv)
    if len(v) != 16:
        raise ArrowInvalid("an AES-CTR counter block is 16 bytes")
    src, ptr = _in(data)
    if out is None:
        out = np.empty(max(len(src), 1), np.uint8)
    _aes_check(lib().agt_aes_ctr(kp, len(k), vp, ptr, len(src),
                                 out.ctypes.data))
    return memoryview(out)[:len(src)]


def aes_gcm_encrypt(key, nonce, data, aad=b"", out=None) -> memoryview:
    """AES-GCM under a 12-byte nonce: the ciphertext of `data`, then its
    16-byte tag over `aad` and the ciphertext. With `out` (a uint8 array
    of len(data) + 16 bytes) the result is written there."""
    k, kp = _in(key)
    v, vp = _in(nonce)
    if len(v) != 12:
        raise ArrowInvalid("an AES-GCM nonce is 12 bytes")
    a, ap = _in(aad)
    src, ptr = _in(data)
    if out is None:
        out = np.empty(len(src) + 16, np.uint8)
    n = _aes_check(lib().agt_aes_gcm_encrypt(kp, len(k), vp, ap, len(a),
                                             ptr, len(src),
                                             out.ctypes.data))
    return memoryview(out)[:n]


def aes_gcm_decrypt(key, nonce, data, aad=b"") -> memoryview:
    """The plaintext of `data` (ciphertext, then its 16-byte tag) under a
    12-byte nonce, after the tag over `aad` and the ciphertext is
    checked in constant time; a mismatch raises ArrowInvalid and
    returns nothing."""
    k, kp = _in(key)
    v, vp = _in(nonce)
    if len(v) != 12:
        raise ArrowInvalid("an AES-GCM nonce is 12 bytes")
    a, ap = _in(aad)
    src, ptr = _in(data)
    out = np.empty(max(len(src) - 16, 1), np.uint8)
    n = _aes_check(lib().agt_aes_gcm_decrypt(kp, len(k), vp, ap, len(a),
                                             ptr, len(src),
                                             out.ctypes.data))
    return memoryview(out)[:n]


# ---------------------------------------------------------------------------
# the JAX module's other names (arrow_go_tpu/native/__init__.py)
# ---------------------------------------------------------------------------

def available() -> bool:
    """True once the codec library is built and loaded. A build that
    fails raises, as every walk does: the port has no Python codec for
    a False to choose (the JAX module's falls back to one)."""
    lib()
    return True


def bitunpack32(data, n: int, width: int) -> np.ndarray:
    """n `width`-bit LSB-first values (width <= 32) as uint32 (numpy)."""
    if n == 0 or width == 0:
        return np.zeros(n, np.uint32)
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    need = n * width
    if bits.size < need:
        bits = np.pad(bits, (0, need - bits.size))
    bits = bits[:need].reshape(n, width).astype(np.uint32)
    return (bits << np.arange(width, dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32)


def bitpack32(values: np.ndarray, width: int) -> bytes:
    """uint32 values packed into `width`-bit LSB-first bytes (numpy)."""
    values = np.ascontiguousarray(values, np.uint32)
    if not len(values) or width == 0:
        return b""
    bits = (values[:, None] >> np.arange(width, dtype=np.uint32)) & 1
    return np.packbits(bits.astype(np.uint8).ravel(),
                       bitorder="little").tobytes()


def byte_array_unpack(data, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """A PLAIN BYTE_ARRAY stream of n values -> (int64 offsets (n + 1),
    the values' bytes back to back), plain_byte_array's walk."""
    ends, out, _ = plain_byte_array(data, n)
    return np.concatenate([[0], ends]).astype(np.int64), out


def factorize_offsets(data: np.ndarray, offsets: np.ndarray,
                      valid: Optional[np.ndarray] = None):
    """First-occurrence codes of offsets + data byte rows (a null row, by
    `valid`, as the empty string): (int32 codes, int64 row of each
    distinct value's first appearance), `factorize`'s walk."""
    off = np.asarray(offsets, np.int64)
    n = len(off) - 1
    lo = int(off[0]) if n >= 0 else 0
    ends = off[1:] - lo
    data = np.asarray(data, np.uint8)[lo:int(off[-1])]
    if valid is not None:
        ends = np.append(ends, ends[-1] if n else 0)   # an empty row
        ends, data = gather_rows(ends, data, np.where(
            np.asarray(valid, np.bool_), np.arange(n), n))
    return factorize(ends, data)
