"""The port's host codec library: csrc/codecs.cc, built with g++.

Snappy and LZ4 raw (compress, decompress) and the header walks of the
RLE/bit-packed hybrid and of DELTA_BINARY_PACKED streams, in C++ with a
plain C interface loaded with ctypes. The library is built at its first
use into `arrow_go_tpu_torch/build/`
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
    min delta) as int64 / int64 / int32 / int64 arrays. A miniblock wider
    than 32 bits raises ArrowNotImplemented (as the JAX package's device
    read does); a stream that ends early raises ArrowInvalid."""
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
        raise ArrowNotImplemented(f"device DELTA decode with a "
                                  f"{int(bad[0])}-bit miniblock width")
    if rows < 0:
        raise ArrowInvalid("DELTA_BINARY_PACKED stream ends early")
    return starts[:rows], bit0[:rows], width[:rows], mins[:rows]
