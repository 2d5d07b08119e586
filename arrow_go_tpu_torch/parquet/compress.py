"""Parquet page codecs of the port: UNCOMPRESSED, SNAPPY, GZIP and LZ4_RAW.

Port of arrow_go_tpu/parquet/compress.py. Snappy and LZ4 raw run in the
port's own host codec library (csrc/codecs.cc, built with g++ at first
use; arrow_go_tpu_torch/native.py), gzip in the standard library's zlib.
ZSTD and BROTLI raise ArrowNotImplemented: the JAX package takes them
from the zstandard package and brotli libraries, which the port does not
use.
"""
from __future__ import annotations

import zlib

from .. import native
from ..compute.errors import ArrowNotImplemented
from . import format as fmt

CODEC_NAMES = {"none": fmt.Codec.UNCOMPRESSED,
               "uncompressed": fmt.Codec.UNCOMPRESSED,
               "snappy": fmt.Codec.SNAPPY,
               "gzip": fmt.Codec.GZIP,
               "lz4": fmt.Codec.LZ4_RAW,
               "lz4_raw": fmt.Codec.LZ4_RAW}


def codec_for_name(name: str) -> fmt.Codec:
    try:
        return CODEC_NAMES[name.lower()]
    except KeyError:
        raise ArrowNotImplemented(
            f"parquet codec {name!r} is not ported (the port reads and "
            f"writes none, snappy, gzip and lz4_raw)") from None


def compress(codec: int, data, level: int = None):
    c = fmt.Codec(codec)
    if c == fmt.Codec.UNCOMPRESSED:
        return data
    if c == fmt.Codec.SNAPPY:
        return native.snappy_compress(data)
    if c == fmt.Codec.GZIP:
        co = zlib.compressobj(level if level is not None else -1,
                              wbits=31)  # gzip container
        return co.compress(data) + co.flush()
    if c == fmt.Codec.LZ4_RAW:
        return native.lz4_compress(data)
    raise ArrowNotImplemented(f"parquet codec {c.name} is not ported")


def decompress(codec: int, data, uncompressed_size: int):
    c = fmt.Codec(codec)
    if c == fmt.Codec.UNCOMPRESSED:
        return data
    if c == fmt.Codec.SNAPPY:
        return native.snappy_decompress(data)
    if c == fmt.Codec.GZIP:
        return zlib.decompress(data, wbits=47)    # gzip or zlib header
    if c == fmt.Codec.LZ4_RAW:
        return native.lz4_decompress(data, uncompressed_size)
    raise ArrowNotImplemented(f"parquet codec {c.name} is not ported")
