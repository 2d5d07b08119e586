"""Parquet page codecs of the port: UNCOMPRESSED, SNAPPY, GZIP, LZ4_RAW
and ZSTD.

Port of arrow_go_tpu/parquet/compress.py. Snappy, LZ4 raw and zstd run
in the port's own host codec library (csrc/codecs.cc, built with g++ at
first use; arrow_go_tpu_torch/native.py), gzip in the standard library's
zlib. zstd reads every frame RFC 8878 describes except those that name
a dictionary, and writes frames of raw literals and predefined-table
sequences (smaller than the zstandard package's at the same level,
which Huffman-codes its literals). BROTLI raises ArrowNotImplemented:
its decoder needs RFC 7932's static dictionary, which the repository
does not hold.
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
               "zstd": fmt.Codec.ZSTD,
               "lz4": fmt.Codec.LZ4_RAW,
               "lz4_raw": fmt.Codec.LZ4_RAW}

ZSTD_DEFAULT_LEVEL = 3


def codec_for_name(name: str) -> fmt.Codec:
    try:
        return CODEC_NAMES[name.lower()]
    except KeyError:
        raise ArrowNotImplemented(
            f"parquet codec {name!r} is not ported (the port reads and "
            f"writes none, snappy, gzip, lz4_raw and zstd)") from None


def compress(codec: int, data, level: int = None):
    """level: gzip's (1-9) or zstd's; None = the codec's default."""
    c = fmt.Codec(codec)
    if c == fmt.Codec.UNCOMPRESSED:
        return data
    if c == fmt.Codec.SNAPPY:
        return native.snappy_compress(data)
    if c == fmt.Codec.GZIP:
        co = zlib.compressobj(level if level is not None else -1,
                              wbits=31)  # gzip container
        return co.compress(data) + co.flush()
    if c == fmt.Codec.ZSTD:
        return native.zstd_compress(
            data, ZSTD_DEFAULT_LEVEL if level is None else level)
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
    if c == fmt.Codec.ZSTD:
        return native.zstd_decompress(data, uncompressed_size)
    if c == fmt.Codec.LZ4_RAW:
        return native.lz4_decompress(data, uncompressed_size)
    raise ArrowNotImplemented(f"parquet codec {c.name} is not ported")
