"""Parquet page codecs of the port: UNCOMPRESSED and GZIP.

Port of arrow_go_tpu/parquet/compress.py for the codecs the standard
library carries (zlib). Snappy and LZ4 decompress through the JAX
package's native library and zstd through the zstandard package; the
port takes neither, so every codec other than these two raises
ArrowNotImplemented.
"""
from __future__ import annotations

import zlib

from ..compute.errors import ArrowNotImplemented
from . import format as fmt

CODEC_NAMES = {"none": fmt.Codec.UNCOMPRESSED,
               "uncompressed": fmt.Codec.UNCOMPRESSED,
               "gzip": fmt.Codec.GZIP}


def codec_for_name(name: str) -> fmt.Codec:
    try:
        return CODEC_NAMES[name.lower()]
    except KeyError:
        raise ArrowNotImplemented(
            f"parquet codec {name!r} is not ported (the port reads and "
            f"writes none and gzip)") from None


def compress(codec: int, data: bytes, level: int = None) -> bytes:
    c = fmt.Codec(codec)
    if c == fmt.Codec.UNCOMPRESSED:
        return data
    if c == fmt.Codec.GZIP:
        co = zlib.compressobj(level if level is not None else -1,
                              wbits=31)  # gzip container
        return co.compress(data) + co.flush()
    raise ArrowNotImplemented(f"parquet codec {c.name} is not ported")


def decompress(codec: int, data: bytes, uncompressed_size: int) -> bytes:
    c = fmt.Codec(codec)
    if c == fmt.Codec.UNCOMPRESSED:
        return data
    if c == fmt.Codec.GZIP:
        return zlib.decompress(data, wbits=47)    # gzip or zlib header
    raise ArrowNotImplemented(f"parquet codec {c.name} is not ported")
