"""Parquet file footer and schema (the part of arrow_go_tpu/parquet/
reader.py:ParquetFile that the device scan reads; reference
parquet/file/file_reader.go:51).

Values are not read here: `device_read.read_batch_device` reads the
column chunks of a row group and decodes them on the device. Encrypted
files (the PARE magic, or a plaintext footer that names an encryption
algorithm) are not ported and raise ArrowNotImplemented.
"""
from __future__ import annotations

import io
import os
import struct
import threading
from typing import BinaryIO, Union

from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from . import format as fmt
from . import schema as psch
from .thrift import CompactReader

MAGIC = b"PAR1"
MAGIC_ENCRYPTED = b"PARE"


class ParquetFile:
    """Footer, schema and leaf columns of a parquet file, plus its source
    for the column-chunk reads."""

    def __init__(self, source: Union[str, os.PathLike, BinaryIO, bytes]):
        self._owned = isinstance(source, (str, os.PathLike))
        # a file given as bytes is sliced in place by read_range
        self._buffer = None
        if self._owned:
            source = open(source, "rb")
        elif isinstance(source, (bytes, bytearray, memoryview)):
            self._buffer = memoryview(source).cast("B")
            source = io.BytesIO(source)
        self.src = source
        # one handle shared by the column reads: seek+read pairs hold it
        self._src_lock = threading.Lock()
        try:
            self.metadata = self._read_footer()
        except BaseException:
            self.close()
            raise
        self.schema, self.leaves = psch.elements_to_schema(
            self.metadata.schema)

    def _read_footer(self) -> fmt.FileMetaData:
        src = self.src
        src.seek(0, 2)
        size = src.tell()
        if size < 12:
            raise ArrowInvalid("file too small for parquet")
        src.seek(0)
        head = src.read(4)
        src.seek(size - 8)
        tail = src.read(8)
        if MAGIC_ENCRYPTED in (head, tail[4:]):
            raise ArrowNotImplemented("encrypted parquet files are not "
                                      "ported")
        if head != MAGIC or tail[4:] != MAGIC:
            raise ArrowInvalid("bad parquet magic")
        (flen,) = struct.unpack("<I", tail[:4])
        if flen > size - 12:
            raise ArrowInvalid(f"footer length {flen} exceeds the file")
        src.seek(size - 8 - flen)
        meta = CompactReader(src.read(flen)).read_struct(fmt.FileMetaData)
        if meta.encryption_algorithm is not None:
            raise ArrowNotImplemented("encrypted parquet files are not "
                                      "ported")
        return meta

    def read_range(self, start: int, size: int) -> memoryview:
        """Bytes [start, start + size) of the file: a slice of the caller's
        buffer when the file came as bytes, else one seek + read under
        the source's lock."""
        if self._buffer is not None:
            return self._buffer[start:start + size]
        with self._src_lock:
            self.src.seek(start)
            return memoryview(self.src.read(size))

    @property
    def num_row_groups(self) -> int:
        return len(self.metadata.row_groups or [])

    def close(self) -> None:
        if self._owned:
            self.src.close()

    def __enter__(self) -> "ParquetFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
