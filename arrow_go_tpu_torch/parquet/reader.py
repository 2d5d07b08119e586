"""Parquet file footer and schema (the part of arrow_go_tpu/parquet/
reader.py:ParquetFile that the device scan reads; reference
parquet/file/file_reader.go:51), and the row-group pruning of the
dataset scan by column statistics and bloom filters
(arrow_go_tpu/parquet/reader.py:683-689,720-796).

Values are not read here: `device_read.read_batch_device` reads the
column chunks of a row group and decodes them on the device. Encrypted
files (the PARE magic, or a plaintext footer that names an encryption
algorithm) are not ported and raise ArrowNotImplemented.

The pruning keeps the JAX package's semantics: only the statistics'
`min_value` / `max_value` are read (not the deprecated `min` / `max`),
only INT32, INT64, FLOAT, DOUBLE and BYTE_ARRAY statistics are decoded
(a string's as UTF-8 with replacement, a binary's as bytes), and a
bloom filter is consulted only for `==`.
"""
from __future__ import annotations

import io
import os
import struct
import threading
from typing import BinaryIO, List, Optional, Union

from .. import dtypes as dt
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

    def _leaf_index_of(self, column: str) -> Optional[int]:
        for i, leaf in enumerate(self.leaves):
            if leaf.path and leaf.path[0] == column and len(leaf.path) == 1:
                return i
        return None

    def read_bloom_filter(self, rg: int, col: int):
        """The bloom filter of leaf `col` in row group `rg`, or None."""
        from .bloom import BloomFilter
        meta = self.metadata.row_groups[rg].columns[col].meta_data
        if meta.bloom_filter_offset is None:
            return None
        return BloomFilter.deserialize(self.read_range(
            meta.bloom_filter_offset, meta.bloom_filter_length or (1 << 20)))

    def _row_group_may_match(self, rg_i: int, filters: List[tuple],
                             bloom: bool = True) -> bool:
        """False when statistics or a bloom filter (not read unless
        `bloom`) show that no row of row group rg_i passes every
        (column, op, literal) of `filters` (ANDed; op one of ==, <, <=,
        >, >=)."""
        rg = self.metadata.row_groups[rg_i]
        for col_name, op, value in filters:
            li = self._leaf_index_of(col_name)
            if li is None:
                continue
            desc = self.leaves[li]
            st = rg.columns[li].meta_data.statistics
            lohi = _decode_stats(st, desc) if st is not None else None
            if lohi is not None:
                lo, hi = lohi
                if op == "==" and (value < lo or value > hi):
                    return False
                if op == "<" and lo >= value:
                    return False
                if op == "<=" and lo > value:
                    return False
                if op == ">" and hi <= value:
                    return False
                if op == ">=" and hi < value:
                    return False
            if op == "==" and bloom:
                bf = self.read_bloom_filter(rg_i, li)
                if bf is not None and not bf.check(value, desc.physical_type):
                    return False
        return True

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


_STAT_PACK = {fmt.Type.INT32: "<i", fmt.Type.INT64: "<q",
              fmt.Type.FLOAT: "<f", fmt.Type.DOUBLE: "<d"}


def _decode_stats(st: fmt.Statistics, desc):
    """(min, max) of a chunk's statistics as Python values, or None."""
    if st.min_value is None or st.max_value is None:
        return None
    phys = desc.physical_type
    if phys in _STAT_PACK:
        code = _STAT_PACK[phys]
        return (struct.unpack(code, st.min_value)[0],
                struct.unpack(code, st.max_value)[0])
    if phys == fmt.Type.BYTE_ARRAY:
        if desc.arrow_type.id == dt.TypeId.STRING:
            return (st.min_value.decode("utf-8", "replace"),
                    st.max_value.decode("utf-8", "replace"))
        return (st.min_value, st.max_value)
    return None
