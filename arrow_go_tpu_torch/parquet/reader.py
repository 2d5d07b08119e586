"""Parquet file footer and schema (the part of arrow_go_tpu/parquet/
reader.py:ParquetFile that the device scan reads; reference
parquet/file/file_reader.go:51), and the row-group pruning of the
dataset scan by column statistics and bloom filters
(arrow_go_tpu/parquet/reader.py:683-689,720-796).

Flat values are not read here: `device_read.read_batch_device` reads
the column chunks of a row group and decodes them on the device. A
nested column (list, map, struct) is read on the host, as the JAX
reader reads it (arrow_go_tpu/parquet/reader.py:_read_field):
`read_field_host` decodes each of its leaf chunks' repetition and
definition levels (the codec library's RLE walk) and present values
(PLAIN, dictionary, DELTA_BINARY_PACKED and the byte-array encodings;
a FIXED_LEN_BYTE_ARRAY or INT96 leaf raises ArrowNotImplemented), and
parquet/levels.py rebuilds the column. Encrypted
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

import numpy as np

from .. import dtypes as dt
from .. import native
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import ExtensionArray, HostArray, factorize
from . import compress as comp
from . import encodings as enc
from . import format as fmt
from . import levels as lv
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


# ---------------------------------------------------------------------------
# the host read of a nested column
# ---------------------------------------------------------------------------

_DICT_ENCODINGS = (fmt.Encoding.RLE_DICTIONARY, fmt.Encoding.PLAIN_DICTIONARY)


def _levels(stream, n: int, max_level: int) -> np.ndarray:
    return native.rle_decode(stream, n, enc.bit_width_for(max_level))


def _split_levels(hdr, body, desc, codec):
    """One data page -> (repetition levels, definition levels, value
    bytes, encoding): v1 pages hold both level streams length-prefixed
    in the compressed payload, v2 pages uncompressed before it."""
    if fmt.PageType(hdr.type) == fmt.PageType.DATA_PAGE:
        dph = hdr.data_page_header
        nv = dph.num_values or 0
        payload = memoryview(comp.decompress(codec, body,
                                             hdr.uncompressed_page_size))
        off, streams = 0, []
        for max_level in (desc.max_rep_level, desc.max_def_level):
            if max_level == 0:
                streams.append(np.zeros(nv, np.uint32))
                continue
            (ln,) = struct.unpack_from("<I", payload, off)
            streams.append(_levels(payload[off + 4:off + 4 + ln], nv,
                                   max_level))
            off += 4 + ln
        return streams[0], streams[1], payload[off:], fmt.Encoding(
            dph.encoding or 0)
    dph = hdr.data_page_header_v2
    nv = dph.num_values or 0
    rl = dph.repetition_levels_byte_length or 0
    dl = dph.definition_levels_byte_length or 0
    reps = _levels(body[:rl], nv, desc.max_rep_level) if \
        desc.max_rep_level else np.zeros(nv, np.uint32)
    defs = _levels(body[rl:rl + dl], nv, desc.max_def_level) if \
        desc.max_def_level else np.zeros(nv, np.uint32)
    vals = body[rl + dl:]
    if dph.is_compressed is not False and codec:
        vals = comp.decompress(codec, vals,
                               (hdr.uncompressed_page_size or 0) - rl - dl)
    return reps, defs, vals, fmt.Encoding(dph.encoding or 0)


def _page_values(phys: fmt.Type, encoding: fmt.Encoding, raw, n: int,
                 dictionary):
    """The n present values of a page: a numpy array of the physical
    type, or (int64 ends, uint8 data) rows of a BYTE_ARRAY leaf."""
    if encoding in _DICT_ENCODINGS:
        if dictionary is None:
            raise ArrowInvalid("dictionary page missing")
        codes = native.rle_decode(raw[1:], n, raw[0]) if n else \
            np.zeros(0, np.uint32)
        if phys == fmt.Type.BYTE_ARRAY:
            return native.gather_rows(*dictionary, codes.astype(np.int64))
        return dictionary[codes]
    if phys == fmt.Type.BYTE_ARRAY:
        return enc.byte_array_decode(encoding, raw, n)
    if encoding == fmt.Encoding.DELTA_BINARY_PACKED:
        vals, _ = native.delta_decode(raw, n)
        return vals.astype(np.int32 if phys == fmt.Type.INT32 else np.int64)
    if encoding == fmt.Encoding.PLAIN:
        return enc.plain_decode(phys, raw, n)
    raise ArrowNotImplemented(f"host decode of {encoding.name} pages")


def _leaf_array(desc, parts) -> HostArray:
    """A leaf's present values as a flat HostArray of its type: strings
    and binaries as a dictionary array (first-occurrence codes), a
    narrow or unsigned integer or temporal type from its physical
    ints."""
    t = desc.arrow_type
    if desc.physical_type == fmt.Type.BYTE_ARRAY:
        from .device_read import _dictionary_from_rows
        lens = [np.diff(e, prepend=0) for e, _ in parts]
        ends = np.cumsum(np.concatenate(lens) if lens else
                         np.zeros(0, np.int64), dtype=np.int64)
        data = np.concatenate([d for _, d in parts]) if parts else \
            np.zeros(0, np.uint8)
        codes, dictionary = factorize(_dictionary_from_rows(ends, data, t))
        return HostArray(codes, None, dt.dictionary(dt.int32, t), dictionary)
    phys = np.concatenate(parts) if parts else np.zeros(
        0, psch.physical_np_dtype(t))
    if t == dt.bool_:
        return HostArray(phys.astype(np.bool_), None, t)
    if phys.dtype.itemsize == t.np_dtype.itemsize:
        return HostArray(phys.view(t.np_dtype), None, t)
    return HostArray(phys.astype(t.np_dtype), None, t)


def _read_leaf(pf: ParquetFile, rg_i: int, li: int):
    """(definition levels, repetition levels, present values) of leaf
    li's chunk in row group rg_i."""
    from .device_read import _iter_pages
    desc = pf.leaves[li]
    phys = desc.physical_type
    if phys in (fmt.Type.FIXED_LEN_BYTE_ARRAY, fmt.Type.INT96):
        raise ArrowNotImplemented(
            f"a nested column's {phys.name} leaf is not ported")
    chunk = pf.metadata.row_groups[rg_i].columns[li]
    codec = chunk.meta_data.codec or 0
    dictionary = None
    defs, reps, parts = [], [], []
    for hdr, body in _iter_pages(pf, chunk):
        ptype = fmt.PageType(hdr.type)
        if ptype == fmt.PageType.DICTIONARY_PAGE:
            payload = comp.decompress(codec, body,
                                      hdr.uncompressed_page_size)
            nvd = hdr.dictionary_page_header.num_values or 0
            dictionary = native.plain_byte_array(payload, nvd)[:2] if \
                phys == fmt.Type.BYTE_ARRAY else np.asarray(
                    enc.plain_decode(phys, payload, nvd))
            continue
        if ptype not in (fmt.PageType.DATA_PAGE, fmt.PageType.DATA_PAGE_V2):
            raise ArrowNotImplemented(f"page type {ptype.name}")
        r, d, raw, encoding = _split_levels(hdr, body, desc, codec)
        n_present = int((d == desc.max_def_level).sum())
        parts.append(_page_values(phys, encoding, raw, n_present,
                                  dictionary))
        defs.append(d)
        reps.append(r)
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.uint32))
    return cat(defs), cat(reps), _leaf_array(desc, parts)


def read_field_host(pf: ParquetFile, rg_i: int, name: str) -> HostArray:
    """A nested top-level column of row group rg_i, read on the host: its
    leaves' levels and values through levels.rebuild_nested, joined by
    levels.merge_leaf_datas; a map column is read as its list storage
    and retyped."""
    li = 0
    for f in pf.schema.fields:
        g = f
        if f.type.id == dt.TypeId.EXTENSION:     # parquet.variant
            g = dt.Field(f.name, f.type.storage_type, f.nullable)
        if f.type.id == dt.TypeId.MAP:
            g = lv.map_storage_field(f)
        paths = lv.leaf_paths(g.type)
        if f.name == name:
            break
        li += len(paths)
    else:
        raise ArrowInvalid(f"unknown column {name!r}")
    datas = []
    for off, path in enumerate(paths):
        defs, reps, values = _read_leaf(pf, rg_i, li + off)
        datas.append(lv.rebuild_nested(lv.prune_field(g, path), defs, reps,
                                       values))
    out = lv.merge_leaf_datas(g, datas)
    if f.type.id == dt.TypeId.MAP:
        entries = out.children[0]
        out = HostArray(None, out.mask, f.type, offsets=out.offsets,
                        children=[HostArray(None, entries.mask,
                                            f.type.value_type,
                                            children=entries.children,
                                            length=len(entries))])
    if f.type.id == dt.TypeId.EXTENSION:
        out = ExtensionArray(f.type, out)
    return out
