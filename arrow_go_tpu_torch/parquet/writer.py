"""A small parquet writer for flat numeric columns.

The port's own writer (after arrow_go_tpu/parquet/writer.py:write_table,
reference parquet/file/file_writer.go): numpy columns (bool, int32,
int64, float32, float64), each optionally with a validity mask, in row
groups of `row_group_size` rows and v1 data pages of about
`data_page_size` bytes, UNCOMPRESSED or GZIP.

With `use_dictionary` every non-boolean column chunk is dictionary
encoded (a PLAIN dictionary page, RLE_DICTIONARY data pages) unless its
dictionary page would pass `dictionary_pagesize_limit` bytes; then the
whole chunk is PLAIN, as the reference falls back
(column_writer.go FallbackToPlainEncoding). The dictionary holds the
distinct bit patterns in ascending order, so -0.0, 0.0 and NaN payloads
survive a round trip.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..compute.errors import ArrowInvalid
from . import compress as comp
from . import encodings as enc
from . import format as fmt
from . import schema as psch
from .thrift import CompactWriter

MAGIC = b"PAR1"
CREATED_BY = "arrow_go_tpu_torch v0.1.0"
_RANGE_TABLE_MAX = 1 << 26     # widest value range dictionary-coded by table


def _thrift_bytes(obj) -> bytes:
    w = CompactWriter()
    w.write_struct(obj)
    return bytes(w.out)


def _dictionary(vals: np.ndarray, limit: int
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(dictionary, uint32 codes) of vals by bit pattern, or None when the
    dictionary page would pass `limit` bytes."""
    if not len(vals):
        return vals[:0], np.zeros(0, np.uint32)
    item = vals.dtype.itemsize
    bits = vals.view(f"i{item}")
    lo, hi = int(bits.min()), int(bits.max())
    if hi - lo < _RANGE_TABLE_MAX:
        # narrow range: one pass over a presence table instead of a sort
        seen = np.zeros(hi - lo + 1, np.bool_)
        rel = (bits - lo).astype(np.int64)
        seen[rel] = True
        if np.count_nonzero(seen) * item > limit:
            return None
        code_of = (np.cumsum(seen, dtype=np.int64) - 1).astype(np.uint32)
        keys = (np.flatnonzero(seen) + lo).astype(bits.dtype)
        return keys.view(vals.dtype), code_of[rel]
    keys = np.unique(bits)
    if len(keys) * item > limit:
        return None
    return keys.view(vals.dtype), np.searchsorted(keys, bits).astype(
        np.uint32)


def _write_chunk(sink: BinaryIO, vals: np.ndarray,
                 mask: Optional[np.ndarray], desc: psch.ColumnDescriptor,
                 codec: int, use_dictionary: bool, dict_limit: int,
                 data_page_size: Optional[int]) -> fmt.ColumnChunk:
    num_values = len(vals)
    nullable = desc.max_def_level > 0
    present = vals if mask is None else vals[mask]
    phys = desc.physical_type
    coded = None
    if use_dictionary and phys != fmt.Type.BOOLEAN:
        coded = _dictionary(np.ascontiguousarray(present), dict_limit)
    start_offset = sink.tell()
    total_unc = total_comp = 0
    dict_page_offset = None
    if coded is not None:
        keys, codes = coded
        width = max(enc.bit_width_for(len(keys) - 1), 1)
        page = enc.plain_encode(phys, keys)
        body = comp.compress(codec, page)
        hb = _thrift_bytes(fmt.PageHeader(
            type=int(fmt.PageType.DICTIONARY_PAGE),
            uncompressed_page_size=len(page),
            compressed_page_size=len(body),
            dictionary_page_header=fmt.DictionaryPageHeader(
                num_values=len(keys), encoding=int(fmt.Encoding.PLAIN))))
        dict_page_offset = sink.tell()
        sink.write(hb)
        sink.write(body)
        total_unc += len(hb) + len(page)
        total_comp += len(hb) + len(body)
        value_encoding = fmt.Encoding.RLE_DICTIONARY
        row_bytes = width / 8
    else:
        value_encoding = fmt.Encoding.PLAIN
        row_bytes = vals.dtype.itemsize if phys != fmt.Type.BOOLEAN else 1 / 8
    if nullable:
        row_bytes += 1 / 8
    rows_per_page = num_values if not data_page_size else max(
        8, int(data_page_size / row_bytes))
    present_before = None if mask is None else np.concatenate(
        ([0], np.cumsum(mask, dtype=np.int64)))

    data_page_offset = None
    for start in range(0, max(num_values, 1), max(rows_per_page, 1)):
        end = min(start + rows_per_page, num_values)
        p0, p1 = (start, end) if mask is None else (
            int(present_before[start]), int(present_before[end]))
        levels = enc.levels_encode_v1(mask[start:end].astype(np.uint32), 1) \
            if nullable else b""
        if coded is not None:
            data = bytes([width]) + enc.rle_encode(codes[p0:p1], width)
        else:
            data = enc.plain_encode(phys, present[p0:p1])
        payload = levels + data
        body = comp.compress(codec, payload)
        hb = _thrift_bytes(fmt.PageHeader(
            type=int(fmt.PageType.DATA_PAGE),
            uncompressed_page_size=len(payload),
            compressed_page_size=len(body),
            data_page_header=fmt.DataPageHeader(
                num_values=end - start, encoding=int(value_encoding),
                definition_level_encoding=int(fmt.Encoding.RLE),
                repetition_level_encoding=int(fmt.Encoding.RLE))))
        if data_page_offset is None:
            data_page_offset = sink.tell()
        sink.write(hb)
        sink.write(body)
        total_unc += len(hb) + len(payload)
        total_comp += len(hb) + len(body)

    encodings = {int(fmt.Encoding.PLAIN), int(value_encoding)}
    if nullable:
        encodings.add(int(fmt.Encoding.RLE))
    meta = fmt.ColumnMetaData(
        type=int(phys), encodings=sorted(encodings),
        path_in_schema=list(desc.path), codec=int(codec),
        num_values=num_values, total_uncompressed_size=total_unc,
        total_compressed_size=total_comp, data_page_offset=data_page_offset,
        dictionary_page_offset=dict_page_offset)
    return fmt.ColumnChunk(file_offset=start_offset, meta_data=meta)


def write_table(data: Dict[str, np.ndarray], sink,
                masks: Optional[Dict[str, np.ndarray]] = None,
                compression: str = "none", use_dictionary: bool = True,
                dictionary_pagesize_limit: int = 1 << 20,
                data_page_size: Optional[int] = None,
                row_group_size: Optional[int] = None) -> None:
    """Write numpy columns (all of one length) to a parquet file.

    masks: validity by column name (True = valid); a column with a mask
           is written OPTIONAL, one without it REQUIRED.
    sink:  a path or a binary file object.
    """
    masks = masks or {}
    names = list(data)
    n = len(data[names[0]]) if names else 0
    fields = []
    for name in names:
        v = np.asarray(data[name])
        if v.ndim != 1 or len(v) != n:
            raise ArrowInvalid(f"column {name!r}: expected 1-D length {n}")
        m = masks.get(name)
        if m is not None and (len(m) != n or np.asarray(m).dtype != np.bool_):
            raise ArrowInvalid(f"mask of {name!r}: expected bool[{n}]")
        fields.append(dt.Field(name, dt.from_numpy_dtype(v.dtype),
                               m is not None))
    codec = comp.codec_for_name(compression)
    schema = dt.Schema(fields)
    elements, leaves = psch.schema_to_elements(schema)
    if hasattr(sink, "write"):
        _write(data, masks, sink, elements, leaves, n, codec, use_dictionary,
               dictionary_pagesize_limit, data_page_size, row_group_size)
        return
    with open(sink, "wb") as f:
        _write(data, masks, f, elements, leaves, n, codec, use_dictionary,
               dictionary_pagesize_limit, data_page_size, row_group_size)


def _write(data, masks, sink, elements, leaves, n, codec, use_dictionary,
           dict_limit, data_page_size, row_group_size) -> None:
    sink.write(MAGIC)
    rg_rows = row_group_size or max(n, 1)
    row_groups: List[fmt.RowGroup] = []
    for a in range(0, n, rg_rows):
        b = min(a + rg_rows, n)
        rg_start = sink.tell()
        chunks = []
        for desc in leaves:
            name = desc.path[0]
            m = masks.get(name)
            chunks.append(_write_chunk(
                sink, np.asarray(data[name])[a:b],
                None if m is None else np.asarray(m)[a:b], desc, codec,
                use_dictionary, dict_limit, data_page_size))
        total = sum(c.meta_data.total_compressed_size for c in chunks)
        row_groups.append(fmt.RowGroup(
            columns=chunks, total_byte_size=total, num_rows=b - a,
            file_offset=rg_start, total_compressed_size=total,
            ordinal=len(row_groups)))
    meta = fmt.FileMetaData(
        version=2, schema=elements, num_rows=n, row_groups=row_groups,
        created_by=CREATED_BY,
        column_orders=[fmt.ColumnOrder(TYPE_ORDER=fmt.TypeDefinedOrder())
                       for _ in leaves])
    mb = _thrift_bytes(meta)
    sink.write(mb)
    sink.write(struct.pack("<I", len(mb)))
    sink.write(MAGIC)
