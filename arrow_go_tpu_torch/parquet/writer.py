"""A small parquet writer for flat columns.

The port's own writer (after arrow_go_tpu/parquet/writer.py:write_table,
reference parquet/file/file_writer.go): numpy columns (bool, the signed
and unsigned ints, float16, float32, float64, the temporal types, the
decimals, fixed-size binaries, and strings or bytes), each optionally
with a validity mask, in row groups of `row_group_size` rows and v1
data pages of about `data_page_size` bytes, UNCOMPRESSED, SNAPPY, GZIP,
LZ4_RAW or ZSTD (at `compression_level`), each chunk with statistics
(the JAX writer's _stats_for rules) and, where asked for, a bloom
filter.

With `use_dictionary` a boolean column chunk is PLAIN and every other
one but a FIXED_LEN_BYTE_ARRAY one is dictionary encoded (a PLAIN
dictionary page; PLAIN_DICTIONARY data pages in v1, RLE_DICTIONARY in
v2, as the JAX writer marks them) unless its dictionary page would pass
`dictionary_pagesize_limit` bytes; then the whole chunk is PLAIN.
A numeric dictionary holds the distinct bit patterns in ascending
order, so -0.0, 0.0 and NaN payloads survive a round trip; a string
dictionary holds the values in first-occurrence order (the JAX
package's DictionaryBuilder), or, for a column given as (codes,
values), those values as they stand.
A FIXED_LEN_BYTE_ARRAY chunk is dictionary encoded (its distinct values
in key order) until its dictionary reaches `dictionary_pagesize_limit`
bytes, and PLAIN from the next page on, as the reference falls back
(column_writer.go FallbackToPlainEncoding): the pages written before
stay dictionary coded, so one chunk mixes both encodings.
`column_encodings` writes an INT32/INT64 column DELTA_BINARY_PACKED,
a string or binary column DELTA_LENGTH_BYTE_ARRAY or DELTA_BYTE_ARRAY,
a FIXED_LEN_BYTE_ARRAY column DELTA_BYTE_ARRAY, and a FLOAT, DOUBLE,
INT32, INT64 or FIXED_LEN_BYTE_ARRAY column BYTE_STREAM_SPLIT (each with
no dictionary; the value bytes of the JAX writer's _encode_values);
`use_dictionary` may name columns.
A column's type is its numpy dtype's (`dt.from_numpy_dtype`) unless
`types` names it: a date32 column of int32 days, say. Such a column is
written with the JAX writer's annotations (DATE, TIME, TIMESTAMP,
INTEGER, DECIMAL, FLOAT16) and its physical values: an 8- or 16-bit
int widened to INT32 by its value, a uint32 or uint64 as its bits, a
decimal32 / decimal64 as its unscaled INT32 / INT64, a decimal128 /
decimal256 as FIXED_LEN_BYTE_ARRAY of 16 / 32 big-endian bytes (the
JAX writer's layout; INT32 / INT64 with `store_decimal_as_integer` up
to precision 18), a float16 as two little-endian bytes and a
fixed_size_binary as its bytes. With `int96_timestamps` a timestamp
column is written as INT96 (nanoseconds of the day and Julian day,
reference WithDeprecatedInt96Timestamps).

A nested column (a HostArray of a list, large_list, fixed_size_list,
struct or map type, nested to any depth) is written OPTIONAL, its
validity its own, one chunk a leaf through parquet/levels.py (a map as
its list<struct<key, value>> storage, a fixed_size_list as a list, as
the JAX writer writes them): one v1 data page a chunk, repetition and
definition levels RLE, the leaf's present values PLAIN, no statistics.
Its leaves are of any flat type: bool, integer, float, temporal, string,
binary, and the FIXED_LEN_BYTE_ARRAY and INT96 ones (decimal, float16,
fixed_size_binary, an INT96 timestamp) as a flat column writes them.

With `encryption` (encryption.FileEncryptionProperties) the file is
written as the JAX writer writes it under parquet modular encryption:
each encrypted chunk's page headers and pages as encrypted frames (the
pages CTR under AES_GCM_CTR_V1; `compressed_page_size` counts the
frame), its bloom filter as two modules, its page index encrypted, its
ColumnMetaData encrypted where the reference does (with a redacted
plaintext copy under a plaintext footer), and the footer encrypted
("PARE") or signed. `write_page_index` writes each chunk's ColumnIndex
(one entry from the chunk statistics) and OffsetIndex (its page
locations) after the row groups and bloom filters; it is off by
default (the JAX writer's default is on) so that files written without
it keep their bytes.

`properties=WriterProperties(...)` (the JAX writer's option set, its
defaults but `created_by`) wins over the keywords and adds the format
version, `created_by`, DATA_PAGE_V2 pages (the levels uncompressed
before the compressed values, the header's statistics on a one-page
chunk, the JAX writer's encoding list), every option by column, the
bloom filters' fpp and the row groups' sorting columns. A HostBatch
input brings its schema's key/value metadata into the footer.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import dtypes as dt
from ..array.record import host_batch
from ..compute.errors import ArrowInvalid
from ..device.block import (HostArray, HostBatch, dictionary_type,
                            factorize)
from . import bloom as bloom_mod
from . import compress as comp
from . import encodings as enc
from . import encryption as encm
from . import format as fmt
from . import levels as lv
from . import schema as psch
from .thrift import CompactWriter

MAGIC = b"PAR1"
MAGIC_ENCRYPTED = b"PARE"
CREATED_BY = "arrow_go_tpu_torch v0.1.0"
_RANGE_TABLE_MAX = 1 << 26     # widest value range dictionary-coded by table
BLOOM_FPP = 0.01       # the JAX writer's default false-positive rate


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


def _string_bytes(dictionary: np.ndarray, t: dt.DataType) -> list:
    if t.is_utf8:
        return [v.encode() for v in dictionary]
    return [bytes(v) for v in dictionary]


def _row_keys(rows: np.ndarray):
    """(int64 key per row, keys -> rows) of an (n, width) byte matrix:
    the rows' own value when each is a big-endian int64 sign-extended
    to `width` bytes (a decimal of up to 18 digits), else codes over
    the distinct rows."""
    n, width = rows.shape
    if width >= 8:
        low = np.ascontiguousarray(rows[:, -8:][:, ::-1]).view(
            np.int64).reshape(-1)
        if (rows[:, :-8] == np.where(low < 0, 255, 0).astype(
                np.uint8)[:, None]).all():
            def rows_of(keys):
                limbs = np.repeat((keys >> 63)[:, None], -(-width // 8), 1)
                limbs[:, 0] = keys
                return _big_endian(limbs, width)
            return low, rows_of
    keyed = np.ascontiguousarray(rows).view(np.dtype((np.void, width)))
    uniq, inv = np.unique(keyed.reshape(-1), return_inverse=True)
    return inv.reshape(-1).astype(np.int64), \
        lambda keys: uniq[keys].view(np.uint8).reshape(len(keys), width)


def _fixed_dictionary(rows: np.ndarray, page_ends: List[int], limit: int):
    """(dictionary rows in byte-key order, uint32 codes of the rows of the
    dictionary pages, number of leading pages that are dictionary coded)
    of an (n, width) byte matrix whose pages end at the present-row
    counts `page_ends`: the dictionary holds the values of the pages up
    to the first one after which it reaches `limit` bytes."""
    n, width = rows.shape
    if not n:
        return rows, np.zeros(0, np.uint32), len(page_ends)
    keys, rows_of = _row_keys(rows)
    lo, hi = int(keys.min()), int(keys.max())
    if hi - lo < _RANGE_TABLE_MAX:
        base, rel = None, keys - lo
    else:
        base, rel = np.unique(keys, return_inverse=True)
        rel = rel.reshape(-1)
    seen = np.zeros(int(rel.max()) + 1, np.bool_)
    count, start, pages = 0, 0, len(page_ends)
    for p, end in enumerate(page_ends):
        new = np.unique(rel[start:end][~seen[rel[start:end]]])
        seen[new] = True
        count += len(new)
        start = end
        if count * width >= limit:
            pages = p + 1
            break
    held = np.flatnonzero(seen)
    code_of = (np.cumsum(seen, dtype=np.int64) - 1).astype(np.uint32)
    dict_keys = held + lo if base is None else base[held]
    return rows_of(dict_keys), code_of[rel[:start]], pages


@dataclass
class _Options:
    """The writer's settings, resolved for one column."""

    codec: int
    level: Optional[int]
    use_dictionary: bool
    dict_limit: int
    data_page_size: Optional[int]
    statistics: bool
    bloom: bool


class _Pages:
    """Writes a chunk's pages, each header and body an encrypted frame
    when the chunk has a crypto context, and keeps their locations and
    sizes."""

    def __init__(self, sink: BinaryIO, crypto):
        self.sink = sink
        self.crypto = crypto
        self.locations: List[fmt.PageLocation] = []
        self.unc = self.comp = 0
        self.ordinal = 0           # data pages written

    def write(self, hdr: fmt.PageHeader, body, uncompressed: int,
              first_row: Optional[int] = None) -> int:
        """Writes one page (a dictionary page when first_row is None);
        returns its offset."""
        c = self.crypto
        data_page = first_row is not None
        if c is not None:
            body = encm.encrypt_module(
                c.key, c.aad(encm.DATA_PAGE_MODULE if data_page
                             else encm.DICT_PAGE_MODULE, self.ordinal),
                body, c.gcm_pages)
            hdr.compressed_page_size = len(body)
        hb = _thrift_bytes(hdr)
        if c is not None:
            hb = encm.encrypt_module(
                c.key, c.aad(encm.DATA_PAGE_HEADER_MODULE if data_page
                             else encm.DICT_PAGE_HEADER_MODULE,
                             self.ordinal), hb)
        off = self.sink.tell()
        self.sink.write(hb)
        self.sink.write(body)
        self.unc += len(hb) + uncompressed
        self.comp += len(hb) + len(body)
        if data_page:
            self.locations.append(fmt.PageLocation(
                offset=off, compressed_page_size=len(hb) + len(body),
                first_row_index=first_row))
            self.ordinal += 1
        return off


def _write_chunk(sink: BinaryIO, vals: np.ndarray,
                 mask: Optional[np.ndarray], desc: psch.ColumnDescriptor,
                 opts: _Options, encoding: Optional[fmt.Encoding] = None,
                 dictionary: Optional[np.ndarray] = None, crypto=None,
                 fpp: float = BLOOM_FPP, v2: bool = False):
    """One column chunk, its bloom filter (None unless asked for, at a
    false-positive rate of `fpp`) and its page locations, in DATA_PAGE_V2
    pages when `v2`. A string column arrives as int32 codes into
    `dictionary`; `crypto` (an encryption._ColumnCryptoContext) encrypts
    its pages."""
    codec, use_dictionary, dict_limit = (opts.codec, opts.use_dictionary,
                                         opts.dict_limit)
    data_page_size = opts.data_page_size
    num_values = len(vals)
    nullable = desc.max_def_level > 0
    present = vals if mask is None else vals[mask]
    phys = desc.physical_type
    coded = None
    dict_pages = None          # leading dictionary-coded pages (all)
    fixed = phys == fmt.Type.FIXED_LEN_BYTE_ARRAY
    if fixed or phys == fmt.Type.INT96:
        rows_per_page = num_values if not data_page_size else max(8, int(
            data_page_size / (vals.shape[1] + nullable / 8)))
        starts = range(0, max(num_values, 1), max(rows_per_page, 1))
        page_ends = [min(a + rows_per_page, num_values) for a in starts]
        if mask is not None:
            before = np.concatenate(([0], np.cumsum(mask, dtype=np.int64)))
            page_ends = [int(before[e]) for e in page_ends]
        if fixed and use_dictionary and encoding in (None,
                                                     fmt.Encoding.PLAIN):
            keys, codes, dict_pages = _fixed_dictionary(
                np.ascontiguousarray(present), page_ends, dict_limit)
            coded = keys, codes
    elif dictionary is not None:
        page_values = _string_bytes(dictionary, desc.arrow_type)
        codes = present         # the statistics read the codes
        if use_dictionary and encoding in (None, fmt.Encoding.PLAIN) and \
                sum(map(len, page_values)) + 4 * len(page_values) <= \
                dict_limit:
            coded = page_values, present.astype(np.uint32)
        else:
            present = [page_values[c] for c in present.tolist()]
    elif use_dictionary and encoding in (None, fmt.Encoding.PLAIN) and \
            phys != fmt.Type.BOOLEAN:
        coded = _dictionary(np.ascontiguousarray(present), dict_limit)
    values, entries = (codes, page_values) if dictionary is not None else \
        (present, None)
    stats = _statistics(phys, values, num_values - len(values), entries) \
        if opts.statistics else None
    bloom = _bloom(phys, values, entries, fpp) if opts.bloom else None
    start_offset = sink.tell()
    pages = _Pages(sink, crypto)
    dict_page_offset = None
    plain_encoding = encoding or fmt.Encoding.PLAIN
    if coded is not None:
        keys, codes = coded
        width = max(enc.bit_width_for(len(keys) - 1), 1)
        page = enc.plain_encode(phys, keys)
        body = comp.compress(codec, page, opts.level)
        dict_page_offset = pages.write(fmt.PageHeader(
            type=int(fmt.PageType.DICTIONARY_PAGE),
            uncompressed_page_size=len(page),
            compressed_page_size=len(body),
            dictionary_page_header=fmt.DictionaryPageHeader(
                num_values=len(keys), encoding=int(fmt.Encoding.PLAIN))),
            body, len(page))
        # v1 data pages say PLAIN_DICTIONARY, as the JAX writer's do
        value_encoding = fmt.Encoding.RLE_DICTIONARY if v2 else \
            fmt.Encoding.PLAIN_DICTIONARY
        row_bytes = width / 8
    else:
        value_encoding = encoding or fmt.Encoding.PLAIN
        if phys == fmt.Type.BYTE_ARRAY:
            row_bytes = 4 + sum(map(len, present)) / max(len(present), 1)
        else:
            row_bytes = vals.dtype.itemsize if phys != fmt.Type.BOOLEAN \
                else 1 / 8
    if nullable:
        row_bytes += 1 / 8
    if not (fixed or phys == fmt.Type.INT96):
        rows_per_page = num_values if not data_page_size else max(
            8, int(data_page_size / row_bytes))
    present_before = None if mask is None else np.concatenate(
        ([0], np.cumsum(mask, dtype=np.int64)))

    data_page_offset = None
    page_encodings = set()
    for page, start in enumerate(range(0, max(num_values, 1),
                                       max(rows_per_page, 1))):
        end = min(start + rows_per_page, num_values)
        p0, p1 = (start, end) if mask is None else (
            int(present_before[start]), int(present_before[end]))
        levels = enc.levels_encode_v1(mask[start:end].astype(np.uint32), 1) \
            if nullable else b""
        page_dict = coded is not None and (dict_pages is None
                                           or page < dict_pages)
        if not page_dict:
            value_encoding = plain_encoding
        page_encodings.add(int(value_encoding))
        if page_dict:
            data = bytes([width]) + enc.rle_encode(codes[p0:p1], width)
        elif value_encoding == fmt.Encoding.DELTA_BINARY_PACKED:
            data = enc.delta_binary_packed_encode(present[p0:p1])
        elif value_encoding == fmt.Encoding.DELTA_LENGTH_BYTE_ARRAY:
            data = enc.delta_length_byte_array_encode(present[p0:p1])
        elif value_encoding == fmt.Encoding.DELTA_BYTE_ARRAY:
            data = enc.delta_byte_array_encode(present[p0:p1])
        elif value_encoding == fmt.Encoding.BYTE_STREAM_SPLIT:
            part = np.ascontiguousarray(present[p0:p1])
            data = enc.byte_stream_split_encode(
                part if fixed else part.view(np.uint8).reshape(
                    len(part), part.dtype.itemsize))
        else:
            data = enc.plain_encode(phys, present[p0:p1])
        if v2:
            defs = enc.rle_encode(mask[start:end].astype(np.uint32), 1) \
                if nullable else b""
            hdr, body, unc = _v2_page(
                codec, opts.level, b"", defs, data, end - start,
                end - start - (p1 - p0), end - start, value_encoding,
                stats if rows_per_page >= num_values else None)
        else:
            payload = levels + data
            body, unc = comp.compress(codec, payload, opts.level), \
                len(payload)
            hdr = fmt.PageHeader(
                type=int(fmt.PageType.DATA_PAGE),
                uncompressed_page_size=unc, compressed_page_size=len(body),
                data_page_header=fmt.DataPageHeader(
                    num_values=end - start, encoding=int(value_encoding),
                    definition_level_encoding=int(fmt.Encoding.RLE),
                    repetition_level_encoding=int(fmt.Encoding.RLE)))
        off = pages.write(hdr, body, unc, start)
        if data_page_offset is None:
            data_page_offset = off

    if v2:
        # the JAX writer's list: RLE, PLAIN with a dictionary page, and
        # the data pages' encodings
        encodings = {int(fmt.Encoding.RLE)} | page_encodings
        if coded is not None:
            encodings.add(int(fmt.Encoding.PLAIN))
    else:
        encodings = {int(fmt.Encoding.PLAIN)} | page_encodings
        if nullable:
            encodings.add(int(fmt.Encoding.RLE))
    meta = fmt.ColumnMetaData(
        type=int(phys), encodings=sorted(encodings),
        path_in_schema=list(desc.path), codec=int(codec),
        num_values=num_values, total_uncompressed_size=pages.unc,
        total_compressed_size=pages.comp, data_page_offset=data_page_offset,
        dictionary_page_offset=dict_page_offset, statistics=stats)
    return fmt.ColumnChunk(file_offset=start_offset, meta_data=meta), \
        bloom, pages.locations


_ENCODING_NAMES = {
    "plain": fmt.Encoding.PLAIN,
    "delta_binary_packed": fmt.Encoding.DELTA_BINARY_PACKED,
    "delta_length_byte_array": fmt.Encoding.DELTA_LENGTH_BYTE_ARRAY,
    "delta_byte_array": fmt.Encoding.DELTA_BYTE_ARRAY,
    "byte_stream_split": fmt.Encoding.BYTE_STREAM_SPLIT}
# the physical types each encoding but PLAIN takes (JAX writer.py:126-152)
_ENCODING_TYPES = {
    fmt.Encoding.DELTA_BINARY_PACKED: {fmt.Type.INT32, fmt.Type.INT64},
    fmt.Encoding.DELTA_LENGTH_BYTE_ARRAY: {fmt.Type.BYTE_ARRAY},
    fmt.Encoding.DELTA_BYTE_ARRAY: {fmt.Type.BYTE_ARRAY,
                                    fmt.Type.FIXED_LEN_BYTE_ARRAY},
    fmt.Encoding.BYTE_STREAM_SPLIT: {fmt.Type.FLOAT, fmt.Type.DOUBLE,
                                     fmt.Type.INT32, fmt.Type.INT64,
                                     fmt.Type.FIXED_LEN_BYTE_ARRAY}}
_STAT_PACK = {fmt.Type.INT32: "<i", fmt.Type.INT64: "<q",
              fmt.Type.FLOAT: "<f", fmt.Type.DOUBLE: "<d"}
MAX_STAT_BYTES = 64    # the JAX writer's bound on byte-string statistics


def _row_extreme(rows: np.ndarray, largest: bool) -> bytes:
    """The lexicographically least (or largest) row of an (n, w) byte
    matrix, narrowing the candidates big-endian word by word (the rows
    zero-padded to whole words when w is not a multiple of 8)."""
    n, w = rows.shape
    if w % 8:
        rows = np.concatenate([rows, np.zeros((n, -w % 8), np.uint8)], 1)
    words = np.ascontiguousarray(rows).view(">u8")
    cand = None
    for j in range(words.shape[1]):
        col = words[:, j] if cand is None else words[cand, j]
        best = col.max() if largest else col.min()
        hit = np.flatnonzero(col == best)
        cand = hit if cand is None else cand[hit]
    return rows[cand[0], :w].tobytes()


def _used(codes: np.ndarray, page_values: list) -> list:
    """The dictionary entries that `codes` name, in entry order."""
    return np.flatnonzero(np.bincount(codes, minlength=len(page_values))
                          ).tolist()


def _statistics(phys: fmt.Type, present, null_count: int,
                page_values: Optional[list]) -> fmt.Statistics:
    """A chunk's statistics as the JAX writer's _stats_for makes them:
    the null count, and min_value / max_value of the present values
    (ints and floats by value as their physical type, booleans as one
    byte, byte strings by their bytes, and those only when the first
    present value is under 64 bytes; none for INT96). A string column's
    present values are codes into `page_values`."""
    st = fmt.Statistics(null_count=int(null_count))
    if not len(present):
        return st
    if page_values is not None:
        if len(page_values[int(present[0])]) >= MAX_STAT_BYTES:
            return st
        vs = [page_values[c] for c in _used(present, page_values)]
        st.min_value, st.max_value = min(vs), max(vs)
    elif phys == fmt.Type.BOOLEAN:
        st.min_value = b"\x01" if present.min() else b"\x00"
        st.max_value = b"\x01" if present.max() else b"\x00"
    elif phys in _STAT_PACK:
        st.min_value = struct.pack(_STAT_PACK[phys], present.min())
        st.max_value = struct.pack(_STAT_PACK[phys], present.max())
    elif phys == fmt.Type.FIXED_LEN_BYTE_ARRAY and \
            present.shape[1] < MAX_STAT_BYTES:
        st.min_value = _row_extreme(present, False)
        st.max_value = _row_extreme(present, True)
    return st


def _v2_page(codec, level, reps: bytes, defs: bytes, data: bytes,
             num_values: int, num_nulls: int, num_rows: int, encoding,
             stats) -> tuple:
    """(header, body, uncompressed size) of a DATA_PAGE_V2: the level
    runs uncompressed (their byte lengths in the header), then the
    compressed values (JAX writer.py:319-350)."""
    body = reps + defs + comp.compress(codec, data, level)
    return fmt.PageHeader(
        type=int(fmt.PageType.DATA_PAGE_V2),
        uncompressed_page_size=len(reps) + len(defs) + len(data),
        compressed_page_size=len(body),
        data_page_header_v2=fmt.DataPageHeaderV2(
            num_values=num_values, num_nulls=num_nulls, num_rows=num_rows,
            encoding=int(encoding), definition_levels_byte_length=len(defs),
            repetition_levels_byte_length=len(reps),
            is_compressed=bool(codec), statistics=stats)), body, \
        len(reps) + len(defs) + len(data)


def _bloom(phys: fmt.Type, present, page_values: Optional[list],
           fpp: float = BLOOM_FPP):
    """The bloom filter of a chunk's present values, sized for their
    distinct count at a false-positive rate of `fpp` (None for BOOLEAN
    and INT96, as in the JAX writer)."""
    if phys in (fmt.Type.BOOLEAN, fmt.Type.INT96):
        return None
    if page_values is not None:
        rows = [page_values[c] for c in _used(present, page_values)]
    elif phys == fmt.Type.FIXED_LEN_BYTE_ARRAY:
        uniq = np.unique(np.ascontiguousarray(present).view(
            np.dtype((np.void, present.shape[1]))).reshape(-1))
        rows = [bytes(r) for r in uniq]
    else:
        item = present.dtype.itemsize
        uniq = np.unique(np.ascontiguousarray(present).view(f"i{item}"))
        return bloom_mod._build_from_hashes(bloom_mod.hash_values(
            uniq.view(present.dtype), phys), len(uniq), fpp)
    return bloom_mod._build_from_hashes(bloom_mod.hash_values(
        enc._ends_data(rows), phys), len(rows), fpp)


def _big_endian(limbs: np.ndarray, width: int) -> np.ndarray:
    """(n, k) little-endian int64 limbs -> (n, width) big-endian
    two's-complement bytes (the low `width` bytes)."""
    le = np.ascontiguousarray(limbs).view(np.uint8).reshape(len(limbs), -1)
    return np.ascontiguousarray(le[:, :width][:, ::-1])


def _int96(ns: np.ndarray) -> np.ndarray:
    """int64 ns since the epoch -> (n, 12) INT96 rows: nanoseconds of the
    day (int64), then the Julian day (int32), little-endian."""
    day, nanos = np.divmod(ns, 86_400 * 10**9)
    out = np.empty((len(ns), 12), np.uint8)
    out[:, :8] = nanos.astype("<i8").view(np.uint8).reshape(-1, 8)
    out[:, 8:] = (day + 2440588).astype("<i4").view(np.uint8).reshape(-1, 4)
    return out


def _fixed_values(name: str, v: np.ndarray, t: dt.DataType,
                  phys: fmt.Type) -> np.ndarray:
    """Physical values of a decimal, float16, fixed_size_binary or INT96
    timestamp column: an (n, width) byte matrix on FIXED_LEN_BYTE_ARRAY
    or INT96, unscaled INT32 / INT64 values otherwise. A decimal128 /
    decimal256 column comes as its (n, k) limbs or as 1-D ints."""
    if t.is_decimal:
        low = (v if v.ndim == 1 else v.view(np.int64)[:, 0]).astype(np.int64)
        if phys != fmt.Type.FIXED_LEN_BYTE_ARRAY:
            return low.astype(np.int32 if phys == fmt.Type.INT32
                              else np.int64)
        if v.ndim == 1:               # unscaled ints, sign-extended
            v = np.repeat((low >> 63)[:, None], t.limbs, axis=1)
            v[:, 0] = low
        return _big_endian(v.view(np.int64), t.bit_width // 8)
    if phys == fmt.Type.INT96:
        ns = v.astype(np.int64) * (10**9 // t.unit.multiplier)
        return _int96(ns)
    if t == dt.float16:
        return np.ascontiguousarray(v.astype("<f2")).view(np.uint8).reshape(
            -1, 2)
    if v.ndim != 2 or v.dtype != np.uint8 or v.shape[1] != t.byte_width:
        raise ArrowInvalid(f"column {name!r}: a {t} column takes an "
                           f"(n, {t.byte_width}) uint8 matrix")
    return v


def _string_type(dictionary: np.ndarray, t: Optional[dt.DataType]
                 ) -> dt.DataType:
    """A string column's type: `t` when it names a binary-like type
    (large_string, say), else string or binary by its values."""
    return t if t is not None and t.is_binary_like else \
        dictionary_type(dictionary)


def _host_column(v: HostArray, mask):
    """A flat HostArray as write_table's (values or (codes, values),
    mask, type); an extension column as its storage, a dictionary of
    numbers as its values (the JAX writer writes the value type)."""
    if mask is not None:
        raise ArrowInvalid("a HostArray column carries its validity")
    if v.type.id == dt.TypeId.EXTENSION:
        v = v.storage
    if v.dict_values is None:
        return v.values, v.mask, v.type
    vt = v.type.value_type if v.type.id == dt.TypeId.DICTIONARY else v.type
    if vt.id == dt.TypeId.FIXED_SIZE_BINARY:     # its (n, width) bytes
        table = np.frombuffer(b"".join(v.dict_values), np.uint8).reshape(
            -1, vt.byte_width)
        rows = table[np.clip(v.values, 0, None)] if len(table) else \
            np.zeros((len(v), vt.byte_width), np.uint8)
        return rows, v.mask, vt
    if not vt.is_binary_like:       # a dictionary of numbers: its values
        table = np.asarray(v.dict_values)
        if not len(table):
            return np.zeros(len(v), vt.np_dtype), v.mask, vt
        return table[np.clip(v.values, 0, len(table) - 1)], v.mask, vt
    return (v.values, v.dict_values), v.mask, vt


def _prepare(name: str, v, mask: Optional[np.ndarray],
             t: Optional[dt.DataType], phys: Optional[fmt.Type] = None):
    """(type, physical values or codes, dictionary or None) of one input
    column: a string or bytes column becomes int32 codes + its
    dictionary; a column of type `t` (its numpy dtype's when None) its
    physical values (`phys`, its physical type, when t is given)."""
    if isinstance(v, tuple):
        codes, dictionary = np.asarray(v[0], np.int32), np.asarray(
            v[1], dtype=object)
        live = codes if mask is None else codes[mask]
        if len(live) and (live.min() < 0 or live.max() >= len(dictionary)):
            raise ArrowInvalid(f"column {name!r}: codes outside the "
                               f"dictionary")
        return _string_type(dictionary, t), codes, dictionary
    v = np.asarray(v)
    if v.dtype.kind in "USO":
        codes, dictionary = factorize(v, mask)
        return _string_type(dictionary, t), codes, dictionary
    t = t or dt.from_numpy_dtype(v.dtype)
    if t.is_binary_like or v.dtype.kind not in "biuf":
        raise ArrowInvalid(f"column {name!r}: {v.dtype} values for {t}")
    if t.is_decimal or phys in (fmt.Type.FIXED_LEN_BYTE_ARRAY,
                                fmt.Type.INT96):
        return t, _fixed_values(name, v, t, phys), None
    vals = v.astype(t.np_dtype, copy=False)
    phys = psch.physical_np_dtype(t)
    if t.is_unsigned_integer and t.bit_width == phys.itemsize * 8:
        return t, vals.view(phys), None
    return t, vals.astype(phys, copy=False), None


class SortingColumn:
    """Declared sort order of a row group's rows (JAX writer.py:401;
    reference parquet.SortingColumn, WithSortingColumns). column_idx
    indexes the leaf columns."""

    def __init__(self, column_idx: int, descending: bool = False,
                 nulls_first: bool = False):
        self.column_idx = column_idx
        self.descending = descending
        self.nulls_first = nulls_first


class WriterProperties:
    """The writer's whole option set (JAX writer.py:413-485; reference
    parquet/writer_properties.go), with the JAX defaults but for
    `created_by`, which names the port. Per-column overrides live in
    ``column_properties``: ``{"col": {"compression": "zstd",
    "compression_level": 9, "use_dictionary": False, "encoding":
    "delta_binary_packed", "write_statistics": False, "bloom": True}}``.
    """

    def __init__(self, *,
                 version: str = "2.6",
                 data_page_version: str = "1.0",
                 created_by: str = CREATED_BY,
                 compression: str = "snappy",
                 compression_level: Optional[int] = None,
                 use_dictionary: bool = True,
                 dictionary_pagesize_limit: int = 1 << 20,
                 data_page_size: Optional[int] = None,
                 max_row_group_length: Optional[int] = None,
                 write_statistics: bool = True,
                 write_page_index: bool = True,
                 write_bloom_filters: bool = False,
                 bloom_filter_fpp: float = BLOOM_FPP,
                 sorting_columns: Optional[List[SortingColumn]] = None,
                 store_decimal_as_integer: bool = False,
                 column_properties: Optional[dict] = None,
                 encryption: Optional[encm.FileEncryptionProperties] = None):
        if version not in ("1.0", "2.4", "2.6"):
            raise ArrowInvalid(f"parquet format version {version!r}")
        if data_page_version not in ("1.0", "2.0"):
            raise ArrowInvalid(f"data page version {data_page_version!r}")
        self.version = version
        self.data_page_version = data_page_version
        self.created_by = created_by
        self.compression = compression
        self.compression_level = compression_level
        self.use_dictionary = use_dictionary
        self.dictionary_pagesize_limit = dictionary_pagesize_limit
        self.data_page_size = data_page_size
        self.max_row_group_length = max_row_group_length
        self.write_statistics = write_statistics
        self.page_index = write_page_index
        self.bloom = write_bloom_filters
        self.bloom_filter_fpp = bloom_filter_fpp
        self.sorting_columns = sorting_columns
        self.store_decimal_as_integer = store_decimal_as_integer
        self.per_column = column_properties or {}
        self.encryption = encryption

    def _col(self, name: str, key: str, default):
        return self.per_column.get(name, {}).get(key, default)

    def codec_for(self, name: str) -> int:
        return int(comp.codec_for_name(
            self._col(name, "compression", self.compression)))

    def level_for(self, name: str) -> Optional[int]:
        return self._col(name, "compression_level", self.compression_level)

    def dict_for(self, name: str) -> bool:
        return self._col(name, "use_dictionary", self.use_dictionary)

    def encoding_for(self, name: str) -> Optional[str]:
        return self._col(name, "encoding", None)

    def stats_for(self, name: str) -> bool:
        return self._col(name, "write_statistics", self.write_statistics)

    def bloom_for(self, name: str) -> bool:
        return self._col(name, "bloom", self.bloom)


def _keyword_properties(names, compression, use_dictionary,
                        dictionary_pagesize_limit, data_page_size,
                        column_properties, column_encodings,
                        store_decimal_as_integer, compression_level,
                        write_statistics, write_bloom_filters,
                        write_page_index, encryption) -> WriterProperties:
    """write_table's keywords as WriterProperties: `column_properties`,
    and over them the by-name forms of use_dictionary, column_encodings
    and write_bloom_filters (of the columns `names`), become column
    properties."""
    per: Dict[str, dict] = {name: dict(props) for name, props in
                            (column_properties or {}).items()}
    for name, e in (column_encodings or {}).items():
        per.setdefault(name, {})["encoding"] = e
    if isinstance(use_dictionary, dict):
        for name, u in use_dictionary.items():
            per.setdefault(name, {})["use_dictionary"] = u
        use_dictionary = True
    if not isinstance(write_bloom_filters, bool):
        named = set(write_bloom_filters)
        for name in names:
            per.setdefault(name, {})["bloom"] = name in named
        write_bloom_filters = True
    return WriterProperties(
        compression=compression, compression_level=compression_level,
        use_dictionary=bool(use_dictionary),
        dictionary_pagesize_limit=dictionary_pagesize_limit,
        data_page_size=data_page_size, write_statistics=write_statistics,
        write_page_index=write_page_index,
        write_bloom_filters=write_bloom_filters,
        store_decimal_as_integer=store_decimal_as_integer,
        column_properties=per, encryption=encryption)


def _batch_columns(hb: HostBatch) -> Dict[str, HostArray]:
    """A HostBatch as write_table's columns: a nullable flat field
    without a mask gets an all-valid one, so the file keeps the field
    OPTIONAL as the JAX writer writes it."""
    data = {}
    for f, c in zip(hb.schema.fields, hb.columns):
        if f.nullable and c.mask is None and c.values is not None:
            c = HostArray(c.values, np.ones(len(c), np.bool_), c.type,
                          c.dict_values)
        data[f.name] = c
    return data


def write_table(table: Union[HostBatch, Dict[str, object]], sink,
                row_group_size: Optional[int] = None,
                compression: str = "snappy",
                use_dictionary: Union[bool, Dict[str, bool]] = True,
                write_page_index: bool = True,
                write_bloom_filters: Union[bool, Sequence[str]] = False,
                data_page_size: Optional[int] = None,
                column_properties: Optional[Dict[str, dict]] = None,
                encryption: Optional[encm.FileEncryptionProperties] = None,
                properties: Optional[WriterProperties] = None, *,
                masks: Optional[Dict[str, np.ndarray]] = None,
                dictionary_pagesize_limit: int = 1 << 20,
                column_encodings: Optional[Dict[str, str]] = None,
                types: Optional[Dict[str, dt.DataType]] = None,
                store_decimal_as_integer: bool = False,
                int96_timestamps: bool = False,
                compression_level: Optional[int] = None,
                write_statistics: bool = True) -> None:
    """Write columns (all of one length) to a parquet file. The
    parameters up to `properties` are the JAX writer's, by name and in
    its order; the port's own keywords follow them.

    table: a HostBatch, a Table or a RecordBatch (the schema's
           key/value metadata goes into the footer; `_batch_columns`
           says how its fields are written), or numpy arrays by name;
           a string (or bytes) column is a numpy str/object array or an
           (int32 codes, values) pair.
           A HostArray goes as its values, codes and validity (a flat
           one) or through parquet/levels.py (a nested one); an
           extension column as its storage, as the JAX writer writes it.
    properties: a WriterProperties; it wins over the keywords from
           `compression` to `encryption` (as in the JAX writer), and
           brings the format version, created_by, data page v2, the
           column properties, the bloom filters' fpp and the sorting
           columns. Without it the keywords below apply.
    masks: validity by column name (True = valid); a column with a mask
           is written OPTIONAL, one without it REQUIRED.
    compression: "none", "snappy", "gzip", "lz4_raw" or "zstd", at
           `compression_level` (gzip's and zstd's; None = the codec's
           default, zstd 3).
    use_dictionary: for every column, or by column name (True for the
           columns not named).
    column_properties: per-column overrides by column name, as
           WriterProperties takes them ({"col": {"compression": "zstd",
           "use_dictionary": False, "encoding": "delta_binary_packed",
           ...}}); the by-name forms of use_dictionary, column_encodings
           and write_bloom_filters override them.
    column_encodings: a value encoding by column name, each but "plain"
           with no dictionary: "plain", "delta_binary_packed"
           (INT32/INT64 columns), "delta_length_byte_array" (string and
           binary columns), "delta_byte_array" (string, binary and
           FIXED_LEN_BYTE_ARRAY columns) or "byte_stream_split" (FLOAT,
           DOUBLE, INT32, INT64 and FIXED_LEN_BYTE_ARRAY columns); an
           encoding the column's physical type does not take raises
           ArrowInvalid.
    write_statistics: each chunk's null count, min and max (the JAX
           writer's rules: byte strings only when the first present
           value is under 64 bytes, nothing for INT96).
    write_bloom_filters: a split-block bloom filter per chunk (not for
           BOOLEAN or INT96) of every column, or of the named columns,
           sized for the chunk's distinct values at a false-positive
           rate of 1%, written after the row groups.
    types: a column's type by name, where its numpy dtype's is not the
           one (date32 for int32 days, uint32, timestamp("ms", "UTC"),
           decimal128(15, 2) for unscaled ints or (n, 2) limbs,
           fixed_size_binary(12) for an (n, 12) uint8 matrix).
    store_decimal_as_integer: a decimal of precision <= 18 as INT32 /
           INT64 (read back as decimal32 / decimal64).
    int96_timestamps: timestamp columns as INT96.
    write_page_index: each chunk's ColumnIndex and OffsetIndex.
    encryption: parquet modular encryption of the file (module doc).
    sink:  a path or a binary file object.
    """
    data = host_batch(table)
    metadata = None
    if isinstance(data, HostBatch):
        metadata = data.schema.metadata
        data = _batch_columns(data)
    p = properties or _keyword_properties(
        list(data), compression, use_dictionary, dictionary_pagesize_limit,
        data_page_size, column_properties, column_encodings,
        store_decimal_as_integer, compression_level, write_statistics,
        write_bloom_filters, write_page_index, encryption)
    store_decimal_as_integer = p.store_decimal_as_integer
    comp.codec_for_name(p.compression)          # an unknown codec raises
    masks = dict(masks or {})
    types = types or {}
    names = list(data)
    encs = {}
    for name in names:
        e = p.encoding_for(name)
        if e is None:
            continue
        if e.lower() not in _ENCODING_NAMES:
            raise ArrowInvalid(f"unknown encoding {e!r}")
        encs[name] = _ENCODING_NAMES[e.lower()]
    fields, cols = [], {}
    n = None
    for name in names:
        m = masks.get(name)
        v = data[name]
        ft = v.type if isinstance(v, HostArray) else None
        if isinstance(v, HostArray) and v.type.id == dt.TypeId.EXTENSION \
                and v.storage.type.is_nested:
            v = v.storage
        if isinstance(v, HostArray) and v.type.is_nested:
            n = len(v) if n is None else n
            if len(v) != n or m is not None:
                raise ArrowInvalid(f"column {name!r}: expected length {n} "
                                   f"and no mask (a nested column carries "
                                   f"its validity)")
            fields.append(dt.Field(name, ft, True))
            cols[name] = (v, None)
            continue
        t = types.get(name)
        if isinstance(v, HostArray):
            v, m, t = _host_column(v, m)
            if m is not None:
                masks[name] = m
        phys = None
        if t is not None and not t.is_binary_like:
            phys = fmt.Type.INT96 if int96_timestamps and \
                t.id == dt.TypeId.TIMESTAMP else psch.physical_for(
                    t, store_decimal_as_integer)[0]
        t, v, dictionary = _prepare(name, v, m, t, phys)
        n = len(v) if n is None else n
        if v.ndim != (2 if phys in (fmt.Type.FIXED_LEN_BYTE_ARRAY,
                                    fmt.Type.INT96) else 1) or len(v) != n:
            raise ArrowInvalid(f"column {name!r}: expected length {n}")
        if m is not None and (len(m) != n or np.asarray(m).dtype != np.bool_):
            raise ArrowInvalid(f"mask of {name!r}: expected bool[{n}]")
        e = encs.get(name, fmt.Encoding.PLAIN)
        if e != fmt.Encoding.PLAIN:
            ptype = fmt.Type.BYTE_ARRAY if dictionary is not None else \
                phys if phys is not None else psch.physical_for(t)[0]
            if ptype not in _ENCODING_TYPES[e]:
                takes = sorted(x.name for x in _ENCODING_TYPES[e])
                raise ArrowInvalid(f"column {name!r}: {e.name} takes "
                                   f"{takes}, not {ptype.name}")
        fields.append(dt.Field(name, t, m is not None))
        cols[name] = (v, dictionary)
    n = n or 0
    schema = dt.Schema(fields)
    elements, leaves = psch.schema_to_elements(
        schema, store_decimal_as_integer, int96_timestamps)
    opts = {name: _Options(
        p.codec_for(name), p.level_for(name), bool(p.dict_for(name)),
        p.dictionary_pagesize_limit, p.data_page_size,
        bool(p.stats_for(name)), bool(p.bloom and p.bloom_for(name)))
        for name in names}
    args = (cols, masks, elements, leaves, n, opts,
            row_group_size or p.max_row_group_length, encs, p, metadata)
    if hasattr(sink, "write"):
        _write(sink, *args)
        return
    with open(sink, "wb") as f:
        _write(f, *args)


def _physical_leaf(leaf: HostArray, desc: psch.ColumnDescriptor):
    """A nested column's present leaf values as plain_encode takes them:
    a FIXED_LEN_BYTE_ARRAY or INT96 leaf as its (n, width) byte rows (a
    fixed_size_binary leaf's codes looked up in its dictionary), a
    decimal on INT32 / INT64 as its unscaled ints, as a flat column of
    the type is written."""
    t = desc.arrow_type
    ptype = desc.physical_type
    if t.is_decimal or ptype in (fmt.Type.FIXED_LEN_BYTE_ARRAY,
                                 fmt.Type.INT96) or (
            leaf.dict_values is not None and not t.is_binary_like):
        if leaf.dict_values is not None:
            return _host_column(leaf, None)[0]
        return _fixed_values(".".join(desc.path), leaf.values, t, ptype)
    if leaf.dict_values is not None:
        page_values = _string_bytes(leaf.dict_values, t)
        return [page_values[c] for c in leaf.values.tolist()]
    if t == dt.bool_:
        return leaf.values
    phys = psch.physical_np_dtype(t)
    vals = leaf.values
    if vals.dtype.itemsize == phys.itemsize:
        return vals.view(phys)
    return vals.astype(phys)


def _write_levels_chunk(sink: BinaryIO, arr: HostArray, field: dt.Field,
                        desc: psch.ColumnDescriptor, opts: _Options,
                        crypto=None, v2: bool = False):
    """One leaf chunk of a nested column: its levels and present values
    in one data page (v1, or v2 as the JAX writer writes a nested chunk
    under data_page_version "2.0"); returns the chunk and its page
    locations."""
    defs, reps, leaf = lv.generate_levels_nested(arr, field)
    mr, md = desc.max_rep_level, desc.max_def_level
    data = enc.plain_encode(desc.physical_type, _physical_leaf(leaf, desc))
    if v2:
        hdr, body, unc = _v2_page(
            opts.codec, opts.level,
            enc.rle_encode(reps, enc.bit_width_for(mr)) if mr else b"",
            enc.rle_encode(defs, enc.bit_width_for(md)) if md else b"",
            data, len(defs), int((defs != md).sum()) if md else 0,
            int((reps == 0).sum()) if mr else len(defs),
            fmt.Encoding.PLAIN, None)
    else:
        levels = b""
        if mr:
            levels += enc.levels_encode_v1(reps, enc.bit_width_for(mr))
        if md:
            levels += enc.levels_encode_v1(defs, enc.bit_width_for(md))
        payload = levels + data
        body, unc = comp.compress(opts.codec, payload, opts.level), \
            len(payload)
        hdr = fmt.PageHeader(
            type=int(fmt.PageType.DATA_PAGE), uncompressed_page_size=unc,
            compressed_page_size=len(body),
            data_page_header=fmt.DataPageHeader(
                num_values=len(defs), encoding=int(fmt.Encoding.PLAIN),
                definition_level_encoding=int(fmt.Encoding.RLE),
                repetition_level_encoding=int(fmt.Encoding.RLE)))
    pages = _Pages(sink, crypto)
    start = pages.write(hdr, body, unc, 0)
    meta = fmt.ColumnMetaData(
        type=int(desc.physical_type),
        encodings=[int(fmt.Encoding.PLAIN), int(fmt.Encoding.RLE)],
        path_in_schema=list(desc.path), codec=int(opts.codec),
        num_values=len(defs), total_uncompressed_size=pages.unc,
        total_compressed_size=pages.comp, data_page_offset=start)
    return fmt.ColumnChunk(file_offset=start, meta_data=meta), \
        pages.locations


def _write_nested(sink: BinaryIO, arr: HostArray, f: dt.Field, descs,
                  opts: _Options, cryptos, v2: bool) -> list:
    """(chunk, page locations) of each leaf of a nested column's rows."""
    if f.type.id == dt.TypeId.MAP:
        f, arr = lv.map_storage_field(f), lv.map_storage_data(arr)
    elif f.type.id == dt.TypeId.FIXED_SIZE_LIST:
        f, arr = lv.fsl_storage_field(f), lv.fsl_storage_data(arr)
    return [_write_levels_chunk(sink, *lv.prune_to_leaf(arr, f, path), desc,
                                opts, crypto, v2)
            for path, desc, crypto in zip(lv.leaf_paths(f.type), descs,
                                          cryptos)]


def _column_crypto(encryption, leaves, rg: int, li: int):
    """(crypto context or None for a plaintext chunk, column key metadata,
    whether the footer key encrypts it) of leaf li in row group rg."""
    if encryption is None:
        return None, None, None
    key, key_meta, uses_footer = encryption.column_setup(
        ".".join(leaves[li].path))
    if key is None:
        return None, None, None
    ctx = encm._ColumnCryptoContext(
        key, encryption.file_aad, rg, li,
        gcm_pages=encryption.algorithm == encm.AES_GCM_V1)
    return ctx, key_meta, uses_footer


def _populate_crypto_metadata(chunk: fmt.ColumnChunk, desc, ctx,
                              col_key_meta: bytes, uses_footer: bool,
                              encryption) -> None:
    """Set crypto_metadata / encrypted_column_metadata on one chunk
    (reference metadata/column_chunk.go PopulateCryptoData:433)."""
    if uses_footer:
        chunk.crypto_metadata = fmt.ColumnCryptoMetaData(
            ENCRYPTION_WITH_FOOTER_KEY=fmt.EncryptionWithFooterKey())
    else:
        chunk.crypto_metadata = fmt.ColumnCryptoMetaData(
            ENCRYPTION_WITH_COLUMN_KEY=fmt.EncryptionWithColumnKey(
                path_in_schema=list(desc.path), key_metadata=col_key_meta))
    encrypted_footer = not encryption.plaintext_footer
    if not encrypted_footer or not uses_footer:
        chunk.encrypted_column_metadata = encm.encrypt_module(
            ctx.key, ctx.aad(encm.COLUMN_META_MODULE),
            _thrift_bytes(chunk.meta_data))
        if encrypted_footer:
            chunk.meta_data = None
        else:
            # a plaintext footer keeps a redacted copy for old readers
            chunk.meta_data.statistics = None
            chunk.meta_data.encoding_stats = None


def _page_index(chunk: fmt.ColumnChunk, locations, ctx, module: int):
    """The thrift bytes of a chunk's ColumnIndex (one entry from its
    statistics) or OffsetIndex (its page locations), encrypted when the
    chunk is."""
    if module == encm.COLUMN_INDEX_MODULE:
        st = chunk.meta_data.statistics
        blob = _thrift_bytes(fmt.ColumnIndex(
            null_pages=[st is None or st.min_value is None],
            min_values=[st.min_value if st and st.min_value else b""],
            max_values=[st.max_value if st and st.max_value else b""],
            boundary_order=0,
            null_counts=[st.null_count if st and st.null_count is not None
                         else 0]))
    else:
        blob = _thrift_bytes(fmt.OffsetIndex(page_locations=locations))
    if ctx is not None:
        blob = encm.encrypt_module(ctx.key, ctx.aad(module), blob)
    return blob


def _write(sink, cols, masks, elements, leaves, n, opts, row_group_size,
           encs, props: Optional[WriterProperties] = None,
           metadata=None) -> None:
    props = props or WriterProperties(write_page_index=False)
    encryption = props.encryption
    v2 = props.data_page_version == "2.0"
    sorting = [fmt.SortingColumn(column_idx=sc.column_idx,
                                 descending=sc.descending,
                                 nulls_first=sc.nulls_first)
               for sc in props.sorting_columns or ()] or None
    encrypted_footer = encryption is not None and \
        not encryption.plaintext_footer
    sink.write(MAGIC_ENCRYPTED if encrypted_footer else MAGIC)
    rg_rows = row_group_size or max(n, 1)
    row_groups: List[fmt.RowGroup] = []
    written = []     # a chunk's (chunk, bloom, page locations, crypto, desc)
    for a in range(0, n, rg_rows):
        b = min(a + rg_rows, n)
        rg_start = sink.tell()
        cryptos = [_column_crypto(encryption, leaves, len(row_groups), li)
                   for li in range(len(leaves))]
        chunks = []
        for li, desc in enumerate(leaves):
            name = desc.path[0]
            v, dictionary = cols[name]
            if isinstance(v, HostArray):
                # a nested column's leaves are consecutive; all of them
                # are written at the first
                if li and leaves[li - 1].path[0] == name:
                    continue
                lis = [k for k, d in enumerate(leaves) if d.path[0] == name]
                for k, (chunk, locs) in zip(lis, _write_nested(
                        sink, v.slice(a, b - a), dt.Field(name, v.type, True),
                        [leaves[k] for k in lis], opts[name],
                        [cryptos[k][0] for k in lis], v2)):
                    chunks.append(chunk)
                    written.append((chunk, None, locs, cryptos[k], leaves[k]))
                continue
            m = masks.get(name)
            chunk, bloom, locs = _write_chunk(
                sink, v[a:b], None if m is None else np.asarray(m)[a:b],
                desc, opts[name], encs.get(name), dictionary, cryptos[li][0],
                props.bloom_filter_fpp, v2)
            chunks.append(chunk)
            written.append((chunk, bloom, locs, cryptos[li], desc))
        total = sum(c.meta_data.total_compressed_size for c in chunks)
        # the ordinal is required for encrypted files: module AADs embed
        # it and readers take it from this field, not the list position
        row_groups.append(fmt.RowGroup(
            columns=chunks, total_byte_size=total, num_rows=b - a,
            sorting_columns=sorting, file_offset=rg_start,
            total_compressed_size=total,
            ordinal=len(row_groups)))
    # the bloom filters after the row groups, then the page index, as the
    # JAX writer lays them out
    for chunk, bloom, _, (ctx, *_), _ in written:
        if bloom is None:
            continue
        if ctx is None:
            blob = bloom.serialize()
        else:
            hdr_b, bits_b = bloom.serialize_parts()
            blob = encm.encrypt_module(
                ctx.key, ctx.aad(encm.BLOOM_HEADER_MODULE), hdr_b) + \
                encm.encrypt_module(
                    ctx.key, ctx.aad(encm.BLOOM_BITSET_MODULE), bits_b)
        chunk.meta_data.bloom_filter_offset = sink.tell()
        chunk.meta_data.bloom_filter_length = len(blob)
        sink.write(blob)
    if props.page_index:
        for rg in range(len(row_groups)):
            here = written[rg * len(leaves):(rg + 1) * len(leaves)]
            for module, where in ((encm.COLUMN_INDEX_MODULE, "column_index"),
                                  (encm.OFFSET_INDEX_MODULE, "offset_index")):
                for chunk, _, locs, (ctx, *_), _ in here:
                    blob = _page_index(chunk, locs, ctx, module)
                    setattr(chunk, where + "_offset", sink.tell())
                    setattr(chunk, where + "_length", len(blob))
                    sink.write(blob)
    for chunk, _, _, (ctx, key_meta, uses_footer), desc in written:
        if ctx is not None:
            _populate_crypto_metadata(chunk, desc, ctx, key_meta,
                                      uses_footer, encryption)
    meta = fmt.FileMetaData(
        version=1 if props.version == "1.0" else 2, schema=elements,
        num_rows=n, row_groups=row_groups, created_by=props.created_by,
        column_orders=[fmt.ColumnOrder(TYPE_ORDER=fmt.TypeDefinedOrder())
                       for _ in leaves],
        key_value_metadata=[fmt.KeyValue(key=k, value=v) for k, v in zip(
            metadata.keys, metadata.values)] if metadata else None)
    if encrypted_footer:
        # [FileCryptoMetaData][encrypted FileMetaData][u32 combined
        # length]["PARE"] (reference file/file_writer.go closeEncryptedFile)
        fb = _thrift_bytes(fmt.FileCryptoMetaData(
            encryption_algorithm=encryption.algorithm_struct(),
            key_metadata=encryption.footer_key_metadata or None))
        ef = encm.encrypt_module(
            encryption.footer_key, encm.footer_aad(encryption.file_aad),
            _thrift_bytes(meta))
        sink.write(fb)
        sink.write(ef)
        sink.write(struct.pack("<I", len(fb) + len(ef)))
        sink.write(MAGIC_ENCRYPTED)
        return
    sig = b""
    if encryption is not None:
        # a plaintext footer, signed with the footer key
        meta.encryption_algorithm = encryption.algorithm_struct()
        meta.footer_signing_key_metadata = \
            encryption.footer_key_metadata or None
    mb = _thrift_bytes(meta)
    if encryption is not None:
        sig = encm.sign_footer(encryption.footer_key,
                               encm.footer_aad(encryption.file_aad), mb)
    sink.write(mb)
    sink.write(sig)
    sink.write(struct.pack("<I", len(mb) + len(sig)))
    sink.write(MAGIC)
