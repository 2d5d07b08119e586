"""Parquet file reader: the footer and schema, the read front
(`ParquetFile.read_table` / `read_row_group` / `read_rows` and the
module's `read_table`), modular encryption, the page index, and the
row-group pruning of the dataset scan by column statistics and bloom
filters (arrow_go_tpu/parquet/reader.py; reference
parquet/file/file_reader.go:51).

Flat values are not read on the host here: `device_read.read_batch_device`
reads the column chunks of a row group and decodes them on the device,
and the read front returns its batches as HostBatches
(`device_batch_to_host`), one read of a row group's chunks each. The
JAX reader's `use_threads` and `ReaderProperties.buffered_stream` /
`buffer_size` change how it stages its I/O, not what it reads: they are
accepted and change nothing here. A nested column (list, map, struct)
is read on the host, as the JAX reader reads it
(arrow_go_tpu/parquet/reader.py:_read_field): `read_field_host`
decodes each of its leaf chunks' repetition and definition levels (the
codec library's RLE walk) and present values (PLAIN, dictionary,
DELTA_BINARY_PACKED at every width, RLE booleans, BYTE_STREAM_SPLIT of
every physical type and the byte-array encodings, DELTA_BYTE_ARRAY on a
FIXED_LEN_BYTE_ARRAY leaf too), and parquet/levels.py rebuilds the
column. A FIXED_LEN_BYTE_ARRAY or INT96 leaf's rows take the values the
flat device route gives them (ops/decode.py on CPU tensors): decimal128
and decimal256 limbs, float16, fixed_size_binary codes over its distinct
rows, INT96 as timestamp[ns].

Encrypted files (encryption.py): the PARE magic (an encrypted footer,
decrypted with the footer key) or a plaintext footer that names an
encryption algorithm (its 28-byte signature verified when the footer
key is known and `check_plaintext_footer_integrity` is set). Each
encrypted chunk's key is resolved when the file opens and its
decrypted ColumnMetaData spliced in; a key that cannot be had is kept
and raised when that column is read, so the plaintext columns of a
partly encrypted file read with no keys. The pages, the bloom filters
and the page index decrypt as they are read.

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
from typing import BinaryIO, List, Optional, Tuple, Union

import numpy as np

from .. import dtypes as dt
from .. import native
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import ExtensionArray, HostArray, factorize
from . import compress as comp
from . import encodings as enc
from . import encryption as encm
from . import format as fmt
from . import levels as lv
from . import schema as psch
from .thrift import CompactReader

MAGIC = b"PAR1"
MAGIC_ENCRYPTED = b"PARE"

DEFAULT_BUF_SIZE = 4096  # reference parquet.DefaultBufSize


class ReaderProperties:
    """Reference parquet.ReaderProperties (reader_properties.go:37):
    `decryption` is used when ParquetFile is given none. `buffer_size`
    and `buffered_stream` stage the JAX reader's I/O; the port reads a
    chunk in one read whatever they say."""

    def __init__(self, buffer_size: int = DEFAULT_BUF_SIZE,
                 buffered_stream: bool = False,
                 decryption: Optional[encm.FileDecryptionProperties] = None):
        self.buffer_size = buffer_size
        self.buffered_stream = buffered_stream
        self.decryption = decryption


class ParquetFile:
    """Footer, schema and leaf columns of a parquet file, plus its source
    for the column-chunk reads, its keys (`decryption`, else
    `properties.decryption`) and the read front."""

    def __init__(self, source: Union[str, os.PathLike, BinaryIO, bytes],
                 decryption: Optional[encm.FileDecryptionProperties] = None,
                 properties: Optional[ReaderProperties] = None):
        self.properties = properties or ReaderProperties()
        if decryption is None:
            decryption = self.properties.decryption
        self._decryption = decryption
        self._file_aad = b""
        self._gcm_pages = True
        self._footer_key: Optional[bytes] = None
        self._col_crypto: dict = {}
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
            if self._file_aad:
                self._resolve_column_crypto()
        except BaseException:
            self.close()
            raise
        self.schema, self.leaves = psch.elements_to_schema(
            self.metadata.schema)
        kv = self.metadata.key_value_metadata or []
        if kv:      # the file's key/value metadata, as the JAX reader keeps
            self.schema = dt.Schema(self.schema.fields, dt.Metadata(
                keys=[e.key for e in kv], values=[e.value or "" for e in kv]))

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
        if head not in (MAGIC, MAGIC_ENCRYPTED) or \
                tail[4:] not in (MAGIC, MAGIC_ENCRYPTED):
            raise ArrowInvalid("bad parquet magic")
        (flen,) = struct.unpack("<I", tail[:4])
        if flen > size - 12:
            raise ArrowInvalid(f"footer length {flen} exceeds the file")
        src.seek(size - 8 - flen)
        footer = src.read(flen)
        if tail[4:] == MAGIC_ENCRYPTED:
            return self._decrypt_footer(footer)
        meta = CompactReader(footer).read_struct(fmt.FileMetaData)
        if meta.encryption_algorithm is not None:
            self._plaintext_footer_crypto(meta, footer)
        return meta

    # -- modular encryption (reference parquet/file/file_reader.go,
    #    internal/encryption/decryptor.go) --------------------------------

    def _algo_setup(self, algo: fmt.EncryptionAlgorithm) -> None:
        a = algo.AES_GCM_V1 or algo.AES_GCM_CTR_V1
        self._gcm_pages = algo.AES_GCM_V1 is not None
        prefix = a.aad_prefix or b""
        if a.supply_aad_prefix:
            if self._decryption is None or not self._decryption.aad_prefix:
                raise ArrowInvalid("file requires the caller to supply the "
                                   "AAD prefix")
            prefix = self._decryption.aad_prefix
        self._file_aad = bytes(prefix) + bytes(a.aad_file_unique or b"")

    def _decrypt_footer(self, blob: bytes) -> fmt.FileMetaData:
        if self._decryption is None:
            raise ArrowInvalid("encrypted-footer parquet file: pass "
                               "decryption=FileDecryptionProperties(...)")
        rd = CompactReader(blob)
        fcmd = rd.read_struct(fmt.FileCryptoMetaData)
        self._algo_setup(fcmd.encryption_algorithm)
        self._footer_key = self._decryption.footer_key_for(
            fcmd.key_metadata or b"")
        pt, _ = encm.decrypt_module(
            self._footer_key, encm.footer_aad(self._file_aad), blob, rd.pos)
        return CompactReader(pt).read_struct(fmt.FileMetaData)

    def _plaintext_footer_crypto(self, meta: fmt.FileMetaData,
                                 footer: bytes) -> None:
        """A plaintext footer of an encrypted file: its columns may be
        encrypted, and its last 28 bytes sign the bytes before them."""
        self._algo_setup(meta.encryption_algorithm)
        if self._decryption is None:
            return  # metadata and plaintext columns stay readable
        try:
            self._footer_key = self._decryption.footer_key_for(
                meta.footer_signing_key_metadata or b"")
        except ArrowInvalid:
            self._footer_key = None
        if (self._footer_key is not None
                and self._decryption.check_plaintext_footer_integrity):
            sig_len = encm.NONCE_LEN + encm.TAG_LEN
            plain, sig = footer[:-sig_len], footer[-sig_len:]
            if not encm.verify_footer_signature(
                    self._footer_key, encm.footer_aad(self._file_aad),
                    plain, sig):
                raise ArrowInvalid("plaintext footer signature verification "
                                   "failed")

    def _resolve_column_crypto(self) -> None:
        """{(rg, col) -> context, or the error its key gave}, with the
        decrypted column metadata spliced back into the chunks before any
        offset is read (reference metadata/column_chunk.go:95). The AAD
        takes the row group's ordinal, not its place in the list."""
        for rg_i, rg in enumerate(self.metadata.row_groups or []):
            rg_ord = rg.ordinal if rg.ordinal is not None else rg_i
            for li, chunk in enumerate(rg.columns or []):
                cm = chunk.crypto_metadata
                if cm is None:
                    continue
                # a missing key surfaces when its column is read, not
                # here: the plaintext columns of a partly encrypted file
                # read with no keys
                try:
                    if cm.ENCRYPTION_WITH_COLUMN_KEY is not None:
                        ck = cm.ENCRYPTION_WITH_COLUMN_KEY
                        if self._decryption is None:
                            raise ArrowInvalid(
                                "encrypted column without decryption "
                                "properties")
                        path = ".".join(ck.path_in_schema or [])
                        key = self._decryption.column_key_for(
                            path, ck.key_metadata or b"")
                    else:
                        if self._footer_key is None:
                            raise ArrowInvalid(
                                "column encrypted with footer key but no "
                                "footer key available")
                        key = self._footer_key
                except ArrowInvalid as e:
                    self._col_crypto[(rg_i, li)] = e
                    continue
                ctx = encm._ColumnCryptoContext(key, self._file_aad, rg_ord,
                                                li, self._gcm_pages)
                self._col_crypto[(rg_i, li)] = ctx
                if chunk.encrypted_column_metadata:
                    pt, _ = encm.decrypt_module(
                        key, ctx.aad(encm.COLUMN_META_MODULE),
                        chunk.encrypted_column_metadata)
                    chunk.meta_data = CompactReader(pt).read_struct(
                        fmt.ColumnMetaData)

    def column_crypto(self, rg: int, col: int):
        """The crypto context of leaf `col`'s chunk in row group `rg`, or
        None for a plaintext chunk; raises the error its key gave."""
        ctx = self._col_crypto.get((rg, col))
        if isinstance(ctx, Exception):
            raise ctx
        return ctx

    def _index_module(self, rg: int, col: int, offset, length, module: int):
        """The bytes of a page-index structure, decrypted when its column
        is encrypted (None when the chunk has none)."""
        if offset is None:
            return None
        ctx = self.column_crypto(rg, col)
        raw = self.read_range(offset, length)
        if ctx is not None:
            raw, _ = encm.decrypt_module(ctx.key, ctx.aad(module), raw)
        return raw

    def read_column_index(self, rg: int, col: int):
        """The ColumnIndex of leaf `col` in row group `rg`, or None."""
        chunk = self.metadata.row_groups[rg].columns[col]
        raw = self._index_module(rg, col, chunk.column_index_offset,
                                 chunk.column_index_length,
                                 encm.COLUMN_INDEX_MODULE)
        return None if raw is None else CompactReader(raw).read_struct(
            fmt.ColumnIndex)

    def read_offset_index(self, rg: int, col: int):
        """The OffsetIndex of leaf `col` in row group `rg`, or None."""
        chunk = self.metadata.row_groups[rg].columns[col]
        raw = self._index_module(rg, col, chunk.offset_index_offset,
                                 chunk.offset_index_length,
                                 encm.OFFSET_INDEX_MODULE)
        return None if raw is None else CompactReader(raw).read_struct(
            fmt.OffsetIndex)

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
        raw = self.read_range(meta.bloom_filter_offset,
                              meta.bloom_filter_length or (1 << 20))
        ctx = self.column_crypto(rg, col)
        if ctx is not None:     # two modules: the header, the bitset
            hdr, used = encm.decrypt_module(
                ctx.key, ctx.aad(encm.BLOOM_HEADER_MODULE), raw)
            bits, _ = encm.decrypt_module(
                ctx.key, ctx.aad(encm.BLOOM_BITSET_MODULE), raw, used)
            raw = bytes(hdr) + bytes(bits)
        return BloomFilter.deserialize(raw)

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
    def num_rows(self) -> int:
        return self.metadata.num_rows or 0

    @property
    def num_row_groups(self) -> int:
        return len(self.metadata.row_groups or [])

    # -- the read front: each row group through read_batch_device on
    #    `device` (the card unless named), back as a HostBatch ---------

    def _selected(self, columns: Optional[List[str]]) -> List[str]:
        """The top-level fields `columns` names, in schema order (a name
        the schema lacks is passed over, as the JAX reader does)."""
        return [f.name for f in self.schema.fields
                if columns is None or f.name in columns]

    def read_row_group(self, i: int, columns: Optional[List[str]] = None,
                       row_range: Optional[Tuple[int, int]] = None,
                       use_threads: bool = True, *, device=None):
        """Row group i's `columns` (all by default) as a HostBatch, read
        by read_batch_device on `device`; `row_range=(start, count)`
        keeps those rows of the group, as the JAX reader cuts it (the
        port reads the group whole and cuts it)."""
        from ..device.block import HostBatch, device_batch_to_host
        from .device_read import read_batch_device
        hb = device_batch_to_host(read_batch_device(
            self, i, self._selected(columns), device=device))
        hb = HostBatch(dt.Schema(hb.schema.fields, self.schema.metadata),
                       hb.columns, hb.num_rows)
        return hb if row_range is None else hb.slice(*row_range)

    def _concat(self, batches: list, columns: Optional[List[str]]):
        from ..dataset import _empty
        from ..device.block import HostBatch, concat_host_arrays
        if len(batches) == 1:
            return batches[0]
        if batches:
            return HostBatch(batches[0].schema, [
                concat_host_arrays([b.columns[i] for b in batches])
                for i in range(len(batches[0].columns))],
                sum(b.num_rows for b in batches))
        fields = [self.schema.field(self.schema.field_index(c))
                  for c in self._selected(columns)]
        return HostBatch(dt.Schema(fields, self.schema.metadata),
                         [_empty(f.type) for f in fields], 0)

    def read_table(self, columns: Optional[List[str]] = None,
                   filters: Optional[List[tuple]] = None,
                   use_threads: bool = True, device=None):
        """Every row group that `filters` ((column, op, literal), ANDed)
        may match by statistics and bloom filters, its `columns` read as
        read_row_group reads them, in one HostBatch (a string column's
        dictionaries merged in first-occurrence order)."""
        keep = [i for i in range(self.num_row_groups)
                if not filters or self._row_group_may_match(i, filters)]
        return self._concat([self.read_row_group(i, columns, device=device)
                             for i in keep], columns)

    def read_rows(self, offset: int, num_rows: int,
                  columns: Optional[List[str]] = None, device=None):
        """Rows [offset, offset + num_rows) as a HostBatch: the row groups
        that hold them, read whole and cut (the JAX reader's SeekToRow
        analog, which also skips pages outside the range)."""
        batches, row0 = [], 0
        for i, rg in enumerate(self.metadata.row_groups or []):
            n = rg.num_rows or 0
            lo, hi = max(offset, row0), min(offset + num_rows, row0 + n)
            if lo < hi:
                batches.append(self.read_row_group(
                    i, columns, (lo - row0, hi - lo), device=device))
            row0 += n
        return self._concat(batches, columns)

    def close(self) -> None:
        if self._owned:
            self.src.close()

    def __enter__(self) -> "ParquetFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_STAT_PACK = {fmt.Type.INT32: "<i", fmt.Type.INT64: "<q",
              fmt.Type.FLOAT: "<f", fmt.Type.DOUBLE: "<d"}


# the JAX module's functions of a ParquetFile (arrow_go_tpu/parquet/
# reader.py:690-735)
read_column_index = ParquetFile.read_column_index
read_offset_index = ParquetFile.read_offset_index
read_bloom_filter = ParquetFile.read_bloom_filter


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


_BSS_WIDTHS = {fmt.Type.INT32: 4, fmt.Type.INT64: 8, fmt.Type.FLOAT: 4,
               fmt.Type.DOUBLE: 8}


def _row_width(desc) -> int:
    """The bytes of a FIXED_LEN_BYTE_ARRAY or INT96 value."""
    return 12 if desc.physical_type == fmt.Type.INT96 else desc.type_length


def _page_values(desc, encoding: fmt.Encoding, raw, n: int, dictionary):
    """The n present values of a page: a numpy array of the physical
    type, (int64 ends, uint8 data) rows of a BYTE_ARRAY leaf, or the
    (n, width) uint8 rows of a FIXED_LEN_BYTE_ARRAY or INT96 leaf."""
    phys = desc.physical_type
    fixed = phys in (fmt.Type.FIXED_LEN_BYTE_ARRAY, fmt.Type.INT96)
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
    if encoding == fmt.Encoding.BYTE_STREAM_SPLIT and phys != fmt.Type.INT96:
        rows = enc.byte_stream_split_decode(raw, n, _BSS_WIDTHS.get(
            phys, desc.type_length))
        return rows if fixed else enc.plain_decode(phys, rows, n)
    if fixed and encoding == fmt.Encoding.PLAIN:
        w = _row_width(desc)
        if len(raw) < n * w:
            raise ArrowInvalid(f"PLAIN page holds no {n} values of {w} "
                               f"bytes")
        return np.frombuffer(raw, np.uint8, count=n * w).reshape(n, w)
    if phys == fmt.Type.FIXED_LEN_BYTE_ARRAY and \
            encoding == fmt.Encoding.DELTA_BYTE_ARRAY:
        w = desc.type_length
        out = enc.fixed_delta_byte_array_decode(raw, n, w)
        if len(out) < n * w:
            raise ArrowInvalid(f"DELTA_BYTE_ARRAY page holds "
                               f"{len(out) // w} values, not {n}")
        return out.reshape(n, w)
    if encoding == fmt.Encoding.RLE and phys == fmt.Type.BOOLEAN:
        (ln,) = struct.unpack_from("<I", raw, 0)
        return native.rle_decode(raw[4:4 + ln], n, 1).astype(np.bool_)
    if encoding == fmt.Encoding.DELTA_BINARY_PACKED and phys in (
            fmt.Type.INT32, fmt.Type.INT64):
        vals, _ = native.delta_decode(raw, n)
        return vals.astype(np.int32 if phys == fmt.Type.INT32 else np.int64)
    if encoding == fmt.Encoding.PLAIN and not fixed:
        return enc.plain_decode(phys, raw, n)
    raise ArrowNotImplemented(f"host decode of {phys.name} pages in "
                              f"{encoding.name}")


def _fixed_leaf(desc, rows: np.ndarray) -> HostArray:
    """A FIXED_LEN_BYTE_ARRAY or INT96 leaf's (n, width) rows as the flat
    device route gives its values (device_read._fixed_rows, on CPU
    tensors): a fixed_size_binary leaf as codes over its distinct rows."""
    import torch
    from ..ops import decode as dd
    from ..ops.convert import host_view
    from .device_read import _fixed_rows
    t = desc.arrow_type
    mat = torch.from_numpy(np.ascontiguousarray(rows, np.uint8))
    if t.id == dt.TypeId.FIXED_SIZE_BINARY:
        codes, dictionary = dd.fixed_size_codes(mat, None)
        return HostArray(codes.numpy(), None, dt.dictionary(dt.int32, t),
                         dictionary)
    values = _fixed_rows(t, desc.physical_type, desc.type_length).of_rows(mat)
    return HostArray(host_view(values.numpy(), t), None, t)


def _leaf_array(desc, parts) -> HostArray:
    """A leaf's present values as a flat HostArray of its type: strings
    and binaries as a dictionary array (first-occurrence codes), a
    FIXED_LEN_BYTE_ARRAY or INT96 leaf by _fixed_leaf, a narrow or
    unsigned integer or temporal type from its physical ints."""
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
    if desc.physical_type in (fmt.Type.FIXED_LEN_BYTE_ARRAY, fmt.Type.INT96):
        return _fixed_leaf(desc, np.concatenate(parts) if parts else np.zeros(
            (0, _row_width(desc)), np.uint8))
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
    ctx = pf.column_crypto(rg_i, li)
    chunk = pf.metadata.row_groups[rg_i].columns[li]
    codec = chunk.meta_data.codec or 0
    dictionary = None
    defs, reps, parts = [], [], []
    for hdr, body in _iter_pages(pf, chunk, ctx):
        ptype = fmt.PageType(hdr.type)
        if ptype == fmt.PageType.DICTIONARY_PAGE:
            payload = comp.decompress(codec, body,
                                      hdr.uncompressed_page_size)
            nvd = hdr.dictionary_page_header.num_values or 0
            dictionary = native.plain_byte_array(payload, nvd)[:2] if \
                phys == fmt.Type.BYTE_ARRAY else np.asarray(_page_values(
                    desc, fmt.Encoding.PLAIN, payload, nvd, None))
            continue
        if ptype not in (fmt.PageType.DATA_PAGE, fmt.PageType.DATA_PAGE_V2):
            raise ArrowNotImplemented(f"page type {ptype.name}")
        r, d, raw, encoding = _split_levels(hdr, body, desc, codec)
        n_present = int((d == desc.max_def_level).sum())
        parts.append(_page_values(desc, encoding, raw, n_present,
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


def read_table(source, columns: Optional[List[str]] = None,
               filters: Optional[List[tuple]] = None,
               decryption: Optional[encm.FileDecryptionProperties] = None,
               properties: Optional[ReaderProperties] = None,
               use_threads: bool = True, device=None):
    """A parquet file's table as a HostBatch (ParquetFile.read_table),
    read on `device` (the card unless named)."""
    with ParquetFile(source, decryption, properties) as pf:
        return pf.read_table(columns, filters, use_threads, device)
