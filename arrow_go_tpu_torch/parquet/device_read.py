"""Parquet -> device memory: the device scan of flat numeric columns.

Port of arrow_go_tpu/parquet/device_read.py (the device inversion of
the reference's decode hot loop, parquet/file/column_reader.go
TypedDecoder.Decode). The host touches only control data (thrift page
headers, RLE run headers, codec decompression); every decoded value is
produced on the device by ops/decode.py:

    page bytes --host: parse, stage--> pinned buffers --copy--> device
               --device: decode--> values + validity words

A scan runs in three phases, each over all requested columns: parse
(host: page split, decompression, run-header walk, staging of the bytes
into pinned host buffers), copy (one non_blocking host-to-device copy
per buffer) and decode (device). `read_batch_device(..., times={})`
adds each phase's seconds to the dict, synchronizing the device at the
phase ends; without `times` nothing synchronizes.

Supported on the device: max_rep_level == 0, max_def_level <= 1 (flat,
optionally nullable; a nested column is read on the host into a
HostColumn), physical INT32/INT64/FLOAT/DOUBLE/BOOLEAN (an INT32 or INT64
column decodes as its physical ints and then takes its annotated type on
the device: int8, int16, uint8 and uint16 narrow there; uint32, uint64
and the temporal types keep the bits; schema.py maps the annotations),
and FIXED_LEN_BYTE_ARRAY and INT96 (each page's values stage as a byte
matrix of `type_length` or 12 bytes a row, and ops/decode.py turns the
rows into the type's values on the device: a decimal's big-endian
two's complement into sign-extended little-endian limbs, a float16's two
bytes into float16, an INT96's day and nanoseconds into a timestamp in
ns; a fixed_size_binary column's rows become codes over its distinct
rows, the JAX package's layout), encodings PLAIN /
RLE_DICTIONARY / PLAIN_DICTIONARY / BYTE_STREAM_SPLIT (of every width:
its planes transposed into rows on the device) / DELTA_BINARY_PACKED
(INT32/INT64, every miniblock width up to 64) / RLE (BOOLEAN: a 4-byte
length, then the hybrid at width 1) / DELTA_BYTE_ARRAY (a
FIXED_LEN_BYTE_ARRAY page: its prefixes and suffixes rebuilt on the host
into rows, staged as a PLAIN page's are), v1 and v2 data pages, codecs
UNCOMPRESSED, SNAPPY, GZIP, LZ4_RAW and ZSTD (the host decompresses; `times` splits its seconds out as "decompress_s", a
part of "parse_s"). String and binary columns read as their dictionary
codes (`codes_only` in the JAX package): a dictionary(int32, string)
column of int32 codes on the device and its values on the host. A chunk
of dictionary pages only keeps its dictionary page's order and decodes
its codes on the device. A chunk with any PLAIN, DELTA_LENGTH_BYTE_ARRAY
or DELTA_BYTE_ARRAY page (a writer's dictionary fallback, whole or part
way, or a writer without dictionaries) decodes on the host, in the codec
library (native.py): its values, the dictionary page's rows that its
dictionary-coded pages name among them, are numbered by first
occurrence over the chunk's rows, a null row counting as the empty
string (the codes and dictionary the JAX package's Scanner gives such a
chunk: its host read, then batch_to_device's memo table); the codes
stage as one int32 buffer and copy as the other columns do. `times`
splits the seconds of that host decode out as "strings_s", a part of
"parse_s". Other encodings and codecs raise ArrowNotImplemented.
"""
from __future__ import annotations

import struct
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from .. import native, torchenv
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import (DeviceBatch, DeviceColumn, HostColumn,
                            dictionary_values, pad_length)
from ..ops import bitmap, convert
from ..ops import decode as dd
from . import compress as comp
from . import encodings as enc
from . import encryption as encm
from . import format as fmt
from . import schema
from .reader import read_field_host
from .thrift import CompactReader

_DICT_ENCODINGS = {fmt.Encoding.RLE_DICTIONARY, fmt.Encoding.PLAIN_DICTIONARY}
# a FIXED_LEN_BYTE_ARRAY page's encodings besides PLAIN and dictionary
_FIXED_ENCODINGS = {fmt.Encoding.BYTE_STREAM_SPLIT,
                    fmt.Encoding.DELTA_BYTE_ARRAY}

Host = Dict[str, torch.Tensor]
Decoded = Tuple[torch.Tensor, Optional[torch.Tensor]]


@dataclass
class _Plan:
    """One column chunk parsed on the host: the CPU tensors to copy to
    the device, and how the copies decode into (values[n], present[n]
    or None)."""

    host: Host
    decode: Callable[[Host], Decoded]
    n: int
    type: dt.DataType
    nullable: bool
    dictionary: Optional[np.ndarray] = None    # a string column's values
    fixed_codes: bool = False    # fixed_size_binary: rows -> codes


class _Stager:
    """Host buffers for the copy to `device`: pinned for the card, so the
    copy can run non_blocking. Each buffer is a fresh tensor, so PLAIN
    bytes start at offset 0 and view as their type without a copy."""

    def __init__(self, device: torch.device):
        self.pin = device.type == "cuda"

    def empty(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)

    def array(self, a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.empty(a.shape, dtype=dd.torch_dtype(a.dtype),
                        pin_memory=self.pin)
        t.numpy()[...] = a
        return t

    def bytes(self, parts: Sequence) -> torch.Tensor:
        t = torch.empty(sum(len(p) for p in parts), dtype=torch.uint8,
                        pin_memory=self.pin)
        buf = t.numpy()
        off = 0
        for p in parts:
            buf[off:off + len(p)] = np.frombuffer(p, np.uint8)
            off += len(p)
        return t


class _Clock:
    """Adds each phase's seconds to `times` when it is given."""

    def __init__(self, times: Optional[dict], device: torch.device):
        self.times = times
        self.device = device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, name: str):
        if self.times is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)

    @contextmanager
    def strings(self):
        """The host decode of a chunk of string pages: its seconds added
        to "strings_s" (a host call: no sync)."""
        t0 = time.perf_counter()
        yield
        if self.times is not None:
            self.times["strings_s"] = self.times.get("strings_s", 0.0) + (
                time.perf_counter() - t0)

    def host(self, name: str, fn, *args):
        """fn(*args), its seconds added to times[name] (a host call: no
        sync)."""
        if self.times is None:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)
        return out

    def decompress(self, codec: int, data, size: int):
        """comp.decompress, its seconds added to "decompress_s"."""
        return self.host("decompress_s", comp.decompress, codec, data, size)

    def decrypt(self, ctx, data, module: int, page: int = -1,
                gcm: bool = True):
        """One encrypted frame of a chunk (encryption.decrypt_module),
        its seconds added to "decrypt_s"."""
        return self.host("decrypt_s", encm.decrypt_module, ctx.key,
                         ctx.aad(module, page), data, 0, gcm)


def _leaf_of(pf, column: str):
    for li, desc in enumerate(pf.leaves):
        if desc.path and desc.path[0] == column and len(desc.path) == 1:
            return li, desc
    raise ArrowInvalid(f"no flat leaf column {column!r}")


def _iter_pages(pf, chunk, ctx=None, clock: Optional[_Clock] = None):
    """(PageHeader, raw_page_bytes) for every page of a column chunk, as
    memoryviews of one read of the chunk. Control-plane only.

    With a crypto context (ParquetFile.column_crypto) each page header is
    an encrypted frame, whose length comes from its u32 prefix, and each
    page body one too (CTR under AES_GCM_CTR_V1), decrypted with the
    module AADs in the JAX reader's order (arrow_go_tpu/parquet/
    reader.py:396-452): the first header is the dictionary page's when
    the chunk has a dictionary_page_offset (its kind is unknown until
    it is decrypted), and the page ordinal counts the pages after the
    dictionary page. `clock` adds the decryption's seconds to
    "decrypt_s"."""
    clock = clock or _Clock(None, None)
    meta = chunk.meta_data
    raw = pf.read_range(meta.dictionary_page_offset or meta.data_page_offset,
                        meta.total_compressed_size)
    pos = 0
    remaining = meta.num_values
    page_ord = 0
    while remaining > 0 and pos < len(raw):
        if ctx is None:
            rd = CompactReader(raw, pos)
            hdr = rd.read_struct(fmt.PageHeader)
            pos = rd.pos
        else:
            first_dict = pos == 0 and meta.dictionary_page_offset is not None
            hb, used = clock.decrypt(
                ctx, raw[pos:], encm.DICT_PAGE_HEADER_MODULE if first_dict
                else encm.DATA_PAGE_HEADER_MODULE, page_ord)
            hdr = CompactReader(hb).read_struct(fmt.PageHeader)
            pos += used
        body = raw[pos: pos + hdr.compressed_page_size]
        pos += hdr.compressed_page_size
        ptype = fmt.PageType(hdr.type)
        if ctx is not None:
            dict_page = ptype == fmt.PageType.DICTIONARY_PAGE
            body, _ = clock.decrypt(
                ctx, body, encm.DICT_PAGE_MODULE if dict_page
                else encm.DATA_PAGE_MODULE, page_ord, ctx.gcm_pages)
            page_ord += not dict_page
        if ptype in (fmt.PageType.DATA_PAGE, fmt.PageType.DATA_PAGE_V2):
            dph = (hdr.data_page_header if ptype == fmt.PageType.DATA_PAGE
                   else hdr.data_page_header_v2)
            remaining -= dph.num_values or 0
        yield hdr, body


def _split_page(hdr, body, desc, codec, clock: _Clock):
    """Header control-plane split of one data page ->
    (nv, def_stream, vals_raw, encoding)."""
    ptype = fmt.PageType(hdr.type)
    if ptype == fmt.PageType.DATA_PAGE:
        dph = hdr.data_page_header
        nv = dph.num_values or 0
        payload = clock.decompress(codec, body, hdr.uncompressed_page_size)
        off = 0
        def_stream = None
        if desc.max_def_level > 0:
            (ln,) = struct.unpack_from("<I", payload, 0)
            def_stream = payload[4:4 + ln]
            off = 4 + ln
        return nv, def_stream, payload[off:], fmt.Encoding(dph.encoding or 0)
    dph = hdr.data_page_header_v2
    nv = dph.num_values or 0
    rl = dph.repetition_levels_byte_length or 0
    dl = dph.definition_levels_byte_length or 0
    def_stream = body[rl:rl + dl] if desc.max_def_level > 0 else None
    vals_raw = body[rl + dl:]
    if dph.is_compressed is not False and codec:
        vals_raw = clock.decompress(
            codec, vals_raw, (hdr.uncompressed_page_size or 0) - rl - dl)
    return nv, def_stream, vals_raw, fmt.Encoding(dph.encoding or 0)


# ---------------------------------------------------------------------------
# host plans and their device decodes
# ---------------------------------------------------------------------------

def _stage_rle(stager: _Stager, host: Host, key: str, data, n: int,
               bit_width: int) -> None:
    """Parse an RLE/bit-packed stream and stage its tables; the walk
    copies the packed bodies straight into staging memory."""
    bufs = []

    def alloc(nbytes: int) -> np.ndarray:
        bufs.append(stager.empty(nbytes))
        return bufs[-1].numpy()
    st, ir, pay, _ = dd.parse_rle_segments(data, n, bit_width, alloc)
    host[key + ".st"] = stager.array(st.astype(np.int64))
    host[key + ".ir"] = stager.array(ir.astype(np.bool_))
    host[key + ".pay"] = stager.array(pay.astype(np.int64))
    host[key + ".words"] = bufs[0].view(torch.int32)


def _rle(d: Host, key: str, bit_width: int, n: int) -> torch.Tensor:
    return dd.rle_hybrid_decode_device(d[key + ".st"], d[key + ".ir"],
                                       d[key + ".pay"], d[key + ".words"],
                                       bit_width, n)


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[0] > n:
        raise ArrowInvalid(f"{t.shape[0]} values do not fit {n} slots")
    if t.shape[0] == n:
        return t
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + t.shape[1:])])


def _spread(dense: torch.Tensor, present: Optional[torch.Tensor]):
    """Row i takes the value of its rank among the present rows; rows
    that are not present hold unspecified values behind the mask."""
    if present is None:
        return dense
    pos = torch.clamp(torch.cumsum(present, 0) - 1, min=0)
    return dense.index_select(0, pos)


def _plan_page(split, desc, np_dtype, has_dict, codes_only, stager, host,
               key, rows=None):
    """One data page (the JAX package's _decode_data_page). A column
    chunk decodes page by page: the JAX package's fused chunk read (one
    decode per uniform chunk) guards against a recompile per page, which
    has no counterpart here; on an H100 the SF10 scan is faster without
    it (PERF.md). A null row's slot holds a value of its own
    page, where the fused read takes one of the chunk's: unspecified in
    both. With `codes_only` (a string column) the page decodes to its
    int32 dictionary codes. `rows` (a FIXED_LEN_BYTE_ARRAY or INT96
    column) takes a PLAIN page's bytes and its value count, or a row
    matrix, to the column's values; np_dtype is then None."""
    nv, def_stream, vals_raw, encoding = split
    if def_stream is not None:
        _stage_rle(stager, host, key + "def", def_stream, nv, 1)
    phys = desc.physical_type
    k = rows.width if rows is not None else np.dtype(np_dtype).itemsize
    if rows is not None and encoding not in _DICT_ENCODINGS | {
            fmt.Encoding.PLAIN} and (phys != fmt.Type.FIXED_LEN_BYTE_ARRAY
                                     or encoding not in _FIXED_ENCODINGS):
        raise ArrowNotImplemented(
            f"device decode of {phys.name} pages in {encoding.name}")
    if rows is not None and encoding == fmt.Encoding.DELTA_BYTE_ARRAY:
        # walked on the host into rows, then read as a PLAIN page's
        vals_raw = enc.fixed_delta_byte_array_decode(vals_raw, nv, k)
        encoding = fmt.Encoding.PLAIN
    # clamp: trailing padding bytes must not push n_present past nv
    n_present = min(len(vals_raw) // k, nv)
    if rows is not None and encoding not in _DICT_ENCODINGS:
        # a PLAIN or BYTE_STREAM_SPLIT page's bytes
        host[key + "raw"] = stager.bytes([vals_raw[:n_present * k]])
        split = encoding == fmt.Encoding.BYTE_STREAM_SPLIT

        def dense(d):
            if split:
                return _pad(rows.of_rows(dd.byte_stream_split_rows_device(
                    d[key + "raw"], k, n_present)), nv)
            return _pad(rows(d[key + "raw"], n_present), nv)
    elif codes_only:
        if encoding not in _DICT_ENCODINGS:
            raise ArrowNotImplemented(
                "device string read needs all-dictionary pages (page "
                f"encoding {encoding.name})")
        width = vals_raw[0]
        _stage_rle(stager, host, key + "codes", vals_raw[1:], nv, width)

        def dense(d):
            return _rle(d, key + "codes", width, nv).to(torch.int32)
    elif encoding == fmt.Encoding.DELTA_BINARY_PACKED and phys in (
            fmt.Type.INT32, fmt.Type.INT64):
        st, b0, wd, mn, words, first, total = dd.parse_delta_segments(
            vals_raw)
        n_present = min(total, nv)
        wide = bool(wd.max() > 32)
        for name, a in (("st", st), ("b0", b0), ("wd", wd), ("mn", mn),
                        ("words", words)):
            host[key + "delta." + name] = stager.array(a)

        def dense(d):
            out = dd.delta_decode_device(
                *(d[key + "delta." + name]
                  for name in ("st", "b0", "wd", "mn", "words")),
                first, n_present, wide)
            return _pad(out.to(dd.torch_dtype(np_dtype)), nv)
    elif encoding == fmt.Encoding.RLE and phys == fmt.Type.BOOLEAN:
        # a 4-byte length, then the hybrid at width 1 over the present
        # values (v1 and v2 pages alike)
        if len(vals_raw) < 4:
            raise ArrowInvalid("RLE boolean page without its length")
        (ln,) = struct.unpack_from("<I", vals_raw, 0)
        _stage_rle(stager, host, key + "bits", vals_raw[4:4 + ln], nv, 1)

        def dense(d):
            return _rle(d, key + "bits", 1, nv).to(torch.bool)
    elif encoding == fmt.Encoding.PLAIN and phys == fmt.Type.BOOLEAN:
        # PLAIN boolean is 1-bit packed over the present values
        host[key + "bits"] = stager.array(dd.words_from_bytes(vals_raw))

        def dense(d):
            return dd.bitunpack_device(d[key + "bits"], 1, nv).to(torch.bool)
    elif encoding == fmt.Encoding.PLAIN:
        host[key + "raw"] = stager.bytes([vals_raw[:n_present * k]])

        def dense(d):
            return _pad(dd.plain_decode_device(d[key + "raw"], np_dtype,
                                               n_present), nv)
    elif encoding in _DICT_ENCODINGS:
        if not has_dict:
            raise ArrowInvalid("dictionary page missing")
        width = vals_raw[0]
        _stage_rle(stager, host, key + "codes", vals_raw[1:], nv, width)

        def dense(d):
            return dd.dict_decode_device(_rle(d, key + "codes", width, nv),
                                         d["dict"])
    elif encoding == fmt.Encoding.BYTE_STREAM_SPLIT:
        host[key + "raw"] = stager.bytes([vals_raw[:n_present * k]])

        def dense(d):
            return _pad(dd.byte_stream_split_decode_device(
                d[key + "raw"], np_dtype, n_present), nv)
    else:
        raise ArrowNotImplemented(
            f"device decode for encoding {encoding.name} is not ported")

    def decode(d: Host) -> Decoded:
        present = None if def_stream is None else \
            _rle(d, key + "def", 1, nv) == 1
        return _spread(dense(d), present), present
    return decode


def _fixed_rows(t: dt.DataType, phys: fmt.Type, type_length: int):
    """The FixedRows of a column of port type t on physical type `phys`,
    or None for the physical types that are not rows of bytes."""
    if phys == fmt.Type.INT96:
        return dd.FixedRows(12, dd.int96_nanos)
    if phys != fmt.Type.FIXED_LEN_BYTE_ARRAY:
        return None
    if t.limbs:
        return dd.FixedRows(type_length,
                            lambda r: dd.decimal_limbs(r, t.limbs))
    if t == dt.float16:
        return dd.FixedRows(2, lambda r: r.contiguous().view(
            torch.float16).reshape(-1))
    return dd.FixedRows(type_length, lambda r: r)


def _dictionary_from_rows(ends: np.ndarray, data: np.ndarray,
                         t: dt.DataType) -> np.ndarray:
    """The rows of (ends, data) as a dictionary's numpy object array: str
    (UTF-8) for a string column, bytes for a binary one."""
    raw = data.tobytes()
    bounds = np.concatenate(([0], ends)).tolist()
    if t == dt.string and raw.isascii():
        text = raw.decode("ascii")
        vals = [text[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    elif t == dt.string:
        vals = [raw[a:b].decode() for a, b in zip(bounds[:-1], bounds[1:])]
    else:
        vals = [raw[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out


def _string_chunk_codes(splits, desc, dict_page):
    """(int32 codes per row, dictionary) of a string chunk with any PLAIN
    or DELTA byte-array page, on the host: every page's values as rows
    (a dictionary-coded page's as the dictionary page's rows it names;
    a null row empty), then one first-occurrence memo table over them."""
    lens, parts = [], []
    for nv, def_stream, vals_raw, encoding in splits:
        present = None if def_stream is None else \
            native.rle_decode(def_stream, nv, 1).astype(np.bool_)
        n_present = nv if present is None else int(present.sum())
        if encoding in _DICT_ENCODINGS and not n_present:
            ends, data = np.zeros(0, np.int64), np.zeros(0, np.uint8)
        elif encoding in _DICT_ENCODINGS:
            if dict_page is None:
                raise ArrowInvalid("dictionary page missing")
            codes = native.rle_decode(vals_raw[1:], n_present, vals_raw[0])
            if n_present and int(codes.max()) >= len(dict_page[0]):
                raise ArrowInvalid("dictionary code past the dictionary")
            ends, data = native.gather_rows(*dict_page, codes)
        else:
            ends, data = enc.byte_array_decode(encoding, vals_raw,
                                               n_present)
        page_lens = np.diff(ends, prepend=0)
        if present is not None:
            row_lens = np.zeros(nv, np.int64)
            row_lens[present] = page_lens
            page_lens = row_lens
        lens.append(page_lens)
        parts.append(data)
    ends = np.cumsum(np.concatenate(lens) if lens else np.zeros(0, np.int64),
                     dtype=np.int64)
    data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    codes, first = native.factorize(ends, data)
    return codes, _dictionary_from_rows(
        *native.gather_rows(ends, data, first), desc.arrow_type)


def _plan_column(pf, rg_i: int, column: str, stager: _Stager,
                 clock: _Clock) -> _Plan:
    li, desc = _leaf_of(pf, column)
    if desc.max_rep_level != 0 or desc.max_def_level > 1:
        raise ArrowNotImplemented("device read supports flat columns only")
    t = desc.arrow_type
    codes_only = t.is_binary_like
    rows = _fixed_rows(t, desc.physical_type, desc.type_length)
    np_dtype = None if rows is not None else np.int32 if codes_only else \
        schema.physical_np_dtype(t)
    ctx = pf.column_crypto(rg_i, li)
    chunk = pf.metadata.row_groups[rg_i].columns[li]
    codec = chunk.meta_data.codec or 0
    host: Host = {}
    splits = []
    dictionary = None
    dict_page = None           # a string dictionary page's (ends, data)
    dict_rows = 0
    for hdr, body in _iter_pages(pf, chunk, ctx, clock):
        ptype = fmt.PageType(hdr.type)
        if ptype == fmt.PageType.DICTIONARY_PAGE:
            payload = clock.decompress(codec, body,
                                       hdr.uncompressed_page_size)
            nvd = hdr.dictionary_page_header.num_values or 0
            if rows is not None:
                # the dictionary's rows decode on the device, once
                host["dict"] = stager.bytes([payload[:nvd * rows.width]])
                dict_rows = nvd
                continue
            if codes_only:
                # the values stay on the host; the codes index them
                dict_page = native.plain_byte_array(payload, nvd)[:2]
            else:
                host["dict"] = stager.array(np.ascontiguousarray(
                    enc.plain_decode(desc.physical_type, payload, nvd)))
            continue
        if ptype not in (fmt.PageType.DATA_PAGE, fmt.PageType.DATA_PAGE_V2):
            raise ArrowNotImplemented(f"page type {ptype.name}")
        splits.append(_split_page(hdr, body, desc, codec, clock))
    has_dict = "dict" in host or dict_page is not None
    n = sum(s[0] for s in splits)
    if codes_only and any(sp[3] not in _DICT_ENCODINGS for sp in splits):
        with clock.strings():
            codes, dictionary = _string_chunk_codes(splits, desc, dict_page)
        host["codes"] = stager.array(codes)
        defs = [(f"p{i}.def", sp[0], sp[1]) for i, sp in enumerate(splits)]
        for key, nv, def_stream in defs:
            if def_stream is not None:
                _stage_rle(stager, host, key, def_stream, nv, 1)

        def string_codes(d: Host) -> Decoded:
            present = None if desc.max_def_level == 0 else torch.cat(
                [_rle(d, key, 1, nv) == 1 for key, nv, _ in defs])
            return d["codes"], present
        return _Plan(host, string_codes, n, dt.dictionary(dt.int32, t),
                     desc.max_def_level > 0, dictionary)
    if dict_page is not None:
        dictionary = _dictionary_from_rows(*dict_page, t)
    pages = [_plan_page(s, desc, np_dtype, has_dict, codes_only, stager,
                        host, f"p{i}.", rows)
             for i, s in enumerate(splits)]
    fixed_codes = t.id == dt.TypeId.FIXED_SIZE_BINARY
    if codes_only or fixed_codes:
        t = dt.dictionary(dt.int32, t)
        if dictionary is None:
            dictionary = dictionary_values([], desc.arrow_type)

    def decode(d: Host) -> Decoded:
        if rows is not None and "dict" in d:
            d = dict(d, dict=rows(d["dict"], dict_rows))
        outs = [page(d) for page in pages]
        present = None if desc.max_def_level == 0 else \
            torch.cat([o[1] for o in outs])
        return torch.cat([o[0] for o in outs]), present
    return _Plan(host, decode, n, t, desc.max_def_level > 0, dictionary,
                 fixed_codes)


def _ship(host: Host, device: torch.device) -> Host:
    return {k: v.to(device, non_blocking=True) for k, v in host.items()}


def _column(plan: _Plan, shipped: Host, pad: Optional[int]) -> DeviceColumn:
    values, present = plan.decode(shipped)
    dictionary = plan.dictionary
    if plan.fixed_codes:
        values, dictionary = dd.fixed_size_codes(values, present)
    elif values.dtype != plan.type.torch_dtype:
        # an 8- or 16-bit int from its INT32 physical values
        values = convert.convert(values, dt.int32, plan.type)
    P = pad if pad is not None else pad_length(plan.n)
    validity = bitmap.pack_mask(_pad(present, P)) if plan.nullable else None
    return DeviceColumn(_pad(values, P), validity, plan.n, plan.type,
                        dictionary)


def read_column_device(pf, rg_i: int, column: str, pad=None,
                       device=None) -> DeviceColumn:
    """Read one flat column of one row group straight into a
    DeviceColumn (values + packed validity words in device memory), on
    `device` (the card unless named)."""
    dev = torchenv.device(device)
    plan = _plan_column(pf, rg_i, column, _Stager(dev), _Clock(None, dev))
    return _column(plan, _ship(plan.host, dev), pad)


def read_batch_device(pf, rg_i: int, columns: Optional[List[str]] = None,
                      pad=None, device=None,
                      times: Optional[dict] = None) -> DeviceBatch:
    """The scan entry point of device pipelines: the requested columns
    (all by default) of a row group as a DeviceBatch on `device` (the
    card unless named), with no host materialization of the values; a
    nested column is read on the host (reader.read_field_host) and
    rides the batch as a HostColumn, as the JAX scanner gives it.

    times: when given, receives the seconds of the phases "parse_s",
    "h2d_s" and "decode_s", and "decompress_s" and "decrypt_s", the
    codec calls' and the decryption's shares of "parse_s" (each added
    to any value already there)."""
    dev = torchenv.device(device)
    if columns is None:
        columns = [f.name for f in pf.schema.fields]
    nrows = pf.metadata.row_groups[rg_i].num_rows or 0
    if pad is None:
        pad = pad_length(nrows)
    if len(set(columns)) != len(columns):
        raise ArrowInvalid(f"duplicate column names in {columns!r}")
    by_name = {f.name: f for f in pf.schema.fields}
    missing = [c for c in columns if c not in by_name]
    if missing:
        raise ArrowInvalid(f"unknown columns {missing!r}")
    # a nested column (its leaves' descriptors under a group) is read on
    # the host and rides the batch as a HostColumn
    nested = {c for c in columns if by_name[c].type.is_nested or (
        by_name[c].type.id == dt.TypeId.EXTENSION
        and by_name[c].type.storage_type.is_nested)}
    flat = [c for c in columns if c not in nested]
    clock = _Clock(times, dev)
    with clock.phase("parse_s"):
        stager = _Stager(dev)
        plans = [_plan_column(pf, rg_i, c, stager, clock) for c in flat]
        hosts = {c: HostColumn(read_field_host(pf, rg_i, c)) for c in nested}
    with clock.phase("h2d_s"):
        shipped = [_ship(p.host, dev) for p in plans]
    with clock.phase("decode_s"):
        decoded = dict(zip(flat, [_column(p, d, pad)
                                  for p, d in zip(plans, shipped)]))
    # fields in REQUESTED order so the schema stays aligned with cols
    return DeviceBatch(dt.Schema([by_name[c] for c in columns]),
                       [hosts[c] if c in hosts else decoded[c]
                        for c in columns], nrows)
