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

Supported: max_rep_level == 0, max_def_level <= 1 (flat, optionally
nullable), physical INT32/INT64/FLOAT/DOUBLE/BOOLEAN, encodings PLAIN /
RLE_DICTIONARY / PLAIN_DICTIONARY / BYTE_STREAM_SPLIT, v1 and v2 data
pages, codecs UNCOMPRESSED and GZIP. DELTA_BINARY_PACKED pages, string
columns and the other codecs raise ArrowNotImplemented.
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
from .. import torchenv
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import DeviceBatch, DeviceColumn, pad_length
from ..ops import bitmap
from ..ops import decode as dd
from . import compress as comp
from . import encodings as enc
from . import format as fmt
from .thrift import CompactReader

_DICT_ENCODINGS = {fmt.Encoding.RLE_DICTIONARY, fmt.Encoding.PLAIN_DICTIONARY}

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


class _Stager:
    """Host buffers for the copy to `device`: pinned for the card, so the
    copy can run non_blocking. Each buffer is a fresh tensor, so PLAIN
    bytes start at offset 0 and view as their type without a copy."""

    def __init__(self, device: torch.device):
        self.pin = device.type == "cuda"

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


def _leaf_of(pf, column: str):
    for li, desc in enumerate(pf.leaves):
        if desc.path and desc.path[0] == column and len(desc.path) == 1:
            return li, desc
    raise ArrowInvalid(f"no flat leaf column {column!r}")


def _iter_pages(pf, chunk):
    """(PageHeader, raw_page_bytes) for every page of a column chunk, as
    memoryviews of one read of the chunk. Control-plane only."""
    meta = chunk.meta_data
    raw = pf.read_range(meta.dictionary_page_offset or meta.data_page_offset,
                        meta.total_compressed_size)
    pos = 0
    remaining = meta.num_values
    while remaining > 0 and pos < len(raw):
        rd = CompactReader(raw, pos)
        hdr = rd.read_struct(fmt.PageHeader)
        pos = rd.pos
        body = raw[pos: pos + hdr.compressed_page_size]
        pos += hdr.compressed_page_size
        ptype = fmt.PageType(hdr.type)
        if ptype in (fmt.PageType.DATA_PAGE, fmt.PageType.DATA_PAGE_V2):
            dph = (hdr.data_page_header if ptype == fmt.PageType.DATA_PAGE
                   else hdr.data_page_header_v2)
            remaining -= dph.num_values or 0
        yield hdr, body


def _split_page(hdr, body, desc, codec):
    """Header control-plane split of one data page ->
    (nv, def_stream, vals_raw, encoding)."""
    ptype = fmt.PageType(hdr.type)
    if ptype == fmt.PageType.DATA_PAGE:
        dph = hdr.data_page_header
        nv = dph.num_values or 0
        payload = comp.decompress(codec, body, hdr.uncompressed_page_size)
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
        vals_raw = comp.decompress(
            codec, vals_raw, (hdr.uncompressed_page_size or 0) - rl - dl)
    return nv, def_stream, vals_raw, fmt.Encoding(dph.encoding or 0)


# ---------------------------------------------------------------------------
# host plans and their device decodes
# ---------------------------------------------------------------------------

def _stage_rle(stager: _Stager, host: Host, key: str, tables) -> None:
    st, ir, pay, words = tables
    host[key + ".st"] = stager.array(st.astype(np.int64))
    host[key + ".ir"] = stager.array(ir.astype(np.bool_))
    host[key + ".pay"] = stager.array(pay.astype(np.int64))
    host[key + ".words"] = stager.array(words)


def _rle(d: Host, key: str, bit_width: int, n: int) -> torch.Tensor:
    return dd.rle_hybrid_decode_device(d[key + ".st"], d[key + ".ir"],
                                       d[key + ".pay"], d[key + ".words"],
                                       bit_width, n)


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[0] > n:
        raise ArrowInvalid(f"{t.shape[0]} values do not fit {n} slots")
    if t.shape[0] == n:
        return t
    return torch.cat([t, t.new_zeros(n - t.shape[0])])


def _spread(dense: torch.Tensor, present: Optional[torch.Tensor]):
    """Row i takes the value of its rank among the present rows; rows
    that are not present hold unspecified values behind the mask."""
    if present is None:
        return dense
    pos = torch.clamp(torch.cumsum(present, 0) - 1, min=0)
    return dense.index_select(0, pos)


def _plan_page(split, desc, np_dtype, has_dict, stager, host, key):
    """One data page (the JAX package's _decode_data_page). A column
    chunk decodes page by page: the JAX package's fused chunk read (one
    decode per uniform chunk) guards against a recompile per page, which
    has no counterpart here; on an H100 the SF10 scan is faster without
    it (PERF.md). A null row's slot holds a value of its own
    page, where the fused read takes one of the chunk's: unspecified in
    both."""
    nv, def_stream, vals_raw, encoding = split
    if def_stream is not None:
        _stage_rle(stager, host, key + "def",
                   dd.parse_rle_segments(def_stream, nv, 1))
    phys = desc.physical_type
    k = np.dtype(np_dtype).itemsize
    # clamp: trailing padding bytes must not push n_present past nv
    n_present = min(len(vals_raw) // k, nv)
    if encoding == fmt.Encoding.PLAIN and phys == fmt.Type.BOOLEAN:
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
        _stage_rle(stager, host, key + "codes",
                   dd.parse_rle_segments(vals_raw[1:], nv, width))

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


def _plan_column(pf, rg_i: int, column: str, stager: _Stager) -> _Plan:
    li, desc = _leaf_of(pf, column)
    if desc.max_rep_level != 0 or desc.max_def_level > 1:
        raise ArrowNotImplemented("device read supports flat columns only")
    t = desc.arrow_type
    np_dtype = t.np_dtype
    chunk = pf.metadata.row_groups[rg_i].columns[li]
    codec = chunk.meta_data.codec or 0
    host: Host = {}
    splits = []
    for hdr, body in _iter_pages(pf, chunk):
        ptype = fmt.PageType(hdr.type)
        if ptype == fmt.PageType.DICTIONARY_PAGE:
            payload = comp.decompress(codec, body, hdr.uncompressed_page_size)
            nvd = hdr.dictionary_page_header.num_values or 0
            host["dict"] = stager.array(np.ascontiguousarray(
                enc.plain_decode(desc.physical_type, payload, nvd)))
            continue
        if ptype not in (fmt.PageType.DATA_PAGE, fmt.PageType.DATA_PAGE_V2):
            raise ArrowNotImplemented(f"page type {ptype.name}")
        splits.append(_split_page(hdr, body, desc, codec))
    has_dict = "dict" in host
    n = sum(s[0] for s in splits)
    pages = [_plan_page(s, desc, np_dtype, has_dict, stager, host, f"p{i}.")
             for i, s in enumerate(splits)]

    def decode(d: Host) -> Decoded:
        outs = [page(d) for page in pages]
        present = None if desc.max_def_level == 0 else \
            torch.cat([o[1] for o in outs])
        return torch.cat([o[0] for o in outs]), present
    return _Plan(host, decode, n, t, desc.max_def_level > 0)


def _ship(host: Host, device: torch.device) -> Host:
    return {k: v.to(device, non_blocking=True) for k, v in host.items()}


def _column(plan: _Plan, shipped: Host, pad: Optional[int]) -> DeviceColumn:
    values, present = plan.decode(shipped)
    P = pad if pad is not None else pad_length(plan.n)
    validity = bitmap.pack_mask(_pad(present, P)) if plan.nullable else None
    return DeviceColumn(_pad(values, P), validity, plan.n, plan.type)


def read_column_device(pf, rg_i: int, column: str, pad=None,
                       device=None) -> DeviceColumn:
    """Read one flat numeric column of one row group straight into a
    DeviceColumn (values + packed validity words in device memory), on
    `device` (the card unless named)."""
    dev = torchenv.device(device)
    plan = _plan_column(pf, rg_i, column, _Stager(dev))
    return _column(plan, _ship(plan.host, dev), pad)


def read_batch_device(pf, rg_i: int, columns: Optional[List[str]] = None,
                      pad=None, device=None,
                      times: Optional[dict] = None) -> DeviceBatch:
    """The scan entry point of device pipelines: the requested columns
    (all by default) of a row group as a DeviceBatch on `device` (the
    card unless named), with no host materialization of the values.

    times: when given, receives the seconds of the phases "parse_s",
    "h2d_s" and "decode_s" (added to any value already there)."""
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
    clock = _Clock(times, dev)
    with clock.phase("parse_s"):
        stager = _Stager(dev)
        plans = [_plan_column(pf, rg_i, c, stager) for c in columns]
    with clock.phase("h2d_s"):
        shipped = [_ship(p.host, dev) for p in plans]
    with clock.phase("decode_s"):
        cols = [_column(p, d, pad) for p, d in zip(plans, shipped)]
    # fields in REQUESTED order so the schema stays aligned with cols
    return DeviceBatch(dt.Schema([by_name[c] for c in columns]), cols, nrows)
