"""Avro Object Container File reader (reference arrow/avro/reader.go:87:
the OCF decoder and the Avro-schema -> Arrow-schema conversion).

Port of arrow_go_tpu/formats/avro.py: the OCF framing (magic, the
metadata map, sync markers; the null, deflate, snappy and zstandard
codecs) and the binary encoding (zigzag varints, unions, records,
arrays, maps, enums, fixed, the logical types decimal, date, time,
timestamp and uuid).

Two tiers decode a block, as in the JAX package:

- a flat record schema (primitive, enum and logical-primitive fields,
  each optionally a two-branch union with null) takes the array tier
  (`_flat_plan`, `_decode_block_vec`): a varint's length and 32-bit
  value at every byte position in one pass (native.varint_lanes), each
  record's field positions from one walk over them
  (native.avro_flat_walk, with the JAX record-jump map's clamps), then
  each field's values by array gathers; a long by the exact 64-bit
  gather `_varint64_at`. The lanes are int32, so a block holds under
  2 GiB. The two passes are sequential, so they are C++ (csrc/
  codecs.cc), as the port's other header walks are.
- any other schema decodes record by record (`_decode_value`) into
  Python values, built into columns by device/block.from_pylist.

Codecs: deflate is raw (zlib, wbits -15); snappy drops the block's
4-byte CRC-32 suffix without checking it, as the JAX package does;
zstandard goes through the port's own decoder (native.zstd_decompress),
which reads each frame's content size or grows its buffer up to 2 GiB.

Results are HostBatches: `read_avro` and `OCFReader.read_all` give one,
`OCFReader` iterates them (`chunk_size` rows each, slicing across
blocks; 0 gives one batch a block). Strings, binary, fixed and enums are
dictionary-coded, as everywhere in the port.
"""
from __future__ import annotations

import io
import json as _json
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .. import dtypes as dt
from .. import native
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import (HostArray, HostBatch, concat_host_arrays,
                            dictionary_values, from_pylist, null_array)
from .csv import _rows_column, _slice_concat

MAGIC = b"Obj\x01"
ZSTD_MAX_OUTPUT = 1 << 31       # the JAX reader's max_output_size


class _Bin:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def long(self) -> int:
        out = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (out >> 1) ^ -(out & 1)

    def bytes_(self) -> bytes:
        n = self.long()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def boolean(self) -> bool:
        b = self.buf[self.pos]
        self.pos += 1
        return b == 1

    def float_(self) -> float:
        (v,) = struct.unpack_from("<f", self.buf, self.pos)
        self.pos += 4
        return v

    def double(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    def fixed(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def eof(self) -> bool:
        return self.pos >= len(self.buf)


_SIMPLE = {"null": dt.null, "boolean": dt.bool_, "int": dt.int32,
           "long": dt.int64, "float": dt.float32, "double": dt.float64,
           "bytes": dt.binary, "string": dt.string}


def _avro_to_arrow(sch, named: Dict[str, Any]) -> dt.DataType:
    """The Arrow type of an Avro schema; `named` collects the named types
    (records, enums, fixed) as they are met."""
    if isinstance(sch, str):
        if sch in _SIMPLE:
            return _SIMPLE[sch]
        if sch in named:
            return _avro_to_arrow(named[sch], named)
        raise ArrowInvalid(f"unknown avro type {sch!r}")
    if isinstance(sch, list):  # union
        non_null = [s for s in sch if s != "null"]
        if len(non_null) == 1:
            return _avro_to_arrow(non_null[0], named)
        return dt.dense_union([dt.Field(f"member{i}",
                                        _avro_to_arrow(s, named))
                               for i, s in enumerate(non_null)])
    t = sch["type"]
    lt = sch.get("logicalType")
    if lt == "decimal":
        return dt.decimal128(sch.get("precision", 38), sch.get("scale", 0))
    logical = {"date": dt.date32, "time-millis": dt.time32("ms"),
               "time-micros": dt.time64("us"),
               "timestamp-millis": dt.timestamp("ms", "UTC"),
               "timestamp-micros": dt.timestamp("us", "UTC"),
               "uuid": dt.string}
    if lt in logical:
        return logical[lt]
    if t == "record":
        named[sch["name"]] = sch
        return dt.struct([dt.Field(f["name"],
                                   _avro_to_arrow(f["type"], named))
                          for f in sch["fields"]])
    if t == "enum":
        named[sch["name"]] = sch
        return dt.dictionary(dt.int32, dt.string)
    if t == "array":
        return dt.list_(_avro_to_arrow(sch["items"], named))
    if t == "map":
        return dt.map_(dt.string, _avro_to_arrow(sch["values"], named))
    if t == "fixed":
        named[sch["name"]] = sch
        return dt.fixed_size_binary(sch["size"])
    return _avro_to_arrow(t, named)


def _decimal_of(raw: bytes, scale: int):
    import decimal
    u = int.from_bytes(raw, "big", signed=True)
    return decimal.Decimal(u).scaleb(-scale)


def _blocks(r: _Bin):
    """The item counts of an array's or a map's blocks (a negative count
    is followed by the block's byte size, which is skipped)."""
    while True:
        n = r.long()
        if n == 0:
            return
        if n < 0:
            r.long()
            n = -n
        yield n


def _decode_value(r: _Bin, sch, named: Dict[str, Any]):
    """One value of Avro schema `sch` as a Python value (the recursive
    tier): a date or time as its integer, an enum as its symbol, a
    decimal as a Decimal, a map as a dict."""
    if isinstance(sch, str):
        if sch == "null":
            return None
        if sch == "boolean":
            return r.boolean()
        if sch in ("int", "long"):
            return r.long()
        if sch == "float":
            return r.float_()
        if sch == "double":
            return r.double()
        if sch == "bytes":
            return r.bytes_()
        if sch == "string":
            return r.string()
        if sch in named:
            return _decode_value(r, named[sch], named)
        raise ArrowInvalid(f"unknown avro type {sch!r}")
    if isinstance(sch, list):
        return _decode_value(r, sch[r.long()], named)
    t = sch["type"]
    lt = sch.get("logicalType")
    if t == "record":
        return {f["name"]: _decode_value(r, f["type"], named)
                for f in sch["fields"]}
    if t == "enum":
        return sch["symbols"][r.long()]
    if t == "array":
        return [_decode_value(r, sch["items"], named)
                for n in _blocks(r) for _ in range(n)]
    if t == "fixed":
        raw = r.fixed(sch["size"])
        return _decimal_of(raw, sch.get("scale", 0)) if lt == "decimal" \
            else raw
    if t == "map":
        out = {}
        for n in _blocks(r):
            for _ in range(n):
                k = r.string()
                out[k] = _decode_value(r, sch["values"], named)
        return out
    if t == "bytes" and lt == "decimal":
        return _decimal_of(r.bytes_(), sch.get("scale", 0))
    return _decode_value(r, t, named)


# ---------------------------------------------------------------------------
# the array tier for flat record schemas: varint lengths and values at
# every byte position in one pass, the field positions from one walk of
# the records, each field's values by array gathers
# ---------------------------------------------------------------------------

_PRIM_KINDS = {"null", "boolean", "int", "long", "float", "double",
               "bytes", "string"}
# a field's kind as native.avro_flat_walk reads it
_KIND_CODE = {"null": 0, "boolean": 1, "int": 2, "long": 2, "enum": 2,
              "float": 3, "double": 4, "bytes": 5, "string": 5}


def _flat_plan(sch, named) -> Optional[List[dict]]:
    """A decode plan a field for a flat record schema, or None when a
    field needs the recursive tier (nested records, arrays, maps,
    decimals, fixed, unions of more than null and one type)."""
    if not isinstance(sch, dict) or sch.get("type") != "record":
        return None
    plan = []
    for f in sch["fields"]:
        ft = f["type"]
        nullable = False
        null_branch = -1
        if isinstance(ft, list):
            if len(ft) != 2 or "null" not in ft:
                return None
            null_branch = ft.index("null")
            ft = ft[1 - null_branch]
            nullable = True
        symbols = None
        if isinstance(ft, str):
            if ft not in _PRIM_KINDS:
                return None
            kind = ft
        elif isinstance(ft, dict):
            base = ft.get("type")
            if base == "enum":
                kind = "enum"
                symbols = ft["symbols"]
            elif base in _PRIM_KINDS and ft.get("logicalType") != "decimal":
                kind = base            # logical date/time/timestamp/uuid
            else:
                return None
        else:
            return None
        plan.append({"name": f["name"], "kind": kind, "nullable": nullable,
                     "null_branch": null_branch, "symbols": symbols})
    return plan


def _varint64_at(buf: np.ndarray, P: np.ndarray,
                 vlen: np.ndarray) -> np.ndarray:
    """The exact zigzag int64 varints at positions P."""
    bufp = np.concatenate([buf, np.zeros(10, np.uint8)])
    lens = vlen[P]
    acc = np.zeros(len(P), np.uint64)
    for k in range(min(int(lens.max(initial=1)), 10)):
        part = (bufp[P + k] & 0x7F).astype(np.uint64) << np.uint64(7 * k)
        acc |= np.where(k < lens, part, np.uint64(0))
    return (acc >> np.uint64(1)).astype(np.int64) ^ \
        -(acc & np.uint64(1)).astype(np.int64)


def _decode_block_vec(payload, count: int, plan):
    """One block's payload -> (its bytes, [(kind, values, validity, plan
    entry)] a field), every primitive lane by arrays."""
    buf = np.frombuffer(payload, np.uint8)
    L = len(buf)
    last = L - 1 if L else 0
    vlen, val = native.varint_lanes(buf)
    starts = native.avro_flat_walk(
        vlen, val, count, [_KIND_CODE[f["kind"]] for f in plan],
        [f["null_branch"] for f in plan])
    cols = []
    for j, f in enumerate(plan):
        P = starts[:, j]
        if f["nullable"]:
            b = val[P]
            validity = (b != 0) if f["null_branch"] == 0 else (b == 0)
            P = np.minimum(P + vlen[P], last)
        else:
            validity = None
        k = f["kind"]
        safeP = np.minimum(P, last)
        if k in ("int", "long", "enum"):
            vals = (_varint64_at(buf, safeP, vlen) if k == "long"
                    else val[safeP].astype(np.int64))
            if validity is not None:
                vals = np.where(validity, vals, 0)
        elif k == "boolean":
            vals = buf[safeP] == 1
            if validity is not None:
                vals &= validity
        elif k in ("float", "double"):
            w = 4 if k == "float" else 8
            raw = buf[np.minimum(safeP[:, None] + np.arange(w), last)] \
                if L else np.zeros((count, w), np.uint8)
            if validity is not None:
                raw[~validity] = 0
            vals = np.frombuffer(raw.tobytes(),
                                 np.float32 if k == "float" else np.float64)
        elif k in ("bytes", "string"):
            lens = np.maximum(val[safeP], 0)
            if validity is not None:
                lens = np.where(validity, lens, 0)
            vals = (lens, safeP + vlen[safeP])
        else:  # null
            vals = np.zeros(count, np.int64)
        cols.append((k, vals, validity, f))
    return buf, cols


def _parts_to_columns(buf, cols, count: int, schema: dt.Schema
                      ) -> List[HostArray]:
    """_decode_block_vec's parts as HostArrays (an all-valid validity is
    dropped)."""
    out = []
    for (k, vals, validity, f), field in zip(cols, schema.fields):
        t = field.type
        mask = None if validity is None or validity.all() else validity
        if t.id == dt.TypeId.NULL:
            out.append(null_array(count))
        elif k in ("bytes", "string"):
            lens, data_start = vals
            out.append(_rows_column(lens, _slice_concat(
                buf, data_start, data_start + lens), mask, t))
        elif k == "enum":
            codes = np.clip(vals, 0, len(f["symbols"]) - 1).astype(np.int32)
            out.append(HostArray(codes, mask, t, dictionary_values(
                f["symbols"], dt.string)))
        elif t.id == dt.TypeId.BOOL:
            out.append(HostArray(vals.astype(np.bool_), mask, t))
        else:
            out.append(HostArray(np.asarray(vals).astype(t.np_dtype), mask,
                                 t))
    return out


def _concat(batches: List[HostBatch]) -> HostBatch:
    first = batches[0]
    if len(batches) == 1:
        return first
    return HostBatch(first.schema, [
        concat_host_arrays([b.columns[i] for b in batches])
        for i in range(len(first.columns))],
        sum(b.num_rows for b in batches))


class OCFReader:
    """Avro Object Container File reader.

    chunk_size: rows a HostBatch when iterating (reference WithChunk,
    arrow/avro/reader.go:385-392; <= 0 gives one batch an OCF block, the
    reference's chunk=-1 mode). The times the reader spent are in
    `decompress_s` and `decode_s`."""

    def __init__(self, source: Union[str, bytes, io.IOBase],
                 chunk_size: int = 0):
        self.chunk_size = chunk_size
        self.decompress_s = self.decode_s = 0.0
        self._pending: List[dict] = []
        self._pending_batches: List[HostBatch] = []
        self._exhausted = False
        if isinstance(source, str):
            with open(source, "rb") as f:
                data = f.read()
        elif isinstance(source, (bytes, bytearray, memoryview)):
            data = bytes(source)
        else:
            data = source.read()
        if data[:4] != MAGIC:
            raise ArrowInvalid("bad avro OCF magic")
        r = _Bin(data[4:])
        meta: Dict[str, bytes] = {}
        for n in _blocks(r):
            for _ in range(n):
                k = r.string()
                meta[k] = r.bytes_()
        self.codec = meta.get("avro.codec", b"null").decode()
        self.avro_schema = _json.loads(meta["avro.schema"])
        self._named: Dict[str, Any] = {}
        arrow_t = _avro_to_arrow(self.avro_schema, self._named)
        self._wrap = arrow_t.id != dt.TypeId.STRUCT
        if self._wrap:
            arrow_t = dt.struct([dt.Field("value", arrow_t)])
        self.schema = dt.Schema(arrow_t.fields())
        self._sync = r.fixed(16)
        self._r = r
        self._plan = None if self._wrap else _flat_plan(self.avro_schema,
                                                        self._named)

    def _next_block_payload(self) -> Optional[Tuple[int, bytes]]:
        r = self._r
        if r.eof():
            return None
        count = r.long()
        size = r.long()
        payload = r.fixed(size)
        sync = r.fixed(16)
        if sync != self._sync:
            raise ArrowInvalid("avro sync marker mismatch")
        t0 = time.perf_counter()
        if self.codec == "deflate":
            payload = zlib.decompress(payload, wbits=-15)
        elif self.codec == "snappy":
            payload = native.snappy_decompress(payload[:-4])  # crc32 suffix
        elif self.codec == "zstandard":
            payload = native.zstd_decompress(payload, None,
                                             max_size=ZSTD_MAX_OUTPUT)
        elif self.codec != "null":
            raise ArrowNotImplemented(f"avro codec {self.codec}")
        self.decompress_s += time.perf_counter() - t0
        return count, payload

    def _read_block(self) -> Optional[List[dict]]:
        nb = self._next_block_payload()
        if nb is None:
            return None
        count, payload = nb
        br = _Bin(bytes(payload))           # the codecs give memoryviews
        out = []
        for _ in range(count):
            v = _decode_value(br, self.avro_schema, self._named)
            out.append({"value": v} if self._wrap else v)
        return out

    def _read_block_batch(self) -> Optional[HostBatch]:
        """One OCF block -> HostBatch through the array tier."""
        nb = self._next_block_payload()
        if nb is None:
            return None
        count, payload = nb
        t0 = time.perf_counter()
        buf, cols = _decode_block_vec(payload, count, self._plan)
        out = HostBatch(self.schema, _parts_to_columns(buf, cols, count,
                                                       self.schema), count)
        self.decode_s += time.perf_counter() - t0
        return out

    def _records_to_batch(self, records: List[dict]) -> HostBatch:
        return HostBatch(self.schema, [
            from_pylist([rec.get(f.name) for rec in records], f.type)
            for f in self.schema.fields], len(records))

    def read_next_batch(self) -> Optional[HostBatch]:
        """The next chunk of rows (None at the end of the file)."""
        if self._plan is not None:
            return self._next_batch_fast()
        want = self.chunk_size
        while not self._exhausted and (want <= 0 or
                                       len(self._pending) < want):
            block = self._read_block()
            if block is None:
                self._exhausted = True
                break
            self._pending.extend(block)
            if want <= 0 and self._pending:
                break  # one batch per OCF block
        if not self._pending:
            return None
        take = len(self._pending) if want <= 0 else min(want,
                                                        len(self._pending))
        records, self._pending = self._pending[:take], self._pending[take:]
        return self._records_to_batch(records)

    def _next_batch_fast(self) -> Optional[HostBatch]:
        want = self.chunk_size
        pend = self._pending_batches
        avail = sum(b.num_rows for b in pend)
        while not self._exhausted and (want <= 0 or avail < want):
            rb = self._read_block_batch()
            if rb is None:
                self._exhausted = True
                break
            pend.append(rb)
            avail += rb.num_rows
            if want <= 0 and avail:
                break  # one batch per OCF block
        if not avail:
            return None
        take = avail if want <= 0 else min(want, avail)
        pieces, got = [], 0
        while got < take:
            b = pend[0]
            need = take - got
            if b.num_rows <= need:
                pieces.append(pend.pop(0))
                got += b.num_rows
            else:
                pieces.append(b.slice(0, need))
                pend[0] = b.slice(need, b.num_rows - need)
                got = take
        return _concat(pieces)

    def __iter__(self):
        while True:
            rb = self.read_next_batch()
            if rb is None:
                return
            yield rb

    def read_all(self) -> HostBatch:
        """Every remaining row in one HostBatch."""
        if self._plan is not None:
            batches = list(self._pending_batches)
            self._pending_batches = []
            while not self._exhausted:
                rb = self._read_block_batch()
                if rb is None:
                    self._exhausted = True
                    break
                batches.append(rb)
            if not batches:
                return self._records_to_batch([])
            return _concat(batches)
        records: List[dict] = list(self._pending)
        self._pending = []
        while not self._exhausted:
            block = self._read_block()
            if block is None:
                self._exhausted = True
                break
            records.extend(block)
        return self._records_to_batch(records)


def read_avro(source) -> HostBatch:
    return OCFReader(source).read_all()
