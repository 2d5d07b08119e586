"""IPC record-batch bodies (assembled and loaded) and message framing.

Port of arrow_go_tpu/ipc/core.py (reference arrow/ipc/writer.go:566-870,
the recursive visit of a column; arrow/ipc/reader.go, the record load;
format/Message.fbs, the encapsulated message: continuation 0xFFFFFFFF,
int32 length, flatbuffer, 8-aligned body; BodyCompression, one frame a
buffer behind its int64 uncompressed length, -1 for a buffer stored
raw).

A column is written from the port's HostArray under its field's type
(the schema's): a fixed-width column as its values, a decimal128 or
decimal256 as its limb bytes (the Arrow layout), fixed_size_binary as
its rows (zeros under a null row), string / binary / large_string /
large_binary as offsets and data gathered from the dictionary-coded
HostArray by `native.gather_rows` (a null row empty), string_view /
binary_view as 16-byte views and one variadic buffer laid out as the JAX
package's builder lays them out, a dictionary field as its indices (the
dictionary rides a DictionaryBatch), the nested types, list views,
unions and run_end_encoded from their children (a list view's rows in
order in its child, a run_end_encoded slice's runs cut to it), an
extension column as its storage. Every column is written from row 0 (a
slice is rebased), so an uncompressed body is the JAX writer's, byte for
byte, for the same rows.

A column is loaded as the port's HostArray: fixed-width values are
views of the message body (no copy); a string or binary column (and a
view column) becomes codes and a dictionary in first-occurrence order
of its valid rows (`native.factorize`), as the port's parquet reader
gives them, a fixed_size_binary column codes over its distinct rows in
byte order (ops/decode.fixed_size_codes). A big-endian body is swapped
as it is read or written (reference arrow/ipc/endian_swap.go); a view
column refuses, as in the JAX package. A buffer or node the body does
not hold raises ArrowInvalid.
"""
from __future__ import annotations

import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from .. import native
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import (ExtensionArray, HostArray, ListViewArray,
                            RunEndEncodedArray, UnionArray,
                            concat_host_arrays, nested_array, null_array)
from ..ops.decode import fixed_size_codes
from . import metadata as md
from .fb import Builder, Reader

CONTINUATION = 0xFFFFFFFF
ALIGN = 8
EOS = struct.pack("<Ii", CONTINUATION, 0)


def _pad_to(n: int, align: int = ALIGN) -> int:
    return (n + align - 1) // align * align


class FieldNode:
    __slots__ = ("length", "null_count")

    def __init__(self, length: int, null_count: int):
        self.length = length
        self.null_count = null_count


# ---------------------------------------------------------------------------
# byte strings of a dictionary-coded column
# ---------------------------------------------------------------------------

def _dictionary_rows(dictionary) -> Tuple[np.ndarray, np.ndarray]:
    """A dictionary's values (str or bytes) as (int64 ends, uint8 data)."""
    raw = [v.encode("utf-8", "surrogateescape") if isinstance(v, str)
           else bytes(v) for v in dictionary]
    ends = np.cumsum([len(v) for v in raw], dtype=np.int64)
    return ends, np.frombuffer(b"".join(raw), np.uint8)


def _row_bytes(arr: HostArray) -> Tuple[np.ndarray, np.ndarray]:
    """A dictionary-coded column's rows as (int64 ends, uint8 data), a
    null row empty: native.gather_rows of its codes, a null row pointing
    at an empty entry past the dictionary."""
    ends, data = _dictionary_rows(arr.dict_values)
    ends = np.append(ends, ends[-1] if len(ends) else 0)
    idx = np.asarray(arr.values, np.int64)
    if arr.mask is not None:
        idx = np.where(arr.mask, idx, len(ends) - 1)
    return native.gather_rows(ends, data, idx)


def _offsets(ends: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.int32 and len(ends) and ends[-1] >= 2 ** 31:
        raise ArrowInvalid(f"{int(ends[-1])} bytes of values need 64-bit "
                           f"offsets (a large type)")
    out = np.zeros(len(ends) + 1, dtype)
    out[1:] = ends
    return out


def _views(ends: np.ndarray, data: np.ndarray):
    """(n x 16 views, variadic data) of rows (ends, data): a value of at
    most 12 bytes inline, a longer one as its length, first 4 bytes,
    buffer 0 and its offset in the one data buffer, appended in row
    order (the JAX package's BinaryViewBuilder)."""
    n = len(ends)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    lens = ends - starts
    views = np.zeros((n, 16), np.uint8)
    views[:, :4] = lens.astype("<i4").view(np.uint8).reshape(n, 4)
    long = lens > 12
    head = np.minimum(lens, np.where(long, 4, 12))
    # the inline bytes, or a long value's first 4
    take = np.arange(12)[None, :] < head[:, None]
    src = np.minimum(starts[:, None] + np.arange(12)[None, :],
                     max(len(data) - 1, 0))
    if len(data):
        views[:, 4:16] = np.where(take, data[src], 0)
    li = np.flatnonzero(long)
    var_ends, var = native.gather_rows(ends, data, li)
    off = np.concatenate([[0], var_ends[:-1]]).astype("<i4")
    views[li, 8:12] = 0
    views[li, 12:16] = off.view(np.uint8).reshape(-1, 4)
    return views, var


# ---------------------------------------------------------------------------
# body assembly
# ---------------------------------------------------------------------------

def _le(a: np.ndarray, big: bool) -> memoryview:
    """A numpy array's bytes, big-endian when `big`."""
    a = np.ascontiguousarray(a)
    if big and a.dtype.itemsize > 1:
        a = a.astype(a.dtype.newbyteorder(">"))
    return memoryview(a).cast("B")


def _bits(mask: np.ndarray) -> bytes:
    return np.packbits(np.asarray(mask, np.bool_), bitorder="little"
                       ).tobytes()


def _null_count(arr: HostArray) -> int:
    return 0 if arr.mask is None else int(len(arr) - arr.mask.sum())


def _ree_rebased(arr: RunEndEncodedArray) -> Tuple[HostArray, HostArray]:
    """(run ends from 0, their values) of a run_end_encoded slice."""
    first, lens = arr._runs()
    ends = np.cumsum(lens).astype(arr.run_ends.values.dtype)
    return (HostArray(ends, None, arr.run_ends.type),
            arr.values.slice(first, len(lens)))


def _list_view_compacted(arr: ListViewArray) -> ListViewArray:
    """A list view with its rows laid out in order in its child, a null
    row empty (the JAX package's builder layout, which its writer gives
    a sliced list view); one already so laid out is returned as is."""
    size = np.where(arr.validity_bools(), arr.sizes.astype(np.int64), 0)
    off = np.zeros(len(arr), np.int64)
    np.cumsum(size[:-1], out=off[1:])
    if np.array_equal(arr.offsets, off) and np.array_equal(arr.sizes, size) \
            and len(arr.children[0]) == int(size.sum()):
        return arr
    return concat_host_arrays([arr])


def collect_body(arr: HostArray, t: dt.DataType, nodes: List[FieldNode],
                 buffers: list, variadic: List[int],
                 big: bool = False) -> None:
    """Append the field nodes and buffers of column `arr` of field type
    `t` (the reference writer's visit); `variadic` gets each view
    column's variadic buffer count (RecordBatch.variadicBufferCounts)."""
    tid = t.id
    if tid == dt.TypeId.EXTENSION:
        collect_body(arr.storage if isinstance(arr, ExtensionArray) else arr,
                     t.storage_type, nodes, buffers, variadic, big)
        return
    n = len(arr)
    if tid == dt.TypeId.NULL:
        nodes.append(FieldNode(n, n))
        return
    if tid in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        nodes.append(FieldNode(n, 0))
        buffers.append(_le(arr.type_ids, big))
        if tid == dt.TypeId.DENSE_UNION:
            buffers.append(_le(arr.value_offsets, big))
        for f, c in zip(t.fields(), arr.children):
            collect_body(c, f.type, nodes, buffers, variadic, big)
        return
    if tid == dt.TypeId.RUN_END_ENCODED:
        nodes.append(FieldNode(n, 0))
        for f, c in zip(t.fields(), _ree_rebased(arr)):
            collect_body(c, f.type, nodes, buffers, variadic, big)
        return
    nc = _null_count(arr)
    nodes.append(FieldNode(n, nc))
    buffers.append(_bits(arr.mask) if nc else b"")
    if tid == dt.TypeId.BOOL:
        buffers.append(_bits(arr.values))
    elif tid == dt.TypeId.DICTIONARY:
        buffers.append(_le(np.asarray(arr.values, t.index_type.np_dtype),
                           big))
    elif tid == dt.TypeId.FIXED_SIZE_BINARY:
        w = t.byte_width
        table = np.frombuffer(b"".join(arr.dict_values), np.uint8).reshape(
            -1, w) if len(arr.dict_values) else np.zeros((1, w), np.uint8)
        rows = table[np.asarray(arr.values, np.int64)]
        if nc:
            rows[~arr.mask] = 0
        buffers.append(memoryview(np.ascontiguousarray(rows)).cast("B"))
    elif t.limbs:                  # little-endian limbs: the Arrow layout
        raw = np.ascontiguousarray(arr.values).view(np.uint8).reshape(
            n, t.bit_width // 8)
        buffers.append(memoryview(np.ascontiguousarray(
            raw[:, ::-1] if big else raw)).cast("B"))
    elif t.is_binary_like:
        ends, data = _row_bytes(arr)
        if t.offset_dtype is None:             # string_view, binary_view
            if big:
                raise ArrowNotImplemented("endian swap of view buffers")
            views, var = _views(ends, data)
            buffers.append(memoryview(views).cast("B"))
            if len(var):
                buffers.append(memoryview(var))
            variadic.append(1 if len(var) else 0)
        else:
            buffers.append(_le(_offsets(ends, t.offset_dtype), big))
            buffers.append(memoryview(data))
    elif t.np_dtype is not None:
        buffers.append(_le(arr.values, big))
    elif tid in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        arr = _list_view_compacted(arr)
        buffers.append(_le(arr.offsets, big))
        buffers.append(_le(arr.sizes, big))
        collect_body(arr.children[0], t.value_type, nodes, buffers,
                     variadic, big)
    elif tid in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST, dt.TypeId.MAP):
        off = np.asarray(arr.offsets, np.int64)
        lo = int(off[0]) if len(off) else 0
        buffers.append(_le((off - lo).astype(t.offset_dtype), big))
        child = arr.children[0].slice(lo, int(off[-1]) - lo) if n else \
            arr.children[0].slice(0, 0)
        collect_body(child, t.value_type, nodes, buffers, variadic, big)
    elif tid == dt.TypeId.FIXED_SIZE_LIST:
        collect_body(arr.children[0].slice(0, n * t.list_size),
                     t.value_type, nodes, buffers, variadic, big)
    elif tid == dt.TypeId.STRUCT:
        for f, c in zip(t.fields(), arr.children):
            collect_body(c, f.type, nodes, buffers, variadic, big)
    else:
        raise ArrowNotImplemented(f"IPC body of {t}")


def compress_buffer(codec: str, buf) -> bytes:
    """One body buffer as an int64-length-prefixed frame, stored raw
    (length -1) when the codec does not shrink it (the IPC
    BodyCompression contract)."""
    if codec == "zstd":
        comp = native.zstd_compress(buf)
    else:
        comp = native.lz4_frame_compress(buf)
    if len(comp) < len(buf):
        return struct.pack("<q", len(buf)) + bytes(comp)
    return struct.pack("<q", -1) + bytes(buf)


def codec_id(compression: Optional[str]) -> Optional[int]:
    """The BodyCompression codec of "lz4" / "zstd" (None: none)."""
    if compression is None:
        return None
    if compression == "zstd":
        return md.COMPRESS_ZSTD
    if compression == "lz4":
        return md.COMPRESS_LZ4
    raise ArrowNotImplemented(f"IPC body compression {compression!r}")


def build_record_batch_parts(columns, types, num_rows: int,
                             compression: Optional[str] = None,
                             dictionary_id: Optional[int] = None,
                             is_delta: bool = False,
                             compress_concurrency: int = 0,
                             big: bool = False):
    """(the message flatbuffer, the body's parts, the body's length) of
    a record batch of `columns` under field types `types`; a
    DictionaryBatch around it when `dictionary_id` is set. With
    `compress_concurrency` > 1 the buffers are compressed on a thread
    pool (the codecs release the GIL; reference WithCompressConcurrency,
    arrow/ipc/ipc.go:160-170)."""
    codec = codec_id(compression)
    nodes: List[FieldNode] = []
    raw: list = []
    variadic: List[int] = []
    for col, t in zip(columns, types):
        collect_body(col, t, nodes, raw, variadic, big)
    if codec is not None:
        if compress_concurrency > 1 and len(raw) > 1:
            with ThreadPoolExecutor(compress_concurrency) as pool:
                raw = list(pool.map(
                    lambda b: compress_buffer(compression, b), raw))
        else:
            raw = [compress_buffer(compression, b) for b in raw]
    parts, buf_meta, off = [], [], 0
    for b in raw:
        parts.append(b)
        pad = _pad_to(len(b)) - len(b)
        if pad:
            parts.append(b"\0" * pad)
        buf_meta.append((off, len(b)))
        off += len(b) + pad

    fb = Builder(1024)
    fb.start_vector(16, len(buf_meta), 8)
    for o, ln in reversed(buf_meta):
        fb.prep(8, 16)
        fb.prepend("<q", ln)
        fb.prepend("<q", o)
    buf_vec = fb.end_vector()
    fb.start_vector(16, len(nodes), 8)
    for node in reversed(nodes):
        fb.prep(8, 16)
        fb.prepend("<q", node.null_count)
        fb.prepend("<q", node.length)
    node_vec = fb.end_vector()
    var_vec = None
    if variadic:
        fb.start_vector(8, len(variadic), 8)
        for v in reversed(variadic):
            fb.prepend("<q", v)
        var_vec = fb.end_vector()
    comp_off = None
    if codec is not None:
        fb.start_object(2)
        fb.add(0, "<b", codec, 0)
        comp_off = fb.end_object()
    fb.start_object(5)
    fb.add(0, "<q", num_rows, 0)
    fb.add_offset(1, node_vec)
    fb.add_offset(2, buf_vec)
    if comp_off is not None:
        fb.add_offset(3, comp_off)
    if var_vec is not None:
        fb.add_offset(4, var_vec)
    header = fb.end_object()
    header_type = md.MSG_RECORD_BATCH
    if dictionary_id is not None:
        fb.start_object(3)
        fb.add(0, "<q", dictionary_id, 0)
        fb.add_offset(1, header)
        fb.add(2, "<B", is_delta, False)
        header = fb.end_object()
        header_type = md.MSG_DICTIONARY_BATCH
    return finish_message(fb, header_type, header, off), parts, off


def finish_message(fb: Builder, header_type: int, header: int,
                   body_len: int) -> bytes:
    fb.start_object(5)
    fb.add(0, "<h", md.METADATA_V5, 0)
    fb.add(1, "<B", header_type, 0)
    fb.add_offset(2, header)
    fb.add(3, "<q", body_len, 0)
    return fb.finish(fb.end_object())


def build_schema_message(schema: dt.Schema, dict_ids: dict,
                         endianness: int = 0) -> bytes:
    fb = Builder(1024)
    off = md.write_schema(fb, schema, dict_ids, endianness)
    return finish_message(fb, md.MSG_SCHEMA, off, 0)


def frame_message(meta: bytes) -> bytes:
    """The encapsulated message: continuation, int32 size, flatbuffer,
    zero padding to 8 bytes."""
    size = _pad_to(len(meta) + 8) - 8
    return struct.pack("<Ii", CONTINUATION, size) + meta + \
        b"\0" * (size - len(meta))


# ---------------------------------------------------------------------------
# loading (the reader side)
# ---------------------------------------------------------------------------

class BodyReader:
    """Sequential consumer of a record batch message's nodes and body
    buffers (decompressed, on a thread pool when `decompress_concurrency`
    > 1, the read-side mirror of WithCompressConcurrency); the seconds
    spent decompressing add up in `decompress_s`."""

    def __init__(self, rb: Reader, body, decompress_concurrency: int = 0,
                 big: bool = False):
        self.rb = rb
        self.body = body
        self.big = big
        self.decompress_s = 0.0
        self.node_i = self.buf_i = self.var_i = 0
        self.n_nodes = rb.vector_len(1)
        self.n_bufs = rb.vector_len(2)
        comp = rb.table(3)
        self.codec = None
        if comp is not None:
            c = comp.i8(0)
            if c not in (md.COMPRESS_ZSTD, md.COMPRESS_LZ4):
                raise ArrowNotImplemented(f"compression codec {c}")
            self.codec = "zstd" if c == md.COMPRESS_ZSTD else "lz4"
        self._prefetched = None
        if self.codec is not None and decompress_concurrency > 1 and \
                self.n_bufs > 1:
            raws = [self._raw_buffer(i) for i in range(self.n_bufs)]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(decompress_concurrency) as pool:
                self._prefetched = list(pool.map(self._decompress_one, raws))
            self.decompress_s += time.perf_counter() - t0

    @property
    def num_rows(self) -> int:
        return self.rb.i64(0)

    def _raw_buffer(self, i: int):
        pos = self.rb.vector_struct_pos(2, i, 16)
        off, ln = self.rb.get("<q", pos), self.rb.get("<q", pos + 8)
        if off < 0 or ln < 0 or off + ln > len(self.body):
            raise ArrowInvalid(f"buffer {i} ({off}, {ln}) outside the "
                               f"{len(self.body)}-byte body")
        return self.body[off: off + ln]

    def _decompress_one(self, raw):
        if self.codec is None or not len(raw):
            return raw
        if len(raw) < 8:
            raise ArrowInvalid("compressed buffer without its length")
        (ulen,) = struct.unpack_from("<q", raw, 0)
        payload = raw[8:]
        if ulen == -1:
            return payload
        if ulen < 0:
            raise ArrowInvalid(f"compressed buffer of length {ulen}")
        if self.codec == "zstd":
            return native.zstd_decompress(payload, ulen)
        return native.lz4_frame_decompress(payload, ulen)

    def next_node(self) -> FieldNode:
        if self.node_i >= self.n_nodes:
            raise ArrowInvalid("record batch has fewer field nodes than "
                               "its schema")
        pos = self.rb.vector_struct_pos(1, self.node_i, 16)
        self.node_i += 1
        node = FieldNode(self.rb.get("<q", pos), self.rb.get("<q", pos + 8))
        if node.length < 0 or not 0 <= node.null_count <= node.length:
            raise ArrowInvalid(f"field node ({node.length}, "
                               f"{node.null_count})")
        return node

    def next_variadic(self) -> int:
        if self.var_i >= self.rb.vector_len(4):
            raise ArrowInvalid("record batch has fewer variadic buffer "
                               "counts than its view columns")
        v = self.rb.vector_i64(4, self.var_i)
        self.var_i += 1
        return v

    def next_buffer(self):
        i = self.buf_i
        if i >= self.n_bufs:
            raise ArrowInvalid("record batch has fewer buffers than its "
                               "schema")
        self.buf_i += 1
        if self._prefetched is not None:
            return self._prefetched[i]
        raw = self._raw_buffer(i)
        if self.codec is None:
            return raw
        t0 = time.perf_counter()
        out = self._decompress_one(raw)
        self.decompress_s += time.perf_counter() - t0
        return out

    def array(self, dtype, n: int) -> np.ndarray:
        """The next buffer as n values of `dtype` (a view unless it is
        swapped)."""
        dtype = np.dtype(dtype)
        raw = self.next_buffer()
        if len(raw) < n * dtype.itemsize:
            raise ArrowInvalid(f"buffer of {len(raw)} bytes for {n} "
                               f"values of {dtype}")
        if not self.big or dtype.itemsize == 1:
            return np.frombuffer(raw, dtype, n)
        return np.frombuffer(raw, dtype.newbyteorder(">"), n).astype(dtype)

    def bits(self, n: int) -> np.ndarray:
        raw = self.next_buffer()
        if len(raw) * 8 < n:
            raise ArrowInvalid(f"bitmap of {len(raw)} bytes for {n} rows")
        return np.unpackbits(np.frombuffer(raw, np.uint8), count=n,
                             bitorder="little").astype(np.bool_)


def coded_column(ends: np.ndarray, data: np.ndarray, mask, t: dt.DataType
           ) -> HostArray:
    """Rows (ends, data) as the port's dictionary-coded column: codes in
    first-occurrence order of the valid rows (native.factorize), a null
    row code 0."""
    from ..device.block import dictionary_values
    n = len(ends)
    if mask is None:
        codes, first = native.factorize(ends, data)
        src_ends, src = ends, data
    else:
        keep = np.flatnonzero(mask)
        src_ends, src = native.gather_rows(ends, data, keep)
        live, first = native.factorize(src_ends, src)
        codes = np.zeros(n, np.int32)
        codes[keep] = live
    starts = np.concatenate([[0], src_ends[:-1]]) if len(src_ends) else \
        src_ends
    raw = src.tobytes()
    values = [raw[starts[i]:src_ends[i]] for i in first.tolist()]
    if t.is_utf8:
        values = [v.decode("utf-8", "surrogateescape") for v in values]
    return HostArray(codes, mask, t, dictionary_values(values, t))


def _view_rows(views: np.ndarray, bufs: list, n: int):
    """The (ends, data) of n 16-byte views over variadic buffers `bufs`."""
    v = views.reshape(n, 16)
    lens = np.ascontiguousarray(v[:, :4]).view("<i4").reshape(-1).astype(
        np.int64)
    idx = np.ascontiguousarray(v[:, 8:12]).view("<i4").reshape(-1)
    off = np.ascontiguousarray(v[:, 12:16]).view("<i4").reshape(-1)
    if (lens < 0).any():
        raise ArrowInvalid("negative view length")
    sizes = [len(b) for b in bufs]
    base = np.concatenate([[n * 16], n * 16 + np.cumsum(sizes)]).astype(
        np.int64)
    long = lens > 12
    if long.any():
        li, lo = idx[long], off[long].astype(np.int64)
        if (li < 0).any() or (li >= len(bufs)).any() or (lo < 0).any() or \
                (lo + lens[long] > np.asarray(sizes, np.int64)[li]).any():
            raise ArrowInvalid("a view outside its variadic buffers")
    start = np.where(long, base[np.clip(idx, 0, len(bufs))] + off,
                     np.arange(n, dtype=np.int64) * 16 + 4)
    src = np.concatenate([v.reshape(-1)] + [np.frombuffer(b, np.uint8)
                                             for b in bufs])
    ends = np.cumsum(lens)
    total = int(ends[-1]) if n else 0
    pos = np.repeat(start - (ends - lens), lens) + np.arange(total)
    return ends, src[pos]


def load_array(br: BodyReader, t: dt.DataType, dictionaries: dict,
               dict_id: Optional[int] = None, field_ids=None) -> HostArray:
    """The next column of field type `t` from a record batch body;
    `dictionaries` maps a dictionary id to its values, `dict_id` is the
    column's own id (a dictionary field), `field_ids(child field)` a
    child's."""
    tid = t.id
    child_id = field_ids or (lambda f: None)

    def child(f: dt.Field) -> HostArray:
        return load_array(br, f.type, dictionaries, child_id(f), field_ids)

    if tid == dt.TypeId.EXTENSION:
        return ExtensionArray(t, load_array(br, t.storage_type,
                                            dictionaries, dict_id,
                                            field_ids))
    node = br.next_node()
    n, nc = node.length, node.null_count
    if tid == dt.TypeId.NULL:
        return null_array(n)
    if tid in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        type_ids = br.array(np.int8, n)
        offsets = br.array(np.int32, n) if tid == dt.TypeId.DENSE_UNION \
            else None
        kids = [child(f) for f in t.fields()]
        return UnionArray(t, type_ids, kids, offsets)
    if tid == dt.TypeId.RUN_END_ENCODED:
        ends, values = [child(f) for f in t.fields()]
        return RunEndEncodedArray(ends, values, n)
    if nc:
        mask = br.bits(n)
    else:
        br.next_buffer()
        mask = None
    if tid == dt.TypeId.BOOL:
        return HostArray(br.bits(n), mask, t)
    if tid == dt.TypeId.DICTIONARY:
        values = br.array(t.index_type.np_dtype, n)
        if dict_id not in dictionaries:
            raise ArrowInvalid(f"no dictionary with id {dict_id}")
        return HostArray(values, mask, t, dictionaries[dict_id])
    if tid == dt.TypeId.FIXED_SIZE_BINARY:
        rows = br.array(np.uint8, n * t.byte_width).reshape(n, t.byte_width)
        codes, dictionary = fixed_size_codes(
            torch.from_numpy(rows.copy()),
            None if mask is None else torch.from_numpy(mask))
        return HostArray(codes.numpy(), mask, t, dictionary)
    if t.limbs:
        w = t.bit_width // 8
        raw = br.next_buffer()
        if len(raw) < n * w:
            raise ArrowInvalid(f"buffer of {len(raw)} bytes for {n} {t}")
        rows = np.frombuffer(raw, np.uint8, n * w).reshape(n, w)
        if br.big:
            rows = np.ascontiguousarray(rows[:, ::-1])
        return HostArray(rows.view(np.int64).reshape(n, t.limbs), mask, t)
    if t.is_binary_like:
        if t.offset_dtype is None:
            if br.big:
                raise ArrowNotImplemented("endian swap of view buffers")
            views = br.array(np.uint8, n * 16)
            bufs = [br.next_buffer() for _ in range(br.next_variadic())]
            return coded_column(*_view_rows(views, bufs, n), mask, t)
        off = br.array(t.offset_dtype, n + 1).astype(np.int64)
        data = np.frombuffer(br.next_buffer(), np.uint8)
        if n and (off[0] < 0 or (np.diff(off) < 0).any()
                  or off[-1] > len(data)):
            raise ArrowInvalid("string offsets outside their data")
        return coded_column(off[1:] - off[0], data[off[0]:off[-1]] if n
                      else data[:0], mask, t)
    if t.np_dtype is not None:
        return HostArray(br.array(t.np_dtype, n), mask, t)
    if tid in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        offsets = br.array(t.offset_dtype, n)
        sizes = br.array(t.offset_dtype, n)
        return ListViewArray(t, mask, offsets, sizes, child(t.value_field))
    if tid in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST, dt.TypeId.MAP):
        offsets = br.array(t.offset_dtype, n + 1)
        kid = child(t.value_field)
        if n and (offsets[0] < 0 or (np.diff(offsets) < 0).any()
                  or offsets[-1] > len(kid)):
            raise ArrowInvalid("list offsets outside their child")
        return nested_array(t, n, mask, [kid], offsets)
    if tid == dt.TypeId.FIXED_SIZE_LIST:
        kid = child(t.value_field)
        if len(kid) < n * t.list_size:
            raise ArrowInvalid("fixed_size_list child shorter than its rows")
        return nested_array(t, n, mask, [kid])
    if tid == dt.TypeId.STRUCT:
        return nested_array(t, n, mask, [child(f) for f in t.fields()])
    raise ArrowNotImplemented(f"IPC load of {t}")


def compact(data):
    """An ArrayData rewritten at offset 0 with exactly sized buffers (its
    rows read out and laid out again, array/arrays.py)."""
    from ..array.arrays import array_data, make_array
    if data.offset == 0:
        return data
    return array_data(make_array(data))
