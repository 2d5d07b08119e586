"""The Arrow C data interface (reference arrow/cdata: cdata.go, abi.h,
trampoline.c): ArrowSchema, ArrowArray and ArrowArrayStream, the device
array and device stream, and the async device stream.

Port of arrow_go_tpu/cdata.py on ctypes (the JAX module uses cffi). The
structs have the ABI's layouts, so a struct the port fills is read by
any consumer (the JAX module, pyarrow) and the reverse. Export fills a
struct from HostArrays and keeps their buffers alive until the consumer
calls `release` (the base struct's: it drops them all; a child's only
marks itself released). Import copies out of the producer's memory into
HostArrays, then calls the array's `release`, as the JAX import does
(an imported schema stays the caller's to release). Every callback is a
module-level CFUNCTYPE object, so none is freed while a struct points
at it.

Layout of an exported column, under its field's type (array/layout.py,
shared with `Array.data` and `make_array`): a string, binary,
large_string or large_binary column (dictionary-coded in the port) as
offsets and data gathered by ipc/core's `_row_bytes`, a dictionary field
as its indices with its dictionary as a child array, decimal128 and
decimal256 as their limbs' little-endian bytes, unsigned types as their
raw bits, a list's offsets from 0 with its child cut to its rows; the
offset is always 0. The types the JAX export refuses (views, unions,
run_end_encoded, intervals, list views, extensions) raise
ArrowNotImplemented. On import a `u`, `z`, `U` or `Z` column becomes the
port's coded column (`coded_column`), a fixed_size_binary one codes over
its distinct rows, and an array with an offset (a slice) is cut to its
rows.

The device interface carries device_type ARROW_DEVICE_CPU with host
buffers, as in the JAX module; a non-CPU device_type is refused with
ArrowInvalid. The async stream pushes batches from a producer thread to
a consumer's ArrowAsyncDeviceStreamHandler, with request(n)
backpressure and cancel().
"""
from __future__ import annotations

import ctypes
import queue
import threading
from ctypes import (CFUNCTYPE, POINTER, Structure, c_char_p, c_int,
                    c_int32, c_int64, c_void_p)
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import dtypes as dt
from .array import layout
from .array.record import host_batch
from .compute.errors import ArrowInvalid, ArrowNotImplemented
from .device.block import HostArray, HostBatch, nested_array
from .ipc import _concat_batches


class ArrowSchema(Structure):
    pass


ArrowSchema._fields_ = [
    ("format", c_char_p), ("name", c_char_p), ("metadata", c_char_p),
    ("flags", c_int64), ("n_children", c_int64),
    ("children", POINTER(POINTER(ArrowSchema))),
    ("dictionary", POINTER(ArrowSchema)),
    ("release", CFUNCTYPE(None, POINTER(ArrowSchema))),
    ("private_data", c_void_p)]


class ArrowArray(Structure):
    pass


ArrowArray._fields_ = [
    ("length", c_int64), ("null_count", c_int64), ("offset", c_int64),
    ("n_buffers", c_int64), ("n_children", c_int64),
    ("buffers", POINTER(c_void_p)),
    ("children", POINTER(POINTER(ArrowArray))),
    ("dictionary", POINTER(ArrowArray)),
    ("release", CFUNCTYPE(None, POINTER(ArrowArray))),
    ("private_data", c_void_p)]


class ArrowArrayStream(Structure):
    pass


# get_last_error returns a `const char*`, declared c_void_p: a callback
# returns the address of a buffer it keeps
ArrowArrayStream._fields_ = [
    ("get_schema", CFUNCTYPE(c_int, POINTER(ArrowArrayStream),
                             POINTER(ArrowSchema))),
    ("get_next", CFUNCTYPE(c_int, POINTER(ArrowArrayStream),
                           POINTER(ArrowArray))),
    ("get_last_error", CFUNCTYPE(c_void_p, POINTER(ArrowArrayStream))),
    ("release", CFUNCTYPE(None, POINTER(ArrowArrayStream))),
    ("private_data", c_void_p)]


class ArrowDeviceArray(Structure):
    _fields_ = [("array", ArrowArray), ("device_id", c_int64),
                ("device_type", c_int32), ("sync_event", c_void_p),
                ("reserved", c_int64 * 3)]


class ArrowDeviceArrayStream(Structure):
    pass


ArrowDeviceArrayStream._fields_ = [
    ("device_type", c_int32),
    ("get_schema", CFUNCTYPE(c_int, POINTER(ArrowDeviceArrayStream),
                             POINTER(ArrowSchema))),
    ("get_next", CFUNCTYPE(c_int, POINTER(ArrowDeviceArrayStream),
                           POINTER(ArrowDeviceArray))),
    ("get_last_error", CFUNCTYPE(c_void_p,
                                 POINTER(ArrowDeviceArrayStream))),
    ("release", CFUNCTYPE(None, POINTER(ArrowDeviceArrayStream))),
    ("private_data", c_void_p)]


class ArrowAsyncTask(Structure):
    pass


ArrowAsyncTask._fields_ = [
    ("extract_data", CFUNCTYPE(c_int, POINTER(ArrowAsyncTask),
                               POINTER(ArrowDeviceArray))),
    ("private_data", c_void_p)]


class ArrowAsyncProducer(Structure):
    pass


ArrowAsyncProducer._fields_ = [
    ("device_type", c_int32),
    ("request", CFUNCTYPE(None, POINTER(ArrowAsyncProducer), c_int64)),
    ("cancel", CFUNCTYPE(None, POINTER(ArrowAsyncProducer))),
    ("release", CFUNCTYPE(None, POINTER(ArrowAsyncProducer))),
    ("additional_metadata", c_char_p),
    ("private_data", c_void_p)]


class ArrowAsyncDeviceStreamHandler(Structure):
    pass


ArrowAsyncDeviceStreamHandler._fields_ = [
    ("on_schema", CFUNCTYPE(c_int, POINTER(ArrowAsyncDeviceStreamHandler),
                            POINTER(ArrowSchema))),
    ("on_next_task", CFUNCTYPE(c_int,
                               POINTER(ArrowAsyncDeviceStreamHandler),
                               POINTER(ArrowAsyncTask), c_char_p)),
    ("on_error", CFUNCTYPE(None, POINTER(ArrowAsyncDeviceStreamHandler),
                           c_int, c_char_p, c_char_p)),
    ("release", CFUNCTYPE(None, POINTER(ArrowAsyncDeviceStreamHandler))),
    ("producer", POINTER(ArrowAsyncProducer)),
    ("private_data", c_void_p)]



def _ctype(struct, name: str):
    """The C type of field `name` of a struct (a callback's CFUNCTYPE)."""
    return dict(struct._fields_)[name]


ARROW_DEVICE_CPU = 1  # ArrowDeviceType kDLCPU

ARROW_FLAG_NULLABLE = 2

# format strings of the C data interface
_FMT = {
    dt.TypeId.NULL: "n", dt.TypeId.BOOL: "b",
    dt.TypeId.INT8: "c", dt.TypeId.UINT8: "C",
    dt.TypeId.INT16: "s", dt.TypeId.UINT16: "S",
    dt.TypeId.INT32: "i", dt.TypeId.UINT32: "I",
    dt.TypeId.INT64: "l", dt.TypeId.UINT64: "L",
    dt.TypeId.FLOAT16: "e", dt.TypeId.FLOAT32: "f", dt.TypeId.FLOAT64: "g",
    dt.TypeId.STRING: "u", dt.TypeId.BINARY: "z",
    dt.TypeId.LARGE_STRING: "U", dt.TypeId.LARGE_BINARY: "Z",
    dt.TypeId.DATE32: "tdD", dt.TypeId.DATE64: "tdm",
}

_FMT_TYPE = {
    "n": dt.null, "b": dt.bool_, "c": dt.int8, "C": dt.uint8,
    "s": dt.int16, "S": dt.uint16, "i": dt.int32, "I": dt.uint32,
    "l": dt.int64, "L": dt.uint64, "e": dt.float16, "f": dt.float32,
    "g": dt.float64, "u": dt.string, "z": dt.binary,
    "U": dt.large_string, "Z": dt.large_binary, "tdD": dt.date32,
    "tdm": dt.date64,
}

_UNIT_CHAR = {0: "s", 1: "m", 2: "u", 3: "n"}
_CHAR_UNIT = {"s": "s", "m": "ms", "u": "us", "n": "ns"}


def _format_for(t: dt.DataType) -> str:
    if t.id in _FMT:
        return _FMT[t.id]
    if t.id == dt.TypeId.TIMESTAMP:
        return f"ts{_UNIT_CHAR[int(t.unit)]}:{t.tz or ''}"
    if t.id == dt.TypeId.TIME32:
        return "tts" if t.unit == dt.TimeUnit.SECOND else "ttm"
    if t.id == dt.TypeId.TIME64:
        return "ttu" if t.unit == dt.TimeUnit.MICROSECOND else "ttn"
    if t.id == dt.TypeId.DURATION:
        return f"tD{_UNIT_CHAR[int(t.unit)]}"
    if t.is_decimal:
        if t.bit_width == 128:
            return f"d:{t.precision},{t.scale}"
        return f"d:{t.precision},{t.scale},{t.bit_width}"
    if t.id == dt.TypeId.FIXED_SIZE_BINARY:
        return f"w:{t.byte_width}"
    if t.id == dt.TypeId.LIST:
        return "+l"
    if t.id == dt.TypeId.LARGE_LIST:
        return "+L"
    if t.id == dt.TypeId.FIXED_SIZE_LIST:
        return f"+w:{t.list_size}"
    if t.id == dt.TypeId.STRUCT:
        return "+s"
    if t.id == dt.TypeId.MAP:
        return "+m"
    if t.id == dt.TypeId.DICTIONARY:
        return _format_for(t.index_type)
    raise ArrowNotImplemented(f"cdata export of {t}")


def _type_for(fmt: str, children: List[dt.Field],
              dictionary: Optional[dt.DataType]) -> dt.DataType:
    if dictionary is not None:
        return dt.dictionary(_type_for(fmt, [], None), dictionary)
    if fmt in _FMT_TYPE:
        return _FMT_TYPE[fmt]
    if fmt.startswith("ts"):
        tz = fmt.split(":", 1)[1] if ":" in fmt else ""
        return dt.timestamp(_CHAR_UNIT[fmt[2]], tz or None)
    if fmt.startswith("tt"):
        return {"s": dt.time32("s"), "m": dt.time32("ms"),
                "u": dt.time64("us"), "n": dt.time64("ns")}[fmt[2]]
    if fmt.startswith("tD"):
        return dt.duration(_CHAR_UNIT[fmt[2]])
    if fmt.startswith("d:"):
        parts = fmt[2:].split(",")
        bw = int(parts[2]) if len(parts) > 2 else 128
        return {32: dt.decimal32, 64: dt.decimal64, 128: dt.decimal128,
                256: dt.decimal256}[bw](int(parts[0]), int(parts[1]))
    if fmt.startswith("w:"):
        return dt.fixed_size_binary(int(fmt[2:]))
    if fmt == "+l":
        return dt.list_(children[0])
    if fmt == "+L":
        return dt.large_list(children[0])
    if fmt.startswith("+w:"):
        return dt.fixed_size_list(children[0], int(fmt[3:]))
    if fmt == "+s":
        return dt.struct(children)
    if fmt == "+m":
        entries = children[0].type
        return dt.map_(entries.field(0).type, entries.field(1).type)
    raise ArrowNotImplemented(f"cdata import of format {fmt!r}")


class _Keepalive:
    """Pins exported Python objects until their release() is called."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[int, list] = {}
        self._next = 1

    def add(self, objs: list) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._live[h] = objs
            return h

    def drop(self, h: int) -> None:
        with self._lock:
            self._live.pop(h, None)


_keep = _Keepalive()
_handles = iter(range(1, 1 << 62))      # stream, producer and task ids


def _as(p, cls):
    """The struct of type `cls` at `p`: an address, a ctypes pointer or
    the struct itself."""
    if isinstance(p, int):
        return cls.from_address(p)
    if isinstance(p, ctypes._Pointer):
        return p.contents
    return p


def _handle(c) -> int:
    return c.private_data or 0


@_ctype(ArrowSchema, "release")
def _release_schema(ptr):
    c = ptr.contents
    _keep.drop(_handle(c))
    c.release = _NO_SCHEMA_RELEASE


@_ctype(ArrowSchema, "release")
def _release_child_schema(ptr):
    ptr.contents.release = _NO_SCHEMA_RELEASE


@_ctype(ArrowArray, "release")
def _release_array(ptr):
    c = ptr.contents
    _keep.drop(_handle(c))
    c.release = _NO_ARRAY_RELEASE


@_ctype(ArrowArray, "release")
def _release_child_array(ptr):
    ptr.contents.release = _NO_ARRAY_RELEASE


_NO_SCHEMA_RELEASE = _ctype(ArrowSchema, "release")()     # NULL
_NO_ARRAY_RELEASE = _ctype(ArrowArray, "release")()


def _cstr(s: str, keep: list):
    buf = ctypes.create_string_buffer(s.encode())
    keep.append(buf)
    return ctypes.cast(buf, c_char_p)


def _fill_schema(c: ArrowSchema, field: dt.Field, keep: list) -> None:
    t = field.type
    c.format = _cstr(_format_for(t), keep)
    c.name = _cstr(field.name, keep)
    c.metadata = None
    c.flags = ARROW_FLAG_NULLABLE if field.nullable else 0
    fields = [] if t.id == dt.TypeId.DICTIONARY else t.fields()
    c.n_children = len(fields)
    if fields:
        arr = (POINTER(ArrowSchema) * len(fields))()
        keep.append(arr)
        for i, f in enumerate(fields):
            child = ArrowSchema()
            keep.append(child)
            _fill_schema(child, f, keep)
            child.release = _release_child_schema
            arr[i] = ctypes.pointer(child)
        c.children = arr
    else:
        c.children = None
    if t.id == dt.TypeId.DICTIONARY:
        d = ArrowSchema()
        keep.append(d)
        _fill_schema(d, dt.Field("", t.value_type, True), keep)
        d.release = _release_child_schema
        c.dictionary = ctypes.pointer(d)
    else:
        c.dictionary = None
    c.private_data = None


def export_schema(field: dt.Field, out_ptr) -> None:
    """Fill the ArrowSchema at `out_ptr` (an address or a ctypes
    pointer) with `field`; a struct type's children are its fields."""
    c = _as(out_ptr, ArrowSchema)
    keep: list = []
    _fill_schema(c, field, keep)
    c.private_data = _keep.add(keep)
    c.release = _release_schema


def _struct_field(schema: dt.Schema) -> dt.Field:
    """A batch's schema as the C stream's top-level struct field."""
    return dt.Field("", dt.struct([dt.Field(f.name, f.type, f.nullable)
                                   for f in schema.fields]), False)


# ---------------------------------------------------------------------------
# export of HostArrays
# ---------------------------------------------------------------------------

def _buffer(a, keep: list) -> int:
    """The address of a buffer holding `a`'s bytes (bytes-like or numpy),
    kept; an empty buffer gets 8 zero bytes, never NULL."""
    a = np.ascontiguousarray(np.frombuffer(a, np.uint8)
                             if not isinstance(a, np.ndarray) else a)
    if not a.nbytes:
        a = np.zeros(8, np.uint8)
    keep.append(a)
    return a.ctypes.data


_REFUSED = (dt.TypeId.STRING_VIEW, dt.TypeId.BINARY_VIEW,
            dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW,
            dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION,
            dt.TypeId.RUN_END_ENCODED, dt.TypeId.EXTENSION,
            dt.TypeId.INTERVAL_MONTHS)


def _refuse(t: dt.DataType, what: str) -> None:
    """The types the JAX module's C data interface refuses (views,
    unions, run_end_encoded, intervals, list views, extensions), at any
    depth, raise ArrowNotImplemented."""
    if t.id in _REFUSED or (t.np_dtype is not None and t.np_dtype.names):
        raise ArrowNotImplemented(f"cdata {what} of {t}")
    for f in t.fields():
        _refuse(f.type, what)
    if t.id == dt.TypeId.DICTIONARY:
        _refuse(t.value_type, what)


def _fill_array(c: ArrowArray, arr: HostArray, t: dt.DataType,
                keep: list) -> None:
    bufs, kids = layout.column_buffers(arr, t)
    n = len(arr)
    c.length = n
    c.offset = 0
    c.null_count = layout.null_count(arr, t)
    c.n_buffers = len(bufs)
    if bufs:
        barr = (c_void_p * len(bufs))(*[
            None if b is None else _buffer(b, keep) for b in bufs])
        keep.append(barr)
        c.buffers = barr
    else:
        c.buffers = None
    c.n_children = len(kids)
    if kids:
        carr = (POINTER(ArrowArray) * len(kids))()
        keep.append(carr)
        for i, (ct, ca) in enumerate(kids):
            child = ArrowArray()
            keep.append(child)
            _fill_array(child, ca, ct, keep)
            child.release = _release_child_array
            carr[i] = ctypes.pointer(child)
        c.children = carr
    else:
        c.children = None
    if t.id == dt.TypeId.DICTIONARY:
        d = ArrowArray()
        keep.append(d)
        _fill_array(d, layout.dictionary_column(arr, t), t.value_type, keep)
        d.release = _release_child_array
        c.dictionary = ctypes.pointer(d)
    else:
        c.dictionary = None
    c.private_data = None


def _export_into(c: ArrowArray, arr: HostArray, t: dt.DataType) -> None:
    _refuse(t, "export")
    keep: list = []
    _fill_array(c, arr, t, keep)
    c.private_data = _keep.add(keep)
    c.release = _release_array


def export_array(arr: HostArray, out_array_ptr, out_schema_ptr=None,
                 field_type: Optional[dt.DataType] = None) -> None:
    """Fill the ArrowArray at `out_array_ptr` (and the ArrowSchema at
    `out_schema_ptr`, a nullable field named "") with `arr` under
    `field_type` (by default the HostArray's type)."""
    t = field_type or arr.type
    _export_into(_as(out_array_ptr, ArrowArray), arr, t)
    if out_schema_ptr is not None:
        export_schema(dt.Field("", t, True), out_schema_ptr)


def _batch_struct(hb: HostBatch) -> HostArray:
    """A HostBatch as the C stream's top-level struct column."""
    return nested_array(_struct_field(hb.schema).type, hb.num_rows, None,
                        hb.columns)


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

def import_field(schema_ptr) -> dt.Field:
    """The field an ArrowSchema describes (not released: the caller
    releases it, as in the JAX module)."""
    c = _as(schema_ptr, ArrowSchema)
    fmt = c.format.decode()
    name = c.name.decode() if c.name is not None else ""
    children = [import_field(c.children[i]) for i in range(c.n_children)]
    dict_t = import_field(c.dictionary).type if c.dictionary else None
    return dt.Field(name, _type_for(fmt, children, dict_t),
                    bool(c.flags & ARROW_FLAG_NULLABLE))


def _copy(ptr: Optional[int], nbytes: int) -> np.ndarray:
    """`nbytes` bytes at `ptr` copied into a numpy uint8 array."""
    if not ptr or nbytes <= 0:
        return np.zeros(0, np.uint8)
    return np.frombuffer((ctypes.c_char * nbytes).from_address(ptr),
                         np.uint8).copy()


def _import_column(c: ArrowArray, t: dt.DataType) -> HostArray:
    """The HostArray of an ArrowArray of field type `t`, copied out and
    cut to rows [offset, offset + length) (array/layout.py)."""
    _refuse(t, "import")
    ptrs = [c.buffers[i] for i in range(c.n_buffers)] if c.buffers else []

    def reader(ptr):
        return None if not ptr else (lambda nbytes: _copy(ptr, nbytes))

    return layout.import_column(
        t, c.length, c.offset, c.null_count, [reader(p) for p in ptrs],
        lambda i, ct: _import_column(c.children[i].contents, ct),
        lambda: _import_column(c.dictionary.contents, t.value_type))


def _import_and_release(c: ArrowArray, t: dt.DataType) -> HostArray:
    out = _import_column(c, t)
    if c.release:
        c.release(ctypes.pointer(c))
    return out


def import_array(array_ptr, schema_or_type) -> HostArray:
    """The HostArray of an ArrowArray (copied out; the array released)
    under an ArrowSchema, a Field or a DataType."""
    if isinstance(schema_or_type, dt.DataType):
        t = schema_or_type
    elif isinstance(schema_or_type, dt.Field):
        t = schema_or_type.type
    else:
        t = import_field(schema_or_type).type
    return _import_and_release(_as(array_ptr, ArrowArray), t)


def _batch_of(col: HostArray, schema: dt.Schema) -> HostBatch:
    return HostBatch(schema, col.children, len(col))


def _schema_of(f: dt.Field) -> dt.Schema:
    return dt.Schema([dt.Field(cf.name, cf.type, cf.nullable)
                      for cf in f.type.fields()])


def schema_handles() -> Tuple[int, int]:
    """Allocate an ArrowSchema and an ArrowArray; their addresses."""
    s, a = ArrowSchema(), ArrowArray()
    _keep.add([s, a])
    return ctypes.addressof(s), ctypes.addressof(a)


# ---------------------------------------------------------------------------
# ArrowArrayStream (reference abi.h + cdata.go ImportCRecordBatchStream /
# ExportRecordBatchReader)
# ---------------------------------------------------------------------------

class _StreamState:
    __slots__ = ("schema", "it", "error")

    def __init__(self, schema: dt.Schema, it):
        self.schema = schema
        self.it = it
        self.error = None


_streams: Dict[int, _StreamState] = {}
_device_streams: Dict[int, _StreamState] = {}


def _source(source) -> Tuple[dt.Schema, object]:
    """(schema, iterator of HostBatches) of a HostBatch, a (schema,
    iterable) pair, or anything with `.schema` that iterates HostBatches
    (a stream reader); a Table is its combined chunks."""
    source = host_batch(source)
    if isinstance(source, HostBatch):
        return source.schema, iter([source])
    if isinstance(source, tuple):
        return source[0], iter(source[1])
    return source.schema, iter(source)


def _error(st: _StreamState, e: Exception) -> int:
    st.error = ctypes.create_string_buffer(str(e).encode())
    return 5  # EIO


def _get_schema(states, ptr, out) -> int:
    st = states.get(_handle(ptr.contents))
    if st is None:
        return 22  # EINVAL
    try:
        export_schema(_struct_field(st.schema), out)
        return 0
    except Exception as e:  # noqa: BLE001 - must not unwind into C
        return _error(st, e)


def _next_into(st: _StreamState, out: ArrowArray) -> int:
    try:
        hb = next(st.it, None)
        if hb is None:
            out.release = _NO_ARRAY_RELEASE     # the end of the stream
            return 0
        _export_into(out, _batch_struct(hb), _struct_field(st.schema).type)
        return 0
    except Exception as e:  # noqa: BLE001
        return _error(st, e)


def _last_error(states, ptr):
    st = states.get(_handle(ptr.contents))
    if st is None or st.error is None:
        return None
    return ctypes.addressof(st.error)


@_ctype(ArrowArrayStream, "get_schema")
def _stream_get_schema(ptr, out):
    return _get_schema(_streams, ptr, out)


@_ctype(ArrowArrayStream, "get_next")
def _stream_get_next(ptr, out):
    st = _streams.get(_handle(ptr.contents))
    return 22 if st is None else _next_into(st, out.contents)


@_ctype(ArrowArrayStream, "get_last_error")
def _stream_get_last_error(ptr):
    return _last_error(_streams, ptr)


@_ctype(ArrowArrayStream, "release")
def _stream_release(ptr):
    _streams.pop(_handle(ptr.contents), None)
    ptr.contents.release = _ctype(ArrowArrayStream, "release")()


def export_stream(source, out_stream_ptr) -> None:
    """Export HostBatches as an ArrowArrayStream: `source` is a
    HostBatch, a (schema, iterable of HostBatches) pair, or anything
    with `.schema` that iterates HostBatches."""
    schema, it = _source(source)
    c = _as(out_stream_ptr, ArrowArrayStream)
    h = next(_handles)
    _streams[h] = _StreamState(schema, it)
    c.private_data = h
    c.get_schema = _stream_get_schema
    c.get_next = _stream_get_next
    c.get_last_error = _stream_get_last_error
    c.release = _stream_release


class RecordBatchStreamReader:
    """Pull-based consumer of a foreign ArrowArrayStream: each batch
    copied out into a HostBatch, its array released; the stream released
    at its end."""

    def __init__(self, stream_ptr):
        self._c = _as(stream_ptr, ArrowArrayStream)
        s = ArrowSchema()
        rc = self._c.get_schema(ctypes.pointer(self._c), ctypes.pointer(s))
        if rc != 0:
            raise ArrowInvalid(f"get_schema failed: {self._last_error(rc)}")
        f = import_field(s)
        if s.release:
            s.release(ctypes.pointer(s))
        self.schema = _schema_of(f)
        self._struct_type = f.type
        self._done = False

    def _last_error(self, rc: int) -> str:
        if self._c.get_last_error:
            e = self._c.get_last_error(ctypes.pointer(self._c))
            if e:
                return ctypes.string_at(e).decode(errors="replace")
        return f"errno {rc}"

    def read_next_batch(self) -> Optional[HostBatch]:
        if self._done:
            return None
        a = ArrowArray()
        rc = self._c.get_next(ctypes.pointer(self._c), ctypes.pointer(a))
        if rc != 0:
            raise ArrowInvalid(f"get_next failed: {self._last_error(rc)}")
        if not a.release:                 # the end of the stream
            self._done = True
            if self._c.release:
                self._c.release(ctypes.pointer(self._c))
            return None
        return _batch_of(_import_and_release(a, self._struct_type),
                         self.schema)

    def __iter__(self):
        while True:
            hb = self.read_next_batch()
            if hb is None:
                return
            yield hb

    def read_all(self) -> HostBatch:
        """Every remaining batch's rows in one HostBatch."""
        return _concat_batches(self.schema, list(self))


def import_stream(stream_ptr) -> RecordBatchStreamReader:
    """A reader of the ArrowArrayStream at `stream_ptr`."""
    return RecordBatchStreamReader(stream_ptr)


def stream_handle() -> int:
    """Allocate an ArrowArrayStream; its address."""
    s = ArrowArrayStream()
    _keep.add([s])
    return ctypes.addressof(s)


# ---------------------------------------------------------------------------
# the device data interface: ArrowDeviceArray / ArrowDeviceArrayStream
# (reference abi.h + cdata.go ExportArrowDeviceArray /
# ImportCDeviceRecordBatch), device_type CPU with host buffers
# ---------------------------------------------------------------------------

def _cpu_device(d) -> None:
    d.device_id = -1
    d.device_type = ARROW_DEVICE_CPU
    d.sync_event = None


def export_device_array(arr: HostArray, out_device_ptr, out_schema_ptr=None,
                        field_type: Optional[dt.DataType] = None) -> None:
    """export_array into an ArrowDeviceArray of device_type CPU."""
    c = _as(out_device_ptr, ArrowDeviceArray)
    export_array(arr, ctypes.addressof(c.array), out_schema_ptr, field_type)
    _cpu_device(c)


def _refuse_device(device_type: int, what: str) -> None:
    if device_type not in (0, ARROW_DEVICE_CPU):
        raise ArrowInvalid(f"cannot import non-CPU device {what} "
                           f"(device_type {device_type}) without a sync "
                           f"bridge")


def import_device_array(device_ptr, schema_or_type) -> HostArray:
    """import_array of an ArrowDeviceArray; a device_type other than CPU
    raises ArrowInvalid."""
    c = _as(device_ptr, ArrowDeviceArray)
    _refuse_device(c.device_type, "array")
    return import_array(ctypes.addressof(c.array), schema_or_type)


def device_array_handle() -> int:
    """Allocate an ArrowDeviceArray; its address."""
    d = ArrowDeviceArray()
    _keep.add([d])
    return ctypes.addressof(d)


@_ctype(ArrowDeviceArrayStream, "get_schema")
def _dstream_get_schema(ptr, out):
    return _get_schema(_device_streams, ptr, out)


@_ctype(ArrowDeviceArrayStream, "get_next")
def _dstream_get_next(ptr, out):
    st = _device_streams.get(_handle(ptr.contents))
    if st is None:
        return 22
    d = out.contents
    rc = _next_into(st, d.array)
    if rc == 0 and d.array.release:
        _cpu_device(d)
    return rc


@_ctype(ArrowDeviceArrayStream, "get_last_error")
def _dstream_get_last_error(ptr):
    return _last_error(_device_streams, ptr)


@_ctype(ArrowDeviceArrayStream, "release")
def _dstream_release(ptr):
    _device_streams.pop(_handle(ptr.contents), None)
    ptr.contents.release = _ctype(ArrowDeviceArrayStream, "release")()


def export_device_stream(source, out_stream_ptr) -> None:
    """export_stream as an ArrowDeviceArrayStream of device_type CPU."""
    schema, it = _source(source)
    c = _as(out_stream_ptr, ArrowDeviceArrayStream)
    h = next(_handles)
    _device_streams[h] = _StreamState(schema, it)
    c.private_data = h
    c.device_type = ARROW_DEVICE_CPU
    c.get_schema = _dstream_get_schema
    c.get_next = _dstream_get_next
    c.get_last_error = _dstream_get_last_error
    c.release = _dstream_release


class DeviceRecordBatchStreamReader:
    """Pull-based consumer of a foreign ArrowDeviceArrayStream of
    device_type CPU."""

    def __init__(self, stream_ptr):
        self._c = _as(stream_ptr, ArrowDeviceArrayStream)
        _refuse_device(self._c.device_type, "stream")
        s = ArrowSchema()
        if self._c.get_schema(ctypes.pointer(self._c),
                              ctypes.pointer(s)) != 0:
            raise ArrowInvalid("get_schema failed")
        f = import_field(s)
        if s.release:
            s.release(ctypes.pointer(s))
        self.schema = _schema_of(f)
        self._struct_type = f.type
        self._done = False

    def read_next_batch(self) -> Optional[HostBatch]:
        if self._done:
            return None
        d = ArrowDeviceArray()
        if self._c.get_next(ctypes.pointer(self._c), ctypes.pointer(d)) != 0:
            raise ArrowInvalid("get_next failed")
        if not d.array.release:
            self._done = True
            if self._c.release:
                self._c.release(ctypes.pointer(self._c))
            return None
        return _batch_of(_import_and_release(d.array, self._struct_type),
                         self.schema)

    def __iter__(self):
        while True:
            hb = self.read_next_batch()
            if hb is None:
                return
            yield hb

    def read_all(self) -> HostBatch:
        return _concat_batches(self.schema, list(self))


def import_device_stream(stream_ptr) -> DeviceRecordBatchStreamReader:
    return DeviceRecordBatchStreamReader(stream_ptr)


def device_stream_handle() -> int:
    """Allocate an ArrowDeviceArrayStream; its address."""
    s = ArrowDeviceArrayStream()
    _keep.add([s])
    return ctypes.addressof(s)


# ---------------------------------------------------------------------------
# the async device stream (reference cdata/interface.go:300-360
# ExportAsyncRecordBatchStream / CreateAsyncDeviceStreamHandler): a push
# producer drives a consumer's ArrowAsyncDeviceStreamHandler, paced by
# ArrowAsyncProducer.request(n)
# ---------------------------------------------------------------------------

class _AsyncProducerState:
    __slots__ = ("schema", "it", "permits", "cancelled", "cv")

    def __init__(self, schema, it):
        self.schema = schema
        self.it = it
        self.permits = 0
        self.cancelled = False
        self.cv = threading.Condition(threading.Lock())


_async_producers: Dict[int, _AsyncProducerState] = {}
_async_tasks: Dict[int, HostBatch] = {}


@_ctype(ArrowAsyncProducer, "request")
def _aprod_request(ptr, n):
    st = _async_producers.get(_handle(ptr.contents))
    if st is None:
        return
    with st.cv:
        st.permits += int(n)
        st.cv.notify_all()


@_ctype(ArrowAsyncProducer, "cancel")
def _aprod_cancel(ptr):
    st = _async_producers.get(_handle(ptr.contents))
    if st is None:
        return
    with st.cv:
        st.cancelled = True
        st.cv.notify_all()


@_ctype(ArrowAsyncProducer, "release")
def _aprod_release(ptr):
    _async_producers.pop(_handle(ptr.contents), None)


@_ctype(ArrowAsyncTask, "extract_data")
def _atask_extract(task, out):
    hb = _async_tasks.pop(_handle(task.contents), None)
    if hb is None:
        return 22
    d = out.contents
    _export_into(d.array, _batch_struct(hb), _struct_field(hb.schema).type)
    _cpu_device(d)
    return 0


def export_async_stream(source, handler_ptr) -> None:
    """Drive the consumer's ArrowAsyncDeviceStreamHandler at
    `handler_ptr` with `source` (as export_stream takes it) from a daemon
    thread: on_schema, then one on_next_task a batch as request(n)
    permits, a NULL task at the end, on_error on a failure; cancel()
    stops it, and the handler is released last."""
    schema, it = _source(source)
    handler = _as(handler_ptr, ArrowAsyncDeviceStreamHandler)
    hp = ctypes.pointer(handler)
    st = _AsyncProducerState(schema, it)
    h = next(_handles)
    _async_producers[h] = st
    producer = ArrowAsyncProducer()
    _keep.add([producer])
    producer.device_type = ARROW_DEVICE_CPU
    producer.request = _aprod_request
    producer.cancel = _aprod_cancel
    producer.release = _aprod_release
    producer.additional_metadata = None
    producer.private_data = h
    handler.producer = ctypes.pointer(producer)

    def pump():
        try:
            s = ArrowSchema()
            export_schema(_struct_field(st.schema), ctypes.pointer(s))
            if handler.on_schema(hp, ctypes.pointer(s)) != 0:
                return
            while True:
                with st.cv:
                    while st.permits <= 0 and not st.cancelled:
                        st.cv.wait(timeout=30)
                    if st.cancelled:
                        break
                    st.permits -= 1
                hb = next(st.it, None)
                if hb is None:
                    # the end of the stream: on_next_task with NULL
                    handler.on_next_task(hp, None, None)
                    break
                th = next(_handles)
                _async_tasks[th] = hb
                task = ArrowAsyncTask()
                _keep.add([task])
                task.extract_data = _atask_extract
                task.private_data = th
                if handler.on_next_task(hp, ctypes.pointer(task), None) != 0:
                    break
        except Exception as e:  # noqa: BLE001 - must not unwind into C
            handler.on_error(hp, 5, str(e).encode(), None)
        finally:
            if handler.release:
                handler.release(hp)

    threading.Thread(target=pump, daemon=True).start()


class AsyncRecordBatchStream:
    """The consumer side (reference cdata CreateAsyncDeviceStreamHandler
    + AsyncRecordBatchStream): an ArrowAsyncDeviceStreamHandler whose
    callbacks feed this object. Iterate to receive HostBatches; the
    producer is asked for `queue_size` batches ahead."""

    def __init__(self, queue_size: int = 4):
        self._q: "queue.Queue" = queue.Queue()
        self.schema: Optional[dt.Schema] = None
        self._struct_type = None
        self._schema_ready = threading.Event()
        self.error: Optional[str] = None
        self._queue_size = queue_size
        self._handler = ArrowAsyncDeviceStreamHandler()
        h = next(_handles)
        _async_handlers[h] = self
        self._handler.private_data = h
        self._handler.on_schema = _ahandler_on_schema
        self._handler.on_next_task = _ahandler_on_next_task
        self._handler.on_error = _ahandler_on_error
        self._handler.release = _ahandler_release
        self._handler.producer = None

    @property
    def handler_ptr(self) -> int:
        return ctypes.addressof(self._handler)

    def __iter__(self):
        self._schema_ready.wait(timeout=30)
        if self.error:
            raise ArrowInvalid(self.error)
        while True:
            item = self._q.get()
            if item is None:
                if self.error:
                    raise ArrowInvalid(self.error)
                return
            # ask for one more as each is taken (steady backpressure)
            p = self._handler.producer
            if p:
                p.contents.request(p, 1)
            yield item

    def read_all(self) -> HostBatch:
        batches = list(self)
        return _concat_batches(self.schema, batches)


_async_handlers: Dict[int, AsyncRecordBatchStream] = {}


def _ahandler(ptr) -> Optional[AsyncRecordBatchStream]:
    return _async_handlers.get(_handle(ptr.contents))


@_ctype(ArrowAsyncDeviceStreamHandler, "on_schema")
def _ahandler_on_schema(ptr, s):
    self = _ahandler(ptr)
    if self is None:
        return 22
    try:
        f = import_field(s)
        if s.contents.release:
            s.contents.release(s)
        self._struct_type = f.type
        self.schema = _schema_of(f)
        self._schema_ready.set()
        p = ptr.contents.producer
        if p:                                    # the first request window
            p.contents.request(p, self._queue_size)
        return 0
    except Exception as e:  # noqa: BLE001
        self.error = str(e)
        self._schema_ready.set()
        return 5


@_ctype(ArrowAsyncDeviceStreamHandler, "on_next_task")
def _ahandler_on_next_task(ptr, task, metadata):
    self = _ahandler(ptr)
    if self is None:
        return 22
    try:
        if not task:                             # the end of the stream
            self._q.put(None)
            return 0
        d = ArrowDeviceArray()
        rc = task.contents.extract_data(task, ctypes.pointer(d))
        if rc != 0:
            self.error = f"extract_data failed ({rc})"
            self._q.put(None)
            return rc
        self._q.put(_batch_of(_import_and_release(d.array,
                                                  self._struct_type),
                              self.schema))
        return 0
    except Exception as e:  # noqa: BLE001
        self.error = str(e)
        self._q.put(None)
        return 5


@_ctype(ArrowAsyncDeviceStreamHandler, "on_error")
def _ahandler_on_error(ptr, code, message, metadata):
    self = _ahandler(ptr)
    if self is None:
        return
    self.error = message.decode(errors="replace") if message \
        else f"errno {code}"
    self._schema_ready.set()
    self._q.put(None)


@_ctype(ArrowAsyncDeviceStreamHandler, "release")
def _ahandler_release(ptr):
    _async_handlers.pop(_handle(ptr.contents), None)
