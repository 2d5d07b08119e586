"""Interop with pyarrow (after arrow_go_tpu/interop/pyarrow_interop.py):
types, schemas, HostArrays, and HostBatches as record batches and
tables, to and from pyarrow, under the JAX module's names.

pyarrow is imported at a function's first call (`_pa`), never with the
module; without it that call raises ImportError("pyarrow not
available"), as the JAX module's `_require_pa` does.

The types the C data interface carries (cdata.py: the primitive,
temporal, decimal, binary-like, fixed_size_binary, dictionary, list,
large_list, fixed_size_list, struct and map columns, nested in any
depth) cross by cdata.export_array into `pa.Array._import_from_c` and by
`pa.Array._export_to_c` into cdata.import_array. The others are built
on each side from the layout: the null column, month_day_nano values as
their 16-byte records, list views from offsets, sizes and child, run-end
encoding from its two children, unions from type codes (a dense one's
offsets) and children; string_view and binary_view (coded in the port)
go as Python values, as the JAX module sends them; a dictionary column
the C data path does not carry goes as its indices and its dictionary.
A HostArray goes as its type unless `type=` names another.

The JAX module's refusals and losses are kept: month and day-time
intervals and extension types raise NotImplementedError, large_list and
large_list_view lose their value field's name on the way to pyarrow, a
union's fields come back nullable and `schema_from_pyarrow` drops field
metadata. Where the JAX module fails, the port does not (ROADMAP §3): a
null column and a union reach pyarrow, and a sliced struct or union
comes back with its own rows.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .. import cdata
from .. import dtypes as dt
from ..array.record import ChunkedArray, host_batch
from ..device.block import (HostArray, HostBatch, ListViewArray,
                            RunEndEncodedArray, UnionArray,
                            concat_host_arrays, from_pylist, null_array)

_T = dt.TypeId
# field types built from their layout on each side, not through cdata
_BY_LAYOUT = (_T.NULL, _T.STRING_VIEW, _T.BINARY_VIEW, _T.LIST_VIEW,
              _T.LARGE_LIST_VIEW, _T.SPARSE_UNION, _T.DENSE_UNION,
              _T.RUN_END_ENCODED, _T.INTERVAL_MONTH_DAY_NANO)


def _pa():
    try:
        import pyarrow
    except ImportError:
        raise ImportError("pyarrow not available") from None
    return pyarrow


# -- type mapping -----------------------------------------------------------

def type_to_pyarrow(t: dt.DataType):
    pa = _pa()
    tid = t.id
    simple = {
        _T.NULL: pa.null(), _T.BOOL: pa.bool_(), _T.INT8: pa.int8(),
        _T.INT16: pa.int16(), _T.INT32: pa.int32(), _T.INT64: pa.int64(),
        _T.UINT8: pa.uint8(), _T.UINT16: pa.uint16(),
        _T.UINT32: pa.uint32(), _T.UINT64: pa.uint64(),
        _T.FLOAT16: pa.float16(), _T.FLOAT32: pa.float32(),
        _T.FLOAT64: pa.float64(), _T.STRING: pa.string(),
        _T.BINARY: pa.binary(), _T.LARGE_STRING: pa.large_string(),
        _T.LARGE_BINARY: pa.large_binary(), _T.DATE32: pa.date32(),
        _T.DATE64: pa.date64(),
        _T.INTERVAL_MONTH_DAY_NANO: pa.month_day_nano_interval(),
        _T.STRING_VIEW: pa.string_view(), _T.BINARY_VIEW: pa.binary_view(),
    }
    if tid in simple:
        return simple[tid]
    if tid == _T.TIMESTAMP:
        return pa.timestamp(str(t.unit), t.tz)
    if tid == _T.TIME32:
        return pa.time32(str(t.unit))
    if tid == _T.TIME64:
        return pa.time64(str(t.unit))
    if tid == _T.DURATION:
        return pa.duration(str(t.unit))
    if t.is_decimal:
        return getattr(pa, t.name)(t.precision, t.scale)
    if tid == _T.FIXED_SIZE_BINARY:
        return pa.binary(t.byte_width)
    if tid in (_T.LIST, _T.LIST_VIEW):
        vf = t.value_field
        return (pa.list_ if tid == _T.LIST else pa.list_view)(pa.field(
            vf.name, type_to_pyarrow(vf.type), vf.nullable))
    if tid == _T.LARGE_LIST:
        return pa.large_list(type_to_pyarrow(t.value_type))
    if tid == _T.LARGE_LIST_VIEW:
        return pa.large_list_view(type_to_pyarrow(t.value_type))
    if tid == _T.FIXED_SIZE_LIST:
        return pa.list_(type_to_pyarrow(t.value_type), t.list_size)
    if tid == _T.STRUCT:
        return pa.struct([pa.field(f.name, type_to_pyarrow(f.type),
                                   f.nullable) for f in t.fields()])
    if tid == _T.MAP:
        return pa.map_(type_to_pyarrow(t.key_type),
                       type_to_pyarrow(t.item_type), t.keys_sorted)
    if tid == _T.DICTIONARY:
        return pa.dictionary(type_to_pyarrow(t.index_type),
                             type_to_pyarrow(t.value_type), t.ordered)
    if tid in (_T.SPARSE_UNION, _T.DENSE_UNION):
        return getattr(pa, t.name)([pa.field(f.name, type_to_pyarrow(f.type))
                                    for f in t.fields()], t.type_codes)
    if tid == _T.RUN_END_ENCODED:
        return pa.run_end_encoded(type_to_pyarrow(t.run_ends_type),
                                  type_to_pyarrow(t.values_type))
    raise NotImplementedError(f"type_to_pyarrow({t})")


def type_from_pyarrow(t) -> dt.DataType:
    _pa()
    import pyarrow.types as pt
    if pt.is_null(t):
        return dt.null
    if pt.is_boolean(t):
        return dt.bool_
    simple = {"int8": dt.int8, "int16": dt.int16, "int32": dt.int32,
              "int64": dt.int64, "uint8": dt.uint8, "uint16": dt.uint16,
              "uint32": dt.uint32, "uint64": dt.uint64,
              "halffloat": dt.float16, "float": dt.float32,
              "double": dt.float64, "string": dt.string, "binary": dt.binary,
              "large_string": dt.large_string, "large_binary": dt.large_binary,
              "date32[day]": dt.date32, "date64[ms]": dt.date64,
              "month_day_nano_interval": dt.month_day_nano_interval,
              "string_view": dt.string_view, "binary_view": dt.binary_view}
    s = str(t)
    if s in simple:
        return simple[s]
    if pt.is_timestamp(t):
        return dt.timestamp(t.unit, t.tz)
    if pt.is_time32(t):
        return dt.time32(t.unit)
    if pt.is_time64(t):
        return dt.time64(t.unit)
    if pt.is_duration(t):
        return dt.duration(t.unit)
    if pt.is_decimal(t):
        return getattr(dt, f"decimal{t.bit_width}")(t.precision, t.scale)
    if pt.is_fixed_size_binary(t):
        return dt.fixed_size_binary(t.byte_width)
    if pt.is_dictionary(t):
        return dt.dictionary(type_from_pyarrow(t.index_type),
                             type_from_pyarrow(t.value_type), t.ordered)
    if pt.is_fixed_size_list(t):
        return dt.fixed_size_list(type_from_pyarrow(t.value_type),
                                  t.list_size)
    kinds = ((pt.is_large_list, dt.large_list),
             (pt.is_list_view, dt.list_view),
             (pt.is_large_list_view, dt.large_list_view),
             (pt.is_list, dt.list_))
    for is_kind, make in kinds:
        if is_kind(t):
            vf = t.value_field
            return make(dt.Field(vf.name, type_from_pyarrow(vf.type),
                                 vf.nullable))
    if pt.is_map(t):
        return dt.map_(type_from_pyarrow(t.key_type),
                       type_from_pyarrow(t.item_type), t.keys_sorted)
    if pt.is_struct(t):
        return dt.struct([dt.Field(f.name, type_from_pyarrow(f.type),
                                   f.nullable) for f in t])
    if pt.is_union(t):
        fields = [dt.Field(f.name, type_from_pyarrow(f.type)) for f in t]
        make = dt.dense_union if t.mode == "dense" else dt.sparse_union
        return make(fields, list(t.type_codes))
    if pt.is_run_end_encoded(t):
        return dt.run_end_encoded(type_from_pyarrow(t.run_end_type),
                                  type_from_pyarrow(t.value_type))
    raise NotImplementedError(f"type_from_pyarrow({t})")


def schema_to_pyarrow(s: dt.Schema):
    pa = _pa()
    md = s.metadata.to_dict() if s.metadata else None
    return pa.schema([pa.field(f.name, type_to_pyarrow(f.type), f.nullable,
                               f.metadata.to_dict() if f.metadata else None)
                      for f in s.fields], metadata=md)


def schema_from_pyarrow(s) -> dt.Schema:
    """The schema's fields and metadata; field metadata is dropped, as
    the JAX module drops it."""
    md = dt.Metadata({k.decode() if isinstance(k, bytes) else k:
                      v.decode() if isinstance(v, bytes) else v
                      for k, v in (s.metadata or {}).items()})
    return dt.Schema([dt.Field(f.name, type_from_pyarrow(f.type), f.nullable)
                      for f in s], md)


# -- array conversion -------------------------------------------------------

def _children(t: dt.DataType) -> list:
    if t.id == _T.DICTIONARY:
        return [t.value_type]
    if t.id == _T.MAP:
        return [t.key_type, t.item_type]
    return [f.type for f in t.fields()] if t.is_nested else []


def _through_c(t: dt.DataType) -> bool:
    """Whether cdata carries a column of field type t."""
    return t.id not in _BY_LAYOUT and t.id != _T.EXTENSION and all(
        _through_c(c) for c in _children(t))


def _bitmap(pa, mask: Optional[np.ndarray]):
    if mask is None or mask.all():
        return None
    return pa.py_buffer(np.packbits(mask, bitorder="little").tobytes())


def array_to_pyarrow(arr: HostArray, type: Optional[dt.DataType] = None):
    """A HostArray as a pyarrow array of `type_to_pyarrow` of its type
    (or of `type`)."""
    pa = _pa()
    t = type if type is not None else arr.type
    pt_ = type_to_pyarrow(t)
    n = len(arr)
    if _through_c(t):
        c_arr, c_schema = cdata.ArrowArray(), cdata.ArrowSchema()
        # the type pyarrow's map gives back: what it drops, the port drops
        cdata.export_array(arr, ctypes.addressof(c_arr),
                           ctypes.addressof(c_schema),
                           field_type=type_from_pyarrow(pt_))
        return pa.Array._import_from_c(ctypes.addressof(c_arr),
                                       ctypes.addressof(c_schema))
    tid = t.id
    if tid == _T.NULL:
        return pa.nulls(n)
    if tid == _T.DICTIONARY:      # of a type the C data path does not carry
        return pa.DictionaryArray.from_arrays(
            array_to_pyarrow(arr.indices), array_to_pyarrow(arr.dictionary),
            ordered=t.ordered)
    if tid == _T.INTERVAL_MONTH_DAY_NANO:
        return pa.Array.from_buffers(pt_, n, [
            _bitmap(pa, arr.mask),
            pa.py_buffer(np.ascontiguousarray(arr.values).tobytes())])
    if tid in (_T.LIST_VIEW, _T.LARGE_LIST_VIEW):
        cls = pa.ListViewArray if tid == _T.LIST_VIEW else \
            pa.LargeListViewArray
        return cls.from_arrays(
            pa.array(arr.offsets), pa.array(arr.sizes),
            array_to_pyarrow(arr.children[0], t.value_type), type=pt_,
            mask=None if arr.mask is None else pa.array(~arr.mask))
    if tid == _T.RUN_END_ENCODED:
        whole = pa.RunEndEncodedArray.from_arrays(
            array_to_pyarrow(arr.run_ends, t.run_ends_type),
            array_to_pyarrow(arr.values, t.values_type), type=pt_)
        return whole.slice(arr.offset, n)
    if tid in (_T.SPARSE_UNION, _T.DENSE_UNION):
        fields = t.fields()
        kids = [array_to_pyarrow(c, f.type)
                for c, f in zip(arr.children, fields)]
        names = [f.name for f in fields]
        codes = pa.array(arr.type_ids, pa.int8())
        if tid == _T.SPARSE_UNION:
            return pa.UnionArray.from_sparse(codes, kids, names,
                                             t.type_codes)
        return pa.UnionArray.from_dense(
            codes, pa.array(arr.value_offsets, pa.int32()), kids, names,
            t.type_codes)
    return pa.array(arr.to_pylist(), type=pt_)


def array_from_pyarrow(parr) -> HostArray:
    """A pyarrow array as a HostArray (copied out), of type
    `type_from_pyarrow(parr.type)`: a string or binary column typed as
    it is, coded in the port."""
    return _from_pyarrow(parr, type_from_pyarrow(parr.type))


def _from_pyarrow(parr, t: dt.DataType) -> HostArray:
    n, off = len(parr), parr.offset
    if _through_c(t):
        c_arr = cdata.ArrowArray()
        parr._export_to_c(ctypes.addressof(c_arr))
        return cdata.import_array(ctypes.addressof(c_arr), t)
    tid = t.id
    mask = None
    if parr.null_count and tid not in (_T.NULL, _T.SPARSE_UNION,
                                       _T.DENSE_UNION, _T.RUN_END_ENCODED):
        mask = np.asarray(parr.is_valid())
    if tid == _T.NULL:
        return null_array(n)
    if tid == _T.INTERVAL_MONTH_DAY_NANO:
        values = np.frombuffer(parr.buffers()[1], t.np_dtype)[off:off + n]
        return HostArray(values.copy(), mask, t)
    if tid in (_T.LIST_VIEW, _T.LARGE_LIST_VIEW):
        return ListViewArray(t, mask, np.asarray(parr.offsets),
                             np.asarray(parr.sizes),
                             _from_pyarrow(parr.values, t.value_type))
    if tid == _T.RUN_END_ENCODED:
        return RunEndEncodedArray(
            _from_pyarrow(parr.run_ends, t.run_ends_type),
            _from_pyarrow(parr.values, t.values_type), n, off)
    if tid in (_T.SPARSE_UNION, _T.DENSE_UNION):
        bufs = parr.buffers()
        codes = np.frombuffer(bufs[1], np.int8)[off:off + n].copy()
        # a sparse union's field(i) is cut to its rows, a dense one's not
        kids = [_from_pyarrow(parr.field(i), f.type)
                for i, f in enumerate(t.fields())]
        if tid == _T.SPARSE_UNION:
            return UnionArray(t, codes, kids)
        return UnionArray(t, codes, kids, np.frombuffer(
            bufs[2], np.int32)[off:off + n].copy())
    return from_pylist(parr.to_pylist(), t)


def record_batch_to_pyarrow(rb: HostBatch):
    """A HostBatch (a RecordBatch, or a Table's combined chunks) as a
    pyarrow RecordBatch."""
    pa = _pa()
    rb = host_batch(rb)
    return pa.RecordBatch.from_arrays(
        [array_to_pyarrow(c, f.type)
         for c, f in zip(rb.columns, rb.schema.fields)],
        schema=schema_to_pyarrow(rb.schema))


def record_batch_from_pyarrow(prb) -> HostBatch:
    return HostBatch(schema_from_pyarrow(prb.schema),
                     [array_from_pyarrow(prb.column(i))
                      for i in range(prb.num_columns)], prb.num_rows)


def table_to_pyarrow(t: HostBatch):
    """A HostBatch or a Table as a pyarrow Table: a ChunkedArray column
    (each of a Table's) one pyarrow chunk per chunk, any other column one
    chunk."""
    pa = _pa()
    cols = []
    for c, f in zip(t.columns, t.schema.fields):
        chunks = c.chunks if isinstance(c, ChunkedArray) else [c]
        cols.append(pa.chunked_array(
            [array_to_pyarrow(ch, f.type) for ch in chunks],
            type=type_to_pyarrow(f.type)))
    return pa.Table.from_arrays(cols, schema=schema_to_pyarrow(t.schema))


def table_from_pyarrow(pt_) -> HostBatch:
    """A pyarrow Table as one HostBatch: the columns of its batches
    concatenated (concat_host_arrays), as the port's readers' read_all
    give them; a union column of several batches stays a ChunkedArray
    (the port concatenates no union, as the JAX package builds none)."""
    from ..compute.nested_selection import null_rows
    schema = schema_from_pyarrow(pt_.schema)
    batches = [record_batch_from_pyarrow(b) for b in pt_.to_batches()]
    cols = []
    for i, f in enumerate(schema.fields):
        parts = [b.columns[i] for b in batches]
        if len(parts) == 1:
            cols.append(parts[0])
        elif f.type.id in (_T.SPARSE_UNION, _T.DENSE_UNION):
            cols.append(ChunkedArray(parts, f.type))
        elif parts:
            cols.append(concat_host_arrays(parts))
        else:
            cols.append(null_rows(f.type, 0))
    return HostBatch(schema, cols, pt_.num_rows)
