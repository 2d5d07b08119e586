"""The Arrow layout of a HostArray, and the HostArray of a layout.

One module for the two places that turn the port's columns into Arrow
buffers and back: `Array.data` / `make_array` (array/arrays.py, the JAX
package's ArrayData) and the C data interface (cdata.py). A layout is a
list of buffers (numpy uint8 arrays, None for an absent validity
bitmap), its children (each with its field type) and, for a dictionary
field, the column of its dictionary's values.

Export (`column_buffers`) gives a column of field type `t` at offset 0:
validity as LSB bits (none without a null), a string, binary or large
column's offsets and data gathered from its codes (a null row empty),
string_view / binary_view as 16-byte views with one variadic buffer of
the values longer than 12 bytes (the JAX package's BinaryViewBuilder
layout), a dictionary field's indices, fixed_size_binary rows (a null
row zeros), decimal128 / decimal256 limbs as their little-endian
bytes, a list's offsets from 0 with its child cut to its rows, a list
view's offsets and sizes over its child as they stand, a union's type
codes (and a dense one's offsets), a run_end_encoded column's children
as they stand (its `offset` is the layout's), an extension column its
storage's buffers.

Import (`import_column`) reads such buffers through one reader a
buffer (`read(nbytes)` -> uint8 array; nbytes None: all of it) at a
given offset and length, and gives the port's column: rows
[offset, offset + length), a string-like column coded in first-
occurrence order (ipc/core.coded_column), a fixed_size_binary one over
its distinct rows, a dictionary field's indices over the values of its
dictionary.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import (ExtensionArray, HostArray, ListViewArray,
                            RunEndEncodedArray, UnionArray,
                            dictionary_as_array, dictionary_from_array,
                            nested_array, null_array)
from ..ipc.core import (_offsets, _row_bytes, _view_rows, _views,
                        coded_column)
from ..ops.decode import fixed_size_codes

Reader = Optional[Callable[[Optional[int]], np.ndarray]]


def bits(mask: np.ndarray) -> np.ndarray:
    """A bool mask as LSB-first bitmap bytes (padding bits zero)."""
    return np.packbits(np.asarray(mask, np.bool_), bitorder="little")


def validity_buffer(arr: HostArray) -> Optional[np.ndarray]:
    """The validity bitmap of a column, None when no row is null."""
    m = arr.mask
    return None if m is None or m.all() else bits(m)


def null_count(arr: HostArray, t: dt.DataType) -> int:
    """The nulls a layout of field type t counts: every row of a null
    column, none of a union or run_end_encoded one (their nulls are
    their children's), else the rows the mask clears."""
    if t.id == dt.TypeId.NULL:
        return len(arr)
    if t.id in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION,
                dt.TypeId.RUN_END_ENCODED):
        return 0
    if t.id == dt.TypeId.EXTENSION:
        return null_count(arr.storage if isinstance(arr, ExtensionArray)
                          else arr, t.storage_type)
    return 0 if arr.mask is None else int(len(arr) - np.count_nonzero(
        arr.mask))


def fixed_size_rows(arr: HostArray, t: dt.DataType) -> np.ndarray:
    """A coded fixed_size_binary column's rows as an (n, width) uint8
    matrix, a null row zeros."""
    w = t.byte_width
    table = np.frombuffer(b"".join(arr.dict_values), np.uint8).reshape(
        -1, w) if len(arr.dict_values) else np.zeros((1, w), np.uint8)
    rows = table[np.asarray(arr.values, np.int64)]
    if arr.mask is not None:
        rows[~arr.mask] = 0
    return rows


def column_buffers(arr: HostArray, t: dt.DataType
                   ) -> Tuple[list, List[Tuple[dt.DataType, HostArray]]]:
    """(buffers, [(child field type, child HostArray)]) of column `arr`
    under field type `t` at offset 0 (a run_end_encoded column at its
    own offset); a dictionary field's dictionary is `dictionary_column`."""
    tid = t.id
    n = len(arr)
    if tid == dt.TypeId.NULL:
        return [], []
    if tid == dt.TypeId.EXTENSION:
        return column_buffers(arr.storage if isinstance(arr, ExtensionArray)
                              else arr, t.storage_type)
    if tid in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        bufs = [arr.type_ids.copy()]
        if tid == dt.TypeId.DENSE_UNION:
            bufs.append(arr.value_offsets.copy())
        return bufs, [(f.type, c) for f, c in zip(t.fields(), arr.children)]
    if tid == dt.TypeId.RUN_END_ENCODED:
        return [], [(f.type, c) for f, c in zip(t.fields(), arr.children)]
    validity = validity_buffer(arr)
    if tid == dt.TypeId.BOOL:
        return [validity, bits(arr.values)], []
    if tid == dt.TypeId.DICTIONARY:
        return [validity, np.asarray(arr.values, t.index_type.np_dtype)], []
    if tid == dt.TypeId.FIXED_SIZE_BINARY:
        return [validity, fixed_size_rows(arr, t)], []
    if t.limbs:                     # little-endian limbs: the Arrow layout
        return [validity, np.ascontiguousarray(arr.values)], []
    if t.is_binary_like:
        ends, data = _row_bytes(arr)
        if t.offset_dtype is None:
            views, var = _views(ends, data)
            return [validity, views] + ([var] if len(var) else []), []
        return [validity, _offsets(ends, t.offset_dtype), data], []
    if t.np_dtype is not None:
        return [validity, np.ascontiguousarray(arr.values)], []
    if tid in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        return [validity, arr.offsets.copy(), arr.sizes.copy()], \
            [(t.value_type, arr.children[0])]
    if tid in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST, dt.TypeId.MAP):
        off = np.asarray(arr.offsets, np.int64)
        lo = int(off[0]) if n else 0
        child = arr.children[0].slice(lo, int(off[-1]) - lo) if n else \
            arr.children[0].slice(0, 0)
        return [validity, (off - lo).astype(t.offset_dtype)], \
            [(t.fields()[0].type, child)]
    if tid == dt.TypeId.FIXED_SIZE_LIST:
        return [validity], [(t.value_type,
                             arr.children[0].slice(0, n * t.list_size))]
    if tid == dt.TypeId.STRUCT:
        return [validity], [(f.type, c) for f, c in zip(t.fields(),
                                                        arr.children)]
    raise ArrowNotImplemented(f"the Arrow layout of {t}")


def dictionary_column(arr: HostArray, t: dt.DataType) -> HostArray:
    """The values of a dictionary field's dictionary as a column of its
    value type."""
    return dictionary_as_array(arr.dict_values, t.value_type)


def import_column(t: dt.DataType, length: int, offset: int,
                  null_count: Optional[int], buffers: Sequence[Reader],
                  child: Callable[[int, dt.DataType], HostArray],
                  dictionary: Callable[[], HostArray]) -> HostArray:
    """The HostArray of rows [offset, offset + length) of a layout of
    type `t`: `buffers[i](nbytes)` reads buffer i (None: absent),
    `child(i, type)` gives child i's whole column and `dictionary()`
    a dictionary field's values column. `null_count` 0 skips the
    validity bitmap (None: read it when present)."""
    n, off = int(length), int(offset)
    total = n + off
    tid = t.id
    bufs = list(buffers) + [None] * (3 - len(buffers))
    if tid == dt.TypeId.NULL:
        return null_array(n)
    if tid == dt.TypeId.EXTENSION:
        return ExtensionArray(t, import_column(
            t.storage_type, n, off, null_count, buffers, child, dictionary))

    def array(i: int, dtype, count: int) -> np.ndarray:
        dtype = np.dtype(dtype)
        if bufs[i] is None:
            if count and total:
                raise ArrowInvalid(f"buffer {i} of a {t} column is absent")
            return np.zeros(count, dtype)   # the offsets of no row: [0]
        raw = bufs[i](count * dtype.itemsize)
        if len(raw) < count * dtype.itemsize:
            raise ArrowInvalid(f"buffer {i} of {len(raw)} bytes for {count} "
                               f"values of {dtype}")
        return np.frombuffer(np.ascontiguousarray(raw), dtype, count)

    def bitmap(i: int) -> np.ndarray:
        raw = array(i, np.uint8, (total + 7) // 8)
        return np.unpackbits(raw, count=total, bitorder="little")[
            off:].astype(np.bool_)

    if tid in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        type_ids = array(0, np.int8, total)[off:]
        kids = [child(i, f.type) for i, f in enumerate(t.fields())]
        if tid == dt.TypeId.DENSE_UNION:
            return UnionArray(t, type_ids, kids, array(1, np.int32, total)[
                off:])
        return UnionArray(t, type_ids, [k.slice(off, n) for k in kids])
    if tid == dt.TypeId.RUN_END_ENCODED:
        ends, values = [child(i, f.type) for i, f in enumerate(t.fields())]
        return RunEndEncodedArray(ends, values, n, off)
    mask = bitmap(0) if bufs[0] is not None and null_count != 0 else None
    if mask is not None and mask.all():
        mask = None
    if tid == dt.TypeId.BOOL:
        return HostArray(bitmap(1), mask, t)
    if tid == dt.TypeId.DICTIONARY:
        from .arrays import DictionaryArray
        idx = array(1, t.index_type.np_dtype, total)[off:].copy()
        return DictionaryArray(idx, mask, t, dictionary_from_array(
            dictionary(), t.value_type))
    if tid == dt.TypeId.FIXED_SIZE_BINARY:
        w = t.byte_width
        rows = array(1, np.uint8, total * w).reshape(total, w)[off:].copy()
        codes, values = fixed_size_codes(
            torch.from_numpy(rows),
            None if mask is None else torch.from_numpy(mask))
        return HostArray(codes.numpy(), mask, t, values)
    if t.limbs:
        return HostArray(array(1, np.int64, total * t.limbs).reshape(
            total, t.limbs)[off:].copy(), mask, t)
    if t.is_binary_like:
        if t.offset_dtype is None:
            views = array(1, np.uint8, total * 16)[off * 16:]
            var = [np.frombuffer(r(None), np.uint8) for r in bufs[2:]
                   if r is not None]
            return coded_column(*_view_rows(views, var, n), mask, t)
        offsets = array(1, t.offset_dtype, total + 1).astype(np.int64)
        data = array(2, np.uint8, int(offsets[-1]) if total else 0)
        lo = int(offsets[off])
        return coded_column(offsets[off + 1:] - lo,
                            data[lo:int(offsets[-1])], mask, t)
    if t.np_dtype is not None:
        return HostArray(array(1, t.np_dtype, total)[off:].copy(), mask, t)
    if tid in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        offsets = array(1, t.offset_dtype, total)[off:]
        sizes = array(2, t.offset_dtype, total)[off:]
        return ListViewArray(t, mask, offsets, sizes, child(0, t.value_type))
    kids = [child(i, f.type) for i, f in enumerate(t.fields())]
    if tid in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST, dt.TypeId.MAP):
        offsets = array(1, t.offset_dtype, total + 1)[off:].copy()
        return nested_array(t, n, mask, kids, offsets)
    if tid == dt.TypeId.FIXED_SIZE_LIST:
        k = t.list_size
        return nested_array(t, n, mask, [kids[0].slice(off * k, n * k)])
    if tid == dt.TypeId.STRUCT:
        return nested_array(t, n, mask, [c.slice(off, n) for c in kids])
    raise ArrowNotImplemented(f"a {t} column from its Arrow layout")
