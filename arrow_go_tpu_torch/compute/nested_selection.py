"""Take and filter of host columns, nested ones included.

Port of arrow_go_tpu/compute/nested_selection.py over the port's
HostArrays: the device block format carries flat columns, so a nested
column (list, large_list, map, fixed_size_list, struct, at any depth)
selects on the host with vectorised numpy, the JAX package's
offsets-rebuild gather. A flat column takes its values and mask by the
same index vector (its existing route; an interval's structured
values too); a dictionary column takes its codes and keeps its
dictionary (the large and view string and binary types are such
columns); a run_end_encoded column takes each row's run and merges
equal neighbouring runs, as the JAX package does. A null column takes
only a length, an extension column takes its storage, a list view its
offsets and sizes (the new offsets a running sum of the kept sizes), a
sparse union each child by the same rows and a dense union its type
codes and offsets, a null index pointing at one null row appended to
child 0 under `type_codes[0]`, as the JAX package's take_host_vec does.

Index vectors are int64 numpy arrays: idx[i] >= 0 selects source row
idx[i], idx[i] == -1 emits a null row.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import dtypes as dt
from ..device.block import (ExtensionArray, HostArray, ListViewArray,
                            RunEndEncodedArray, UnionArray,
                            concat_host_arrays, nested_array, null_array,
                            storage_zeros)
from .errors import ArrowIndexError, ArrowNotImplemented

_LISTS = (dt.TypeId.LIST, dt.TypeId.LARGE_LIST, dt.TypeId.MAP)


def _out_mask(arr: HostArray, idx: np.ndarray,
              safe: np.ndarray) -> Optional[np.ndarray]:
    """The output's validity (None when every row is valid)."""
    ok = idx >= 0
    if arr.mask is not None:
        ok = ok & arr.mask[safe]
    return None if ok.all() else ok


def expand_runs(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The ranges [starts[i], starts[i] + lens[i]) concatenated: the child
    index of a list gather (prefix-sum form, no Python loop)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lens)
    out_base = np.repeat(ends - lens, lens)
    return np.repeat(starts, lens) + (np.arange(total, dtype=np.int64)
                                      - out_base)


def null_rows(t: dt.DataType, n: int) -> HostArray:
    """n null rows of t (a take of an empty source by null indices; with
    n = 0, an empty column of t). A union or extension type raises
    ArrowNotImplemented, as the JAX package's `nulls` (it has no builder
    for them)."""
    mask = np.zeros(n, np.bool_)
    if t.id == dt.TypeId.NULL:
        return null_array(n)
    if t.id in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION,
                dt.TypeId.EXTENSION):
        raise ArrowNotImplemented(f"null rows of {t}")
    if t.id in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        zeros = np.zeros(n, t.offset_dtype)
        return ListViewArray(t, mask, zeros, zeros,
                             null_rows(t.value_type, 0))
    if t.id in _LISTS:
        return HostArray(None, mask, t,
                         offsets=np.zeros(n + 1, t.offset_dtype),
                         children=[null_rows(t.value_type, 0)])
    if t.id == dt.TypeId.FIXED_SIZE_LIST:
        return HostArray(None, mask, t, children=[
            null_rows(t.value_type, n * t.list_size)], length=n)
    if t.id == dt.TypeId.STRUCT:
        return HostArray(None, mask, t, children=[
            null_rows(f.type, n) for f in t.fields()], length=n)
    if t.id == dt.TypeId.RUN_END_ENCODED:     # one null run, or none
        ends = np.full(min(n, 1), n, t.run_ends_type.np_dtype)
        return RunEndEncodedArray(HostArray(ends, None, t.run_ends_type),
                                  null_rows(t.values_type, len(ends)), n)
    if t.id == dt.TypeId.DICTIONARY or t.codes_on_device:
        idx_t = t.index_type if t.id == dt.TypeId.DICTIONARY else dt.int32
        return HostArray(np.zeros(n, idx_t.np_dtype), mask, t,
                         np.zeros(0, object))
    return HostArray(storage_zeros(t, n), mask, t)


def _take_flat(arr: HostArray, idx: np.ndarray) -> HostArray:
    """A flat column's rows idx (-1 = null): values and mask gathered,
    a dictionary kept."""
    if not len(arr):
        mask = np.zeros(len(idx), np.bool_)
        return HostArray(np.zeros((len(idx),) + arr.values.shape[1:],
                                  arr.values.dtype),
                         mask if len(idx) else None, arr.type,
                         arr.dict_values)
    safe = np.where(idx < 0, 0, idx)
    return HostArray(arr.values[safe], _out_mask(arr, idx, safe), arr.type,
                     arr.dict_values)


def _take_run_ends(arr: RunEndEncodedArray, idx: np.ndarray
                   ) -> RunEndEncodedArray:
    """Rows idx of a run_end_encoded column: each row's run, equal
    neighbouring runs merged back into one (a null index is a run of
    its own)."""
    n_out = len(idx)
    phys = np.searchsorted(arr.run_ends.values.astype(np.int64),
                           arr.offset + np.where(idx < 0, 0, idx),
                           side="right")
    phys = np.where(idx < 0, -1, phys)
    change = np.ones(n_out, np.bool_)
    change[1:] = phys[1:] != phys[:-1]
    keep = np.flatnonzero(change)
    ends = np.append(keep[1:], n_out)[:len(keep)].astype(
        arr.type.run_ends_type.np_dtype)
    return RunEndEncodedArray(
        HostArray(ends, None, arr.type.run_ends_type),
        take_host_vec(arr.values, phys[keep]), n_out)


def take_host_vec(arr: HostArray, idx: np.ndarray) -> HostArray:
    """Rows idx of a host column of any type the port carries (idx
    int64, -1 = a null row)."""
    idx = np.asarray(idx, dtype=np.int64)
    t = arr.type
    n_out = len(idx)
    if t.id == dt.TypeId.NULL:
        return null_array(n_out)
    if len(arr) == 0:
        if (idx >= 0).any():
            raise ArrowIndexError("take index out of bounds (empty source)")
        return null_rows(t, n_out)
    if t.id == dt.TypeId.EXTENSION:
        return ExtensionArray(t, take_host_vec(arr.storage, idx))
    if not t.is_nested:
        return _take_flat(arr, idx)
    if t.id == dt.TypeId.RUN_END_ENCODED:
        return _take_run_ends(arr, idx)
    if t.id in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        return _take_union(arr, idx)
    safe = np.where(idx < 0, 0, idx)
    mask = _out_mask(arr, idx, safe)
    if t.id in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        starts = np.where(idx < 0, 0, arr.offsets.astype(np.int64)[safe])
        lens = np.where(idx < 0, 0, arr.sizes.astype(np.int64)[safe])
        child = take_host_vec(arr.children[0], expand_runs(starts, lens))
        new_off = np.zeros(n_out, np.int64)
        np.cumsum(lens[:-1], out=new_off[1:])
        return ListViewArray(t, mask, new_off, lens, child)
    if t.id in _LISTS:
        off = arr.offsets.astype(np.int64)
        starts = np.where(idx < 0, 0, off[:-1][safe])
        lens = np.where(idx < 0, 0, (off[1:] - off[:-1])[safe])
        child = take_host_vec(arr.children[0], expand_runs(starts, lens))
        new_off = np.zeros(n_out + 1, dtype=t.offset_dtype)
        np.cumsum(lens, out=new_off[1:])
        return nested_array(t, n_out, mask, [child], new_off)
    if t.id == dt.TypeId.FIXED_SIZE_LIST:
        k = t.list_size
        child_idx = (safe[:, None] * k
                     + np.arange(k, dtype=np.int64)).reshape(-1)
        child_idx = np.where(np.repeat(idx < 0, k), -1, child_idx)
        return nested_array(t, n_out, mask,
                            [take_host_vec(arr.children[0], child_idx)])
    return nested_array(t, n_out, mask, [take_host_vec(c, idx)
                                         for c in arr.children])


def _take_union(arr: UnionArray, idx: np.ndarray) -> UnionArray:
    """Rows idx of a union: a sparse union's children by the same rows
    (a null index is null in every child, whatever its type code); a
    dense union's type codes and offsets, its children shared, a null
    index at one null row appended to child 0 under type_codes[0]."""
    safe = np.where(idx < 0, 0, idx)
    tids = arr.type_ids[safe]
    if not arr.dense:
        return UnionArray(arr.type, tids, [take_host_vec(c, idx)
                                           for c in arr.children])
    voff = arr.value_offsets[safe]
    children = list(arr.children)
    neg = idx < 0
    if neg.any():
        c0 = children[0]
        children[0] = concat_host_arrays([c0, null_rows(c0.type, 1)])
        tids = np.where(neg, np.int8(arr.type.type_codes[0]), tids)
        voff = np.where(neg, np.int32(len(c0)), voff)
    return UnionArray(arr.type, tids, children, voff)


def filter_indices_host(mask_vals: np.ndarray, mask_valid: np.ndarray,
                        null_selection: str) -> np.ndarray:
    """A bool mask (and its validity) -> an int64 index vector (reference
    getTakeIndices, vector_selection.go:102). drop: a null slot selects
    nothing; emit_null: a null slot emits -1."""
    if null_selection == "emit_null":
        sel = mask_vals | ~mask_valid
        src = np.arange(len(mask_vals), dtype=np.int64)
        return np.where(mask_valid, src, -1)[sel]
    return np.flatnonzero(mask_vals & mask_valid).astype(np.int64)
