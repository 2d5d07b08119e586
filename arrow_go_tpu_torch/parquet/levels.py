"""Definition and repetition levels of nested parquet columns.

The port's own copy of arrow_go_tpu/parquet/levels.py (reference
parquet/pqarrow/path_builder.go and parquet/file/level_conversion.go),
over the port's HostArrays: a nested column is written one leaf at a
time, each leaf's column pruned to the single chain of structs and
lists that reaches it (`leaf_paths`, `prune_field`, `prune_to_leaf`);
`generate_levels_nested` walks it into definition and repetition
levels and the leaf's present values, and `rebuild_nested` turns a
leaf's levels and values back into the pruned column, which
`merge_leaf_datas` joins into the whole one. A map is written as its
list<key_value: struct<key, value>> storage and a fixed_size_list as a
plain list (`map_storage_*`, `fsl_storage_*`), as the JAX package and
pyarrow write them.

Levels follow the JAX package bit for bit: a null list or struct
stops at its parent's level, an empty list at its own, and the list's
repeated level adds one definition level under it.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..compute.errors import ArrowNotImplemented
from ..compute.nested_selection import take_host_vec
from ..device.block import HostArray, nested_array

_LIST_IDS = (dt.TypeId.LIST, dt.TypeId.LARGE_LIST)


# ---------------------------------------------------------------------------
# write side: column -> (def_levels, rep_levels, leaf values)
# ---------------------------------------------------------------------------

def generate_levels(arr: HostArray, nullable: bool
                    ) -> Tuple[np.ndarray, np.ndarray, HostArray]:
    """A flat column's levels: its validity as definition levels."""
    n = len(arr)
    def_levels = arr.validity_bools().astype(np.uint32) if nullable else \
        np.zeros(n, np.uint32)
    return def_levels, np.zeros(n, np.uint32), arr


def prune_to_leaf(arr: HostArray, field: dt.Field, path: Tuple[int, ...]
                  ) -> Tuple[HostArray, dt.Field]:
    """The column cut to the single leaf chain `path` selects (a child
    index at each struct level; lists are transparent)."""
    t = field.type
    if not path:
        return arr, field
    if t.id == dt.TypeId.STRUCT:
        i = path[0]
        inner, inner_f = prune_to_leaf(arr.children[i], t.fields()[i],
                                       path[1:])
        pruned = dt.StructType([inner_f])
        return (nested_array(pruned, len(arr), arr.mask, [inner]),
                dt.Field(field.name, pruned, field.nullable))
    if t.id in _LIST_IDS:
        inner, inner_f = prune_to_leaf(arr.children[0], t.value_field, path)
        pruned = type(t)(dt.Field(t.value_field.name, inner_f.type,
                                  inner_f.nullable))
        return (HostArray(None, arr.mask, pruned, offsets=arr.offsets,
                          children=[inner]),
                dt.Field(field.name, pruned, field.nullable))
    return arr, field


def fsl_storage_field(f: dt.Field) -> dt.Field:
    """A fixed_size_list field as plain list storage (parquet has no
    fixed-size list; it reads back as a list, as with pyarrow)."""
    vf = f.type.value_field
    return dt.Field(f.name, dt.ListType(dt.Field(vf.name, vf.type,
                                                 vf.nullable)), f.nullable)


def fsl_storage_data(arr: HostArray) -> HostArray:
    """A fixed_size_list column as list storage: offsets i * list_size
    over the same child rows."""
    k = arr.type.list_size
    vf = arr.type.value_field
    offsets = np.arange(len(arr) + 1, dtype=np.int64) * k
    return HostArray(None, arr.mask, dt.ListType(dt.Field(
        vf.name, vf.type, vf.nullable)),
        offsets=offsets.astype(np.int32), children=arr.children)


def map_storage_field(f: dt.Field) -> dt.Field:
    """A map field as its list<key_value: struct<key, value>> storage."""
    return dt.Field(f.name, dt.ListType(dt.Field(
        "key_value", f.type.value_type, False)), f.nullable)


def map_storage_data(arr: HostArray) -> HostArray:
    """A map column as list storage over the same offsets and entries."""
    return HostArray(None, arr.mask, dt.ListType(dt.Field(
        "key_value", arr.type.value_type, False)), offsets=arr.offsets,
        children=arr.children)


def leaf_paths(t: dt.DataType) -> List[Tuple[int, ...]]:
    """Struct-child index chains to every leaf (lists are transparent)."""
    if t.id == dt.TypeId.MAP:
        return leaf_paths(t.value_type)
    if t.id == dt.TypeId.STRUCT:
        return [(i,) + sub for i, f in enumerate(t.fields())
                for sub in leaf_paths(f.type)]
    if t.id in _LIST_IDS + (dt.TypeId.FIXED_SIZE_LIST,):
        return leaf_paths(t.value_type)
    return [()]


def prune_field(field: dt.Field, path: Tuple[int, ...]) -> dt.Field:
    """The type-level `prune_to_leaf`."""
    t = field.type
    if t.id == dt.TypeId.STRUCT:
        inner = prune_field(t.fields()[path[0]], path[1:])
        return dt.Field(field.name, dt.StructType([inner]), field.nullable)
    if t.id in _LIST_IDS:
        inner = prune_field(t.value_field, path)
        return dt.Field(field.name, type(t)(dt.Field(
            t.value_field.name, inner.type, inner.nullable)), field.nullable)
    return field


def _leaf_array(arr: HostArray) -> HostArray:
    while arr.type.is_nested:
        arr = arr.children[0]
    return arr


def generate_levels_nested(arr: HostArray, field: dt.Field
                           ) -> Tuple[np.ndarray, np.ndarray, HostArray]:
    """Definition and repetition levels of a single-leaf column (a struct
    column is split per leaf first), and its leaf's present values."""
    defs: List[int] = []
    reps: List[int] = []
    rows: List[int] = []

    def valid(a: HostArray, i: int) -> bool:
        return a.mask is None or bool(a.mask[i])

    def walk(a: HostArray, f: dt.Field, cur_def: int, cur_rep: int,
             idx: int, entry_rep: int):
        t, nullable = f.type, f.nullable
        if nullable and not valid(a, idx):
            defs.append(cur_def)
            reps.append(entry_rep)
            return
        this_def = cur_def + (1 if nullable else 0)
        if t.id in _LIST_IDS:
            start, end = int(a.offsets[idx]), int(a.offsets[idx + 1])
            if start == end:
                defs.append(this_def)
                reps.append(entry_rep)
                return
            vf = t.value_field
            child_f = dt.Field("element", vf.type, vf.nullable)
            for k, j in enumerate(range(start, end)):
                walk(a.children[0], child_f, this_def + 1, cur_rep + 1, j,
                     entry_rep if k == 0 else cur_rep + 1)
            return
        if t.id == dt.TypeId.STRUCT:
            walk(a.children[0], t.fields()[0], this_def, cur_rep, idx,
                 entry_rep)
            return
        defs.append(this_def)
        reps.append(entry_rep)
        rows.append(idx)

    for i in range(len(arr)):
        walk(arr, field, 0, 0, i, 0)
    leaf = take_host_vec(_leaf_array(arr), np.asarray(rows, np.int64))
    return (np.array(defs, dtype=np.uint32), np.array(reps, dtype=np.uint32),
            leaf)


# ---------------------------------------------------------------------------
# read side: levels + leaf values -> the nested column
# ---------------------------------------------------------------------------

def rebuild_nested(field: dt.Field, def_levels: np.ndarray,
                   rep_levels: Optional[np.ndarray],
                   leaf_values: HostArray) -> HostArray:
    """One single-leaf column rebuilt from its levels and the leaf's
    present values (one per entry at the leaf's max definition level)."""
    if rep_levels is None:
        rep_levels = np.zeros(len(def_levels), dtype=np.uint32)
    def_levels = np.asarray(def_levels)
    rep_levels = np.asarray(rep_levels)

    def build(f: dt.Field, cur_def: int, cur_rep: int,
              entries: np.ndarray) -> HostArray:
        """entries: positions (in the level arrays) of this node's
        slots."""
        t, nullable = f.type, f.nullable
        this_def = cur_def + (1 if nullable else 0)
        n = len(entries)
        d = def_levels[entries]
        valid = d >= this_def if nullable else np.ones(n, np.bool_)
        mask = None if valid.all() else valid
        if t.id in _LIST_IDS:
            # a slot's run reaches the next slot; its items are the run's
            # entries at the child's repetition level, defined past the
            # repeated level
            child_rep = cur_rep + 1
            ends = np.append(entries[1:], len(def_levels))
            offsets = np.zeros(n + 1, dtype=np.int64)
            parts = []
            for i in range(n):
                seg = np.arange(int(entries[i]), int(ends[i]))
                items = seg[(rep_levels[seg] <= child_rep)
                            & (def_levels[seg] >= this_def + 1)]
                parts.append(items)
                offsets[i + 1] = offsets[i] + len(items)
            child_entries = np.concatenate(parts) if parts else \
                np.zeros(0, np.int64)
            vf = t.value_field
            child = build(dt.Field("element", vf.type, vf.nullable),
                          this_def + 1, child_rep, child_entries)
            return HostArray(None, mask, t, offsets=offsets.astype(
                t.offset_dtype), children=[child])
        if t.id == dt.TypeId.STRUCT:
            child = build(t.fields()[0], this_def, cur_rep, entries)
            return HostArray(None, mask, t, children=[child], length=n)
        # a leaf: the value stream has one slot per entry at max_def
        value_rank = np.cumsum(def_levels >= this_def) - 1
        take_idx = np.where(d >= this_def, value_rank[entries], -1)
        return take_host_vec(leaf_values, take_idx.astype(np.int64))

    return build(field, 0, 0, np.nonzero(rep_levels == 0)[0])


def merge_leaf_datas(field: dt.Field, datas: List[HostArray]) -> HostArray:
    """The whole column of `field` from its leaves' single-leaf columns
    (in leaf_paths order)."""
    t = field.type
    if len(datas) == 1 and t.id != dt.TypeId.STRUCT:
        d = datas[0]
        if t.id in _LIST_IDS:
            inner = merge_leaf_datas(t.value_field, [d.children[0]])
            return HostArray(None, d.mask, t, offsets=d.offsets,
                             children=[inner])
        return d
    d0 = datas[0]
    if t.id == dt.TypeId.STRUCT:
        children, di = [], 0
        for cf in t.fields():
            k = len(leaf_paths(cf.type))
            children.append(merge_leaf_datas(
                cf, [datas[di + j].children[0] for j in range(k)]))
            di += k
        return HostArray(None, d0.mask, t, children=children,
                         length=len(d0))
    if t.id in _LIST_IDS:
        inner = merge_leaf_datas(t.value_field,
                                 [d.children[0] for d in datas])
        return HostArray(None, d0.mask, t, offsets=d0.offsets,
                         children=[inner])
    raise ArrowNotImplemented(f"merge for {t}")
