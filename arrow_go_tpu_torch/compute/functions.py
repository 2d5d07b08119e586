"""Selection, sort, vector hash, set lookup and scalar aggregate functions.

Port of the paths of arrow_go_tpu/compute/functions.py that the device
pipeline runs: the DeviceBatch filter (every column rides the stable
compaction, K1 on the card), take, sort_indices with the small-host
fast path for group-sized results and its record form over sort keys
(a dictionary column sorts by its values' string order); unique and
dictionary_encode (first-occurrence codes, ops/hashing.py); is_in and
index_in against a host value set; fill_null and if_else; and the
scalar aggregates sum / min / max / mean / count / min_max / product /
variance / stddev (masked reductions, K3 on the card; bool, the narrow
integers and float16 widened to the JAX package's accumulators first,
unsigned values read unsigned), count_distinct, any and all;
`value_counts` and `make_struct`, whose struct results are host
columns. filter_ and take take DeviceBatches, DeviceColumns,
DeviceListColumns, HostBatches and HostArrays; a column the device
block format does not carry (nested, a union, a list view, the
day_time and month_day_nano intervals, an extension of such a storage)
selects on the host (compute/nested_selection.py), as the JAX package's
`_device_selectable` routes it.

A decimal128 / decimal256 column is a (P, k) limb matrix: the batch
filter carries each limb as a payload of its own, take gathers rows and
sort_indices sorts by k keys. Its aggregates (but count), unique,
dictionary_encode and is_in raise ArrowNotImplemented, as the JAX
package has none (it fails on the matrix's shape); index_in looks the
rows up on the host, as the JAX package does. decimal32 / decimal64
aggregate their unscaled ints, as in the JAX package.
"""
from __future__ import annotations

import decimal as pydec
from dataclasses import dataclass, field as dc_field
from typing import Any, List, Optional, Union

import numpy as np
import torch

from .. import dtypes as dt
from .. import torchenv
from ..device.block import (DeviceBatch, DeviceColumn, DeviceListColumn,
                            HostArray, HostBatch, HostColumn, column_to_host,
                            device_batch_to_host, factorize,
                            host_array_to_device, host_batch_to_device,
                            list_take_device, nested_array, pad_length,
                            row_mask)
from ..array.record import ChunkedArray, RecordBatch, Table, host_batch
from ..ops import bitmap, convert, hashing, reductions, selection
from ..ops import sort as sort_ops
from ..ops.decimal import to_ints
from . import nested_selection
from .cast import cast_device, cast_host
from .errors import ArrowIndexError, ArrowInvalid, ArrowNotImplemented


@dataclass
class FilterOptions:
    null_selection: str = "drop"          # 'drop' | 'emit_null'


@dataclass
class TakeOptions:
    bounds_check: bool = True


@dataclass
class SortKey:
    target: Union[str, int]
    order: str = "ascending"              # 'ascending' | 'descending'


@dataclass
class SortOptions:
    keys: List[SortKey] = dc_field(default_factory=list)
    null_placement: str = "at_end"        # 'at_end' | 'at_start'


@dataclass
class CountOptions:
    mode: str = "only_valid"              # 'only_valid' | 'only_null' | 'all'


@dataclass
class SetLookupOptions:
    value_set: Any = None
    skip_nulls: bool = False


@dataclass
class VarianceOptions:
    ddof: int = 0


@dataclass
class MakeStructOptions:
    """Field names, nullability and metadata of make_struct's result
    (reference compute.MakeStructOptions)."""
    field_names: List[str] = dc_field(default_factory=list)
    field_nullability: Optional[List[bool]] = None
    field_metadata: Optional[List[Optional[dict]]] = None


def _trim(col: DeviceColumn, count: int) -> DeviceColumn:
    """Shrink capacity after a filter when the waste is large."""
    newP = pad_length(max(count, 1))
    if newP < col.padded:
        words = col.validity[: newP // 32] if col.validity is not None \
            else None
        return DeviceColumn(col.values[:newP], words, count, col.type,
                            col.dictionary)
    return DeviceColumn(col.values, col.validity, count, col.type,
                        col.dictionary)


def _filter_batch(mvals, mvalidity, col_vals, col_valids, length,
                  null_selection):
    """Filter every column of a batch in ONE compaction: each column (and
    its validity, as a bool lane) rides it as a payload; each limb of a
    decimal128 / decimal256 column rides as a payload of its own."""
    P = mvals.shape[0]
    payloads = []
    plan = []
    for v, w in zip(col_vals, col_valids):
        vi = len(payloads)
        if v.dim() == 2:
            payloads.extend(v[:, i].contiguous() for i in range(v.shape[1]))
            vi = slice(vi, len(payloads))
        else:
            payloads.append(v)
        wi = None
        if w is not None:
            wi = len(payloads)
            payloads.append(bitmap.expand_words(w, P))
        plan.append((vi, wi))
    outs_all, out_null, cnt = selection.filter_with_payload(
        mvals, mvalidity, length, tuple(payloads), null_selection)
    in_range = torch.arange(P, device=mvals.device) < cnt
    emit = null_selection == "emit_null"
    outs, valids = [], []
    for vi, wi in plan:
        outs.append(torch.stack(outs_all[vi], dim=1) if isinstance(vi, slice)
                    else outs_all[vi])
        if wi is None and not emit:
            # drop mode introduces no nulls: tail invalidity is already
            # row_mask(P, count), so no word buffer
            valids.append(None)
            continue
        vb = outs_all[wi] if wi is not None else torch.ones_like(in_range)
        valids.append(bitmap.pack_mask(vb & in_range & ~out_null))
    return cnt, outs, valids


def _mask_on(mask, dev, P: int) -> DeviceColumn:
    """A boolean filter mask (DeviceColumn or HostArray) as a DeviceColumn
    on `dev` padded to P."""
    if isinstance(mask, HostArray):
        mask = host_array_to_device(mask, dev, P)
    if not isinstance(mask, DeviceColumn) or mask.type != dt.bool_:
        raise ArrowNotImplemented("filter mask must be a boolean "
                                  "DeviceColumn or HostArray")
    if mask.padded != P:
        raise ArrowInvalid(f"mask padding {mask.padded} != values padding "
                           f"{P}")
    return mask


def _combined(v):
    """A ChunkedArray as one HostArray (its chunks concatenated);
    anything else as it is."""
    return v.combine() if isinstance(v, ChunkedArray) else v


def _host_mask(mask):
    """A boolean filter mask -> (values, validity) bool ndarrays."""
    mask = _combined(mask)
    if isinstance(mask, DeviceColumn):
        mask = column_to_host(mask)
    if not isinstance(mask, HostArray) or mask.type != dt.bool_:
        raise ArrowNotImplemented("filter mask must be a boolean "
                                  "DeviceColumn or HostArray")
    return mask.values.astype(np.bool_), mask.validity_bools()


def _host_filter_indices(mask, options: FilterOptions) -> np.ndarray:
    return nested_selection.filter_indices_host(*_host_mask(mask),
                                                options.null_selection)


def _filter_device_batch(db: DeviceBatch, mask,
                         options: FilterOptions) -> DeviceBatch:
    """Every device column rides one compaction (K1 on the card); a
    HostColumn takes the same rows on the host."""
    devs = db.device_columns
    hidx = None
    if devs:
        mcol = _mask_on(mask, devs[0].device, db.padded)
        cnt, out_vals, out_valids = _filter_batch(
            mcol.values, mcol.validity, [c.values for c in devs],
            [c.validity for c in devs], db.length, options.null_selection)
        count = int(cnt)
        outs = iter(zip(out_vals, out_valids))
    else:
        hidx = _host_filter_indices(mask, options)
        count = len(hidx)
    cols = []
    for c in db.columns:
        if isinstance(c, HostColumn):
            if hidx is None:
                hidx = _host_filter_indices(mcol, options)
            cols.append(HostColumn(nested_selection.take_host_vec(c.array,
                                                                  hidx)))
            continue
        v, w = next(outs)
        cols.append(_trim(DeviceColumn(v, w, count, c.type, c.dictionary),
                          count))
    return DeviceBatch(db.schema, cols, count)


def _filter_column(col: DeviceColumn, mask,
                   options: FilterOptions) -> DeviceColumn:
    """One column's values (its limbs, each a payload) and its validity
    ride the compaction (K1 on the card), as the JAX package's single
    column filter does."""
    mcol = _mask_on(mask, col.device, col.padded)
    cnt, (v,), (w,) = _filter_batch(mcol.values, mcol.validity,
                                    [col.values], [col.validity],
                                    col.length, options.null_selection)
    count = int(cnt)
    return _trim(DeviceColumn(v, w, count, col.type, col.dictionary), count)


def _like_input(result, values):
    """A Table's selection as a Table and a RecordBatch's as a
    RecordBatch, as the JAX package's `_wrap_table` hands them back; any
    other result (a reader's HostBatch's among them) as it is."""
    if isinstance(result, HostBatch) and isinstance(values,
                                                    (Table, RecordBatch)):
        rb = RecordBatch(result.schema, result.columns, result.num_rows)
        return Table.from_batches([rb]) if isinstance(values, Table) else rb
    return result


def filter_(values, mask, options: Optional[FilterOptions] = None,
            device=None):
    """The rows where `mask` (a boolean DeviceColumn or HostArray) is
    true. A DeviceBatch or DeviceColumn filters on its device (K1), a
    DeviceBatch's HostColumns on the host; a DeviceListColumn by
    filter_indices (K1) and list_take_device. A HostBatch or HostArray
    of columns the device block format carries (`DataType.on_device`)
    filters on `device` (the card unless named) and comes back to the
    host; one with another column (nested, day_time_interval, ...)
    filters on the host (compute/nested_selection.py), as the JAX
    package routes them. A host input or mask gives a host result, as
    in the JAX package; a ChunkedArray of values or of the mask is
    combined first, as a HostArray. A Table's result is a Table, a
    RecordBatch's a RecordBatch."""
    return _like_input(_filter(host_batch(values), mask, options, device),
                       values)


def _filter(values, mask, options: Optional[FilterOptions], device):
    options = options or FilterOptions()
    values, mask = _combined(values), _combined(mask)
    host_mask = isinstance(mask, HostArray)
    if isinstance(values, DeviceBatch):
        out = _filter_device_batch(values, mask, options)
        return device_batch_to_host(out) if host_mask else out
    if isinstance(values, DeviceColumn):
        out = _filter_column(values, mask, options)
        return column_to_host(out) if host_mask else out
    if isinstance(values, DeviceListColumn):
        mcol = _mask_on(mask, values.device, values.padded)
        idx, cnt = selection.filter_indices(mcol.values, mcol.validity,
                                            mcol.length,
                                            options.null_selection)
        return list_take_device(values, idx, int(cnt))
    if isinstance(values, HostBatch):
        if not all(c.type.on_device for c in values.columns):
            hidx = _host_filter_indices(mask, options)
            return HostBatch(values.schema, [
                nested_selection.take_host_vec(c, hidx)
                for c in values.columns], len(hidx))
        db = host_batch_to_device(values, _device_of(mask, device))
        return device_batch_to_host(_filter_device_batch(db, mask, options))
    if isinstance(values, HostArray):
        if not values.type.on_device:
            return nested_selection.take_host_vec(
                values, _host_filter_indices(mask, options))
        col = host_array_to_device(values, _device_of(mask, device))
        return column_to_host(_filter_column(col, mask, options))
    raise ArrowNotImplemented(f"filter of {type(values).__name__}")


def _device_of(other, device):
    """The device of `other` when it is a DeviceColumn, else `device`
    (the card unless named)."""
    if isinstance(other, DeviceColumn):
        return other.device
    return torchenv.device(device)


# ---------------------------------------------------------------------------
# take
# ---------------------------------------------------------------------------

def _host_take_indices(indices: HostArray, n_src: int,
                       options: TakeOptions) -> np.ndarray:
    """Take-indices of any integer type (a HostArray or a ChunkedArray,
    combined) -> int64 ndarray with -1 for null slots, bounds-checked
    before the null slots become -1."""
    indices = _combined(indices)
    if not indices.type.is_integer:
        raise ArrowNotImplemented("take indices must be integer")
    idx = np.asarray(indices.values).astype(np.int64)
    valid = indices.validity_bools()
    if options.bounds_check and len(idx) and (
            (valid & ((idx < 0) | (idx >= n_src))).any()):
        raise ArrowIndexError(
            f"take index out of bounds (source length {n_src})")
    idx[~valid] = -1
    return idx


def _device_take_indices(icol: DeviceColumn, n_src: int,
                         options: TakeOptions) -> torch.Tensor:
    """Take-indices of any integer type on the device -> int64 with -1
    for null slots. The bounds check reads the raw values under the
    validity (the JAX package's take_indices_checked), so a valid -1,
    or a uint32 0xFFFFFFFF, is out of bounds; an unsigned index reads
    unsigned."""
    if not icol.type.is_integer:
        raise ArrowNotImplemented("take indices must be integer")
    raw = convert.as_int64(icol.values, icol.type)
    valid = icol.validity_mask()
    if options.bounds_check and bool(
            (valid & ((raw < 0) | (raw >= n_src))).any()):
        raise ArrowIndexError(
            f"take index out of bounds (source length {n_src})")
    return torch.where(valid, raw, -1)


def _take_device_column(col: DeviceColumn, idx: torch.Tensor,
                        count: int) -> DeviceColumn:
    return DeviceColumn(selection.gather(col.values, idx),
                        selection.take_validity(col.validity, idx, count,
                                                idx.shape[0]),
                        count, col.type, col.dictionary)


def take(values, indices, options: Optional[TakeOptions] = None,
         device=None):
    """values[indices], indices of any integer type (a null index gives
    a null row). Host values by host indices take on the host (nested
    columns too, compute/nested_selection.py). A DeviceColumn,
    DeviceListColumn or DeviceBatch takes on its device; a DeviceBatch's
    HostColumns on the host. A DeviceColumn by host indices, or a flat
    HostArray by DeviceColumn indices, moves both to the device, and
    the result comes back to the host, as the JAX package's take does.
    A ChunkedArray of values or indices is combined first, as a
    HostArray. A Table's result is a Table, a RecordBatch's a
    RecordBatch."""
    return _like_input(_take(host_batch(values), indices, options, device),
                       values)


def _take(values, indices, options: Optional[TakeOptions], device):
    options = options or TakeOptions()
    values, indices = _combined(values), _combined(indices)
    if isinstance(values, (HostBatch, HostArray)) and isinstance(
            indices, DeviceColumn):
        if isinstance(values, HostBatch) or not values.type.on_device:
            indices = column_to_host(indices)
        else:
            return column_to_host(_take(host_array_to_device(
                values, indices.device), indices, options, device))
    if isinstance(values, HostBatch):
        hidx = _host_take_indices(indices, values.num_rows, options)
        return HostBatch(values.schema,
                         [nested_selection.take_host_vec(c, hidx) for c in values.columns],
                         len(hidx))
    if isinstance(values, HostArray):
        return nested_selection.take_host_vec(
            values, _host_take_indices(indices, len(values), options))
    if isinstance(indices, HostArray) and isinstance(values, DeviceColumn):
        return column_to_host(_take(values, host_array_to_device(
            indices, values.device), options, device))
    if not isinstance(indices, DeviceColumn):
        raise ArrowNotImplemented(
            f"take of {type(values).__name__} by {type(indices).__name__}")
    if isinstance(values, DeviceColumn):
        idx = _device_take_indices(indices, values.length, options)
        return _take_device_column(values, idx, indices.length)
    if isinstance(values, DeviceListColumn):
        idx = _device_take_indices(indices, values.length, options)
        return list_take_device(values, idx, indices.length)
    if isinstance(values, DeviceBatch):
        idx = _device_take_indices(indices, values.length, options)
        hidx = None
        cols = []
        for c in values.columns:
            if isinstance(c, HostColumn):
                if hidx is None:
                    hidx = idx[:indices.length].cpu().numpy()
                cols.append(HostColumn(nested_selection.take_host_vec(
                    c.array, hidx)))
            else:
                cols.append(_take_device_column(c, idx, indices.length))
        return DeviceBatch(values.schema, cols, indices.length)
    raise ArrowNotImplemented(
        f"take of {type(values).__name__} by {type(indices).__name__}")


# ---------------------------------------------------------------------------
# sort_indices
# ---------------------------------------------------------------------------

_HOST_SMALL = 4096     # below this a host argsort beats a device round trip


def _dictionary_rank(dictionary: np.ndarray) -> np.ndarray:
    """Rank of each dictionary code in its values' order (ties by code),
    int64, at least one entry."""
    order = sorted(range(len(dictionary)), key=lambda i: dictionary[i])
    rank = np.zeros(max(len(dictionary), 1), np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    return rank


def _host_sort_operand(arr: HostArray, desc: bool, nulls_first: bool):
    """(order bits, most significant first; null group) of a host
    column: the device path's total order (NaN greatest, dictionary
    codes by their values' rank, decimal limbs from the top) as unsigned
    ints, and the rank of its null placement."""
    v = np.ascontiguousarray(arr.values)
    d = v.dtype
    if arr.dictionary is not None:
        rank = _dictionary_rank(arr.dictionary)
        keys = [rank[np.clip(v, 0, len(rank) - 1)].astype(np.uint64)]
    elif v.ndim == 2:
        u = v.view(np.uint64)
        k = u.shape[1]
        keys = [u[:, k - 1] ^ np.uint64(1 << 63)] + [
            u[:, i] for i in reversed(range(k - 1))]
    elif d.kind == "b":
        keys = [v.astype(np.uint8)]
    elif d.kind == "u":
        keys = [v]
    elif d.kind == "i":
        u = v.view(f"u{d.itemsize}")
        keys = [u ^ np.dtype(f"u{d.itemsize}").type(
            1 << (d.itemsize * 8 - 1))]
    else:
        canon = np.where(np.isnan(v), np.array(np.nan, d), v)
        b = canon.view(f"u{d.itemsize}")
        sign = np.dtype(f"u{d.itemsize}").type(1 << (d.itemsize * 8 - 1))
        keys = [np.where((b & sign) != 0, ~b, b | sign)]
    if desc:
        keys = [~k for k in keys]
    valid = arr.validity_bools()
    ngroup = valid if nulls_first else ~valid
    return keys, ngroup.astype(np.uint8)


def _lex_keys(cols, descs, nulls_first: bool) -> list:
    """np.lexsort's keys (last most significant) of host columns, the
    first column most significant."""
    lex = []
    for col, desc in zip(reversed(cols), reversed(descs)):
        keys, ngroup = _host_sort_operand(col, desc, nulls_first)
        lex.extend(reversed(keys))
        lex.append(ngroup)
    return lex


def _argsort_host_small(arr: HostArray, desc: bool,
                        nulls_first: bool) -> np.ndarray:
    """Host argsort: the device path's total order (NaN greatest, stable,
    null placement) on numpy."""
    return np.lexsort(_lex_keys([arr], [desc], nulls_first)).astype(
        np.int64)


def _column_sort_key(col: DeviceColumn, descending: bool,
                     nulls_first: bool) -> sort_ops.SortOperand:
    """A device column's sort operand; a dictionary column's codes sort
    by their values' rank (host-computed from the dictionary)."""
    rank = None
    if col.dictionary is not None:
        rank = torch.from_numpy(_dictionary_rank(col.dictionary)).to(
            col.device)
    return sort_ops.sort_key(col.values, col.type, col.validity, col.length,
                             descending=descending, nulls_first=nulls_first,
                             rank=rank)


def _sort_record(values, options: Optional[SortOptions], nulls_first: bool,
                 device):
    """sort_indices of a HostBatch or DeviceBatch by options.keys, first
    key most significant, stable."""
    if not options or not options.keys:
        raise ArrowInvalid("record sort requires SortOptions.keys")
    descs = [k.order == "descending" for k in options.keys]
    if isinstance(values, HostBatch):
        cols = [values.column(k.target) for k in options.keys]
        if values.num_rows <= _HOST_SMALL:
            lex = _lex_keys(cols, descs, nulls_first)
            perm = np.lexsort(lex).astype(np.int64) if lex else \
                np.arange(values.num_rows, dtype=np.int64)
            return HostArray(perm, None, dt.int64)
        dev = torchenv.device(device)
        cols = [host_array_to_device(c, dev) for c in cols]
        n = values.num_rows
    else:
        cols = [values.column(k.target) for k in options.keys]
        n = values.length
    perm = sort_ops.argsort_multi([_column_sort_key(c, desc, nulls_first)
                                   for c, desc in zip(cols, descs)])
    if isinstance(values, HostBatch):
        return HostArray(perm[:n].cpu().numpy(), None, dt.int64)
    return DeviceColumn(perm, None, n, dt.int64)


def sort_indices(values, options: Optional[SortOptions] = None, *,
                 order: str = "ascending", null_placement: str = "at_end",
                 device=None):
    """Sort indices of a HostArray (returned as a HostArray) or a
    DeviceColumn (returned as a DeviceColumn); of a HostBatch or a
    DeviceBatch by `options.keys` (the record form; a HostArray or a
    DeviceColumn back). Host input longer than _HOST_SMALL rows sorts on
    `device` (the card unless named)."""
    nulls_first = ((options.null_placement if options else null_placement)
                   == "at_start")
    if isinstance(values, (HostBatch, DeviceBatch)):
        return _sort_record(values, options, nulls_first, device)
    desc = (options.keys[0].order == "descending") if (
        options and options.keys) else order == "descending"
    if isinstance(values, HostArray):
        if len(values) <= _HOST_SMALL:
            return HostArray(_argsort_host_small(values, desc, nulls_first),
                             None, dt.int64)
        dev = torchenv.device(device)
        col = host_array_to_device(values, dev)
        perm = sort_ops.argsort_single(_column_sort_key(col, desc,
                                                        nulls_first))
        return HostArray(perm[:len(values)].cpu().numpy(), None, dt.int64)
    if not isinstance(values, DeviceColumn):
        raise ArrowNotImplemented(f"sort_indices of {type(values).__name__}")
    perm = sort_ops.argsort_single(_column_sort_key(values, desc,
                                                    nulls_first))
    return DeviceColumn(perm, None, values.length, dt.int64)


def sort(values, options: Optional[SortOptions] = None, *,
         order: str = "ascending", null_placement: str = "at_end",
         device=None):
    """A sorted copy of a HostArray, DeviceColumn, HostBatch or
    DeviceBatch: take(values, sort_indices(values)), the reference's
    "sort" MetaFunction (compute/vector_sort.go:65-82). A batch sorts by
    `options.keys`; host input longer than _HOST_SMALL rows sorts on
    `device` (the card unless named)."""
    idx = sort_indices(values, options, order=order,
                       null_placement=null_placement, device=device)
    return take(values, idx, device=device)


# ---------------------------------------------------------------------------
# scalar aggregates (reference compute "sum"/"min_max"/"count"/"mean")
# ---------------------------------------------------------------------------

def _as_device(values, what: str = "", device=None,
               pad: Optional[int] = None) -> DeviceColumn:
    """`values` as a DeviceColumn: a ChunkedArray combined, and a
    HostArray moved to `device` (the card unless named; padded to `pad`
    when given), as the JAX package moves host input to its device.
    Naming `what` refuses a decimal128 / decimal256 column (the JAX
    package has no such aggregate or set operation: it fails there on
    the limb matrix's shape)."""
    values = _combined(values)
    if isinstance(values, HostArray):
        values = host_array_to_device(values, torchenv.device(device), pad)
    if not isinstance(values, DeviceColumn):
        raise ArrowNotImplemented(
            f"expected an array or a DeviceColumn, got "
            f"{type(values).__name__}")
    if what and values.type.limbs:
        raise ArrowNotImplemented(f"{what} of {values.type}")
    return values


def _maybe_host(result, *inputs):
    """`result` on the host when any input was a host array or batch,
    as the JAX package's `_maybe_host` hands it back."""
    if not any(isinstance(i, (HostArray, ChunkedArray, HostBatch))
               for i in inputs):
        return result
    if isinstance(result, DeviceColumn):
        return column_to_host(result)
    if isinstance(result, DeviceBatch):
        return device_batch_to_host(result)
    return result


def _n_valid(col: DeviceColumn) -> int:
    """Valid rows of a column: its length when it has no validity words,
    else one popcount read from the device."""
    if col.validity is None:
        return col.length
    return int(reductions.count_valid(col.values, col.validity, col.length))


_U64 = 1 << 64


def _agg_operand(col: DeviceColumn, op: str) -> torch.Tensor:
    """A column's values as K3 takes them, in the accumulator the JAX
    package uses (ops/reductions._acc_dtype; jnp.prod promotes ints):
    a sum or product of bool or any integer type in int64 (unsigned
    zero-extended; a uint64's bits wrap as uint64 does), a float16 in
    float32; min and max of an 8- or 16-bit integer in int32, of a
    uint32 zero-extended to int64, of a uint64 with its sign bit
    flipped (`_agg_result` flips it back), of a float16 in float32."""
    t, v = col.type, col.values
    if t.is_decimal or t.is_temporal or t.id == dt.TypeId.DICTIONARY:
        return v
    if t == dt.float16:
        return v.to(torch.float32)
    if op in ("sum", "prod"):
        return v if v.dtype.is_floating_point else convert.as_int64(v, t)
    if t.id == dt.TypeId.UINT64:
        return convert.order_bits(v, t)
    if t == dt.uint32:
        return convert.as_int64(v, t)
    if t.is_integer and t.bit_width < 32:
        return convert.as_int64(v, t).to(torch.int32)
    return v


def _agg_result(acc, t: dt.DataType, op: str):
    """K3's accumulator as the JAX package's result: an unsigned sum or
    product mod 2**64, a uint64 minimum or maximum with its sign bit
    back, a float16 product rounded to float16."""
    if t.is_unsigned_integer:
        if op in ("min", "max") and t.id == dt.TypeId.UINT64:
            return acc + (1 << 63)
        return acc % _U64
    if t == dt.float16 and op == "prod":
        return float(np.float16(acc))
    return acc


def _reduce(values, op: str, device=None):
    """One masked reduction as a Python scalar; None when no row is
    valid. The accumulator and the valid count come from one K3 launch
    and one device-to-host copy. A decimal32 / decimal64 column reduces
    its unscaled ints, as the JAX package does. Host input reduces on
    `device` (the card unless named)."""
    col = _as_device(values, op, device)
    acc, count = reductions.reduce_with_count_host(
        _agg_operand(col, op), col.validity, col.length, op)
    return None if count == 0 else _agg_result(acc, col.type, op)


def agg_sum(values, options=None, device=None):
    return _reduce(values, "sum", device)


def agg_min(values, options=None, device=None):
    return _reduce(values, "min", device)


def agg_max(values, options=None, device=None):
    return _reduce(values, "max", device)


def agg_mean(values, options=None, device=None):
    """Sum over count of the valid rows, in float64, from one K3 launch
    and one device-to-host copy; None when no row is valid."""
    col = _as_device(values, "mean", device)
    total, count = reductions.reduce_with_count_host(
        _agg_operand(col, "sum"), col.validity, col.length, "sum")
    if count == 0:
        return None
    return float(_agg_result(total, col.type, "sum")) / count


def agg_count(values, options: Optional[CountOptions] = None,
              device=None):
    options = options or CountOptions()
    col = _as_device(values, device=device)
    if options.mode == "only_valid":
        return _n_valid(col)
    if options.mode == "only_null":
        return col.length - _n_valid(col)
    return col.length


def min_max(values, options=None, device=None):
    col = _as_device(values, device=device)
    return {"min": agg_min(col), "max": agg_max(col)}


def agg_count_distinct(values, options=None, device=None):
    """Distinct values, a null counting as one (one host read)."""
    col = _as_device(values, "count_distinct", device)
    res = hashing.encode_codes(col.values, col.type, col.validity,
                               col.length, order="key")
    n_unique, has_null = torch.stack([res.n_unique,
                                      res.has_null.to(torch.int64)]).tolist()
    return n_unique + has_null


def agg_any(values, options=None, device=None):
    col = _as_device(values, "any", device)
    return bool((col.values & col.validity_mask()).any())


def agg_all(values, options=None, device=None):
    col = _as_device(values, "all", device)
    return bool((col.values | ~col.validity_mask()).all())


def agg_product(values, options=None, device=None):
    """Product of the valid rows (K3), None when there is none; bool and
    every integer type multiply in int64 (uint64 bits), as `jnp.prod`
    promotes them; integer products wrap."""
    return _reduce(values, "prod", device)


def agg_variance(values, options: Optional[VarianceOptions] = None,
                 device=None):
    """Population variance (ddof 0) or with `options.ddof`, in float64:
    two K3 sums, of the values (with their count) and of the squared
    deviations from their mean. Unsigned values read unsigned."""
    options = options or VarianceOptions()
    col = _as_device(values, "variance", device)
    t = col.type
    x = convert.convert(col.values, t, dt.float64) if (
        t.is_numeric or t == dt.bool_) else col.values.to(torch.float64)
    total, count = reductions.reduce_with_count_host(x, col.validity,
                                                     col.length, "sum")
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.float64(total) / np.float64(count)
        sq, _ = reductions.reduce_with_count_host(
            (x - float(mean)) ** 2, col.validity, col.length, "sum")
        return float(np.float64(sq) / np.float64(count - options.ddof))


def agg_stddev(values, options: Optional[VarianceOptions] = None,
               device=None):
    return float(np.sqrt(agg_variance(values, options, device)))


# ---------------------------------------------------------------------------
# vector hash: unique / dictionary_encode (reference vector_hash.go)
# ---------------------------------------------------------------------------

def _first_occurrences(col: DeviceColumn):
    """(first-occurrence codes, the row of each code's first occurrence
    (on the column's device), the output position of the null or None):
    one encode and one host read."""
    res = hashing.encode_codes(col.values, col.type, col.validity,
                               col.length)
    n_unique, has_null, null_row = torch.stack([
        res.n_unique, res.has_null.to(torch.int64),
        res.null_first_row]).tolist()
    first = res.first_index[:n_unique]
    null_at = None
    if has_null:
        # the null goes where it first occurs among the distinct values
        null_at = int((first < null_row).sum())
    return res.codes, first, null_at


def _with_null(vals: torch.Tensor, null_at) -> tuple:
    """`vals` with a null slot inserted at null_at (None: no null), as
    (padded values, validity words or None, length)."""
    n = vals.shape[0] + (null_at is not None)
    P = pad_length(n)
    out = torch.zeros(P, dtype=vals.dtype, device=vals.device)
    words = None
    if null_at is None:
        out[:n] = vals
    else:
        out[:null_at] = vals[:null_at]
        out[null_at + 1:n] = vals[null_at:]
        ok = row_mask(P, n, vals.device)
        ok[null_at] = False
        words = bitmap.pack_mask(ok)
    return out, words, n


def unique(values, options=None, device=None):
    """The distinct values in first-occurrence order, a null (if any)
    where it first occurs. A dictionary column's result is a dictionary
    column of its distinct values. Host input is hashed on `device`
    (the card unless named) and its result comes back to the host."""
    col = _as_device(values, "unique", device)
    _, first, null_at = _first_occurrences(col)
    vals = col.values.index_select(0, first)
    if col.dictionary is None:
        out, words, n = _with_null(vals, null_at)
        return _maybe_host(DeviceColumn(out, words, n, col.type), values)
    codes = vals.cpu().numpy()
    k = len(codes)
    out, words, n = _with_null(torch.arange(k, dtype=torch.int32,
                                            device=col.device), null_at)
    return _maybe_host(DeviceColumn(out, words, n, col.type,
                                    col.dictionary[codes]), values)


def dictionary_encode(values, options=None, device=None):
    """int32 codes into a dictionary of the distinct non-null values in
    first-occurrence order; null rows keep their validity (code 0). A
    dictionary column comes back as it is. Host input encodes on
    `device` (the card unless named) and comes back to the host."""
    col = _as_device(values, "dictionary_encode", device)
    if col.dictionary is not None:
        return _maybe_host(col, values)
    codes, first, _ = _first_occurrences(col)
    dictionary = convert.host_view(
        col.values.index_select(0, first).cpu().numpy(), col.type)
    return _maybe_host(DeviceColumn(
        torch.where(codes >= 0, codes, 0).to(torch.int32), col.validity,
        col.length, dt.dictionary(dt.int32, col.type), dictionary), values)


def _with_null_host(vals: np.ndarray, null_at) -> tuple:
    """Host values with a null slot inserted at null_at (None: no null),
    as (values, mask or None)."""
    if null_at is None:
        return vals, None
    out = np.insert(vals, null_at, np.zeros((), vals.dtype), axis=0)
    mask = np.ones(len(out), np.bool_)
    mask[null_at] = False
    return out, mask


def value_counts(values, options=None, device=None) -> HostArray:
    """struct<values, counts: int64> of the distinct values in
    first-occurrence order, the null (if any) where it first occurs,
    with its count: one encode, one count scatter and one host read of
    the group-sized results (the JAX package builds the same struct row
    by row). A HostArray counts on `device` (the card unless named)."""
    col = _as_device(values, "value_counts", device)
    res = hashing.encode_codes(col.values, col.type, col.validity,
                               col.length)
    counts = hashing.value_counts_from_codes(res, col.padded, col.length)
    n_unique, has_null, null_row, null_count = torch.stack([
        res.n_unique, res.has_null.to(torch.int64), res.null_first_row,
        counts[col.padded]]).tolist()
    first = res.first_index[:n_unique]
    null_at = int((first < null_row).sum()) if has_null else None
    vals, mask = _with_null_host(convert.host_view(
        col.values.index_select(0, first).cpu().numpy(), col.type),
        null_at)
    cnts = counts[:n_unique].cpu().numpy()
    if null_at is not None:
        cnts = np.insert(cnts, null_at, null_count)
    vtype = col.type.value_type if col.dictionary is not None else col.type
    st = dt.struct([dt.Field("values", vtype), dt.Field("counts", dt.int64)])
    return nested_array(st, len(cnts), None, [
        HostArray(vals, mask, col.type, col.dictionary),
        HostArray(cnts.astype(np.int64), None, dt.int64)])


def _scalar_array(v, n: int) -> HostArray:
    """n copies of a Python scalar, typed as the JAX package's array()
    infers it: bool, int64, float64 or string."""
    if isinstance(v, (str, bytes)):
        t = dt.string if isinstance(v, str) else dt.binary
        d = np.empty(1, dtype=object)
        d[0] = v
        return HostArray(np.zeros(n, np.int32), None,
                         dt.dictionary(dt.int32, t), d)
    t = dt.bool_ if isinstance(v, bool) else dt.int64 if isinstance(
        v, int) else dt.float64
    return HostArray(np.full(n, v, t.np_dtype), None, t)


def make_struct(*args, options=None) -> HostArray:
    """Zip columns into one struct column whose rows are never null
    (nulls stay in the children), as the JAX package's make_struct:
    DeviceColumns come to the host, HostArrays go as they are, a Python
    scalar repeats. options: MakeStructOptions, a dict of its fields,
    or a list of field names (missing names are "0", "1", ...)."""
    if options is None:
        options = MakeStructOptions()
    elif isinstance(options, dict):
        options = MakeStructOptions(**options)
    elif isinstance(options, (list, tuple)):
        options = MakeStructOptions(field_names=list(options))
    names = list(options.field_names)
    names += [str(i) for i in range(len(names), len(args))]
    lengths = {len(a) if isinstance(a, HostArray) else a.length
               for a in args if isinstance(a, (HostArray, DeviceColumn))}
    if not lengths:
        raise ArrowInvalid("make_struct needs at least one array argument")
    if len(lengths) > 1:
        raise ArrowInvalid(f"make_struct column lengths {sorted(lengths)}")
    (n,) = lengths
    children = [column_to_host(a) if isinstance(a, DeviceColumn) else a
                if isinstance(a, HostArray) else _scalar_array(a, n)
                for a in args]
    nullable = list(options.field_nullability or [])
    nullable += [True] * (len(children) - len(nullable))
    st = dt.struct([dt.Field(nm, c.type.value_type if c.dictionary
                             is not None else c.type, bool(nb))
                    for nm, c, nb in zip(names, children, nullable)])
    return nested_array(st, n, None, children)


# ---------------------------------------------------------------------------
# set lookup (reference scalar_set_lookup.go IsIn / IndexIn)
# ---------------------------------------------------------------------------

def _set_options(options, value_set) -> SetLookupOptions:
    return options if options is not None else SetLookupOptions(
        value_set=value_set)


def _set_list(vset, t: dt.DataType) -> list:
    """The value set as Python values (None for a null). For a decimal
    column each value becomes an unscaled int of its type, as the JAX
    package builds the set as an array of the column's type: a Decimal
    scales exactly (ArrowInvalid when it has more digits than the
    scale), a float rounds, an int is taken as unscaled."""
    if isinstance(vset, HostArray):
        return vset.unscaled() if vset.type.is_decimal else vset.to_pylist()
    vset = list(vset)
    if t.is_decimal:
        return [None if v is None else _unscaled_of(v, t) for v in vset]
    return vset


def _unscaled_of(v, t: dt.DataType) -> int:
    if isinstance(v, pydec.Decimal):
        q = v.scaleb(t.scale)
        if q != q.to_integral_value():
            raise ArrowInvalid(f"{v} does not fit scale {t.scale}")
        return int(q)
    if isinstance(v, float):
        return int(round(v * 10 ** t.scale))
    return int(v)


def _set_table(col: DeviceColumn, vset: list):
    """(sorted distinct non-null set values as a tensor of the column's
    dtype on its device, each one's first position in the set as int32;
    None when no value survives). A value that the column's dtype does
    not hold exactly matches nothing; NaN never matches."""
    np_dtype = col.type.np_dtype
    vals, pos = [], []
    for i, v in enumerate(vset):
        if v is not None and np.asarray(v, np_dtype).item() == v:
            vals.append(v)
            pos.append(i)
    if not vals:
        return None
    uniq, first = np.unique(np.asarray(vals, np_dtype), return_index=True)
    if np_dtype == np.bool_:                 # searchsorted takes no bool
        uniq = uniq.astype(np.uint8)
    # an unsigned type's set, like its column, compares in order_bits
    table = convert.order_bits(torch.from_numpy(
        convert.storage_view(uniq, col.type)), col.type)
    return (table.to(col.device),
            torch.from_numpy(np.asarray(pos, np.int32)[first]).to(
                col.device))


def _lookup(col: DeviceColumn, vset: list) -> torch.Tensor:
    """Per row: the first position of its value in the set, -1 when not
    there (null rows included)."""
    if col.dictionary is not None:
        where = {}
        for i, v in enumerate(vset):
            if v is not None:
                where.setdefault(v, i)
        table = torch.tensor([where.get(v, -1) for v in col.dictionary]
                             or [-1], dtype=torch.int32, device=col.device)
        idx = table.index_select(0, col.values.to(torch.int64).clamp(
            0, table.shape[0] - 1))
    else:
        st = _set_table(col, vset)
        if st is None:
            return torch.full((col.padded,), -1, dtype=torch.int32,
                              device=col.device)
        sv, spos = st
        x = convert.order_bits(col.values, col.type).to(sv.dtype)
        at = torch.searchsorted(sv, x).clamp(max=sv.shape[0] - 1)
        idx = torch.where(sv.index_select(0, at) == x,
                          spos.index_select(0, at), -1)
    return torch.where(col.validity_mask(), idx, -1)


def _limb_lookup(col: DeviceColumn, vset: list) -> torch.Tensor:
    """`_lookup` of a decimal128 / decimal256 column, on the host by
    unscaled value, as the JAX package's index_in looks up every row."""
    where = {}
    for i, v in enumerate(vset):
        if v is not None:
            where.setdefault(v, i)
    rows = to_ints(col.values[:col.length].cpu().numpy())
    idx = torch.full((col.padded,), -1, dtype=torch.int64)
    idx[:col.length] = torch.tensor([where.get(v, -1) for v in rows],
                                    dtype=torch.int64)
    return torch.where(col.validity_mask(), idx.to(col.device), -1)


def is_in(values, options: Optional[SetLookupOptions] = None,
          value_set=None, device=None):
    """Whether each row's value is in the value set. A null row is true
    when the set holds a null and `skip_nulls` is off, else false; the
    result has no nulls. Host input looks up on `device` (the card
    unless named) and its result comes back to the host."""
    options = _set_options(options, value_set)
    col = _as_device(values, "is_in", device)
    vset = _set_list(options.value_set, col.type)
    out = _lookup(col, vset) >= 0
    if None in vset and not options.skip_nulls and \
            col.validity is not None:
        out = out | ~bitmap.expand_words(col.validity, col.padded)
    return _maybe_host(DeviceColumn(
        out & row_mask(col.padded, col.length, col.device), None,
        col.length, dt.bool_), values)


def index_in(values, options: Optional[SetLookupOptions] = None,
             value_set=None, device=None):
    """The first position of each row's value in the value set (int32),
    null where it is not there. A null row takes the position of the
    set's first null, if it has one. Host input looks up on `device`
    (the card unless named) and its result comes back to the host."""
    options = _set_options(options, value_set)
    col = _as_device(values, device=device)
    vset = _set_list(options.value_set, col.type)
    idx = _limb_lookup(col, vset) if col.type.limbs else _lookup(col, vset)
    if None in vset:
        isnull = ~col.validity_mask() & row_mask(col.padded, col.length,
                                                 col.device)
        idx = torch.where(isnull, vset.index(None), idx)
    return _maybe_host(DeviceColumn(
        torch.where(idx >= 0, idx, 0).to(torch.int32),
        bitmap.pack_mask(idx >= 0), col.length, dt.int32), values)


# ---------------------------------------------------------------------------
# fill_null / if_else
# ---------------------------------------------------------------------------

def shared_dict_codes(a: DeviceColumn, b: DeviceColumn, what: str):
    """Two dictionary columns' codes in one code space, numbered by first
    occurrence over [a's dictionary; b's dictionary] (the JAX package's
    numbering of a join's string keys): a host factorize of the two
    dictionaries, then one gather per column on its device. Returns (a's
    int32 codes, b's, the merged dictionary). Raises ArrowInvalid unless
    both columns are dictionaries."""
    if a.dictionary is None or b.dictionary is None:
        raise ArrowInvalid(f"{what} must both be strings/dictionary")
    ad, bd = a.dictionary, b.dictionary
    codes, merged = factorize(np.concatenate([ad, bd]))

    def remap(col, table):
        t = torch.from_numpy(table if len(table) else np.zeros(1, np.int32))
        t = t.to(col.device)
        return t.index_select(0, col.values.to(torch.int64).clamp(
            0, t.shape[0] - 1))

    return remap(a, codes[:len(ad)]), remap(b, codes[len(ad):]), merged


def _one_code_space(x, y, what: str):
    """Operands x, y of a selection, at least one a dictionary column,
    in one code space: two columns by `shared_dict_codes`; a string
    scalar becomes its code in the column's dictionary, appended when it
    is absent; an int scalar is a code already. Returns (x, y), each
    column recoded and carrying the shared dictionary."""
    if isinstance(x, DeviceColumn) and isinstance(y, DeviceColumn):
        xc, yc, merged = shared_dict_codes(x, y, what)
        return tuple(DeviceColumn(c.to(col.values.dtype), col.validity,
                                  col.length, col.type, merged)
                     for col, c in ((x, xc), (y, yc)))
    x_col = isinstance(x, DeviceColumn)
    col, s = (x, y) if x_col else (y, x)
    if isinstance(s, (str, bytes)):
        d = col.dictionary
        hit = np.flatnonzero(d == s)
        if len(hit):
            s = int(hit[0])
        else:
            s, d = len(d), np.concatenate([d, np.array([s], dtype=object)])
            col = DeviceColumn(col.values, col.validity, col.length,
                               col.type, d)
    return (col, s) if x_col else (s, col)


def _is_dict(x) -> bool:
    return isinstance(x, DeviceColumn) and x.dictionary is not None


def _storage_scalar(v, t: dt.DataType):
    """A scalar of type t as its storage value: an unsigned integer's
    bits in the signed storage dtype (uint32 2**31 -> -2**31)."""
    if t.stores_unsigned_as_signed and isinstance(v, (int, np.integer)):
        return int(np.array(v, t.np_dtype).view(f"i{t.bit_width // 8}"))
    return v


def fill_null(values, fill_value, device=None):
    """Null rows take `fill_value` (a scalar or a DeviceColumn's row).
    String operands select in one code space (`_one_code_space`) and the
    result carries its dictionary; a string fill beside a column that is
    not a string column raises ArrowInvalid. Host values fill on
    `device` (the card unless named) and come back to the host."""
    col = _as_device(values, device=device)
    if col.validity is None:
        return _maybe_host(col, values)
    if _is_dict(col) or _is_dict(fill_value):
        col, fill_value = _one_code_space(col, fill_value,
                                          "fill_null operands")
    fv = fill_value.values if isinstance(fill_value, DeviceColumn) else \
        torch.full((col.padded,), _storage_scalar(fill_value, col.type),
                   dtype=col.values.dtype, device=col.device)
    isvalid = bitmap.expand_words(col.validity, col.padded)
    return _maybe_host(DeviceColumn(torch.where(isvalid, col.values, fv),
                                    None, col.length, col.type,
                                    col.dictionary), values)


def if_else(cond, left, right, device=None):
    """left where cond, else right (scalars broadcast; two scalars make
    an int64, float64 or bool column). A null cond gives a null row; the
    result always carries its validity words. String operands select in
    one code space (`_one_code_space`) and the result carries its
    dictionary; a string column beside a column that is not a string
    column raises ArrowInvalid. Host operands select on `device` (the
    card unless named; host arrays beside a DeviceColumn cond on its
    device) and the result comes back to the host."""
    inputs = (cond, left, right)
    c = _as_device(cond, device=device)
    P, dev = c.padded, c.device
    left, right = (_as_device(x, device=dev, pad=P)
                   if isinstance(x, (HostArray, ChunkedArray)) else x
                   for x in (left, right))
    if _is_dict(left) or _is_dict(right):
        left, right = _one_code_space(left, right, "if_else operands")
    col = left if isinstance(left, DeviceColumn) else right
    if isinstance(col, DeviceColumn):
        t = col.type
    elif all(isinstance(x, bool) for x in (left, right)):
        t = dt.bool_
    else:
        # two constants (a SQL CASE of literals), typed as a literal
        # broadcast is: int64, or float64 beside a float
        t = dt.float64 if any(isinstance(x, float)
                              for x in (left, right)) else dt.int64

    def vals_mask(x):
        if isinstance(x, DeviceColumn):
            ok = torch.ones(P, dtype=torch.bool, device=dev) \
                if x.validity is None else bitmap.expand_words(x.validity, P)
            return x.values, ok
        return (torch.full((P,), _storage_scalar(x, t), dtype=t.torch_dtype,
                           device=dev),
                torch.ones(P, dtype=torch.bool, device=dev))

    lv, lm = vals_mask(left)
    rv, rm = vals_mask(right)
    chosen = torch.where(c.values, lm, rm)
    if c.validity is not None:
        chosen = chosen & bitmap.expand_words(c.validity, P)
    dictionary = col.dictionary if isinstance(col, DeviceColumn) else None
    return _maybe_host(DeviceColumn(torch.where(c.values, lv, rv),
                                    bitmap.pack_mask(chosen), c.length, t,
                                    dictionary), *inputs)


# ---------------------------------------------------------------------------
# registration (the JAX package's register_all, for the ported functions)
# ---------------------------------------------------------------------------

#: per-target cast functions (reference cast.go:80 RegisterScalarCast); a
#: target with parameters takes its type through options["to_type"]
CAST_TARGETS = {
    "cast_int8": dt.int8, "cast_int16": dt.int16, "cast_int32": dt.int32,
    "cast_int64": dt.int64, "cast_uint8": dt.uint8,
    "cast_uint16": dt.uint16, "cast_uint32": dt.uint32,
    "cast_uint64": dt.uint64, "cast_half_float": dt.float16,
    "cast_float": dt.float32, "cast_double": dt.float64,
    "cast_boolean": dt.bool_, "cast_string": dt.string,
    "cast_large_string": dt.large_string, "cast_binary": dt.binary,
    "cast_large_binary": dt.large_binary,
    "cast_string_view": dt.string_view, "cast_binary_view": dt.binary_view,
    "cast_date32": dt.date32, "cast_date64": dt.date64,
    "cast_month_day_nano_interval": dt.month_day_nano_interval,
    "cast_time32": None, "cast_time64": None, "cast_timestamp": None,
    "cast_duration": None, "cast_decimal": None, "cast_decimal256": None,
    "cast_fixed_sized_binary": None, "cast_list": None,
    "cast_large_list": None, "cast_fixed_size_list": None,
    "cast_struct": None, "cast_extension": None, "cast_dictionary": None,
}


def register_all(reg) -> None:
    from . import kernels, temporal
    from .registry import Arity, Function, FunctionKind as K

    def add(name, kind, arity, fn, raw_args=False):
        reg.register(Function(name, kind, arity, fn, raw_args=raw_args))

    # scalar arithmetic: checked + unchecked variants (reference
    # arithmetic.go)
    for op in kernels._ARITH_BINARY:
        for suffix, checked in (("", True), ("_unchecked", False)):
            add(op + suffix, K.SCALAR, Arity.binary(),
                lambda a, b, options=None, op=op, checked=checked:
                kernels.arithmetic_binary(op, a, b, checked=checked))
    for op in kernels._ARITH_UNARY:
        for suffix, checked in (("", True), ("_unchecked", False)):
            add(op + suffix, K.SCALAR, Arity.unary(),
                lambda a, options=None, op=op, checked=checked:
                kernels.arithmetic_unary(op, a, checked=checked))
    add("round", K.SCALAR, Arity.unary(),
        lambda a, options=None: kernels.round_(a, **(options or {})))
    add("round_to_multiple", K.SCALAR, Arity.unary(),
        lambda a, options=None: kernels.round_to_multiple(
            a, **(options or {"multiple": 1.0})))
    # temporal rounding (reference arithmetic.go:593-625)
    for name in ("floor_temporal", "ceil_temporal", "round_temporal"):
        add(name, K.SCALAR, Arity.unary(),
            lambda a, options=None, f=getattr(temporal, name):
            f(a, **(options or {})))
    for op in kernels._COMPARE:
        add(op, K.SCALAR, Arity.binary(),
            lambda a, b, options=None, op=op: kernels.compare(op, a, b))
    for op in tuple(kernels._BOOLEAN) + kernels._KLEENE:
        add(op, K.SCALAR, Arity.binary(),
            lambda a, b, options=None, op=op: kernels.boolean_binary(op, a,
                                                                     b))
    for name in ("invert", "is_null", "is_valid", "is_nan", "is_finite"):
        add(name, K.SCALAR, Arity.unary(),
            lambda a, options=None, f=getattr(kernels, name): f(a))
    reg.add_alias("not", "invert")          # reference scalar_bool.go
    reg.add_alias("is_not_null", "is_valid")
    reg.add_alias("sub", "subtract")        # reference arithmetic.go:680
    reg.add_alias("sub_unchecked", "subtract_unchecked")

    # cast: the host path for binary-like sides, the device path for the
    # fixed-width lattice
    add("cast", K.SCALAR, Arity.unary(), _exec_cast, raw_args=True)
    for name, target in CAST_TARGETS.items():
        add(name, K.SCALAR, Arity.unary(), _cast_to(name, target),
            raw_args=True)

    # selection, sort and vector hash
    def filter_fn(values, mask, options=None, device=None):
        return filter_(values, mask, options, device)

    def take_fn(values, indices, options=None, device=None):
        return take(values, indices, options, device)

    add("filter", K.META, Arity.binary(), filter_fn, raw_args=True)
    add("array_filter", K.VECTOR, Arity.binary(), filter_fn, raw_args=True)
    add("take", K.META, Arity.binary(), take_fn, raw_args=True)
    add("array_take", K.VECTOR, Arity.binary(), take_fn, raw_args=True)
    add("sort_indices", K.VECTOR, Arity.unary(), sort_indices,
        raw_args=True)
    add("sort", K.META, Arity.unary(),
        lambda values, options=None, device=None: sort(values, options,
                                                       device=device),
        raw_args=True)
    # run-end encode / decode (reference vector_run_ends.go:45-90)
    from . import run_ends
    add("run_end_encode", K.VECTOR, Arity.unary(),
        lambda a, options=None, device=None: run_ends.run_end_encode(
            a, **(options or {}), device=device), raw_args=True)
    add("run_end_decode", K.VECTOR, Arity.unary(),
        lambda a, options=None, device=None: run_ends.run_end_decode(a),
        raw_args=True)
    add("unique", K.VECTOR, Arity.unary(), unique)
    add("value_counts", K.VECTOR, Arity.unary(), value_counts,
        raw_args=True)
    add("dictionary_encode", K.VECTOR, Arity.unary(), dictionary_encode)
    # set lookup and the structural selections
    add("is_in", K.SCALAR, Arity.unary(), is_in)
    add("index_in", K.SCALAR, Arity.unary(), index_in)
    add("fill_null", K.SCALAR, Arity.binary(),
        lambda a, b, options=None: fill_null(a, b))
    add("if_else", K.SCALAR, Arity.ternary(),
        lambda c, a, b, options=None: if_else(c, a, b))
    add("make_struct", K.SCALAR, Arity.varargs(1),
        lambda *args, options=None, device=None: make_struct(
            *args, options=options), raw_args=True)
    # scalar aggregates
    for name, fn in (("sum", agg_sum), ("min", agg_min), ("max", agg_max),
                     ("mean", agg_mean), ("count", agg_count),
                     ("count_distinct", agg_count_distinct),
                     ("any", agg_any), ("all", agg_all),
                     ("product", agg_product), ("variance", agg_variance),
                     ("stddev", agg_stddev), ("min_max", min_max)):
        add(name, K.SCALAR_AGGREGATE, Arity.unary(), fn)


def _cast_to(name: str, default_t):
    def exec_fn(a, options=None, device=None):
        to_t, opts = default_t, None
        if isinstance(options, dt.DataType):
            to_t = options
        elif isinstance(options, dict):
            to_t = options.get("to_type") or default_t
            opts = options.get("options")
        if to_t is None:
            raise ArrowInvalid(f"{name} requires to_type in options")
        return _exec_cast(a, {"to_type": to_t, "options": opts}, device)
    exec_fn.__name__ = name
    return exec_fn


def _exec_cast(a, options=None, device=None):
    """cast's routing: a DeviceColumn casts on its device (to a string
    or decimal type on the host); a HostArray casts on the host when a
    side is binary-like, decimal or nested, else on `device` (the card
    unless named) and back."""
    from ..device.block import column_to_host
    if isinstance(options, dt.DataType):
        to_t, opts = options, None
    elif isinstance(options, dict):
        to_t, opts = options.get("to_type"), options.get("options")
    else:
        raise ArrowInvalid("cast requires target type")
    if isinstance(a, DeviceColumn):
        if to_t.is_binary_like or to_t.is_decimal:
            return cast_host(column_to_host(a), to_t, opts)
        return cast_device(a, to_t, opts)
    if isinstance(a, HostArray):
        t = a.type
        storage = t.value_type if t.id == dt.TypeId.DICTIONARY else t
        if storage.is_binary_like or to_t.is_binary_like or \
                storage.is_decimal or to_t.is_decimal or \
                storage.is_nested or to_t.is_nested:
            return cast_host(a, to_t, opts)
        return column_to_host(cast_device(
            host_array_to_device(a, torchenv.device(device)), to_t, opts))
    raise ArrowInvalid(f"cannot cast {type(a)}")
