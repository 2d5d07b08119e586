"""Selection, sort and scalar aggregate functions.

Port of the paths of arrow_go_tpu/compute/functions.py that the device
pipeline runs: the DeviceBatch filter (every column rides the stable
compaction, K1 on the card), take, sort_indices with the small-host
fast path for group-sized results, and the scalar aggregates sum / min /
max / mean / count / min_max (masked reductions, K3 on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import dtypes as dt
from .. import torchenv
from ..device.block import (DeviceBatch, DeviceColumn, HostArray, HostBatch,
                            pad_length)
from ..ops import bitmap, reductions, selection
from ..ops import sort as sort_ops
from .errors import ArrowIndexError, ArrowInvalid, ArrowNotImplemented


@dataclass
class FilterOptions:
    null_selection: str = "drop"          # 'drop' | 'emit_null'


@dataclass
class TakeOptions:
    bounds_check: bool = True


@dataclass
class CountOptions:
    mode: str = "only_valid"              # 'only_valid' | 'only_null' | 'all'


def _trim(col: DeviceColumn, count: int) -> DeviceColumn:
    """Shrink capacity after a filter when the waste is large."""
    newP = pad_length(max(count, 1))
    if newP < col.padded:
        words = col.validity[: newP // 32] if col.validity is not None \
            else None
        return DeviceColumn(col.values[:newP], words, count, col.type)
    return DeviceColumn(col.values, col.validity, count, col.type)


def _filter_batch(mvals, mvalidity, col_vals, col_valids, length,
                  null_selection):
    """Filter every column of a batch in ONE compaction: each column (and
    its validity, as a bool lane) rides it as a payload."""
    P = mvals.shape[0]
    payloads = []
    plan = []
    for v, w in zip(col_vals, col_valids):
        vi = len(payloads)
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
        outs.append(outs_all[vi])
        if wi is None and not emit:
            # drop mode introduces no nulls: tail invalidity is already
            # row_mask(P, count), so no word buffer
            valids.append(None)
            continue
        vb = outs_all[wi] if wi is not None else torch.ones_like(in_range)
        valids.append(bitmap.pack_mask(vb & in_range & ~out_null))
    return cnt, outs, valids


def filter_(values, mask, options: Optional[FilterOptions] = None):
    """DeviceBatch in -> DeviceBatch out: the rows where `mask` is true."""
    options = options or FilterOptions()
    if not isinstance(values, DeviceBatch):
        raise ArrowNotImplemented("the port filters DeviceBatches")
    db = values
    if not isinstance(mask, DeviceColumn) or mask.type != dt.bool_:
        raise ArrowNotImplemented("filter mask must be a boolean "
                                  "DeviceColumn")
    if mask.padded != db.padded:
        raise ArrowInvalid(f"mask padding {mask.padded} != batch padding "
                           f"{db.padded}")
    cnt, out_vals, out_valids = _filter_batch(
        mask.values, mask.validity, [c.values for c in db.columns],
        [c.validity for c in db.columns], db.length,
        options.null_selection)
    count = int(cnt)
    cols = [_trim(DeviceColumn(v, w, count, c.type), count)
            for v, w, c in zip(out_vals, out_valids, db.columns)]
    return DeviceBatch(db.schema, cols, count)


# ---------------------------------------------------------------------------
# take
# ---------------------------------------------------------------------------

def _host_take_indices(indices: HostArray, n_src: int,
                       options: TakeOptions) -> np.ndarray:
    """Take-indices -> int64 ndarray with -1 for null slots."""
    if indices.type not in (dt.int32, dt.int64):
        raise ArrowNotImplemented("take indices must be integer")
    idx = np.asarray(indices.values, dtype=np.int64).copy()
    valid = indices.validity_bools()
    if options.bounds_check and len(idx) and (
            (valid & ((idx < 0) | (idx >= n_src))).any()):
        raise ArrowIndexError(
            f"take index out of bounds (source length {n_src})")
    idx[~valid] = -1
    return idx


def _take_host(arr: HostArray, idx: np.ndarray) -> HostArray:
    safe = np.clip(idx, 0, max(len(arr) - 1, 0))
    vals = arr.values[safe] if len(arr) else np.zeros(len(idx),
                                                      arr.values.dtype)
    mask = (idx >= 0) & arr.validity_bools()[safe] if len(arr) else \
        np.zeros(len(idx), np.bool_)
    return HostArray(vals, None if mask.all() else mask, arr.type)


def take(values, indices, options: Optional[TakeOptions] = None):
    """values[indices]: host arrays take on the host; device columns
    take on their device."""
    options = options or TakeOptions()
    if isinstance(values, HostBatch):
        hidx = _host_take_indices(indices, values.num_rows, options)
        return HostBatch(values.schema,
                         [_take_host(c, hidx) for c in values.columns],
                         len(hidx))
    if isinstance(values, HostArray):
        return _take_host(values, _host_take_indices(indices, len(values),
                                                     options))
    if isinstance(values, DeviceColumn) and isinstance(indices,
                                                       DeviceColumn):
        idx = indices.values.to(torch.int64)
        if indices.validity is not None:
            idx = torch.where(
                bitmap.expand_words(indices.validity, indices.padded),
                idx, -1)
        live = torch.arange(indices.padded, device=idx.device) \
            < indices.length
        if options.bounds_check and bool(
                (live & ((idx < -1) | (idx >= values.length))).any()):
            raise ArrowIndexError(
                f"take index out of bounds (source length {values.length})")
        vals = selection.gather(values.values, idx)
        words = selection.take_validity(values.validity, idx,
                                        indices.length, indices.padded)
        return DeviceColumn(vals, words, indices.length, values.type)
    raise ArrowNotImplemented(
        f"take of {type(values).__name__} by {type(indices).__name__}")


# ---------------------------------------------------------------------------
# sort_indices
# ---------------------------------------------------------------------------

_HOST_SMALL = 4096     # below this a host argsort beats a device round trip


def _argsort_host_small(arr: HostArray, desc: bool,
                        nulls_first: bool) -> np.ndarray:
    """Host argsort: the device path's total order (NaN greatest, stable,
    null placement) on numpy."""
    v = np.ascontiguousarray(arr.values)
    d = v.dtype
    if d.kind == "b":
        bits = v.astype(np.uint8)
    elif d.kind == "i":
        u = v.view(f"u{d.itemsize}")
        bits = u ^ np.dtype(f"u{d.itemsize}").type(1 << (d.itemsize * 8 - 1))
    else:
        canon = np.where(np.isnan(v), np.array(np.nan, d), v)
        b = canon.view(f"u{d.itemsize}")
        sign = np.dtype(f"u{d.itemsize}").type(1 << (d.itemsize * 8 - 1))
        bits = np.where((b & sign) != 0, ~b, b | sign)
    if desc:
        bits = ~bits
    valid = arr.validity_bools()
    ngroup = valid if nulls_first else ~valid
    # lexsort: last key is primary; stable by position
    return np.lexsort((bits, ngroup.astype(np.uint8))).astype(np.int64)


def sort_indices(values, *, order: str = "ascending",
                 null_placement: str = "at_end", device=None):
    """Sort indices of a HostArray (returned as a HostArray) or a
    DeviceColumn (returned as a DeviceColumn). A HostArray longer than
    _HOST_SMALL sorts on `device` (the card unless named)."""
    desc = order == "descending"
    nulls_first = null_placement == "at_start"
    if isinstance(values, HostArray):
        if len(values) <= _HOST_SMALL:
            return HostArray(_argsort_host_small(values, desc, nulls_first),
                             None, dt.int64)
        dev = torchenv.device(device)
        col = DeviceColumn(*_host_to_device(values, dev), len(values),
                           values.type)
        perm = sort_indices(col, order=order, null_placement=null_placement)
        return HostArray(perm.values[:len(values)].cpu().numpy(), None,
                         dt.int64)
    if not isinstance(values, DeviceColumn):
        raise ArrowNotImplemented(f"sort_indices of {type(values).__name__}")
    key = sort_ops.sort_key(values.values, values.type, values.validity,
                            values.length, descending=desc,
                            nulls_first=nulls_first)
    perm = sort_ops.argsort_single(key)
    return DeviceColumn(perm, None, values.length, dt.int64)


# ---------------------------------------------------------------------------
# scalar aggregates (reference compute "sum"/"min_max"/"count"/"mean")
# ---------------------------------------------------------------------------

def _as_device(values) -> DeviceColumn:
    if not isinstance(values, DeviceColumn):
        raise ArrowNotImplemented(
            f"the port aggregates DeviceColumns, got {type(values).__name__}")
    return values


def _n_valid(col: DeviceColumn) -> int:
    """Valid rows of a column: its length when it has no validity words,
    else one popcount read from the device."""
    if col.validity is None:
        return col.length
    return int(reductions.count_valid(col.values, col.validity, col.length))


def _reduce(values, op: str):
    """One masked reduction as a Python scalar; None when no row is
    valid. The accumulator and the valid count come from one K3 launch
    and one device-to-host copy."""
    col = _as_device(values)
    acc, count = reductions.reduce_with_count_host(
        col.values, col.validity, col.length, op)
    return None if count == 0 else acc


def agg_sum(values, options=None):
    return _reduce(values, "sum")


def agg_min(values, options=None):
    return _reduce(values, "min")


def agg_max(values, options=None):
    return _reduce(values, "max")


def agg_mean(values, options=None):
    """Sum over count of the valid rows, in float64, from one K3 launch
    and one device-to-host copy; None when no row is valid."""
    col = _as_device(values)
    total, count = reductions.reduce_with_count_host(
        col.values, col.validity, col.length, "sum")
    return None if count == 0 else float(total) / count


def agg_count(values, options: Optional[CountOptions] = None):
    options = options or CountOptions()
    col = _as_device(values)
    if options.mode == "only_valid":
        return _n_valid(col)
    if options.mode == "only_null":
        return col.length - _n_valid(col)
    return col.length


def min_max(values, options=None):
    return {"min": agg_min(values), "max": agg_max(values)}


def _host_to_device(arr: HostArray, dev):
    from ..device.block import _pack_words, _words_to_tensor
    n = len(arr)
    P = pad_length(n)
    host = np.zeros(P, dtype=arr.type.np_dtype)
    host[:n] = arr.values
    words = None if arr.mask is None else _words_to_tensor(
        _pack_words(arr.mask, P), dev)
    return torch.from_numpy(host).to(dev), words
