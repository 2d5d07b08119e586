"""Hash aggregate: GROUP BY over a DeviceBatch (single device).

Port of arrow_go_tpu/compute/groupby.py: the sort-based grouping core
(ops/hashing.py) plus segment aggregation in the key-sorted domain
(ops/groupagg.py), for every aggregation the JAX package takes. The
group count is read on the host once; then the group-sized results and
the key representatives come back as a RecordBatch. Spans
(utils/metrics.py): `group_by`, its phases `group_by.program` and
`group_by.to_host`; every device->host read goes through
`metrics.host_read`.

Null keys form their own group; groups appear in first-occurrence
order (PARITY.md D3). A dictionary (string) key groups on its int32
codes, and its output column carries the dictionary. A decimal32 or
decimal64 column groups and aggregates as its unscaled ints, as in the
JAX package: sum, min, max, first and last come back typed as the
decimal, mean as a float64 of the unscaled values and product as the
integer product typed as the decimal. A decimal128 / decimal256 column
raises ArrowNotImplemented, as a key or a value (the JAX package has no
such group-by: it fails on the limb matrix's shape).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from .. import torchenv
from ..array.record import RecordBatch
from ..device.block import (DeviceBatch, HostArray, _unpack_words,
                            batch_to_device, pad_length, row_mask)
from ..ops import bitmap, groupagg, hashing, selection
from ..ops.convert import as_int64, convert, host_view
from ..ops.sort import _orderable_bits, sortable
from ..utils.metrics import metrics
from .errors import ArrowNotImplemented

_AGGS = ("sum", "count", "count_all", "min", "max", "mean", "product",
         "any", "all", "first", "last")


def _combined_key(key_vals, key_valids, key_types, length):
    """Multi-column key -> one combined int64 (null key = its own code,
    so every row is 'valid' for the final grouping)."""
    combined = None
    for vals, validity, t in zip(key_vals, key_valids, key_types):
        res = hashing.encode_codes(vals, t, validity, length, order="key")
        codes = torch.where(res.codes >= 0, res.codes, res.n_unique)
        if combined is None:
            combined = codes
        else:
            combined = combined * (res.n_unique + 1) + codes
    return combined


def _group_program(key_vals, key_valids, agg_vals, agg_valids, length,
                   key_types, agg_names, agg_types):
    """Key encode + first-occurrence ordering + every aggregation.
    Returns (n_groups, rep_rows, [(result_by_group, valid_by_group)])
    over the padded domain; slots >= n_groups are padding."""
    combined = _combined_key(key_vals, key_valids, key_types, length)
    P = combined.shape[0]
    dev = combined.device
    row_ok = row_mask(P, length, dev)

    # the sum family's (cast) values and validity, and the valid masks
    # the other aggregations count with, ride the encode sort as payload
    # lanes, so the aggregation reads them in sorted order
    payloads = []
    plan = []     # per agg: (vmask, value payload index, mask payload index)
    for vals, valids, agg, t in zip(agg_vals, agg_valids, agg_names,
                                    agg_types):
        vmask = row_ok if valids is None else (
            bitmap.expand_words(valids, P) & row_ok)
        vi = mi = None
        if agg in ("sum", "count", "mean"):
            vi = len(payloads)
            payloads.append(_sum_lane(vals, t))
            mi = len(payloads)
            payloads.append(vmask)
        elif agg == "any":
            mi = len(payloads)
            payloads.append(vmask & vals.to(torch.bool))
        elif agg == "all":
            mi = len(payloads)
            payloads.append(vmask & ~vals.to(torch.bool))
        elif agg in ("min", "max", "first", "last"):
            mi = len(payloads)       # only the valid count needs it
            payloads.append(vmask)
        plan.append((vmask, vi, mi))
    enc, spay = hashing.encode_sorted_with(combined, dt.int64, None,
                                           length, tuple(payloads))
    n_groups = enc.n_unique

    # first occurrence per run (key order) -> first-occurrence order
    (first_by_run,) = groupagg.compact_runs(enc.start, (enc.sidx,))
    in_run = torch.arange(P, device=dev) < n_groups
    first_x = torch.where(in_run, first_by_run, P)
    metrics.sort(P)
    order = torch.argsort(first_x, stable=True)
    rep_rows = first_x.index_select(0, order)

    # the min/max family's key, in original row order
    skey = sortable(_orderable_bits(combined, dt.int64))
    results = []
    for vals, agg, t, (vmask, vi, mi) in zip(agg_vals, agg_names,
                                             agg_types, plan):
        r, v = _segment_agg(enc, skey, vals, t, vmask, agg,
                            None if vi is None else spay[vi],
                            None if mi is None else spay[mi])
        results.append((r.index_select(0, order),
                        None if v is None else v.index_select(0, order)))
    return n_groups, rep_rows, results


def _segment_agg(enc, skey, v, t, vmask, agg: str, values_sorted,
                 mask_sorted):
    """Per-run aggregation (key order) -> (by_run[P], valid[P] or None).
    values_sorted / mask_sorted are payload lanes carried through the
    encode sort."""
    P = v.shape[0]
    zeros64 = torch.zeros(P, dtype=torch.int64, device=v.device)

    def valid_count():
        return groupagg.segment_sum_count(enc, zeros64, None,
                                          values_sorted=zeros64,
                                          valid_sorted=mask_sorted)[1]

    if agg == "count_all":
        return groupagg.segment_sum_count(enc, zeros64, None,
                                          values_sorted=zeros64)[1], None
    if agg == "any":
        return valid_count() > 0, None
    if agg == "all":
        return valid_count() == 0, None
    if agg in ("sum", "count", "mean"):
        s, c = groupagg.segment_sum_count(enc, v, None,
                                          values_sorted=values_sorted,
                                          valid_sorted=mask_sorted)
        if agg == "count":
            return c, None
        if agg == "mean":
            # a uint64 sum's bits read unsigned
            total = convert(s, dt.uint64, dt.float64) if \
                t.id == dt.TypeId.UINT64 else s.to(torch.float64)
            return total / torch.clamp(c, min=1).to(torch.float64), c > 0
        return s, c > 0
    if agg in ("min", "max"):
        out = groupagg.segment_min_max(skey, v,
                                       sortable(_orderable_bits(v, t)), vmask,
                                       agg)
        return out, valid_count() > 0
    if agg in ("first", "last"):
        iota = torch.arange(P, dtype=torch.int64, device=v.device)
        sel = groupagg.segment_min_max(skey, iota, iota, vmask,
                                       "min" if agg == "first" else "max")
        return (v.index_select(0, sel.clamp(0, P - 1)),
                valid_count() > 0)
    if agg == "product":
        # rare: the JAX package's scatter path, by each row's run id
        codes = torch.full((P,), -1, dtype=torch.int64, device=v.device)
        codes[enc.sidx] = torch.where(enc.svalid, enc.run_id.to(torch.int64),
                                      -1)
        slot = torch.where(vmask & (codes >= 0), codes, P)
        lane = _sum_lane(v, t)
        acc = lane.dtype
        s = torch.ones(P + 1, dtype=acc, device=v.device).scatter_reduce_(
            0, slot, torch.where(vmask, lane, torch.ones((), dtype=acc,
                                                         device=v.device)),
            "prod")
        cnt = torch.zeros(P + 1, dtype=torch.int32,
                          device=v.device).scatter_add_(
            0, slot, vmask.to(torch.int32))
        return s[:P], cnt[:P] > 0
    raise ArrowNotImplemented(agg)


def group_by(data, keys, aggregations: Sequence[Tuple[str, str]],
             device=None) -> RecordBatch:
    """GROUP BY `keys` with aggregations [(column, agg), ...], agg one of
    sum, count, count_all, min, max, mean, product, any, all, first, last.
    `data` is a DeviceBatch, or a HostBatch, RecordBatch or Table, which
    moves to `device` (the card unless named) first.

    Output columns: key columns (first-occurrence values) followed by
    '<col>_<agg>' result columns, as a RecordBatch. A key column comes
    back as from_device gives it (a string key of a DeviceBatch as a
    DictionaryArray), a host input's key column of its own type, as in
    the JAX package.
    """
    host_input = not isinstance(data, DeviceBatch)
    dev = torchenv.device(device) if host_input else (
        data.device_columns[0].device if data.device_columns else None)
    with metrics.span("group_by", rows=data.num_rows if host_input
                      else data.length, device=dev):
        return _group_by(data, keys, aggregations, device, host_input, dev)


def _group_by(data, keys, aggregations, device, host_input: bool,
              dev) -> RecordBatch:
    if host_input:
        data = batch_to_device(data, device)
    if isinstance(keys, str):
        keys = [keys]
    for _, agg in aggregations:
        if agg not in _AGGS:
            raise ArrowNotImplemented(f"aggregation {agg!r}")
    key_cols = [data.column(k) for k in keys]
    agg_cols = [data.column(c) for c, _ in aggregations]
    for c in key_cols + agg_cols:
        if c.type.limbs:
            raise ArrowNotImplemented(f"group_by over a {c.type} column")
    for (_, agg), vcol in zip(aggregations, agg_cols):
        if vcol.dict_values is not None and agg not in ("count", "count_all"):
            raise ArrowNotImplemented(f"{agg} on string/dictionary column")
    with metrics.span("group_by.program", device=dev):
        n_groups_dev, rep_rows, results = _group_program(
            [c.values for c in key_cols], [c.validity for c in key_cols],
            [c.values for c in agg_cols], [c.validity for c in agg_cols],
            data.length,
            [dt.int32 if c.dict_values is not None else c.type
             for c in key_cols],
            [agg for _, agg in aggregations], [c.type for c in agg_cols])
    with metrics.span("group_by.to_host", device=dev):
        return _to_host(data, keys, aggregations, key_cols, agg_cols,
                        n_groups_dev, rep_rows, results, host_input)


def _to_host(data, keys, aggregations, key_cols, agg_cols, n_groups_dev,
             rep_rows, results, host_input: bool) -> RecordBatch:
    """The group count first (one scalar), then only group-sized slices
    and the key representatives leave the device, each read through
    `metrics.host_read`."""
    n_groups = metrics.host_read(n_groups_dev, "group_count")
    kb = min(pad_length(max(n_groups, 1)), rep_rows.shape[0])
    idx = torch.where(torch.arange(kb, device=rep_rows.device) < n_groups,
                      rep_rows[:kb], -1)
    out_cols: List[HostArray] = []
    names: List[str] = []
    for name, c in zip(keys, key_cols):
        kvals = host_view(metrics.host_read(
            selection.gather(c.values, idx)[:n_groups], "group_keys"),
            c.type)
        kwords = selection.take_validity(c.validity, idx, n_groups, kb)
        kmask = _unpack_words(metrics.host_read(
            kwords, "group_key_validity").view(np.uint32), n_groups)
        key = HostArray(kvals, kmask, c.type, c.dict_values)
        if host_input and c.type.id == dt.TypeId.DICTIONARY and \
                data.schema.field(data.schema.field_index(name)).type.id \
                != dt.TypeId.DICTIONARY:
            key = key.decode()
        out_cols.append(key)
        names.append(name)
    for (col_name, agg), vcol, (res, valid) in zip(aggregations, agg_cols,
                                                   results):
        t = _out_type(vcol.type, agg)
        res_np = host_view(metrics.host_read(res[:n_groups],
                                             "group_values"), t).astype(
            t.np_dtype, copy=False)
        mask_np = None if valid is None else metrics.host_read(
            valid[:n_groups], "group_validity")
        out_cols.append(HostArray(res_np, mask_np, t))
        names.append(f"{col_name}_{agg}")
    return RecordBatch(dt.Schema([dt.Field(nm, c.type)
                                  for nm, c in zip(names, out_cols)]),
                       out_cols, n_groups)


def _sum_lane(v: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """A sum, mean or product's values in their accumulator: bool and
    the integers in int64 (unsigned zero-extended, a uint64's bits), a
    float16 in float32 (a deviation: the JAX package accumulates
    float16 in float16), other floats as they are."""
    if v.dtype == torch.float16:
        return v.to(torch.float32)
    return v if v.dtype.is_floating_point else as_int64(v, t)


def _out_type(t: dt.DataType, agg: str) -> dt.DataType:
    """The result type, the JAX package's: a sum of bool or a signed
    integer is int64, of an unsigned one uint64."""
    if agg in ("count", "count_all"):
        return dt.int64
    if agg == "mean":
        return dt.float64
    if agg in ("any", "all"):
        return dt.bool_
    if agg == "sum" and t.is_unsigned_integer:
        return dt.uint64
    if agg == "sum" and (t.is_integer or t == dt.bool_):
        return dt.int64
    return t
