"""Hash aggregate: GROUP BY over a DeviceBatch (single device).

Port of the sum/count path of arrow_go_tpu/compute/groupby.py: the
sort-based grouping core (ops/hashing.py) plus segment aggregation in
the key-sorted domain (ops/groupagg.py). The group count is read on the
host once; then the group-sized results and the key representatives
come back as a HostBatch.

Null keys form their own group; groups appear in first-occurrence
order (PARITY.md D3).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..device.block import (DeviceBatch, HostArray, HostBatch, _unpack_words,
                            pad_length, row_mask)
from ..ops import bitmap, groupagg, hashing, selection
from .errors import ArrowNotImplemented

_AGGS = ("sum", "count")


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
                   key_types, agg_names):
    """Key encode + first-occurrence ordering + every aggregation.
    Returns (n_groups, rep_rows, [(result_by_group, valid_by_group)])
    over the padded domain; slots >= n_groups are padding."""
    combined = _combined_key(key_vals, key_valids, key_types, length)
    P = combined.shape[0]
    dev = combined.device
    row_ok = row_mask(P, length, dev)

    # every agg's (cast) values and validity ride the encode sort as
    # payload lanes, so the aggregation reads them in sorted order
    payloads = []
    for vals, valids in zip(agg_vals, agg_valids):
        vmask = row_ok if valids is None else (
            bitmap.expand_words(valids, P) & row_ok)
        acc = torch.int64 if not vals.dtype.is_floating_point else vals.dtype
        payloads.extend((vals.to(acc), vmask))
    enc, spay = hashing.encode_sorted_with(combined, dt.int64, None,
                                           length, tuple(payloads))
    n_groups = enc.n_unique

    # first occurrence per run (key order) -> first-occurrence order
    (first_by_run,) = groupagg.compact_runs(enc.start, (enc.sidx,))
    in_run = torch.arange(P, device=dev) < n_groups
    first_x = torch.where(in_run, first_by_run, P)
    order = torch.argsort(first_x, stable=True)
    rep_rows = first_x.index_select(0, order)

    results = []
    for i, agg in enumerate(agg_names):
        s, c = groupagg.segment_sum_count(
            enc, agg_vals[i], None, values_sorted=spay[2 * i],
            valid_sorted=spay[2 * i + 1])
        r, v = (c, None) if agg == "count" else (s, c > 0)
        results.append((r.index_select(0, order),
                        None if v is None else v.index_select(0, order)))
    return n_groups, rep_rows, results


def group_by(data: DeviceBatch, keys,
             aggregations: Sequence[Tuple[str, str]]) -> HostBatch:
    """GROUP BY `keys` with aggregations [(column, 'sum'|'count'), ...].

    Output columns: key columns (first-occurrence values) followed by
    '<col>_<agg>' result columns, as a HostBatch.
    """
    if not isinstance(data, DeviceBatch):
        raise ArrowNotImplemented("the port groups DeviceBatches")
    if isinstance(keys, str):
        keys = [keys]
    for _, agg in aggregations:
        if agg not in _AGGS:
            raise ArrowNotImplemented(f"aggregation {agg!r} is not ported")
    key_cols = [data.column(k) for k in keys]
    agg_cols = [data.column(c) for c, _ in aggregations]
    n_groups_dev, rep_rows, results = _group_program(
        [c.values for c in key_cols], [c.validity for c in key_cols],
        [c.values for c in agg_cols], [c.validity for c in agg_cols],
        data.length, [c.type for c in key_cols],
        [agg for _, agg in aggregations])

    # the group COUNT first (one scalar), then only group-sized slices
    # and the key representatives leave the device
    n_groups = int(n_groups_dev)
    kb = min(pad_length(max(n_groups, 1)), rep_rows.shape[0])
    idx = torch.where(torch.arange(kb, device=rep_rows.device) < n_groups,
                      rep_rows[:kb], -1)
    out_cols: List[HostArray] = []
    names: List[str] = []
    for name, c in zip(keys, key_cols):
        kvals = selection.gather(c.values, idx)[:n_groups].cpu().numpy()
        kwords = selection.take_validity(c.validity, idx, n_groups, kb)
        kmask = _unpack_words(kwords.cpu().numpy().view(np.uint32),
                              n_groups)
        out_cols.append(HostArray(kvals, kmask, c.type))
        names.append(name)
    for (col_name, agg), vcol, (res, valid) in zip(aggregations, agg_cols,
                                                   results):
        res_np = res[:n_groups].cpu().numpy()
        mask_np = None if valid is None else valid[:n_groups].cpu().numpy()
        out_cols.append(HostArray(res_np, mask_np,
                                  _out_type(vcol.type, agg)))
        names.append(f"{col_name}_{agg}")
    return HostBatch(dt.Schema([dt.Field(nm, c.type)
                                for nm, c in zip(names, out_cols)]),
                     out_cols, n_groups)


def _out_type(t: dt.DataType, agg: str) -> dt.DataType:
    if agg == "count" or t.is_integer or t == dt.bool_:
        return dt.int64
    return t
