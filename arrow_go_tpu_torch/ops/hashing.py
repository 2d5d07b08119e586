"""Sort-based key encoding: dense codes and sorted-domain run structure.

Port of arrow_go_tpu/ops/hashing.py (the memo-table analog of the
reference's internal/hashing/xxh3_memo_table.go): one stable radix-key
sort of the rows, run starts where the key changes, run id = prefix
count of run starts. Codes here are numbered in key order
(`order="key"`), the order every consumer on the device pipeline needs
(join code spaces, group-by internals); first-occurrence numbering is
not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import dtypes as dt
from ..device.block import row_mask, valid_rows
from .sort import _orderable_bits, lexsort_stable, sortable


class EncodeResult(NamedTuple):
    codes: torch.Tensor        # int64 code per row (-1 for null/padding)
    n_unique: torch.Tensor     # 0-d: distinct non-null values
    has_null: torch.Tensor     # 0-d bool
    first_index: torch.Tensor  # [P] row of the first occurrence per code
    null_first_row: torch.Tensor  # 0-d: first null row (P if none)


class SortedEncode(NamedTuple):
    """Sorted-domain view of a key column: the substrate for segment
    aggregation (ops/groupagg.py)."""
    sidx: torch.Tensor         # [P] original row at sorted position
    start: torch.Tensor        # [P] bool: run (distinct valid key) starts here
    svalid: torch.Tensor       # [P] bool: sorted position holds a valid row
    run_id: torch.Tensor       # [P] int32: run index at sorted position
    n_unique: torch.Tensor     # 0-d


def _sorted_runs(values, t, validity, n):
    """The encode sort: (valid, sidx, svalid, start, n_unique). Invalid
    rows cluster at the tail behind a flag key, so a sorted position is
    valid iff it is below the valid count; the flag key is dropped when
    the column is statically null-free and unpadded."""
    P = values.shape[0]
    all_valid = validity is None and isinstance(n, int) and n >= P
    valid = valid_rows(validity, P, n, values.device)
    key = sortable(_orderable_bits(values, t))
    keys = [key] if all_valid else [(~valid).to(torch.int8), key]
    sidx = lexsort_stable(keys)
    skey = key.index_select(0, sidx)
    iota = torch.arange(P, device=values.device)
    svalid = iota < valid.sum()
    start = torch.ones_like(svalid)
    start[1:] = skey[1:] != skey[:-1]
    start = start & svalid
    return valid, sidx, svalid, start, start.sum()


def encode_sorted_with(values: torch.Tensor, t: dt.DataType,
                       validity: Optional[torch.Tensor], n, payloads=()):
    """One radix-key sort -> (SortedEncode, payloads in sorted order)."""
    _, sidx, svalid, start, n_unique = _sorted_runs(values, t, validity, n)
    run_id = torch.cumsum(start.to(torch.int32), 0, dtype=torch.int32) - 1
    spayloads = tuple(p.index_select(0, sidx) for p in payloads)
    return SortedEncode(sidx, start, svalid, run_id, n_unique), spayloads


def encode_codes(values: torch.Tensor, t: dt.DataType,
                 validity: Optional[torch.Tensor], n,
                 order: str = "key") -> EncodeResult:
    """Dense codes for each row, numbered in key-sorted order."""
    if order != "key":
        raise NotImplementedError(
            "encode_codes: only order='key' is ported")
    P = values.shape[0]
    valid, sidx, svalid, start, n_unique = _sorted_runs(
        values, t, validity, n)
    iota = torch.arange(P, device=values.device)
    isnull = ~valid & row_mask(P, n, values.device)
    has_null = isnull.any()
    null_first_row = torch.where(isnull, iota, P).min()
    # run id in key order IS the code; sidx is a permutation, so the
    # scatter through it is the inverse permutation
    run_id = torch.cumsum(start.to(torch.int64), 0) - 1
    codes = torch.empty(P, dtype=torch.int64, device=values.device)
    codes[sidx] = torch.where(svalid, run_id, -1)
    # run-start rows compacted to the front are already in run order
    from .groupagg import compact_runs
    (first_index,) = compact_runs(start, (sidx,))
    first_index = torch.where(iota < n_unique, first_index, P)
    return EncodeResult(codes, n_unique, has_null, first_index,
                        null_first_row)
