"""Sort-based key encoding, and the vector hash of fixed-width columns.

Port of arrow_go_tpu/ops/hashing.py (the memo-table analog of the
reference's internal/hashing/xxh3_memo_table.go): one stable radix-key
sort of the rows, run starts where the key changes, run id = prefix
count of run starts. `encode_codes` numbers the codes in key order
(`order="key"`: join code spaces, group-by internals, distinct counts)
or by first occurrence (`order="first_occurrence"`: unique,
dictionary_encode). The first-occurrence numbering fills each run's
first row forward with a running max of (position, row) packs, K2 on
the card (ops/scan.py), then sorts the runs by that row.

`hash32` is the murmur3-finalizer hash of any fixed-width column, and
`hash_combine` folds a second column's hash into a first.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import dtypes as dt
from ..device.block import row_mask, valid_rows
from .convert import as_int64
from .scan import cummax_u64_lanes
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


def encode_sorted(values: torch.Tensor, t: dt.DataType,
                  validity: Optional[torch.Tensor], n) -> SortedEncode:
    """One radix-key sort -> sorted-domain run structure."""
    return encode_sorted_with(values, t, validity, n)[0]


def encode_codes(values: torch.Tensor, t: dt.DataType,
                 validity: Optional[torch.Tensor], n,
                 order: str = "first_occurrence") -> EncodeResult:
    """Dense codes for each row (the MemoTable analog).

    order='first_occurrence': codes numbered by first appearance, the
    reference memo table's numbering (unique / dictionary_encode).
    order='key': codes numbered in key-sorted order, for consumers that
    only test equality (join code spaces, group-by internals); it skips
    the forward fill and the second sort."""
    if order not in ("key", "first_occurrence"):
        raise ValueError(f"encode_codes: unknown order {order!r}")
    from .groupagg import compact_runs
    P = values.shape[0]
    dev = values.device
    valid, sidx, svalid, start, n_unique = _sorted_runs(
        values, t, validity, n)
    iota = torch.arange(P, device=dev)
    isnull = ~valid & row_mask(P, n, dev)
    has_null = isnull.any()
    null_first_row = torch.where(isnull, iota, P).min()
    codes = torch.empty(P, dtype=torch.int64, device=dev)
    if order == "key":
        # run id in key order IS the code; sidx is a permutation, so the
        # scatter through it is the inverse permutation
        run_id = torch.cumsum(start.to(torch.int64), 0) - 1
        codes[sidx] = torch.where(svalid, run_id, -1)
        # run-start rows compacted to the front are already in run order
        (first_index,) = compact_runs(start, (sidx,))
        first_index = torch.where(iota < n_unique, first_index, P)
        return EncodeResult(codes, n_unique, has_null, first_index,
                            null_first_row)
    # each run's first row (the stable sort puts its smallest row at the
    # run start) filled forward through the run: the (position, row)
    # pack's position lane is monotone, so a running max fills it
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    first = cummax_u64_lanes(torch.where(start, iota, zero),
                             [torch.where(start, sidx, zero)])[1]
    # runs sorted by their first row are in first-occurrence order; the
    # invalid rows stay at the tail behind their flag
    perm = lexsort_stable([(~svalid).to(torch.int8), first])
    f2 = first.index_select(0, perm)
    valid2 = svalid.index_select(0, perm)
    start2 = torch.ones_like(valid2)
    start2[1:] = f2[1:] != f2[:-1]
    start2 = start2 & valid2
    code2 = torch.cumsum(start2.to(torch.int64), 0) - 1
    codes[sidx.index_select(0, perm)] = torch.where(valid2, code2, -1)
    # run starts compacted to the front are in code order
    (first_index,) = compact_runs(start2, (f2,))
    first_index = torch.where(iota < n_unique, first_index, P)
    return EncodeResult(codes, n_unique, has_null, first_index,
                        null_first_row)


def value_counts_from_codes(res: EncodeResult, P: int, n) -> torch.Tensor:
    """counts[code] for code in [0, n_unique); slot P holds the null
    count. Rows beyond n are not counted."""
    dev = res.codes.device
    slot = torch.where(res.codes >= 0, res.codes, P)
    slot = torch.where(row_mask(P, n, dev), slot, P + 1)
    counts = torch.zeros(P + 2, dtype=torch.int64, device=dev)
    counts.index_add_(0, slot, torch.ones_like(slot))
    return counts[:P + 1]


# ---------------------------------------------------------------------------
# scalar hashing for partitioning (reference hash_funcs.go prime-multiply)
# ---------------------------------------------------------------------------

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for x in [0, 2**32), in int64 with no overflow:
    the high and low 16 bits of x multiply separately."""
    hi = (((x >> 16) * m) & 0xFFFF) << 16
    return (hi + (x & 0xFFFF) * m) & _U32


def hash32(values: torch.Tensor,
           t: Optional[dt.DataType] = None) -> torch.Tensor:
    """Avalanching 32-bit hash of a fixed-width column (murmur3
    finalizer; the role of the reference's prime-multiply hash,
    hash_funcs.go:27): bool, signed and unsigned ints of 1 to 8 bytes,
    float16, float32 and float64. Every NaN hashes as one NaN, and -0.0
    (and a float32 or float64 denormal) as 0.0. `t` is the column's
    type: a uint16 or uint32 column, stored in int16 or int32, is
    zero-extended as the JAX package's `astype(uint32)` extends it.
    Returns int64 carrying the u32 hash."""
    d = values.dtype
    if t is not None and t.is_unsigned_integer and d.itemsize <= 4:
        x = as_int64(values, t) & _U32
    elif d == torch.bool:
        x = values.to(torch.int64)
    elif d.is_floating_point:
        canon = torch.where(torch.isnan(values),
                            torch.full_like(values, float("nan")), values)
        # zero is canonical; float32 and float64 denormals hash as zero
        # too, as in the JAX package (XLA flushes them to zero there)
        zero = canon == 0 if d.itemsize < 4 else \
            canon.abs() < torch.finfo(d).tiny
        canon = torch.where(zero, torch.zeros_like(canon), canon)
        if d.itemsize <= 4:
            x = canon.to(torch.float32).view(torch.int32).to(
                torch.int64) & _U32
        else:
            b = canon.view(torch.int64)
            x = (b ^ (b >> 32)) & _U32
    elif d.itemsize <= 4:
        x = values.to(torch.int64) & _U32
    else:
        b = values if d == torch.int64 else values.view(torch.int64)
        x = (b ^ (b >> 32)) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul_u32(x, _M2)
    return x ^ (x >> 16)


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boost-style hash combine of two u32 hashes (int64 carrying u32)."""
    return a ^ ((b + 0x9E3779B9 + ((a << 6) & _U32) + (a >> 2)) & _U32)
