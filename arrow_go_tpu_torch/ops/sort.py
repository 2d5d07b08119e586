"""Order-preserving key transforms and stable multi-key sorts.

Port of arrow_go_tpu/ops/sort.py. Every key column maps to an
order-isomorphic unsigned 64-bit "radix key" (`_orderable_bits`): signed
ints (and the temporal types, by their storage) by a sign-bit flip,
unsigned ints as their zero-extended bits (uint64 as its bits, so a
value of 2**63 or more sorts above the small ones), floats of 16, 32
and 64 bits by the sign-flip bit trick with NaN canonicalized above
+inf. torch has no usable uint64, so a radix key is
an int64 tensor carrying the u64 bit pattern, and `sortable` flips its
sign bit so that torch's signed order is the unsigned order.

`jax.lax.sort(num_keys=k, is_stable=True)` over several operands has no
torch counterpart; `lexsort_stable` takes its place: a chain of stable
`torch.sort` passes from the least significant key up (torch's default
sort is not stable).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from .. import dtypes as dt
from ..device.block import row_mask
from ..utils.metrics import metrics
from . import bitmap
from .convert import as_int64

INT64_MIN = -(1 << 63)


class SortOperand(NamedTuple):
    flag: torch.Tensor   # int32: 0 null-first, 1 valid, 2 null-last, 3 padding
    keys: tuple          # int64s whose signed lexicographic order, first
    # key most significant, is the column's order


def f64_bits(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 bit pattern of float64 values, as int64."""
    return x.view(torch.int64)


def f64_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of f64_bits: int64 IEEE-754 bit patterns -> float64 (one
    bit view; the JAX package rebuilds them arithmetically on a TPU)."""
    return bits.contiguous().view(torch.float64)


def _orderable_bits(values: torch.Tensor,
                    t: Optional[dt.DataType] = None) -> torch.Tensor:
    """Radix key: int64 carrying the u64 bit pattern whose unsigned order
    is the logical order of type t (the JAX package's value after
    .astype(uint64)); without t, ints of a signed dtype are signed."""
    d = values.dtype
    if d in (torch.bool, torch.uint8):
        return values.to(torch.int64)
    if t is not None and t.is_unsigned_integer:
        return as_int64(values, t)
    if d in (torch.int8, torch.int16, torch.int32):
        width = torch.iinfo(d).bits
        return values.to(torch.int64) + (1 << (width - 1))
    if d == torch.int64:
        return values ^ INT64_MIN
    if d == torch.float64:
        canon = torch.where(torch.isnan(values),
                            torch.full_like(values, float("nan")), values)
        bits = f64_bits(canon)
        return torch.where(bits < 0, ~bits, bits | INT64_MIN)
    if d in (torch.float32, torch.float16):
        ibits = {torch.float32: torch.int32, torch.float16: torch.int16}[d]
        width = torch.iinfo(ibits).bits
        canon = torch.where(torch.isnan(values),
                            torch.full_like(values, float("nan")), values)
        umask = (1 << width) - 1
        bits = canon.view(ibits).to(torch.int64) & umask
        sign = 1 << (width - 1)
        return torch.where((bits & sign) != 0, ~bits & umask, bits | sign)
    raise NotImplementedError(f"radix key for {d}")


def sortable(bits: torch.Tensor) -> torch.Tensor:
    """u64 bit patterns (as int64) -> int64 whose signed order is their
    unsigned order."""
    return bits ^ INT64_MIN


def lexsort_stable(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable multi-key argsort, first key most significant: the
    permutation `jax.lax.sort(keys + (iota,), num_keys=len(keys),
    is_stable=True)` returns as its last operand. Keys are compared in
    torch's order for their dtype (signed for ints). Counted as one
    sort of len(keys) passes (utils/metrics.py)."""
    keys = list(keys)
    if keys:
        metrics.sort(keys[0].shape[0], len(keys))
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k.index_select(0, perm)
        order = torch.sort(kk, stable=True).indices
        perm = order if perm is None else perm.index_select(0, order)
    return perm


def sort_key(col_values: torch.Tensor, t: dt.DataType,
             validity: Optional[torch.Tensor], n,
             descending: bool = False,
             nulls_first: bool = False,
             rank: Optional[torch.Tensor] = None) -> SortOperand:
    """Build the (flag, keys) operand for one sort column. `rank` (int64,
    one per dictionary code, >= 0) orders a dictionary column's codes by
    their values: the key of a row is its code's rank. A (P, k) limb
    column (decimal128 / decimal256) gives k keys, most significant
    first: the top limb as signed, the others as unsigned bits (the JAX
    package's key words, top limb sign-flipped)."""
    P = col_values.shape[0]
    if rank is not None:
        keys = [rank.index_select(0, col_values.to(torch.int64).clamp(
            0, rank.shape[0] - 1))]
    elif col_values.dim() == 2:
        k = col_values.shape[1]
        keys = [col_values[:, k - 1]] + [sortable(col_values[:, i])
                                         for i in reversed(range(k - 1))]
    else:
        keys = [sortable(_orderable_bits(col_values, t))]
    if descending:
        keys = [~key for key in keys]
    flag = torch.ones(P, dtype=torch.int32, device=col_values.device)
    if validity is not None:
        isnull = ~bitmap.expand_words(validity, P)
        flag = torch.where(isnull, 0 if nulls_first else 2, flag).to(
            torch.int32)
    flag = torch.where(row_mask(P, n, col_values.device), flag, 3).to(
        torch.int32)
    return SortOperand(flag, tuple(keys))


def argsort_single(op: SortOperand) -> torch.Tensor:
    """Stable ascending argsort -> int64 permutation."""
    return argsort_multi([op])


def argsort_multi(ops: List[SortOperand]) -> torch.Tensor:
    """Stable multi-key argsort, first operand most significant."""
    keys = []
    for op in ops:
        keys.append(op.flag)
        keys.extend(op.keys)
    return lexsort_stable(keys)
