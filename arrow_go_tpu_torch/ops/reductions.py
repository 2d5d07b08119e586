"""Masked reductions: sum / prod / min / max, count and mean.

Port of arrow_go_tpu/ops/reductions.py (reference arrow/math SIMD Sum,
internal/utils min/max). Every function takes (values[P],
validity_words[P/32] | None, n): row i counts when i < n and its
validity bit is set; rows in [n, P) hold whatever a filter left there
and never count.

On a CUDA tensor `reduce` and `reduce_with_count` launch K3
(csrc/reduce.cu), the hand-written Hopper kernel that replaces the TPU
kernel `_reduce_kernel`: one launch that expands the packed validity
words itself, as the TPU kernel does, and counts the rows it takes in
the same pass. `reduce_with_count_host` reads the accumulator and the
count with one device-to-host copy. On a CPU tensor the plain versions
run: `reduce_plain` (the JAX package's `reduce_xla`: a masked torch
reduction) and `reduce_with_count_plain` (`reduce_plain` +
`count_valid`). The TPU kernel takes 32-bit lanes only and leaves int64
and float64 to XLA; on the card K3 takes all four types the port
carries: int32, int64, float32 and float64.

Result types follow `_acc_dtype`: integer sums accumulate in int64,
everything else in the value type. Integer sums and products wrap on
overflow, as in the JAX package; min, max and float sums propagate NaN.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import cuda_build
from ..device.block import valid_rows
from ..torchenv import use_kernels
from . import bitmap

OPS = ("sum", "prod", "min", "max")
_OP_CODE = {op: i for i, op in enumerate(OPS)}                 # OP_* in K3
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}                               # DT_* in K3
_PARTIALS = 4096                # K3's partials per stream: cap its grid
_ctypes_ready = False


def _acc_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    """Accumulator type: integer sums widen to int64; min, max, prod and
    float sums keep the value type."""
    if op == "sum" and not dtype.is_floating_point:
        return torch.int64
    return dtype


def _identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if op == "prod":
        return 1
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _check(values: torch.Tensor, op: str) -> None:
    if op not in _OP_CODE:
        raise ValueError(f"reduce: op must be one of {OPS}, got {op!r}")
    if values.dtype not in _DTYPE_CODE:
        raise ValueError(f"reduce: values of {values.dtype} are not "
                         f"supported (int32, int64, float32, float64)")
    if values.dim() != 1:
        raise ValueError("reduce: values must be 1-D")


def reduce_plain(values: torch.Tensor, validity: Optional[torch.Tensor],
                 n: int, op: str) -> torch.Tensor:
    """Plain version: the masked rows set to the op's identity, then one
    torch reduction in the accumulator type."""
    _check(values, op)
    acc = _acc_dtype(op, values.dtype)
    mask = valid_rows(validity, values.shape[0], n, values.device)
    v = torch.where(mask, values.to(acc),
                    torch.tensor(_identity(op, acc), dtype=acc,
                                 device=values.device))
    if v.numel() == 0:
        return torch.tensor(_identity(op, acc), dtype=acc,
                            device=values.device)
    if op == "sum":
        return v.sum(dtype=acc)
    if op == "prod":
        return v.prod(dtype=acc)
    return v.amin() if op == "min" else v.amax()


def reduce(values: torch.Tensor, validity: Optional[torch.Tensor], n: int,
           op: str) -> torch.Tensor:
    """Masked reduction of rows [0, n) with their validity bit set: a 0-d
    tensor of `_acc_dtype(op, values.dtype)` on the values' device."""
    if not use_kernels(values):
        return reduce_plain(values, validity, n, op)
    return _acc_of(_reduce_cuda(values, validity, n, op),
                   _acc_dtype(op, values.dtype))


reduce.launches = 0


def count_valid(values: torch.Tensor, validity: Optional[torch.Tensor],
                n: int) -> torch.Tensor:
    """Rows [0, n) with their validity bit set (0-d int64 tensor)."""
    if validity is None:
        return torch.tensor(n, dtype=torch.int64, device=values.device)
    words = validity & bitmap.length_words(values.shape[0], n,
                                           validity.device)
    return bitmap.popcount_words(words)


def reduce_with_count_plain(values: torch.Tensor,
                            validity: Optional[torch.Tensor], n: int,
                            op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `reduce_with_count`: `reduce_plain` and
    `count_valid`."""
    return (reduce_plain(values, validity, n, op),
            count_valid(values, validity, n))


def reduce_with_count(values: torch.Tensor, validity: Optional[torch.Tensor],
                      n: int, op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(`reduce(values, validity, n, op)`, the count of the rows it took
    as a 0-d int64 tensor), from one K3 launch on the card."""
    if not use_kernels(values):
        return reduce_with_count_plain(values, validity, n, op)
    out = _reduce_cuda(values, validity, n, op)
    return _acc_of(out, _acc_dtype(op, values.dtype)), out[1]


def reduce_with_count_host(values: torch.Tensor,
                           validity: Optional[torch.Tensor], n: int,
                           op: str) -> tuple:
    """`reduce_with_count` as (Python scalar, int), read from the card
    with one device-to-host copy."""
    if not use_kernels(values):
        acc, cnt = reduce_with_count_plain(values, validity, n, op)
        return acc.item(), int(cnt)
    host = _reduce_cuda(values, validity, n, op).cpu()
    return _acc_of(host, _acc_dtype(op, values.dtype)).item(), int(host[1])


def mean(values: torch.Tensor, validity: Optional[torch.Tensor],
         n: int) -> torch.Tensor:
    """Sum over count of the valid rows (float64; 0.0 when none)."""
    s, c = reduce_with_count(values, validity, n, "sum")
    return s.to(torch.float64) / torch.clamp(c.to(torch.float64), min=1)


def _lib():
    global _ctypes_ready
    lib = cuda_build.load("reduce")
    if not _ctypes_ready:
        p = ctypes.c_void_p
        lib.agt_reduce.argtypes = [ctypes.c_int, ctypes.c_int, p, p,
                                   ctypes.c_longlong, ctypes.c_int, p,
                                   ctypes.c_int, p, p]
        lib.agt_reduce.restype = ctypes.c_int
        _ctypes_ready = True
    return lib


def _acc_of(out: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """The accumulator K3 wrote into the first bytes of out[0] (0-d)."""
    return out[:1].view(acc)[0]


def _reduce_cuda(values: torch.Tensor, validity: Optional[torch.Tensor],
                 n: int, op: str) -> torch.Tensor:
    """One K3 launch; returns its 2 int64 of output: the accumulator's
    bits in out[0], the count of rows taken in out[1]."""
    _check(values, op)
    if not values.is_contiguous():
        raise ValueError("reduce: values must be contiguous")
    P = values.shape[0]
    n = max(0, min(int(n), P))
    if validity is not None:
        if validity.dtype != torch.int32 or validity.dim() != 1 or \
                not validity.is_contiguous() or \
                validity.device != values.device:
            raise ValueError("reduce: validity must be contiguous 1-D int32 "
                             "words on the values' device")
        if validity.shape[0] * 32 < n:
            raise ValueError(f"reduce: {validity.shape[0]} validity words do "
                             f"not cover {n} rows")
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        scratch = cuda_build.stream_scratch("reduce", values.device, stream,
                                            2 * _PARTIALS + 1)
        out = torch.empty(2, dtype=torch.int64, device=values.device)
        cuda_build.check(lib.agt_reduce(
            _DTYPE_CODE[values.dtype], _OP_CODE[op], values.data_ptr(),
            None if validity is None else validity.data_ptr(), n,
            int(values.data_ptr() % 16 == 0), scratch.data_ptr(),
            _PARTIALS, out.data_ptr(), stream), "K3 reduce")
    reduce.launches += 1
    return out
