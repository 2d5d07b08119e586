"""Scalar (elementwise) kernels over device columns.

Port of the arithmetic, comparison and boolean part of
arrow_go_tpu/compute/kernels.py (reference arrow/compute/arithmetic.go,
internal/kernels/scalar_comparisons.go, scalar_bool.go). Null semantics
of the plain kernels follow the
executor-kernel contract NullHandling=Intersection (exec/kernel.go:457):
output validity = AND of the input validity words.

Checked arithmetic ('add' etc. called directly) detects integer overflow
like the reference's non-_unchecked functions and raises ArrowInvalid;
expressions run unchecked, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import dtypes as dt
from ..device.block import DeviceColumn, valid_rows
from ..ops import bitmap
from .errors import ArrowInvalid, ArrowNotImplemented

_ARITH_BINARY = {
    "add": torch.add, "subtract": torch.subtract, "multiply": torch.multiply,
}

_COMPARE = {
    "equal": torch.eq, "not_equal": torch.ne,
    "less": torch.lt, "less_equal": torch.le,
    "greater": torch.gt, "greater_equal": torch.ge,
}


def _broadcast_scalar(v, t: dt.DataType, P: int, n: int,
                      device) -> DeviceColumn:
    """Python scalar -> constant DeviceColumn (null scalar -> all-null)."""
    if isinstance(v, float) and not t.is_floating:
        t = dt.float64
    if isinstance(v, bool):
        t = dt.bool_
    if v is None:
        vals = torch.zeros(P, dtype=t.torch_dtype, device=device)
        words = torch.zeros(P // 32, dtype=torch.int32, device=device)
        return DeviceColumn(vals, words, n, t)
    return DeviceColumn(torch.full((P,), v, dtype=t.torch_dtype,
                                   device=device), None, n, t)


def _align(a, b) -> Tuple[DeviceColumn, DeviceColumn]:
    if not isinstance(b, DeviceColumn):
        b = _broadcast_scalar(b, a.type, a.padded, a.length, a.device)
        return a, b
    if not isinstance(a, DeviceColumn):
        a = _broadcast_scalar(a, b.type, b.padded, b.length, b.device)
    if a.padded != b.padded:
        raise ArrowInvalid(f"length/padding mismatch {a.padded} vs {b.padded}")
    return a, b


def _out_validity(a: DeviceColumn, b: Optional[DeviceColumn] = None):
    v = a.validity
    if b is not None:
        v = bitmap.words_and(v, b.validity)
    return v


def _cast_operands(a: DeviceColumn, b: DeviceColumn, to: dt.DataType):
    av = a.values.to(to.torch_dtype) if a.type != to else a.values
    bv = b.values.to(to.torch_dtype) if b.type != to else b.values
    return av, bv


def arithmetic_binary(op: str, a, b, checked: bool = True) -> DeviceColumn:
    if op not in _ARITH_BINARY:
        raise ArrowNotImplemented(f"arithmetic {op!r} is not ported")
    a, b = _align(a, b)
    to = dt.common_numeric_type(a.type, b.type)
    av, bv = _cast_operands(a, b, to)
    validity = _out_validity(a, b)
    n = max(a.length, b.length)
    out = _ARITH_BINARY[op](av, bv).to(to.torch_dtype)
    if checked and to.is_integer:
        _check_overflow(op, av, bv, out, validity, n, to)
    return DeviceColumn(out, validity, n, to)


def _overflow_flag(op, av, bv, out, mask) -> torch.Tensor:
    if op == "add":
        bad = ((av > 0) & (bv > 0) & (out < 0)) | (
            (av < 0) & (bv < 0) & (out >= 0))
    elif op == "subtract":
        bad = ((av >= 0) & (bv < 0) & (out < 0)) | (
            (av < 0) & (bv > 0) & (out >= 0))
    else:  # multiply: recompute in float64 and compare magnitude
        approx = av.to(torch.float64) * bv.to(torch.float64)
        bad = torch.abs(approx - out.to(torch.float64)) > 1.0
    return (bad & mask).any()


def _check_overflow(op, av, bv, out, validity, n, to):
    mask = valid_rows(validity, av.shape[0], n, av.device)
    if bool(_overflow_flag(op, av, bv, out, mask)):
        raise ArrowInvalid(f"integer overflow in {op} ({to})")


def compare(op: str, a, b) -> DeviceColumn:
    a, b = _align(a, b)
    to = dt.common_numeric_type(a.type, b.type) if a.type != b.type \
        else a.type
    av, bv = _cast_operands(a, b, to)
    out = _COMPARE[op](av, bv)
    return DeviceColumn(out, _out_validity(a, b), max(a.length, b.length),
                        dt.bool_)


# ---------------------------------------------------------------------------
# boolean kernels incl. Kleene (reference scalar_bool.go:123-140)
# ---------------------------------------------------------------------------

_BOOLEAN = {"and": torch.logical_and, "or": torch.logical_or}
_KLEENE = ("and_kleene", "or_kleene")


def _known(c: DeviceColumn) -> torch.Tensor:
    if c.validity is None:
        return torch.ones(c.padded, dtype=torch.bool, device=c.device)
    return bitmap.expand_words(c.validity, c.padded)


def boolean_binary(op: str, a, b) -> DeviceColumn:
    """and / or (nulls intersect) and and_kleene / or_kleene (null =
    unknown). A Kleene result always carries its validity words, so no
    host sync decides their presence: where the JAX package drops the
    words of an all-known result, these words are all set."""
    a, b = _align(a, b)
    if a.type != dt.bool_ or b.type != dt.bool_:
        raise ArrowNotImplemented(f"{op} requires booleans")
    av, bv = a.values, b.values
    n = max(a.length, b.length)
    if op in _BOOLEAN:
        return DeviceColumn(_BOOLEAN[op](av, bv), _out_validity(a, b), n,
                            dt.bool_)
    a_known, b_known = _known(a), _known(b)
    if op == "and_kleene":
        out = av & bv
        known = (a_known & b_known) | (a_known & ~av) | (b_known & ~bv)
    elif op == "or_kleene":
        out = av | bv
        known = (a_known & b_known) | (a_known & av) | (b_known & bv)
    else:
        raise ArrowNotImplemented(f"boolean {op!r} is not ported")
    return DeviceColumn(out, bitmap.pack_mask(known), n, dt.bool_)


def invert(a: DeviceColumn) -> DeviceColumn:
    if a.type != dt.bool_:
        raise ArrowNotImplemented("invert requires boolean")
    return DeviceColumn(~a.values, a.validity, a.length, dt.bool_)
