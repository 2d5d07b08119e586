"""Decimal128 and decimal256 arithmetic over little-endian 64-bit limbs.

Port of arrow_go_tpu/ops/decimal.py (reference arrow/decimal128 and
arrow/decimal256: two's-complement add, subtract, multiply, compare and
negate), whole columns at a time. A column is a (P, 2) or (P, k) int64
tensor: [:, 0] is the lowest limb, and each limb carries the u64 bits
the JAX package holds in uint64.

torch has no usable uint64, so the unsigned operations of the JAX code
are spelled out here: a right shift of a limb masks the bits the
arithmetic shift copied from the sign (`_shr`), and a carry or borrow
test `s < a` compares with the sign bits flipped (`_ult`). Products
split limbs into 32-bit halves, as the JAX code does; the product of
two halves can pass 2**63, and int64 multiplication keeps its low 64
bits, the bits uint64 keeps. Every result is the JAX package's, bit for
bit, quirks included: `mul128` drops the carries out of its middle
partial sums as the JAX code does (the kernels multiply with `muln`,
which keeps them).
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INT64_MIN = -(1 << 63)


def _shr(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits (in int64) by 0 < s < 64."""
    return (v >> s) & ((1 << (64 - s)) - 1)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b of u64 bits held in int64, as int64 0 / 1."""
    return ((a ^ INT64_MIN) < (b ^ INT64_MIN)).to(torch.int64)


def _split(v: torch.Tensor):
    return v & MASK32, _shr(v, 32)


def add128(a, b):
    """(P,2) + (P,2) -> (P,2) with carry, wrapping (two's complement)."""
    lo = a[:, 0] + b[:, 0]
    hi = a[:, 1] + b[:, 1] + _ult(lo, a[:, 0])
    return torch.stack([lo, hi], dim=1)


def neg128(a):
    lo = ~a[:, 0] + 1
    # ~a.lo + 1 wraps to 0 only when a.lo == 0: a carry into hi
    hi = ~a[:, 1] + (a[:, 0] == 0).to(torch.int64)
    return torch.stack([lo, hi], dim=1)


def sub128(a, b):
    return add128(a, neg128(b))


def mul128(a, b):
    """Low 128 bits of the product via 32-bit limbs, with the JAX
    package's carries: a carry out of a partial sum's 64 bits is lost."""
    a0, a1 = _split(a[:, 0])
    a2, a3 = _split(a[:, 1])
    b0, b1 = _split(b[:, 0])
    b2, b3 = _split(b[:, 1])
    p0 = a0 * b0
    p1 = a0 * b1 + a1 * b0
    p2 = a0 * b2 + a1 * b1 + a2 * b0
    p3 = a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0
    l0 = p0 & MASK32
    t1 = p1 + _shr(p0, 32)
    l1 = t1 & MASK32
    t2 = p2 + _shr(t1, 32)
    l2 = t2 & MASK32
    t3 = p3 + _shr(t2, 32)
    l3 = t3 & MASK32
    return torch.stack([l0 | (l1 << 32), l2 | (l3 << 32)], dim=1)


def cmp128(a, b):
    """Signed compare: -1 / 0 / 1 as int32."""
    return cmpn(a, b)


def is_negative(a):
    return a[:, 1] < 0


def from_int64(v):
    """int64 column -> (P,2) limbs (sign-extended)."""
    return from_int64_n(v, 2)


def scale_by_pow10(a, k: int):
    """a * 10**k (k >= 0, static): (x << 3) + (x << 1) per factor."""
    out = a
    for _ in range(k):
        x8 = torch.stack([out[:, 0] << 3,
                          (out[:, 1] << 3) | _shr(out[:, 0], 61)], dim=1)
        x2 = torch.stack([out[:, 0] << 1,
                          (out[:, 1] << 1) | _shr(out[:, 0], 63)], dim=1)
        out = add128(x8, x2)
    return out


# ---------------------------------------------------------------------------
# k-limb two's-complement arithmetic: decimal256 is (P, 4) (reference
# arrow/decimal256/decimal256.go, the 4x64 Add/Sub/Mul/Cmp semantics)
# ---------------------------------------------------------------------------

def addn(a, b):
    """(P,k) + (P,k) ripple-carry, wrapping."""
    limbs = []
    carry = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for i in range(a.shape[1]):
        s = a[:, i] + b[:, i]
        s2 = s + carry
        carry = _ult(s, a[:, i]) + _ult(s2, s)
        limbs.append(s2)
    return torch.stack(limbs, dim=1)


def negn(a):
    """Two's-complement negate: ~a + 1 with carries."""
    limbs = []
    carry = torch.ones(a.shape[0], dtype=torch.int64, device=a.device)
    for i in range(a.shape[1]):
        inv = ~a[:, i]
        s = inv + carry
        carry = _ult(s, inv)
        limbs.append(s)
    return torch.stack(limbs, dim=1)


def subn(a, b):
    return addn(a, negn(b))


def muln(a, b):
    """Low 64k bits of the product (wrapping), via 32-bit limbs. Each
    32-bit output limb sums its partial products' low and high halves
    apart, so no sum passes 2**63."""
    k = a.shape[1]
    a32, b32 = [], []
    for i in range(k):
        a32 += _split(a[:, i])
        b32 += _split(b[:, i])
    out32 = []
    carry = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for j in range(2 * k):
        acc_lo = carry & MASK32
        acc_hi = carry >> 32              # carry < 2**63: no sign bits
        for i in range(j + 1):
            p = a32[i] * b32[j - i]
            acc_lo = acc_lo + (p & MASK32)
            acc_hi = acc_hi + _shr(p, 32)
        out32.append(acc_lo & MASK32)
        carry = acc_hi + (acc_lo >> 32)
    return torch.stack([out32[2 * i] | (out32[2 * i + 1] << 32)
                        for i in range(k)], dim=1)


def cmpn(a, b):
    """Signed compare over k limbs: -1 / 0 / 1 as int32. The top limb
    compares signed, the others unsigned; the most significant limb
    that differs decides."""
    k = a.shape[1]
    out = None
    for i in reversed(range(k)):
        av, bv = a[:, i], b[:, i]
        if i != k - 1:
            av, bv = av ^ INT64_MIN, bv ^ INT64_MIN
        here = (av > bv).to(torch.int32) - (av < bv).to(torch.int32)
        out = here if out is None else torch.where(out == 0, here, out)
    return out


def is_negative_n(a):
    return a[:, -1] < 0


def from_int64_n(v, k: int):
    """int64 column -> (P,k) limbs (sign-extended)."""
    ext = v >> 63
    return torch.stack([v] + [ext] * (k - 1), dim=1)


def shln_1(a, shift: int):
    """a << shift (0 <= shift < 64), whole column."""
    if shift == 0:
        return a
    limbs = [a[:, 0] << shift]
    for i in range(1, a.shape[1]):
        limbs.append((a[:, i] << shift) | _shr(a[:, i - 1], 64 - shift))
    return torch.stack(limbs, dim=1)


def scale_by_pow10_n(a, p10: int):
    """a * 10**p10 (static, >= 0): (x << 3) + (x << 1) per factor."""
    out = a
    for _ in range(p10):
        out = addn(shln_1(out, 3), shln_1(out, 1))
    return out


def sign_extend(a, k: int):
    """(P, j) limbs widened to (P, k >= j), the sign limb repeated."""
    if a.shape[1] >= k:
        return a
    ext = (a[:, -1] >> 63).unsqueeze(1).expand(-1, k - a.shape[1])
    return torch.cat([a, ext], dim=1)


def to_ints(limbs):
    """Host helper: an (n, k) numpy array of limbs (int64 or uint64) as
    a numpy object array of the Python ints they hold (two's
    complement)."""
    u = np.ascontiguousarray(limbs).view(np.uint64)
    k = u.shape[1]
    v = u[:, k - 1].astype(object)
    for i in reversed(range(k - 1)):
        v = (v << 64) | u[:, i].astype(object)
    neg = (u[:, k - 1] >> np.uint64(63)).astype(bool)
    v[neg] -= 1 << (64 * k)
    return v


def from_ints(values, k: int):
    """Host helper: Python ints as an (n, k) int64 numpy array of limbs
    (wrapping mod 2**(64k))."""
    v = np.asarray(values, dtype=object).reshape(-1)
    mask = (1 << 64) - 1
    out = np.zeros((len(v), k), np.uint64)
    for i in range(k):
        out[:, i] = ((v >> (64 * i)) & mask).astype(np.uint64)
    return out.view(np.int64)
