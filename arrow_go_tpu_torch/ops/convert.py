"""Value conversion between the storage tensors of logical types, and the
integer primitives whose result depends on signedness.

uint16, uint32 and uint64 live in int16, int32 and int64 tensors that
carry their raw bits (dtypes.py), so torch's own conversions and
compares would read them as signed. The functions here read them as
unsigned: widening zero-extends, compares flip the sign bit first,
division, modulo and right shift are the unsigned operations, and a
conversion to float rounds the unsigned value once.

Every conversion matches the JAX package's `astype` (XLA's convert):
integer narrowing wraps; a float becomes an integer by truncation, NaN
becoming 0 and an out-of-range value the target's minimum or maximum
(the clamp is explicit, so the CPU and the card give the same bits);
float64 to float16 rounds once (torch's own conversion rounds twice,
through float32), and a NaN becomes float16's canonical NaN on the card
as on the CPU.
"""
from __future__ import annotations

import torch

from .. import dtypes as dt

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


def _mask(t: dt.DataType) -> int:
    return (1 << t.bit_width) - 1


def as_int64(v: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """The integer (or bool, or temporal) values as int64: unsigned
    values zero-extended (a uint64 keeps its bits), signed ones
    sign-extended."""
    out = v.to(torch.int64)
    if t.stores_unsigned_as_signed and t.bit_width < 64:
        out = out & _mask(t)
    return out


def order_bits(v: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """The values in a tensor whose signed order is the logical order:
    an unsigned type's bits with the sign bit flipped, else the values."""
    if t.stores_unsigned_as_signed:
        return v ^ torch.iinfo(v.dtype).min
    return v


def shift_right_logical(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Unsigned right shift of an int tensor's bits by s in [0, width)."""
    width = v.element_size() * 8
    if v.dtype == torch.uint8:
        return v >> s
    if width < 64:
        return ((v.to(torch.int64) & ((1 << width) - 1)) >> s).to(v.dtype)
    s = torch.as_tensor(s, dtype=torch.int64, device=v.device)
    keep = torch.full_like(v, INT64_MAX) >> torch.clamp(s - 1, min=0)
    return torch.where(s == 0, v, (v >> s) & keep)


def u64_divmod(a: torch.Tensor, b: torch.Tensor):
    """Unsigned 64-bit quotient and remainder of the bits of int64 a and
    b (b != 0): the quotient of a >> 1 by b, doubled, is off by at most
    one; a divisor of 2**63 or more goes into a at most once."""
    big = b < 0
    half = torch.div((a >> 1) & INT64_MAX, torch.where(big, 1, b),
                     rounding_mode="floor")
    q = half << 1
    r = a - q * b
    q = torch.where(order_bits(r, dt.uint64) >= order_bits(b, dt.uint64),
                    q + 1, q)
    q = torch.where(big, (order_bits(a, dt.uint64)
                          >= order_bits(b, dt.uint64)).to(torch.int64), q)
    return q, a - q * b


def _u64_to_float(v: torch.Tensor, fdtype) -> torch.Tensor:
    """uint64 bits -> float, rounded once: a value of 2**63 or more
    halves with its lost bit kept as a sticky bit, converts, and
    doubles exactly."""
    halved = ((v >> 1) & INT64_MAX) | (v & 1)
    return torch.where(v < 0, halved.to(fdtype) * 2, v.to(fdtype))


def _f64_to_f16(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float16 rounded once, to nearest even: float32 rounded
    to odd first (toward zero, then the last bit set when inexact) keeps
    the one rounding to float16 exact."""
    r = v.to(torch.float32)
    bits = r.view(torch.int32)
    fin = torch.isfinite(v)
    bits = torch.where(fin & (r.to(torch.float64).abs() > v.abs()),
                       bits - 1, bits)
    inexact = fin & (bits.view(torch.float32).to(torch.float64) != v)
    return torch.where(inexact, bits | 1, bits).view(torch.float32).to(
        torch.float16)


def int_range(t: dt.DataType):
    """The (min, max) of an integer type, as Python ints."""
    if t.is_unsigned_integer:
        return 0, _mask(t)
    hi = (1 << (t.bit_width - 1)) - 1
    return -hi - 1, hi


def _float_to_int(v: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """Truncation toward zero, NaN -> 0, out of range -> the target's
    minimum or maximum (XLA's saturating convert)."""
    lo, hi = int_range(t)
    tv = torch.trunc(v)
    nan = torch.isnan(v)
    wide = tv.to(torch.float64)           # (a float16 has no 2**31)
    above = wide >= float(hi + 1)         # a power of two: exact
    below = wide < float(lo)
    safe = torch.where(nan | above | below, torch.zeros_like(tv), tv)
    if t.id == dt.TypeId.UINT64:
        top = safe >= float(1 << 63)
        out = torch.where(top, (safe - float(1 << 63)).to(torch.int64)
                          ^ INT64_MIN, safe.to(torch.int64))
    else:
        out = safe.to(torch.int64)
    top = hi if hi <= INT64_MAX else hi - (1 << 64)   # uint64: its bits
    out = torch.where(above, top, torch.where(below, lo, out))
    return _narrow(out, t)


def _narrow(v64: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """int64 values -> t's storage, keeping the low bits (wrapping)."""
    if t.torch_dtype == torch.uint8:
        v64 = v64 & 0xFF
    return v64.to(t.torch_dtype)


def _storage_type(t: dt.DataType) -> dt.DataType:
    """A temporal type converts as the signed integer it is stored in."""
    if t.is_temporal:
        return dt.int32 if t.bit_width == 32 else dt.int64
    return t


def convert(v: torch.Tensor, from_t: dt.DataType,
            to_t: dt.DataType) -> torch.Tensor:
    """Values of type from_t (its storage tensor) as values of type to_t
    (its storage tensor), as the JAX package's `astype` converts them:
    bool, numeric and temporal types (a temporal type converts as its
    storage integer; units are not rescaled here)."""
    f, t = _storage_type(from_t), _storage_type(to_t)
    if f == t:
        return v
    if t == dt.bool_:
        return v != 0
    if f == dt.bool_:
        return v.to(t.torch_dtype)
    if f.is_floating and t.is_integer:
        return _float_to_int(v, t)
    if f.is_integer and t.is_integer:
        return _narrow(as_int64(v, f), t)
    if f.is_integer:                       # -> float
        if f.id == dt.TypeId.UINT64:
            out = _u64_to_float(v, torch.float32 if t == dt.float16
                                else t.torch_dtype)
            return out.to(t.torch_dtype)
        return as_int64(v, f).to(t.torch_dtype) \
            if f.stores_unsigned_as_signed else v.to(t.torch_dtype)
    if t == dt.float16:
        # a NaN becomes the canonical float16 NaN, 0x7e00, as on the CPU
        # (the card's own conversion gives 0x7fff)
        out = _f64_to_f16(v) if f == dt.float64 else v.to(torch.float16)
        return torch.where(torch.isnan(v), _f16_nan(v.device), out)
    return v.to(t.torch_dtype)


def _f16_nan(device) -> torch.Tensor:
    return torch.tensor(0x7E00, dtype=torch.int16).view(torch.float16).to(
        device)


def host_view(a, t: dt.DataType):
    """A numpy array of t's storage dtype viewed as t's numpy dtype."""
    return a.view(t.np_dtype) if t.stores_unsigned_as_signed else a


def storage_view(a, t: dt.DataType):
    """A numpy array of t's numpy dtype viewed as its storage dtype."""
    if t.stores_unsigned_as_signed:
        return a.view(f"i{a.dtype.itemsize}")
    return a
