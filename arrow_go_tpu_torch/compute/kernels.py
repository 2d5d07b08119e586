"""Scalar (elementwise) kernels over device columns.

Port of the arithmetic, comparison, boolean and validity part of
arrow_go_tpu/compute/kernels.py (reference arrow/compute/arithmetic.go,
internal/kernels/scalar_comparisons.go, scalar_bool.go). Null semantics
of the plain kernels follow the
executor-kernel contract NullHandling=Intersection (exec/kernel.go:457):
output validity = AND of the input validity words.

Checked arithmetic ('add' etc. called directly) detects integer overflow
and division by zero like the reference's non-_unchecked functions and
raises ArrowInvalid; expressions run unchecked, as in the JAX package.
Integer division truncates toward zero (Go semantics); `mod` is floored
(the sign of the divisor), as `jnp.mod`. uint16, uint32 and uint64
columns hold their bits in signed storage (dtypes.py), so every
operation whose result depends on signedness (compares, divide, mod,
shift right, min/max, the overflow checks, widening) reads them as
unsigned through ops/convert.py. Two temporal operands combine only
when they share a type; a Python int beside a temporal column is
broadcast to the column's type. `round_` and `round_to_multiple` take
the nine round modes.

A string-like or fixed_size_binary operand (or a dictionary of one)
of an arithmetic or math function, or of `round_to_multiple`, raises
ArrowNotImplemented (`refuse_codes`): its rows are dictionary codes.
Bool operands follow the JAX package's jnp functions: abs, floor, ceil
and trunc give the bool column back, negate, sign and subtract raise
TypeError, and divide gives a or not b (the bool of a float quotient).

decimal128 and decimal256 operands (limb matrices) take
`_decimal_binary`, as in the JAX package: add, subtract and the
compares align the scales by powers of ten, multiply adds precisions
and scales, and an int or Decimal scalar becomes the column's unscaled
value (int(Decimal.scaleb(scale)) truncates, as there); every other op
and a non-decimal operand raise ArrowNotImplemented. decimal32 and
decimal64 run as their storage integers, as in the JAX package: an int
scalar is an unscaled value, a product keeps the operand type, no
overflow check runs, and divide truncates.
"""
from __future__ import annotations

import decimal as pydec
import operator
from typing import Optional, Tuple

import torch

from .. import dtypes as dt
from ..device.block import DeviceColumn, row_mask, valid_rows
from ..dtypes import common_numeric_type  # noqa: F401  (the JAX name)
from ..ops import bitmap
from ..ops import convert as cv
from ..ops import decimal as dec
from .errors import ArrowInvalid, ArrowNotImplemented


def _divide(a, b):
    if a.dtype.is_floating_point:
        return a / b
    # truncation toward zero; x / 0 is x, as in the JAX package, and
    # x / -1 is -x (INT_MIN / -1 traps on x86, and wraps to INT_MIN here)
    minus_one = b == -1
    q = torch.div(a, torch.where((b == 0) | minus_one, 1, b),
                  rounding_mode="trunc")
    return torch.where(minus_one, -a, q)


def _shift_left(a, b):
    return a << (b & (a.element_size() * 8 - 1))


def _shift_right(a, b):
    return a >> (b & (a.element_size() * 8 - 1))


def _logb(a, b):
    return torch.log(a) / torch.log(b)


def _mod(a, b):
    if a.dtype.is_floating_point:
        return torch.remainder(a, b)
    # x mod 0 is 0 as in jnp.mod, and x mod -1 is 0 (INT_MIN % -1 traps
    # on x86): both take the divisor 1
    return torch.remainder(a, torch.where((b == 0) | (b == -1), 1, b))


_ARITH_BINARY = {
    "add": torch.add, "subtract": torch.subtract, "multiply": torch.multiply,
    "divide": _divide,
    "power": torch.pow, "atan2": torch.atan2, "logb": _logb,
    "bit_wise_and": torch.bitwise_and, "bit_wise_or": torch.bitwise_or,
    "bit_wise_xor": torch.bitwise_xor,
    "shift_left": _shift_left, "shift_right": _shift_right,
    "max_element_wise": torch.maximum, "min_element_wise": torch.minimum,
    "mod": _mod,
}


def _sign(a):
    # torch.sign(NaN) is 0; the sign of NaN is NaN, as in jnp.sign
    out = torch.sign(a)
    return torch.where(torch.isnan(a), a, out) if a.is_floating_point() \
        else out


_ARITH_UNARY = {
    "negate": torch.neg, "abs": torch.abs, "sign": _sign,
    "sqrt": torch.sqrt, "exp": torch.exp, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "ln": torch.log, "log10": torch.log10, "log2": torch.log2,
    "log1p": torch.log1p, "floor": torch.floor, "ceil": torch.ceil,
    "trunc": torch.trunc, "bit_wise_not": torch.bitwise_not,
}

_FLOAT_ONLY = {"sqrt", "exp", "expm1", "sin", "cos", "tan", "asin", "acos",
               "atan", "sinh", "cosh", "tanh", "ln", "log10", "log2",
               "log1p", "power", "atan2", "logb"}

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
    if t.stores_unsigned_as_signed and v >= 1 << (t.bit_width - 1):
        v -= 1 << t.bit_width              # the same bits, signed
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
    return cv.convert(a.values, a.type, to), cv.convert(b.values, b.type, to)


def _unsigned_binary(op: str, av, bv, t: dt.DataType):
    """The ops whose result depends on signedness, on unsigned storage
    (divide and mod take the divisor 1 for 0, as the signed ops do)."""
    if op in ("max_element_wise", "min_element_wise"):
        ge = cv.order_bits(av, t) >= cv.order_bits(bv, t)
        return torch.where(ge if op == "max_element_wise" else ~ge, av, bv)
    if op == "shift_right":
        return cv.shift_right_logical(av, bv & (t.bit_width - 1))
    zero = bv == 0
    if t.bit_width == 64:
        q, r = cv.u64_divmod(av, torch.where(zero, 1, bv))
    else:
        a64, b64 = cv.as_int64(av, t), cv.as_int64(bv, t)
        b64 = torch.where(zero, 1, b64)
        q, r = a64 // b64, a64 % b64
    out = q if op == "divide" else torch.where(zero, 0, r)
    return out.to(t.torch_dtype)


_UNSIGNED_OPS = ("divide", "mod", "shift_right", "max_element_wise",
                 "min_element_wise")


def _wide_decimal(x) -> bool:
    return isinstance(x, DeviceColumn) and x.type.limbs > 0


def refuse_codes(x, what: str) -> None:
    """ArrowNotImplemented when `x` is a column of a string-like or
    fixed_size_binary type, or a dictionary of one: its rows are codes
    into a dictionary, and a number made of a code means nothing (the
    JAX package computes on its own codes, or fails)."""
    t = getattr(x, "type", None)
    if t is None:
        return
    vt = t.value_type if t.id == dt.TypeId.DICTIONARY else t
    if vt.codes_on_device:
        raise ArrowNotImplemented(f"{what} of a {t} column")


def arithmetic_binary(op: str, a, b, checked: bool = True) -> DeviceColumn:
    if _wide_decimal(a) or _wide_decimal(b):
        return _decimal_binary(op, a, b)
    if op not in _ARITH_BINARY:
        raise ArrowNotImplemented(f"arithmetic {op!r} is not ported")
    refuse_codes(a, op)
    refuse_codes(b, op)
    a, b = _align(a, b)
    to = dt.common_numeric_type(a.type, b.type)
    if to == dt.bool_ and op in ("subtract", "divide"):
        return _bool_binary(op, a, b)
    if op in _FLOAT_ONLY and not to.is_floating:
        to = dt.float64
    if op.startswith(("bit_wise", "shift")) and not to.is_integer:
        raise ArrowNotImplemented(f"{op} requires integers, got {to}")
    av, bv = _cast_operands(a, b, to)
    validity = _out_validity(a, b)
    n = max(a.length, b.length)
    if checked and op == "divide" and to.is_integer and bool(
            ((bv == 0) & valid_rows(validity, av.shape[0], n,
                                    av.device)).any()):
        raise ArrowInvalid("divide by zero")
    if to.is_unsigned_integer and op in _UNSIGNED_OPS:
        out = _unsigned_binary(op, av, bv, to)
    else:
        out = _ARITH_BINARY[op](av, bv).to(to.torch_dtype)
    if checked and to.is_integer and op in ("add", "subtract", "multiply"):
        _check_overflow(op, av, bv, out, validity, n, to)
    return DeviceColumn(out, validity, n, to)


def _bool_binary(op: str, a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    """subtract and divide of two bool operands, as the JAX package gives
    them: subtract raises TypeError (jnp has no bool subtract); divide
    is the bool of the float quotient, a / b != 0 (NaN counting as
    true), so a or not b."""
    if op == "subtract":
        raise TypeError("subtract does not accept bool operands")
    return DeviceColumn(a.values | ~b.values, _out_validity(a, b),
                        max(a.length, b.length), dt.bool_)


#: unary functions of a bool column: the column as it is, or TypeError,
#: as the JAX package's jnp functions give them
_BOOL_SAME = ("abs", "floor", "ceil", "trunc")
_BOOL_REFUSED = ("negate", "sign")


def arithmetic_unary(op: str, a: DeviceColumn,
                     checked: bool = True) -> DeviceColumn:
    if op not in _ARITH_UNARY:
        raise ArrowNotImplemented(f"arithmetic {op!r} is not ported")
    refuse_codes(a, op)
    if a.type == dt.bool_ and op in _BOOL_SAME:
        return DeviceColumn(a.values, a.validity, a.length, dt.bool_)
    if a.type == dt.bool_ and op in _BOOL_REFUSED:
        raise TypeError(f"{op} does not accept a bool column")
    to = a.type
    if op in _FLOAT_ONLY and not to.is_floating:
        to = dt.float64
    if op == "bit_wise_not" and not to.is_integer:
        raise ArrowNotImplemented("bit_wise_not requires integers")
    av = cv.convert(a.values, a.type, to)
    if op == "negate" and checked and to.is_unsigned_integer and bool(
            ((av != 0) & valid_rows(a.validity, a.padded, a.length,
                                    a.device)).any()):
        raise ArrowInvalid("negate overflow on unsigned")
    if to.is_unsigned_integer and op in ("abs", "sign"):
        out = av if op == "abs" else (av != 0).to(to.torch_dtype)
    else:
        out = _ARITH_UNARY[op](av).to(to.torch_dtype)
    return DeviceColumn(out, a.validity, a.length, to)


def _overflow_flag(op, av, bv, out, mask, to) -> torch.Tensor:
    if to.is_unsigned_integer and op in ("add", "subtract"):
        # an unsigned sum wrapped iff it is below an addend; a difference
        # iff the subtrahend is the larger
        x, y = (out, av) if op == "add" else (av, bv)
        bad = cv.order_bits(x, to) < cv.order_bits(y, to)
    elif op == "add":
        bad = ((av > 0) & (bv > 0) & (out < 0)) | (
            (av < 0) & (bv < 0) & (out >= 0))
    elif op == "subtract":
        bad = ((av >= 0) & (bv < 0) & (out < 0)) | (
            (av < 0) & (bv > 0) & (out >= 0))
    else:  # multiply: recompute in float64 and compare magnitude
        approx = cv.convert(av, to, dt.float64) * cv.convert(bv, to,
                                                            dt.float64)
        bad = torch.abs(approx - cv.convert(out, to, dt.float64)) > 1.0
    return (bad & mask).any()


def _check_overflow(op, av, bv, out, validity, n, to):
    mask = valid_rows(validity, av.shape[0], n, av.device)
    if bool(_overflow_flag(op, av, bv, out, mask, to)):
        raise ArrowInvalid(f"integer overflow in {op} ({to})")


_FLIP = {"equal": "equal", "not_equal": "not_equal", "less": "greater",
         "less_equal": "greater_equal", "greater": "less",
         "greater_equal": "less_equal"}


def _is_dict(x) -> bool:
    return isinstance(x, DeviceColumn) and x.type.id == dt.TypeId.DICTIONARY


def compare(op: str, a, b) -> DeviceColumn:
    if _wide_decimal(a) or _wide_decimal(b):
        return _decimal_binary(op, a, b)
    # string comparisons: dictionary codes vs a host literal resolve to a
    # per-code truth table gathered on the device
    if _is_dict(a) and isinstance(b, (str, bytes)):
        return _compare_dict_scalar(op, a, b)
    if _is_dict(b) and isinstance(a, (str, bytes)):
        return _compare_dict_scalar(_FLIP[op], b, a)
    a, b = _align(a, b)
    if _is_dict(a) or _is_dict(b):
        raise ArrowNotImplemented(
            "compare dictionary vs dictionary: decode first")
    to = dt.common_numeric_type(a.type, b.type) if a.type != b.type \
        else a.type
    av, bv = _cast_operands(a, b, to)
    out = _COMPARE[op](cv.order_bits(av, to), cv.order_bits(bv, to))
    return DeviceColumn(out, _out_validity(a, b), max(a.length, b.length),
                        dt.bool_)


def _decimal_binary(op: str, a, b) -> DeviceColumn:
    """decimal128 / decimal256 add, subtract, multiply and compares on
    limb matrices (reference decimal promotion rules; arrow/decimal256
    4x64-limb semantics): the narrower operand is sign-extended to the
    wider's limbs, add / subtract / compare bring both to the larger
    scale, and the result is decimal256 when either side is."""
    if not isinstance(a, DeviceColumn):
        a = _decimal_scalar_to_col(a, b)
    if not isinstance(b, DeviceColumn):
        b = _decimal_scalar_to_col(b, a)
    ta, tb = a.type, b.type
    if not (ta.limbs and tb.limbs):
        raise ArrowNotImplemented(f"decimal binary {op} with {ta} vs {tb}")
    if a.padded != b.padded:
        raise ArrowInvalid(f"length/padding mismatch {a.padded} vs {b.padded}")
    validity = _out_validity(a, b)
    n = max(a.length, b.length)
    k = max(ta.limbs, tb.limbs)
    max_p, mk = (76, dt.decimal256) if k == 4 else (38, dt.decimal128)
    av, bv = dec.sign_extend(a.values, k), dec.sign_extend(b.values, k)
    if op in ("add", "subtract") or op in _COMPARE:
        s_out = max(ta.scale, tb.scale)
        av = dec.scale_by_pow10_n(av, s_out - ta.scale)
        bv = dec.scale_by_pow10_n(bv, s_out - tb.scale)
        if op in _COMPARE:
            c = dec.cmpn(av, bv)
            return DeviceColumn(_COMPARE[op](c, 0), validity, n, dt.bool_)
        out = dec.addn(av, bv) if op == "add" else dec.subn(av, bv)
        p = min(max_p, max(ta.precision - ta.scale,
                           tb.precision - tb.scale) + s_out + 1)
        return DeviceColumn(out, validity, n, mk(p, s_out))
    if op == "multiply":
        p = min(max_p, ta.precision + tb.precision + 1)
        return DeviceColumn(dec.muln(av, bv), validity, n,
                            mk(p, ta.scale + tb.scale))
    raise ArrowNotImplemented(f"decimal {op}")


def _decimal_scalar_to_col(v, like: DeviceColumn) -> DeviceColumn:
    """An int or Decimal scalar as a constant column of `like`'s decimal
    type: its unscaled value, truncated (int(Decimal.scaleb))."""
    t = like.type
    if isinstance(v, pydec.Decimal):
        unscaled = int(v.scaleb(t.scale))
    elif isinstance(v, int):
        unscaled = v * 10 ** t.scale
    else:
        raise ArrowNotImplemented(f"decimal scalar {type(v)}")
    row = torch.from_numpy(dec.from_ints([unscaled], t.limbs)).to(
        like.device)
    return DeviceColumn(row.expand(like.padded, -1), None, like.length, t)


def _compare_dict_scalar(op: str, a: DeviceColumn, lit) -> DeviceColumn:
    """Each dictionary value compared with the literal on the host, then
    one gather of that table by the codes."""
    fn = {"equal": operator.eq, "not_equal": operator.ne,
          "less": operator.lt, "less_equal": operator.le,
          "greater": operator.gt, "greater_equal": operator.ge}[op]
    dvals = list(a.dict_values)
    if isinstance(lit, bytes) and dvals and isinstance(dvals[0], str):
        lit = lit.decode("utf-8")
    table = torch.tensor([bool(fn(v, lit)) for v in dvals] or [False],
                         device=a.device)
    out = table.index_select(0, a.values.to(torch.int64).clamp(
        0, table.shape[0] - 1))
    return DeviceColumn(out, a.validity, a.length, dt.bool_)


# ---------------------------------------------------------------------------
# boolean kernels incl. Kleene (reference scalar_bool.go:123-140)
# ---------------------------------------------------------------------------

_BOOLEAN = {"and": torch.logical_and, "or": torch.logical_or,
            "xor": torch.logical_xor, "and_not": lambda x, y: x & ~y}
_KLEENE = ("and_kleene", "or_kleene", "and_not_kleene")


def _known(c: DeviceColumn) -> torch.Tensor:
    if c.validity is None:
        return torch.ones(c.padded, dtype=torch.bool, device=c.device)
    return bitmap.expand_words(c.validity, c.padded)


def boolean_binary(op: str, a, b) -> DeviceColumn:
    """and / or / xor / and_not (nulls intersect) and and_kleene /
    or_kleene / and_not_kleene (null = unknown). A Kleene result always
    carries its validity words, so no host sync decides their presence:
    where the JAX package drops the words of an all-known result, these
    words are all set."""
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
    elif op == "and_not_kleene":
        out = av & ~bv
        known = (a_known & b_known) | (a_known & ~av) | (b_known & bv)
    else:
        raise ArrowNotImplemented(f"boolean {op!r} is not ported")
    return DeviceColumn(out, bitmap.pack_mask(known), n, dt.bool_)


def invert(a: DeviceColumn) -> DeviceColumn:
    if a.type != dt.bool_:
        raise ArrowNotImplemented("invert requires boolean")
    return DeviceColumn(~a.values, a.validity, a.length, dt.bool_)


# ---------------------------------------------------------------------------
# validity predicates
# ---------------------------------------------------------------------------

def is_null(a: DeviceColumn) -> DeviceColumn:
    """True where the validity bit is clear (padding rows included)."""
    if a.validity is None:
        out = torch.zeros(a.padded, dtype=torch.bool, device=a.device)
    else:
        out = ~bitmap.expand_words(a.validity, a.padded)
    return DeviceColumn(out, None, a.length, dt.bool_)


def is_valid(a: DeviceColumn) -> DeviceColumn:
    return DeviceColumn(~is_null(a).values & row_mask(a.padded, a.length,
                                                      a.device),
                        None, a.length, dt.bool_)


def is_nan(a: DeviceColumn) -> DeviceColumn:
    out = torch.isnan(a.values) if a.type.is_floating else torch.zeros(
        a.padded, dtype=torch.bool, device=a.device)
    return DeviceColumn(out, a.validity, a.length, dt.bool_)


def is_finite(a: DeviceColumn) -> DeviceColumn:
    out = torch.isfinite(a.values) if a.type.is_floating else torch.ones(
        a.padded, dtype=torch.bool, device=a.device)
    return DeviceColumn(out, a.validity, a.length, dt.bool_)


# ---------------------------------------------------------------------------
# rounding (reference internal/kernels/rounding.go)
# ---------------------------------------------------------------------------

def _half_up(x):
    return torch.floor(x + 0.5)


def _half_down(x):
    return torch.ceil(x - 0.5)


_ROUND_MODES = {
    "half_to_even": torch.round, "down": torch.floor, "up": torch.ceil,
    "towards_zero": torch.trunc,
    "towards_infinity": lambda x: torch.where(x >= 0, torch.ceil(x),
                                              torch.floor(x)),
    "half_up": _half_up, "half_down": _half_down,
    "half_towards_zero": lambda x: torch.where(x >= 0, _half_down(x),
                                               _half_up(x)),
    "half_towards_infinity": lambda x: torch.where(x >= 0, _half_up(x),
                                                   _half_down(x)),
}


def round_(a: DeviceColumn, ndigits: int = 0,
           mode: str = "half_to_even") -> DeviceColumn:
    """Round a float column to `ndigits` decimal digits in one of nine
    modes (x * 10**ndigits rounded, divided back); any other column
    comes back as it is."""
    if not a.type.is_floating:
        return a
    if mode not in _ROUND_MODES:
        raise ArrowNotImplemented(f"round mode {mode}")
    scale = 10.0 ** ndigits
    return DeviceColumn(_ROUND_MODES[mode](a.values * scale) / scale,
                        a.validity, a.length, a.type)


def round_to_multiple(a: DeviceColumn, multiple: float,
                      mode: str = "half_to_even") -> DeviceColumn:
    """Round a float column to a multiple of `multiple` (> 0); any other
    column but a string-like one (ArrowNotImplemented) comes back as it
    is."""
    refuse_codes(a, "round_to_multiple")
    if multiple <= 0:
        raise ArrowInvalid("multiple must be positive")
    if not a.type.is_floating:
        return a
    r = round_(DeviceColumn(a.values / multiple, a.validity, a.length,
                            a.type), 0, mode)
    return DeviceColumn(r.values * multiple, a.validity, a.length, a.type)
