"""Expression trees evaluated over a DeviceBatch.

Port of the eager path of arrow_go_tpu/compute/expression.py (reference
arrow/compute/expression.go:52 Literal / FieldRef / Call trees,
exprs/exec.go ExecuteScalarExpression). The ported functions are the
arithmetic, comparison, boolean and validity kernels of
compute/kernels.py, and fill_null, if_else and is_in of
compute/functions.py, and cast (compute/cast.py); expressions run the
arithmetic unchecked and cast with CastOptions.unsafe(), as the JAX
package does, so no check syncs with the host inside an expression. A
literal reaches its kernel as it is: a `decimal.Decimal` beside a
decimal128 / decimal256 column becomes the column's unscaled value
there (compute/kernels.py). `project` is a `make_struct` call, whose
struct result lives on the host (device blocks are flat).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Union

from ..device.block import DeviceBatch, DeviceColumn
from .. import dtypes as dt
from . import functions, kernels
from .cast import CastOptions, cast_device
from .errors import ArrowInvalid, ArrowKeyError


class Expression:
    """Base expression node."""

    def cast(self, to_type: dt.DataType, safe: bool = True) -> "Call":
        return Call("cast", [self], {"to_type": to_type, "safe": safe})


@dataclass(frozen=True)
class Literal(Expression):
    value: Any

    def __repr__(self):
        return repr(self.value)


class FieldRef(Expression):
    """Column reference by name or position."""

    def __init__(self, *path: Union[str, int]):
        if len(path) != 1:
            raise ArrowInvalid("nested field refs are not ported")
        self.path = path

    def __repr__(self):
        return "$" + str(self.path[0])


class Call(Expression):
    def __init__(self, function: str, args: Sequence[Expression],
                 options: Any = None):
        self.function = function
        self.args = list(args)
        self.options = options

    def __repr__(self):
        return f"{self.function}({', '.join(map(repr, self.args))})"


def field(*path) -> FieldRef:
    return FieldRef(*path)


def literal(v) -> Literal:
    return Literal(v)


def call(function: str, args: Sequence[Expression], options=None) -> Call:
    return Call(function, [a if isinstance(a, Expression) else literal(a)
                           for a in args], options)


def project(values: Sequence[Expression], names: Sequence[str]) -> Call:
    """Shorthand for a `make_struct` call of record-batch shape
    (reference expression.go:573-581 Project)."""
    return call("make_struct", list(values), {"field_names": list(names)})


def _resolve_field(db: DeviceBatch, ref: FieldRef) -> DeviceColumn:
    p = ref.path[0]
    idx = db.schema.field_index(p) if isinstance(p, str) else p
    if idx < 0:
        raise ArrowKeyError(f"no field {p!r}")
    return db.columns[idx]


def _eval(expr: Expression, db: DeviceBatch):
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, FieldRef):
        return _resolve_field(db, expr)
    if isinstance(expr, Call):
        return _apply(expr.function, [_eval(a, db) for a in expr.args],
                      expr.options)
    raise ArrowInvalid(f"bad expression node {expr!r}")


_UNARY = {"invert": kernels.invert, "is_null": kernels.is_null,
          "is_valid": kernels.is_valid, "is_nan": kernels.is_nan,
          "is_finite": kernels.is_finite}


def _apply(fname: str, args: List[Any], options):
    if fname in kernels._ARITH_BINARY:
        return kernels.arithmetic_binary(fname, args[0], args[1],
                                         checked=False)
    if fname in kernels._ARITH_UNARY:
        return kernels.arithmetic_unary(fname, args[0], checked=False)
    if fname in kernels._COMPARE:
        return kernels.compare(fname, args[0], args[1])
    if fname in kernels._BOOLEAN or fname in kernels._KLEENE:
        return kernels.boolean_binary(fname, args[0], args[1])
    if fname in _UNARY:
        return _UNARY[fname](args[0])
    if fname == "fill_null":
        return functions.fill_null(args[0], args[1])
    if fname == "if_else":
        return functions.if_else(args[0], args[1], args[2])
    if fname == "cast":
        to_t = options["to_type"] if isinstance(options, dict) else options
        return cast_device(args[0], to_t, CastOptions.unsafe())
    if fname == "make_struct":
        return functions.make_struct(*args, options=options)
    if fname == "is_in":
        vs = options["value_set"] if isinstance(options, dict) else options
        return functions.is_in(args[0], value_set=vs)
    raise ArrowKeyError(f"expression function {fname!r} is not ported")


def execute_scalar_expression(expr: Expression, batch: DeviceBatch) -> Any:
    """Eager execution against a DeviceBatch
    (reference exprs/exec.go:440 ExecuteScalarExpression)."""
    if not isinstance(batch, DeviceBatch):
        raise ArrowInvalid("the port evaluates expressions over DeviceBatch")
    return _eval(expr, batch)
