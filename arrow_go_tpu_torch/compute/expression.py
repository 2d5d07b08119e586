"""Expression trees evaluated over a DeviceBatch.

Port of the eager path of arrow_go_tpu/compute/expression.py (reference
arrow/compute/expression.go:52 Literal / FieldRef / Call trees,
exprs/exec.go ExecuteScalarExpression). The ported functions are the
arithmetic and comparison kernels of compute/kernels.py; expressions
run them unchecked, so no host sync happens inside an expression.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Union

from ..device.block import DeviceBatch, DeviceColumn
from . import kernels
from .errors import ArrowInvalid, ArrowKeyError


class Expression:
    """Base expression node."""


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
        return _apply(expr.function, [_eval(a, db) for a in expr.args])
    raise ArrowInvalid(f"bad expression node {expr!r}")


def _apply(fname: str, args: List[Any]):
    if fname in kernels._ARITH_BINARY:
        return kernels.arithmetic_binary(fname, args[0], args[1],
                                         checked=False)
    if fname in kernels._COMPARE:
        return kernels.compare(fname, args[0], args[1])
    raise ArrowKeyError(f"expression function {fname!r} is not ported")


def execute_scalar_expression(expr: Expression, batch: DeviceBatch) -> Any:
    """Eager execution against a DeviceBatch
    (reference exprs/exec.go:440 ExecuteScalarExpression)."""
    if not isinstance(batch, DeviceBatch):
        raise ArrowInvalid("the port evaluates expressions over DeviceBatch")
    return _eval(expr, batch)
