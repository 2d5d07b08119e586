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

Expressions are built with `field`, `literal` and `call`, or with the
operators (`field("a") > 5`). `compile_expression` checks a tree once
against a schema and returns a function of DeviceBatches that
evaluates it eagerly on the device (the JAX package jits one program;
see its docstring for why the port does not).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Union

from ..device.block import (DeviceBatch, DeviceColumn, HostBatch,
                            column_to_host, host_batch_to_device)
from .. import dtypes as dt
from .. import torchenv
from ..utils.metrics import metrics
from . import functions, kernels
from .cast import CastOptions, cast_device
from .errors import ArrowInvalid, ArrowKeyError


class Expression:
    """Base expression node. The operators build calls: `+ - * /`, the
    six compares, and `& | ~` as and_kleene / or_kleene / invert."""

    def _bin(self, op, other, reverse=False):
        other = other if isinstance(other, Expression) else literal(other)
        args = [other, self] if reverse else [self, other]
        return Call(op, args)

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, True)

    def __sub__(self, o):
        return self._bin("subtract", o)

    def __rsub__(self, o):
        return self._bin("subtract", o, True)

    def __mul__(self, o):
        return self._bin("multiply", o)

    def __rmul__(self, o):
        return self._bin("multiply", o, True)

    def __truediv__(self, o):
        return self._bin("divide", o)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("equal", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("not_equal", o)

    def __lt__(self, o):
        return self._bin("less", o)

    def __le__(self, o):
        return self._bin("less_equal", o)

    def __gt__(self, o):
        return self._bin("greater", o)

    def __ge__(self, o):
        return self._bin("greater_equal", o)

    def __and__(self, o):
        return self._bin("and_kleene", o)

    def __or__(self, o):
        return self._bin("or_kleene", o)

    def __invert__(self):
        return Call("invert", [self])

    def __hash__(self):
        return hash(repr(self))

    def is_null(self) -> "Call":
        return Call("is_null", [self])

    def is_valid(self) -> "Call":
        return Call("is_valid", [self])

    def isin(self, values) -> "Call":
        return Call("is_in", [self], {"value_set": list(values)})

    def cast(self, to_type: dt.DataType, safe: bool = True) -> "Call":
        return Call("cast", [self], {"to_type": to_type, "safe": safe})


@dataclass(frozen=True)
class Literal(Expression):
    """A constant. The dataclass's generated equality replaces the
    operator: literal(3) == literal(3) is True, as in the JAX package."""

    value: Any

    def __repr__(self):
        return repr(self.value)

    def __hash__(self):
        return hash(("lit", self.value))


class FieldRef(Expression):
    """Column reference by name or position; "a.b" is the path
    ("a", "b") (reference fieldref.go:588). A path of more than one
    step raises ArrowInvalid when it is evaluated over a DeviceBatch,
    whose columns are flat."""

    def __init__(self, *path: Union[str, int]):
        if len(path) == 1 and isinstance(path[0], str) and "." in path[0]:
            path = tuple(path[0].split("."))
        self.path = path

    def __repr__(self):
        return "$" + ".".join(str(p) for p in self.path)

    def __hash__(self):
        return hash(("ref", self.path))


class Call(Expression):
    def __init__(self, function: str, args: Sequence[Expression],
                 options: Any = None):
        self.function = function
        self.args = list(args)
        self.options = options

    def __repr__(self):
        return f"{self.function}({', '.join(map(repr, self.args))})"

    def __hash__(self):
        return hash((self.function, tuple(self.args)))


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


def _field_index(schema: dt.Schema, ref: FieldRef) -> int:
    p = ref.path[0]
    idx = schema.field_index(p) if isinstance(p, str) else p
    if idx < 0:
        raise ArrowKeyError(f"no field {p!r}")
    if len(ref.path) > 1:
        raise ArrowInvalid("nested field refs require struct flattening "
                           "before device execution")
    return idx


def _resolve_field(db: DeviceBatch, ref: FieldRef) -> DeviceColumn:
    return db.columns[_field_index(db.schema, ref)]


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


def execute_scalar_expression(expr: Expression, batch, device=None) -> Any:
    """Eager execution against a DeviceBatch, or a HostBatch, which goes
    to `device` (the card unless named) and whose column result comes
    back to the host, as the JAX package does for a RecordBatch
    (reference exprs/exec.go:440 ExecuteScalarExpression)."""
    if isinstance(batch, HostBatch):
        dev = torchenv.device(device)
        with metrics.span("execute_scalar_expression", device=dev):
            out = _eval(expr, host_batch_to_device(batch, dev))
            return column_to_host(out) if isinstance(out, DeviceColumn) \
                else out
    if not isinstance(batch, DeviceBatch):
        raise ArrowInvalid("expressions evaluate over a DeviceBatch or a "
                           "HostBatch")
    dev = batch.device_columns[0].device if batch.device_columns else None
    with metrics.span("execute_scalar_expression", device=dev):
        return _eval(expr, batch)


# the functions a compiled expression may call: those of _apply that
# stay on the device (make_struct's struct result lives on the host)
_DEVICE_FUNCTIONS = frozenset(
    set(kernels._ARITH_BINARY) | set(kernels._ARITH_UNARY)
    | set(kernels._COMPARE) | set(kernels._BOOLEAN) | set(kernels._KLEENE)
    | set(_UNARY) | {"fill_null", "if_else", "cast", "is_in"})


def _compile_node(expr: Expression, schema: dt.Schema) -> Callable:
    """fn(columns) -> the node's value, every field resolved to its
    column position once."""
    if isinstance(expr, Literal):
        value = expr.value
        return lambda cols: value
    if isinstance(expr, FieldRef):
        idx = _field_index(schema, expr)
        return lambda cols: cols[idx]
    if isinstance(expr, Call):
        if expr.function not in _DEVICE_FUNCTIONS:
            raise ArrowInvalid(f"{expr.function!r} cannot run in a compiled "
                               f"expression")
        args = [_compile_node(a, schema) for a in expr.args]
        fname, options = expr.function, expr.options
        return lambda cols: _apply(fname, [a(cols) for a in args], options)
    raise ArrowInvalid(f"bad expression node {expr!r}")


def compile_expression(expr: Expression, schema: dt.Schema):
    """fn(DeviceBatch) -> DeviceColumn, with `fn.expression` = expr.

    The checks run once, here: every field resolves against `schema`
    (the batch's columns are taken in its order) and every function is
    one that runs on the device, else ArrowInvalid (ArrowKeyError for a
    missing field). A call then evaluates the tree eagerly on the
    batch's device: the kernels are those of execute_scalar_expression,
    and no step of a numeric tree reads the device from the host. Where
    the JAX package jits one program, whose output carries a type
    inferred from the tree (a Python int literal counts as int64), the
    output here carries the eager result's type: a DeviceColumn's type
    must match its tensor's dtype.
    """
    node = _compile_node(expr, schema)

    def run(db: DeviceBatch) -> DeviceColumn:
        out = node(db.columns)
        if not isinstance(out, DeviceColumn):
            raise ArrowInvalid(f"{expr!r} gives no column")
        return out

    run.expression = expr
    return run
