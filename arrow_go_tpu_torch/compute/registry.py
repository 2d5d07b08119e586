"""Function registry and dispatch.

Port of arrow_go_tpu/compute/registry.py (reference
arrow/compute/registry.go:30, functions.go Function/Arity/kinds,
exec.go:191 CallFunction). A name resolves to a Python callable over
whole DeviceColumns. HostArray and ChunkedArray arguments move to the
device (`torchenv.device()`: the card unless the caller named one) and
the results of such a call come back to the host. While the spans of
`utils.metrics.metrics` are on, each call is a span there, and its
calls, rows and host seconds count in `Snapshot.ops`, as the JAX package
records them: host time only, so on the card it times the dispatch. The
device time of the work is that of the operators' own spans (CUDA events
of hash_join, group_by, filter, take, sort_indices and
execute_scalar_expression), on the clock torch.profiler stamps its
events with.
"""
from __future__ import annotations

import decimal
import enum
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import torchenv
from ..array.record import ChunkedArray
from ..device.block import (DeviceColumn, HostArray, column_to_host,
                            host_array_to_device, pad_length)
from ..utils.metrics import metrics
from .errors import ArrowKeyError, ArrowNotImplemented


class FunctionKind(enum.Enum):
    SCALAR = "scalar"
    VECTOR = "vector"
    SCALAR_AGGREGATE = "scalar_aggregate"
    HASH_AGGREGATE = "hash_aggregate"
    META = "meta"


@dataclass
class Arity:
    num_args: int
    is_varargs: bool = False

    @staticmethod
    def unary() -> "Arity":
        return Arity(1)

    @staticmethod
    def binary() -> "Arity":
        return Arity(2)

    @staticmethod
    def ternary() -> "Arity":
        return Arity(3)

    @staticmethod
    def varargs(min_args: int = 0) -> "Arity":
        return Arity(min_args, True)


@dataclass
class Function:
    name: str
    kind: FunctionKind
    arity: Arity
    exec: Callable[..., Any]     # (*device_args, options=...) -> result
    doc: str = ""
    #: receives the arguments as they were given, and the caller's
    #: device for any HostArray it moves: exec(*args, options=, device=)
    raw_args: bool = False

    def validate_arity(self, n: int) -> None:
        if self.arity.is_varargs:
            if n < self.arity.num_args:
                raise ArrowNotImplemented(
                    f"{self.name} needs >= {self.arity.num_args} args, got {n}")
        elif n != self.arity.num_args:
            raise ArrowNotImplemented(
                f"{self.name} needs {self.arity.num_args} args, got {n}")


class FunctionRegistry:
    """Name -> Function map with aliasing and parent chaining
    (reference registry.go parent-chained child registries)."""

    def __init__(self, parent: Optional["FunctionRegistry"] = None):
        self._parent = parent
        self._fns: Dict[str, Function] = {}
        self._lock = threading.Lock()

    def register(self, fn: Function, allow_overwrite: bool = False) -> None:
        with self._lock:
            if fn.name in self._fns and not allow_overwrite:
                raise ArrowKeyError(f"function {fn.name} already registered")
            self._fns[fn.name] = fn

    def add_alias(self, alias: str, target: str) -> None:
        fn = self.get_function(target)
        with self._lock:
            self._fns[alias] = fn

    def get_function(self, name: str) -> Function:
        fn = self._fns.get(name)
        if fn is None and self._parent is not None:
            return self._parent.get_function(name)
        if fn is None:
            raise ArrowKeyError(f"no function registered named {name!r}")
        return fn

    def function_names(self) -> List[str]:
        names = set(self._fns)
        if self._parent:
            names |= set(self._parent.function_names())
        return sorted(names)

    def __contains__(self, name: str) -> bool:
        try:
            self.get_function(name)
            return True
        except ArrowKeyError:
            return False


_default_registry: Optional[FunctionRegistry] = None
_registry_lock = threading.Lock()


def default_registry() -> FunctionRegistry:
    global _default_registry
    if _default_registry is None:
        with _registry_lock:
            if _default_registry is None:
                reg = FunctionRegistry()
                from . import functions
                functions.register_all(reg)
                _default_registry = reg
    return _default_registry


def new_child_registry() -> FunctionRegistry:
    return FunctionRegistry(default_registry())


# ---------------------------------------------------------------------------
# argument coercion + call
# ---------------------------------------------------------------------------

def _is_scalar(v) -> bool:
    return v is None or isinstance(v, (int, float, bool, str, bytes,
                                       decimal.Decimal, np.generic))


def call_function(name: str, args: Sequence[Any], options: Any = None,
                  registry: Optional[FunctionRegistry] = None, device=None):
    """The CallFunction entry point (reference compute/exec.go:191).
    DeviceColumns and scalars (a `decimal.Decimal` too) pass as they
    are; HostArrays and ChunkedArrays (combined first) move to `device`
    (the card unless named), padded to the widest argument, and the
    result comes back to the host."""
    reg = registry or default_registry()
    fn = reg.get_function(name)
    fn.validate_arity(len(args))
    if fn.raw_args:
        with metrics.time_op(name):
            return fn.exec(*args, options=options, device=device)

    args = [a.combine() if isinstance(a, ChunkedArray) else a for a in args]
    pad = max([a.padded for a in args if isinstance(a, DeviceColumn)]
              + [pad_length(len(a)) for a in args
                 if isinstance(a, HostArray)], default=None)
    coerced, any_host = [], False
    for a in args:
        if isinstance(a, HostArray):
            a = host_array_to_device(a, torchenv.device(device), pad)
            any_host = True
        elif not (isinstance(a, DeviceColumn) or _is_scalar(a)):
            raise ArrowNotImplemented(
                f"cannot coerce {type(a)} to device column")
        coerced.append(a)
    rows = max((c.length for c in coerced if isinstance(c, DeviceColumn)),
               default=0)
    with metrics.time_op(name, rows=rows):
        result = fn.exec(*coerced, options=options)
    return _to_host(result) if any_host else result


def _to_host(result):
    if isinstance(result, DeviceColumn):
        return column_to_host(result)
    if isinstance(result, tuple):
        return tuple(_to_host(r) for r in result)
    return result
