"""Logical types of the port: the subset of the JAX package's dtypes that
the device pipeline carries (bool, int32, int64, float32, float64), with
the same names and type ids, plus the torch dtype of each."""
from __future__ import annotations

import enum
from typing import Dict, List, Sequence

import numpy as np
import torch


class TypeId(enum.IntEnum):
    """Logical type ids, mirroring arrow.Type (reference arrow/datatype.go)."""

    BOOL = 1
    INT32 = 7
    INT64 = 9
    FLOAT32 = 11
    FLOAT64 = 12


class DataType:
    """A fixed-width logical type with its numpy and torch dtypes."""

    def __init__(self, type_id: TypeId, name: str, np_dtype, torch_dtype):
        self.id = type_id
        self.name = name
        self.np_dtype = np.dtype(np_dtype)
        self.torch_dtype = torch_dtype

    @property
    def is_integer(self) -> bool:
        return self.id in (TypeId.INT32, TypeId.INT64)

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DataType):
            return NotImplemented
        return self.id == other.id

    def __hash__(self) -> int:
        return hash(int(self.id))

    def __repr__(self) -> str:
        return self.name


bool_ = DataType(TypeId.BOOL, "bool", np.bool_, torch.bool)
int32 = DataType(TypeId.INT32, "int32", np.int32, torch.int32)
int64 = DataType(TypeId.INT64, "int64", np.int64, torch.int64)
float32 = DataType(TypeId.FLOAT32, "float", np.float32, torch.float32)
float64 = DataType(TypeId.FLOAT64, "double", np.float64, torch.float64)

_BY_NAME: Dict[str, DataType] = {
    "bool": bool_, "int32": int32, "int64": int64, "float": float32,
    "float32": float32, "double": float64, "float64": float64}
_FROM_NUMPY = {t.np_dtype: t for t in (bool_, int32, int64, float32,
                                       float64)}


def type_for_name(name: str) -> DataType:
    """Type by its name ('int32', 'int64', 'float' or 'float32', 'double'
    or 'float64', 'bool')."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"the port carries no type named {name!r}") from None


def from_numpy_dtype(d) -> DataType:
    try:
        return _FROM_NUMPY[np.dtype(d)]
    except KeyError:
        raise ValueError(f"the port carries no type for numpy {d}") from None


class Field:
    """Named, nullable-annotated slot in a schema."""

    __slots__ = ("name", "type", "nullable")

    def __init__(self, name: str, type: DataType, nullable: bool = True):
        self.name = name
        self.type = type
        self.nullable = bool(nullable)

    def with_name(self, name: str) -> "Field":
        return Field(name, self.type, self.nullable)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Field):
            return NotImplemented
        return (self.name, self.type, self.nullable) == (
            other.name, other.type, other.nullable)

    def __hash__(self):
        return hash((self.name, self.type, self.nullable))

    def __repr__(self):
        return f"Field({self.name}: {self.type})"


class Schema:
    """Ordered field collection (reference arrow/schema.go:157)."""

    __slots__ = ("_fields", "_index")

    def __init__(self, fields: Sequence[Field]):
        self._fields = list(fields)
        self._index: Dict[str, int] = {}
        for i, f in enumerate(self._fields):
            self._index.setdefault(f.name, i)

    @property
    def fields(self) -> List[Field]:
        return list(self._fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self._fields]

    def __len__(self) -> int:
        return len(self._fields)

    def field(self, i: int) -> Field:
        return self._fields[i]

    def field_index(self, name: str) -> int:
        return self._index.get(name, -1)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Schema):
            return NotImplemented
        return self._fields == other._fields

    def __repr__(self):
        return "schema<" + ", ".join(
            f"{f.name}: {f.type}" for f in self._fields) + ">"


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Implicit cast target of a binary numeric kernel (numpy promotion,
    as the reference's DispatchBest, compute/exec.go:100)."""
    from .compute.errors import ArrowNotImplemented
    if a == b:
        return a
    if not (a.is_numeric and b.is_numeric):
        raise ArrowNotImplemented(f"no common type for {a} and {b}")
    try:
        return from_numpy_dtype(np.promote_types(a.np_dtype, b.np_dtype))
    except ValueError as e:
        raise ArrowNotImplemented(str(e)) from None
