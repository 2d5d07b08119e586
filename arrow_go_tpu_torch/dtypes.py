"""Logical types of the port, with the JAX package's type ids, names,
numpy dtypes and bit widths (arrow_go_tpu/dtypes.py): bool; the signed
and unsigned integers of 8 to 64 bits; float16, float32 and float64;
date32, date64, timestamp(unit, tz), time32(unit), time64(unit) and
duration(unit); decimal32, decimal64, decimal128 and
decimal256(precision, scale); fixed_size_binary(byte_width); the
intervals (month_interval, day_time_interval, month_day_nano_interval);
the null type; and the variable-width string and binary types (with
large_string, large_binary, string_view and binary_view), which live on
the device as a dictionary type: int32 codes there, the values in a
host dictionary (a fixed_size_binary column too, as in the JAX
package).

Each fixed-width type carries the torch dtype its device tensor is
stored in (`torch_dtype`). torch computes on none of uint16, uint32 and
uint64, so those types store their raw bits in int16, int32 and int64
(uint8 stays torch.uint8); every operation whose result depends on
signedness reads such bits as unsigned (`is_unsigned_integer`), and
the host sees them through a view as numpy's unsigned dtype. A
temporal type stores int32 (date32, time32) or int64 (the others), its
`np_dtype` in the JAX package. decimal32 and decimal64 store their
unscaled values in int32 and int64; decimal128 and decimal256 in a
(padded, 2) or (padded, 4) int64 matrix of little-endian 64-bit limbs
carrying u64 bits (`limbs`), the JAX package's uint64 limb layout, so
a column's first dimension is its padded length whatever its type.

The nested types list, large_list, fixed_size_list, list_view,
large_list_view, struct, map and the sparse and dense unions (`list_`,
`large_list`, `fixed_size_list`, `list_view`, `large_list_view`,
`struct`, `map_`, `sparse_union`, `dense_union`) have the JAX package's
names, str(), equality, child fields and offset dtypes; their columns
live on the host (device/block.py HostArray), a list of a flat type
also on the device (DeviceListColumn). An ExtensionType wraps a storage
type (extensions.py has the canonical ones).
"""
from __future__ import annotations

import enum
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class TypeId(enum.IntEnum):
    """Logical type ids, mirroring arrow.Type (reference arrow/datatype.go)."""

    NULL = 0
    BOOL = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    UINT32 = 6
    INT32 = 7
    UINT64 = 8
    INT64 = 9
    FLOAT16 = 10
    FLOAT32 = 11
    FLOAT64 = 12
    STRING = 13
    BINARY = 14
    FIXED_SIZE_BINARY = 15
    DATE32 = 16
    DATE64 = 17
    TIMESTAMP = 18
    TIME32 = 19
    TIME64 = 20
    INTERVAL_MONTHS = 21
    INTERVAL_DAY_TIME = 22
    DECIMAL128 = 23
    DECIMAL256 = 24
    LIST = 25
    STRUCT = 26
    SPARSE_UNION = 27
    DENSE_UNION = 28
    DICTIONARY = 29
    MAP = 30
    EXTENSION = 31
    FIXED_SIZE_LIST = 32
    DURATION = 33
    LARGE_STRING = 34
    LARGE_BINARY = 35
    LARGE_LIST = 36
    INTERVAL_MONTH_DAY_NANO = 37
    RUN_END_ENCODED = 38
    STRING_VIEW = 39
    BINARY_VIEW = 40
    LIST_VIEW = 41
    LARGE_LIST_VIEW = 42
    DECIMAL32 = 43
    DECIMAL64 = 44


class TimeUnit(enum.IntEnum):
    SECOND = 0
    MILLISECOND = 1
    MICROSECOND = 2
    NANOSECOND = 3

    @property
    def multiplier(self) -> int:
        """Ticks of this unit in one second."""
        return (1, 10**3, 10**6, 10**9)[int(self)]

    def __str__(self) -> str:
        return ("s", "ms", "us", "ns")[int(self)]


_TIMEUNIT_FROM_STR = {"s": TimeUnit.SECOND, "ms": TimeUnit.MILLISECOND,
                      "us": TimeUnit.MICROSECOND, "ns": TimeUnit.NANOSECOND}


def timeunit_from_str(s: str) -> TimeUnit:
    return _TIMEUNIT_FROM_STR[s]


def _unit(u) -> TimeUnit:
    return timeunit_from_str(u) if isinstance(u, str) else TimeUnit(u)


class BufferKind(enum.IntEnum):
    """The role of a buffer in a type's Arrow layout (reference
    DataTypeLayout), as `DataType.buffer_kinds` lists them."""

    VALIDITY = 0
    DATA = 1
    OFFSETS = 2
    TYPE_IDS = 3
    SIZES = 4
    VIEWS = 5
    ALWAYS_NULL = 6


_INTEGERS = (TypeId.UINT8, TypeId.INT8, TypeId.UINT16, TypeId.INT16,
             TypeId.UINT32, TypeId.INT32, TypeId.UINT64, TypeId.INT64)
_UNSIGNED = (TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64)
_FLOATS = (TypeId.FLOAT16, TypeId.FLOAT32, TypeId.FLOAT64)
_DECIMALS = (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128,
             TypeId.DECIMAL256)
_TEMPORAL = (TypeId.DATE32, TypeId.DATE64, TypeId.TIMESTAMP, TypeId.TIME32,
             TypeId.TIME64, TypeId.DURATION, TypeId.INTERVAL_MONTHS,
             TypeId.INTERVAL_DAY_TIME, TypeId.INTERVAL_MONTH_DAY_NANO)
_NESTED = (TypeId.LIST, TypeId.LARGE_LIST, TypeId.FIXED_SIZE_LIST,
           TypeId.LIST_VIEW, TypeId.LARGE_LIST_VIEW, TypeId.STRUCT,
           TypeId.MAP, TypeId.SPARSE_UNION, TypeId.DENSE_UNION,
           TypeId.RUN_END_ENCODED)
_BINARY_LIKE = (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
                TypeId.LARGE_BINARY, TypeId.STRING_VIEW, TypeId.BINARY_VIEW)
_UTF8 = (TypeId.STRING, TypeId.LARGE_STRING, TypeId.STRING_VIEW)


class DataType:
    """A logical type with its numpy dtype (None for string and binary),
    bit width and torch storage dtype."""

    def __init__(self, type_id: TypeId, name: str, np_dtype, torch_dtype,
                 bit_width: int = 0):
        self.id = type_id
        self.name = name
        self.np_dtype = None if np_dtype is None else np.dtype(np_dtype)
        self.torch_dtype = torch_dtype
        self.bit_width = bit_width

    @property
    def is_integer(self) -> bool:
        return self.id in _INTEGERS

    @property
    def is_signed_integer(self) -> bool:
        return self.is_integer and self.id not in _UNSIGNED

    @property
    def is_unsigned_integer(self) -> bool:
        return self.id in _UNSIGNED

    @property
    def is_floating(self) -> bool:
        return self.id in _FLOATS

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating

    @property
    def is_temporal(self) -> bool:
        return self.id in _TEMPORAL

    @property
    def is_decimal(self) -> bool:
        return self.id in _DECIMALS

    @property
    def is_fixed_width(self) -> bool:
        """One fixed-size value a row: a type with a numpy dtype, bool,
        fixed_size_binary (the JAX package's test; not decimal128 or
        decimal256, whose values it holds as limbs)."""
        return self.np_dtype is not None or self.id == TypeId.BOOL

    @property
    def is_primitive(self) -> bool:
        return self.is_numeric or self.id == TypeId.BOOL or self.is_temporal

    @property
    def byte_width(self) -> int:
        """Bytes a value (ValueError for bool, whose values are bits)."""
        if self.bit_width % 8:
            raise ValueError(f"{self} has no byte width")
        return self.bit_width // 8

    @property
    def device_dtype(self):
        """The torch dtype a device column of this type is stored in:
        int32 codes for the types coded on the device, the limbs' int64
        for decimal128 / decimal256, else `torch_dtype` (None for a type
        that stays on the host). The JAX package gives a numpy dtype."""
        if self.codes_on_device:
            return torch.int32
        return self.torch_dtype

    def buffer_kinds(self) -> List[BufferKind]:
        """The buffers of the type's Arrow layout, validity first where
        there is one (array/layout.py builds them)."""
        tid = self.id
        if tid in (TypeId.NULL, TypeId.RUN_END_ENCODED):
            return []
        if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
                   TypeId.LARGE_BINARY):
            return [BufferKind.VALIDITY, BufferKind.OFFSETS, BufferKind.DATA]
        if tid in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW):
            return [BufferKind.VALIDITY, BufferKind.VIEWS]
        if tid in (TypeId.LIST, TypeId.LARGE_LIST, TypeId.MAP):
            return [BufferKind.VALIDITY, BufferKind.OFFSETS]
        if tid in (TypeId.LIST_VIEW, TypeId.LARGE_LIST_VIEW):
            return [BufferKind.VALIDITY, BufferKind.OFFSETS, BufferKind.SIZES]
        if tid in (TypeId.FIXED_SIZE_LIST, TypeId.STRUCT):
            return [BufferKind.VALIDITY]
        if tid == TypeId.SPARSE_UNION:
            return [BufferKind.TYPE_IDS]
        if tid == TypeId.DENSE_UNION:
            return [BufferKind.TYPE_IDS, BufferKind.OFFSETS]
        return [BufferKind.VALIDITY, BufferKind.DATA]

    @property
    def limbs(self) -> int:
        """64-bit limbs per value of a decimal128 (2) or decimal256 (4)
        column, 0 for a type stored one value per element."""
        if self.id in (TypeId.DECIMAL128, TypeId.DECIMAL256):
            return self.bit_width // 64
        return 0

    @property
    def is_binary_like(self) -> bool:
        """string, binary, their large and view forms."""
        return self.id in _BINARY_LIKE

    @property
    def is_utf8(self) -> bool:
        """string, large_string and string_view: str values."""
        return self.id in _UTF8

    @property
    def is_nested(self) -> bool:
        """list, large_list, fixed_size_list, list_view,
        large_list_view, struct, map, the unions and run_end_encoded:
        host columns of child arrays (device/block.py)."""
        return self.id in _NESTED

    @property
    def on_device(self) -> bool:
        """The device block format carries a column of this type (the
        JAX package's `_device_selectable`): null, bool, the decimals,
        fixed_size_binary, the binary-like types (as codes), a
        dictionary of a flat type, and every type stored as one number
        a row (integers, floats, temporals, month_interval, an extension
        of such a storage). The others (nested types, day_time_interval,
        month_day_nano_interval, an extension of other storage) select
        on the host."""
        if self.id in (TypeId.NULL, TypeId.BOOL, TypeId.FIXED_SIZE_BINARY) \
                or self.is_decimal or self.is_binary_like:
            return True
        if self.id == TypeId.DICTIONARY:
            return not self.value_type.is_nested
        return self.np_dtype is not None and self.np_dtype.kind in "iufb"

    def fields(self) -> List["Field"]:
        """The child fields of a nested type (none for the others)."""
        return []

    @property
    def num_fields(self) -> int:
        return len(self.fields())

    @property
    def codes_on_device(self) -> bool:
        """The binary-like types and fixed_size_binary: int32 codes on
        the device, the values in a host dictionary."""
        return self.is_binary_like or self.id == TypeId.FIXED_SIZE_BINARY

    @property
    def stores_unsigned_as_signed(self) -> bool:
        """uint16, uint32, uint64: raw bits in a signed torch dtype."""
        return self.is_unsigned_integer and self.id != TypeId.UINT8

    def _eq_extra(self) -> tuple:
        return ()

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DataType):
            return NotImplemented
        return self.id == other.id and self._eq_extra() == other._eq_extra()

    def __hash__(self) -> int:
        return hash((int(self.id), self._eq_extra()))

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return str(self)


class _UnitType(DataType):
    """A temporal type with a time unit (its ticks are 1/multiplier s)."""

    def __init__(self, type_id: TypeId, name: str, np_dtype, torch_dtype,
                 bit_width: int, unit):
        super().__init__(type_id, name, np_dtype, torch_dtype, bit_width)
        self.unit = _unit(unit)

    def _eq_extra(self) -> tuple:
        return (self.unit,)

    def __str__(self) -> str:
        return f"{self.name}[{self.unit}]"


class TimestampType(_UnitType):
    def __init__(self, unit=TimeUnit.MICROSECOND, tz: Optional[str] = None):
        super().__init__(TypeId.TIMESTAMP, "timestamp", np.int64,
                         torch.int64, 64, unit)
        self.tz = tz

    def _eq_extra(self) -> tuple:
        return (self.unit, self.tz)

    def __str__(self) -> str:
        if self.tz:
            return f"timestamp[{self.unit}, tz={self.tz}]"
        return f"timestamp[{self.unit}]"


def _simple_type(cls_name: str, type_id: TypeId, name: str, np_dtype,
                 torch_dtype, bit_width: int, doc: str) -> type:
    """A DataType subclass of one parameterless type (the JAX package's
    Int32Type, Date32Type, ...): `Int32Type()` equals `int32`."""
    def __init__(self):
        DataType.__init__(self, type_id, name, np_dtype, torch_dtype,
                          bit_width)
    return type(cls_name, (DataType,), {"__init__": __init__,
                                        "__doc__": doc})


NullType = _simple_type("NullType", TypeId.NULL, "null", None, None, 0,
                        "A column of the null type holds a length only "
                        "(int8 zeros with no valid row on the device).")
BooleanType = _simple_type("BooleanType", TypeId.BOOL, "bool", np.bool_,
                           torch.bool, 1, "bool: numpy and torch bool.")
Int8Type = _simple_type("Int8Type", TypeId.INT8, "int8", np.int8,
                        torch.int8, 8, "int8.")
Int16Type = _simple_type("Int16Type", TypeId.INT16, "int16", np.int16,
                         torch.int16, 16, "int16.")
Int32Type = _simple_type("Int32Type", TypeId.INT32, "int32", np.int32,
                         torch.int32, 32, "int32.")
Int64Type = _simple_type("Int64Type", TypeId.INT64, "int64", np.int64,
                         torch.int64, 64, "int64.")
UInt8Type = _simple_type("UInt8Type", TypeId.UINT8, "uint8", np.uint8,
                         torch.uint8, 8, "uint8.")
UInt16Type = _simple_type("UInt16Type", TypeId.UINT16, "uint16", np.uint16,
                          torch.int16, 16, "uint16: raw bits in int16.")
UInt32Type = _simple_type("UInt32Type", TypeId.UINT32, "uint32", np.uint32,
                          torch.int32, 32, "uint32: raw bits in int32.")
UInt64Type = _simple_type("UInt64Type", TypeId.UINT64, "uint64", np.uint64,
                          torch.int64, 64, "uint64: raw bits in int64.")
Float16Type = _simple_type("Float16Type", TypeId.FLOAT16, "halffloat",
                           np.float16, torch.float16, 16, "float16.")
Float32Type = _simple_type("Float32Type", TypeId.FLOAT32, "float",
                           np.float32, torch.float32, 32, "float32.")
Float64Type = _simple_type("Float64Type", TypeId.FLOAT64, "double",
                           np.float64, torch.float64, 64, "float64.")
Date32Type = _simple_type("Date32Type", TypeId.DATE32, "date32", np.int32,
                          torch.int32, 32, "Days since 1970-01-01.")
Date64Type = _simple_type("Date64Type", TypeId.DATE64, "date64", np.int64,
                          torch.int64, 64,
                          "Milliseconds since 1970-01-01.")
# the intervals: months as int32 (on the device too); (days, ms) and
# (months, days, ns) as numpy structured values, host columns only
MonthIntervalType = _simple_type(
    "MonthIntervalType", TypeId.INTERVAL_MONTHS, "month_interval", np.int32,
    torch.int32, 32, "Months as int32, on the device too.")
DayTimeIntervalType = _simple_type(
    "DayTimeIntervalType", TypeId.INTERVAL_DAY_TIME, "day_time_interval",
    [("days", np.int32), ("milliseconds", np.int32)], None, 64,
    "(days, milliseconds) int32 pairs, a host column only.")
MonthDayNanoIntervalType = _simple_type(
    "MonthDayNanoIntervalType", TypeId.INTERVAL_MONTH_DAY_NANO,
    "month_day_nano_interval",
    [("months", np.int32), ("days", np.int32), ("nanoseconds", np.int64)],
    None, 128, "(months, days, nanoseconds), a host column only.")

bool_ = BooleanType()
int8 = Int8Type()
int16 = Int16Type()
int32 = Int32Type()
int64 = Int64Type()
uint8 = UInt8Type()
uint16 = UInt16Type()
uint32 = UInt32Type()
uint64 = UInt64Type()
float16 = Float16Type()
float32 = Float32Type()
float64 = Float64Type()
date32 = Date32Type()
date64 = Date64Type()
month_interval = MonthIntervalType()
day_time_interval = DayTimeIntervalType()
month_day_nano_interval = MonthDayNanoIntervalType()
null = NullType()


class _BinaryLike(DataType):
    """string, binary and their large (int64 offsets) and view forms.
    Host values are Python str / bytes objects; a column of any of them
    is a dictionary(int32, ...) column of codes, on the host and on the
    device (device/block.py); `Array.data` builds the JAX package's
    offsets or 16-byte views (array/layout.py). `offset_dtype` is the
    JAX type's (None for a view type, which has no offsets)."""

    _SPEC: tuple = ()

    def __init__(self):
        type_id, name, offset_dtype = self._SPEC
        super().__init__(type_id, name, None, None)
        self.offset_dtype = None if offset_dtype is None else np.dtype(
            offset_dtype)


class BinaryType(_BinaryLike):
    _SPEC = (TypeId.BINARY, "binary", np.int32)


class StringType(_BinaryLike):
    _SPEC = (TypeId.STRING, "utf8", np.int32)


class LargeBinaryType(_BinaryLike):
    _SPEC = (TypeId.LARGE_BINARY, "large_binary", np.int64)


class LargeStringType(_BinaryLike):
    _SPEC = (TypeId.LARGE_STRING, "large_utf8", np.int64)


class BinaryViewType(_BinaryLike):
    _SPEC = (TypeId.BINARY_VIEW, "binary_view", None)


class StringViewType(BinaryViewType):
    _SPEC = (TypeId.STRING_VIEW, "string_view", None)


string = StringType()
binary = BinaryType()
large_string = LargeStringType()
large_binary = LargeBinaryType()
string_view = StringViewType()
binary_view = BinaryViewType()


class DecimalType(DataType):
    """decimal32/64/128/256(precision, scale): unscaled two's-complement
    integers of 32, 64, 128 or 256 bits; a value is unscaled * 10**-scale
    (the JAX package's _DecimalType)."""

    _SPEC = {TypeId.DECIMAL32: ("decimal32", 32, 9, np.int32, torch.int32),
             TypeId.DECIMAL64: ("decimal64", 64, 18, np.int64, torch.int64),
             TypeId.DECIMAL128: ("decimal128", 128, 38, None, torch.int64),
             TypeId.DECIMAL256: ("decimal256", 256, 76, None, torch.int64)}

    def __init__(self, type_id: TypeId, precision: int, scale: int = 0):
        name, bits, max_p, np_dtype, torch_dtype = self._SPEC[type_id]
        if not 1 <= precision <= max_p:
            raise ValueError(f"{name} precision out of range [1, {max_p}]: "
                             f"{precision}")
        super().__init__(type_id, name, np_dtype, torch_dtype, bits)
        self.precision = int(precision)
        self.scale = int(scale)

    def _eq_extra(self) -> tuple:
        return (self.precision, self.scale)

    def __str__(self) -> str:
        return f"{self.name}({self.precision}, {self.scale})"


class Decimal32Type(DecimalType):
    def __init__(self, precision: int, scale: int = 0):
        super().__init__(TypeId.DECIMAL32, precision, scale)


class Decimal64Type(DecimalType):
    def __init__(self, precision: int, scale: int = 0):
        super().__init__(TypeId.DECIMAL64, precision, scale)


class Decimal128Type(DecimalType):
    def __init__(self, precision: int, scale: int = 0):
        super().__init__(TypeId.DECIMAL128, precision, scale)


class Decimal256Type(DecimalType):
    def __init__(self, precision: int, scale: int = 0):
        super().__init__(TypeId.DECIMAL256, precision, scale)


def decimal32(precision, scale=0) -> Decimal32Type:
    return Decimal32Type(precision, scale)


def decimal64(precision, scale=0) -> Decimal64Type:
    return Decimal64Type(precision, scale)


def decimal128(precision, scale=0) -> Decimal128Type:
    return Decimal128Type(precision, scale)


def decimal256(precision, scale=0) -> Decimal256Type:
    return Decimal256Type(precision, scale)


class FixedSizeBinaryType(DataType):
    """Values of `byte_width` bytes each; on the device a dictionary
    column of codes into the distinct values (host bytes)."""

    def __init__(self, byte_width: int):
        super().__init__(TypeId.FIXED_SIZE_BINARY, "fixed_size_binary", None,
                         None, int(byte_width) * 8)
        self._byte_width = int(byte_width)

    @property
    def byte_width(self) -> int:
        return self._byte_width

    @property
    def is_fixed_width(self) -> bool:
        return True

    def _eq_extra(self) -> tuple:
        return (self._byte_width,)

    def __str__(self) -> str:
        return f"fixed_size_binary[{self.byte_width}]"


def fixed_size_binary(byte_width: int) -> FixedSizeBinaryType:
    return FixedSizeBinaryType(byte_width)


def timestamp(unit="us", tz: Optional[str] = None) -> TimestampType:
    return TimestampType(unit, tz)


class Time32Type(_UnitType):
    def __init__(self, unit=TimeUnit.MILLISECOND):
        if _unit(unit) not in (TimeUnit.SECOND, TimeUnit.MILLISECOND):
            raise ValueError("time32 requires s or ms unit")
        super().__init__(TypeId.TIME32, "time32", np.int32, torch.int32, 32,
                         unit)


class Time64Type(_UnitType):
    def __init__(self, unit=TimeUnit.MICROSECOND):
        if _unit(unit) not in (TimeUnit.MICROSECOND, TimeUnit.NANOSECOND):
            raise ValueError("time64 requires us or ns unit")
        super().__init__(TypeId.TIME64, "time64", np.int64, torch.int64, 64,
                         unit)


class DurationType(_UnitType):
    def __init__(self, unit=TimeUnit.MICROSECOND):
        super().__init__(TypeId.DURATION, "duration", np.int64, torch.int64,
                         64, unit)


def time32(unit="ms") -> Time32Type:
    return Time32Type(unit)


def time64(unit="us") -> Time64Type:
    return Time64Type(unit)


def duration(unit="us") -> DurationType:
    return DurationType(unit)


class DictionaryType(DataType):
    """Codes of `index_type` into a host dictionary of `value_type` values
    (the JAX package's DictionaryType, with its `ordered` flag; the
    port's own columns are unordered)."""

    def __init__(self, index_type: DataType, value_type: DataType,
                 ordered: bool = False):
        if not index_type.is_integer:
            raise ValueError("dictionary index type must be integer")
        super().__init__(TypeId.DICTIONARY, "dictionary",
                         index_type.np_dtype, index_type.torch_dtype,
                         index_type.bit_width)
        self.index_type = index_type
        self.value_type = value_type
        self.ordered = bool(ordered)

    def _eq_extra(self) -> tuple:
        return (self.index_type, self.value_type, self.ordered)

    def __str__(self) -> str:
        return (f"dictionary<values={self.value_type!r}, "
                f"indices={self.index_type!r}, ordered={self.ordered}>")


def dictionary(index_type: DataType, value_type: DataType,
               ordered: bool = False) -> DictionaryType:
    return DictionaryType(index_type, value_type, ordered)


_SIMPLE = (null, bool_, int8, int16, int32, int64, uint8, uint16, uint32,
           uint64, float16, float32, float64, date32, date64, string, binary,
           large_string, large_binary, string_view, binary_view,
           month_interval, day_time_interval, month_day_nano_interval)
_BY_NAME: Dict[str, DataType] = {t.name: t for t in _SIMPLE}
_BY_NAME.update({"float16": float16, "float32": float32,
                 "float64": float64, "string": string,
                 "large_string": large_string})
_PARAMETRIZED = re.compile(r"(timestamp|time32|time64|duration)"
                           r"\[(s|ms|us|ns)(?:, tz=(.+))?\]")
_DECIMAL_NAME = re.compile(r"(decimal32|decimal64|decimal128|decimal256)"
                           r"\((\d+), *(-?\d+)\)")
_FIXED_NAME = re.compile(r"fixed_size_binary\[(\d+)\]")
_FROM_NUMPY = {t.np_dtype: t for t in (bool_, int8, int16, int32, int64,
                                       uint8, uint16, uint32, uint64,
                                       float16, float32, float64)}


def type_for_name(name: str) -> DataType:
    """Type by its name ('null', 'int8' ... 'uint64', 'halffloat' or
    'float16', 'float' or 'float32', 'double' or 'float64', 'bool',
    'utf8' or 'string', 'binary', 'large_utf8' or 'large_string',
    'large_binary', 'string_view', 'binary_view', 'date32', 'date64',
    'month_interval', 'day_time_interval', 'month_day_nano_interval')
    or by the str() of a type
    with a unit ('timestamp[ms]', 'timestamp[us, tz=UTC]', 'time32[s]',
    'time64[ns]', 'duration[ms]'), a decimal ('decimal128(15, 2)') or a
    fixed-size binary ('fixed_size_binary[12]')."""
    t = _BY_NAME.get(name)
    if t is not None:
        return t
    m = _DECIMAL_NAME.fullmatch(name)
    if m is not None:
        return globals()[m.group(1)](int(m.group(2)), int(m.group(3)))
    m = _FIXED_NAME.fullmatch(name)
    if m is not None:
        return fixed_size_binary(int(m.group(1)))
    m = _PARAMETRIZED.fullmatch(name)
    if m is None:
        raise ValueError(f"the port carries no type named {name!r}")
    kind, unit, tz = m.groups()
    if kind == "timestamp":
        return timestamp(unit, tz)
    if tz is not None:
        raise ValueError(f"the port carries no type named {name!r}")
    return {"time32": time32, "time64": time64, "duration": duration}[kind](
        unit)


def from_numpy_dtype(dt) -> DataType:
    """Type of a numpy dtype: the fixed-width numeric dtypes, and
    datetime64 (D: date32; s/ms/us/ns: timestamp) and timedelta64
    (s/ms/us/ns: duration), as the JAX package maps them."""
    d = np.dtype(dt)
    t = _FROM_NUMPY.get(d)
    if t is not None:
        return t
    if d.kind in "Mm":
        unit = np.datetime_data(d)[0]
        if d.kind == "M" and unit == "D":
            return date32
        if unit in _TIMEUNIT_FROM_STR:
            return timestamp(unit) if d.kind == "M" else duration(unit)
    raise ValueError(f"the port carries no type for numpy {d}")


class Metadata:
    """Ordered string -> string key/value metadata of a field or a
    schema (the JAX package's Metadata; reference arrow/schema.go)."""

    __slots__ = ("keys", "values")

    def __init__(self, pairs: Optional[Dict[str, str]] = None,
                 keys: Sequence[str] = (), values: Sequence[str] = ()):
        if pairs is not None:
            keys, values = list(pairs), list(pairs.values())
        self.keys = list(keys)
        self.values = list(values)
        if len(self.keys) != len(self.values):
            raise ValueError("metadata keys/values length mismatch")

    def __len__(self) -> int:
        return len(self.keys)

    def __bool__(self) -> bool:
        return len(self.keys) > 0

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.values[self.keys.index(key)] if key in self.keys \
            else default

    def with_pair(self, key: str, value: str) -> "Metadata":
        return Metadata(keys=self.keys + [key], values=self.values + [value])

    def to_dict(self) -> Dict[str, str]:
        return dict(zip(self.keys, self.values))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Metadata):
            return NotImplemented
        return (self.keys, self.values) == (other.keys, other.values)

    def __repr__(self) -> str:
        return f"Metadata({self.to_dict()!r})"


EMPTY_METADATA = Metadata()


class Field:
    """Named, nullable-annotated slot in a schema, with key/value
    metadata (not part of its equality, as in the JAX package)."""

    __slots__ = ("name", "type", "nullable", "metadata")

    def __init__(self, name: str, type: DataType, nullable: bool = True,
                 metadata: Metadata = EMPTY_METADATA):
        self.name = name
        self.type = type
        self.nullable = bool(nullable)
        self.metadata = metadata

    def with_name(self, name: str) -> "Field":
        return Field(name, self.type, self.nullable, self.metadata)

    def with_type(self, dt: DataType) -> "Field":
        return Field(self.name, dt, self.nullable, self.metadata)

    def equals(self, other: "Field", check_metadata: bool = False) -> bool:
        ok = (self.name, self.type, self.nullable) == (
            other.name, other.type, other.nullable)
        return ok and (not check_metadata or self.metadata == other.metadata)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Field):
            return NotImplemented
        return self.equals(other)

    def __hash__(self):
        return hash((self.name, self.type, self.nullable))

    def __repr__(self):
        return f"Field({self.name}: {self.type})"



class ListType(DataType):
    """list<item>: int32 offsets into one child array (the JAX
    package's ListType; `large_list` has int64 offsets)."""

    offset_dtype = np.dtype(np.int32)

    def __init__(self, value, nullable: bool = True,
                 type_id: TypeId = TypeId.LIST, name: str = "list"):
        super().__init__(type_id, name, None, None)
        self.value_field = value if isinstance(value, Field) else \
            Field("item", value, nullable)

    @property
    def value_type(self) -> DataType:
        return self.value_field.type

    def fields(self) -> List[Field]:
        return [self.value_field]

    def _eq_extra(self) -> tuple:
        return (self.value_field.type, self.value_field.nullable)

    def __str__(self) -> str:
        return f"{self.name}<{self.value_field.name}: {self.value_type}>"


class LargeListType(ListType):
    offset_dtype = np.dtype(np.int64)

    def __init__(self, value, nullable: bool = True):
        super().__init__(value, nullable, TypeId.LARGE_LIST, "large_list")


class ListViewType(ListType):
    """list_view<item>: an offset and a size a row (int32; int64 for
    `large_list_view`) into one child array, in any order (the JAX
    package's ListViewType)."""

    def __init__(self, value, nullable: bool = True):
        super().__init__(value, nullable, TypeId.LIST_VIEW, "list_view")


class LargeListViewType(ListType):
    offset_dtype = np.dtype(np.int64)

    def __init__(self, value, nullable: bool = True):
        super().__init__(value, nullable, TypeId.LARGE_LIST_VIEW,
                         "large_list_view")


class FixedSizeListType(DataType):
    """fixed_size_list<item>[list_size]: row i is the child's rows
    [i * list_size, (i + 1) * list_size), present under null rows too."""

    def __init__(self, value, list_size: int, nullable: bool = True):
        super().__init__(TypeId.FIXED_SIZE_LIST, "fixed_size_list", None,
                         None)
        self.value_field = value if isinstance(value, Field) else \
            Field("item", value, nullable)
        self.list_size = int(list_size)

    @property
    def value_type(self) -> DataType:
        return self.value_field.type

    def fields(self) -> List[Field]:
        return [self.value_field]

    def _eq_extra(self) -> tuple:
        return (self.value_field.type, self.list_size)

    def __str__(self) -> str:
        return (f"fixed_size_list<{self.value_field.name}: "
                f"{self.value_type}>[{self.list_size}]")


class StructType(DataType):
    """struct<fields>: one child array a field, each of the struct's
    length."""

    def __init__(self, fields: Sequence[Field]):
        super().__init__(TypeId.STRUCT, "struct", None, None)
        self._fields = list(fields)

    def fields(self) -> List[Field]:
        return list(self._fields)

    def field(self, i: int) -> Field:
        return self._fields[i]

    def field_by_name(self, name: str) -> Optional[Field]:
        i = self.field_index(name)
        return self._fields[i] if i >= 0 else None

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self._fields):
            if f.name == name:
                return i
        return -1

    def _eq_extra(self) -> tuple:
        return tuple((f.name, f.type, f.nullable) for f in self._fields)

    def __str__(self) -> str:
        inner = ", ".join(f"{f.name}: {f.type}" for f in self._fields)
        return f"struct<{inner}>"


class MapType(ListType):
    """map<key, value>: stored as list<entries: struct<key, value>>, the
    key not nullable (the JAX package's MapType)."""

    def __init__(self, key: DataType, item: DataType,
                 keys_sorted: bool = False, item_nullable: bool = True):
        self.key_field = Field("key", key, nullable=False)
        self.item_field = Field("value", item, nullable=item_nullable)
        self.keys_sorted = keys_sorted
        super().__init__(Field("entries", StructType(
            [self.key_field, self.item_field]), nullable=False),
            type_id=TypeId.MAP, name="map")

    @property
    def key_type(self) -> DataType:
        return self.key_field.type

    @property
    def item_type(self) -> DataType:
        return self.item_field.type

    def _eq_extra(self) -> tuple:
        return (self.key_type, self.item_type, self.keys_sorted)

    def __str__(self) -> str:
        return f"map<{self.key_type}, {self.item_type}>"


class RunEndEncodedType(DataType):
    """run_end_encoded<run_ends, values>: int16 / int32 / int64 run ends
    (not nullable) and one values child, one entry a run (the JAX
    package's RunEndEncodedType). Its columns live on the host
    (device/block.py RunEndEncodedArray)."""

    def __init__(self, run_ends: DataType, values: DataType):
        if run_ends.id not in (TypeId.INT16, TypeId.INT32, TypeId.INT64):
            raise ValueError("run-ends must be int16/int32/int64")
        super().__init__(TypeId.RUN_END_ENCODED, "run_end_encoded", None,
                         None)
        self.run_ends_field = Field("run_ends", run_ends, nullable=False)
        self.values_field = Field("values", values, nullable=True)

    @property
    def run_ends_type(self) -> DataType:
        return self.run_ends_field.type

    @property
    def values_type(self) -> DataType:
        return self.values_field.type

    def fields(self) -> List[Field]:
        return [self.run_ends_field, self.values_field]

    def _eq_extra(self) -> tuple:
        return (self.run_ends_type, self.values_type)

    def __str__(self) -> str:
        return (f"run_end_encoded<run_ends: {self.run_ends_type}, "
                f"values: {self.values_type}>")


def run_end_encoded(run_ends: DataType, values: DataType
                    ) -> RunEndEncodedType:
    return RunEndEncodedType(run_ends, values)


class UnionType(DataType):
    """sparse_union / dense_union<fields>: an int8 type code a row
    naming its child (`type_codes`, 0..n-1 unless given; `child_id` maps
    a code to its child), a dense union also an int32 offset a row into
    that child (the JAX package's UnionType). Its columns live on the
    host (device/block.py UnionArray)."""

    def __init__(self, type_id: TypeId, name: str, fields: Sequence[Field],
                 type_codes: Optional[Sequence[int]] = None):
        super().__init__(type_id, name, None, None)
        self._fields = list(fields)
        self.type_codes = list(type_codes) if type_codes is not None \
            else list(range(len(self._fields)))

    def fields(self) -> List[Field]:
        return list(self._fields)

    def child_id(self, type_code: int) -> int:
        return self.type_codes.index(type_code)

    def _eq_extra(self) -> tuple:
        return (tuple((f.name, f.type) for f in self._fields),
                tuple(self.type_codes))

    def __str__(self) -> str:
        inner = ", ".join(f"{f.name}: {f.type}" for f in self._fields)
        return f"{self.name}<{inner}>"


class SparseUnionType(UnionType):
    def __init__(self, fields: Sequence[Field],
                 type_codes: Optional[Sequence[int]] = None):
        super().__init__(TypeId.SPARSE_UNION, "sparse_union", fields,
                         type_codes)


class DenseUnionType(UnionType):
    def __init__(self, fields: Sequence[Field],
                 type_codes: Optional[Sequence[int]] = None):
        super().__init__(TypeId.DENSE_UNION, "dense_union", fields,
                         type_codes)


def sparse_union(fields, type_codes=None) -> SparseUnionType:
    return SparseUnionType(fields, type_codes)


def dense_union(fields, type_codes=None) -> DenseUnionType:
    return DenseUnionType(fields, type_codes)


class ExtensionType(DataType):
    """A named type over a storage type (the JAX package's
    ExtensionType): its numpy and torch dtypes and its fields are the
    storage's (its bit width is 0, as there). A column is its storage column under this type
    (device/block.py ExtensionArray); one whose storage is one number a
    row also lives on the device (`on_device`). The canonical types and
    the registry are in extensions.py."""

    def __init__(self, storage_type: DataType, extension_name: str,
                 serialized: bytes = b""):
        super().__init__(TypeId.EXTENSION, "extension",
                         storage_type.np_dtype, storage_type.torch_dtype)
        self.storage_type = storage_type
        self.extension_name = extension_name
        self.serialized = serialized

    def fields(self) -> List[Field]:
        return self.storage_type.fields()

    def _eq_extra(self) -> tuple:
        return (self.extension_name, self.storage_type, self.serialized)

    def __str__(self) -> str:
        return (f"extension<{self.extension_name}, "
                f"storage={self.storage_type}>")


def list_(value, nullable: bool = True) -> ListType:
    return ListType(value, nullable)


def large_list(value, nullable: bool = True) -> LargeListType:
    return LargeListType(value, nullable)


def list_view(value, nullable: bool = True) -> ListViewType:
    return ListViewType(value, nullable)


def large_list_view(value, nullable: bool = True) -> LargeListViewType:
    return LargeListViewType(value, nullable)


def fixed_size_list(value, list_size: int) -> FixedSizeListType:
    return FixedSizeListType(value, list_size)


def struct(fields) -> StructType:
    """struct of Fields, or of a {name: type} dict."""
    if isinstance(fields, dict):
        fields = [Field(k, v) for k, v in fields.items()]
    return StructType(fields)


def map_(key: DataType, item: DataType, keys_sorted: bool = False
         ) -> MapType:
    return MapType(key, item, keys_sorted)


class Schema:
    """Ordered field collection with key/value metadata (reference
    arrow/schema.go:157); its equality is the fields'."""

    __slots__ = ("_fields", "_index", "metadata")

    def __init__(self, fields: Sequence[Field],
                 metadata: Metadata = EMPTY_METADATA):
        self._fields = list(fields)
        self.metadata = metadata
        self._index: Dict[str, int] = {}
        for i, f in enumerate(self._fields):
            self._index.setdefault(f.name, i)

    @property
    def fields(self) -> List[Field]:
        return list(self._fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self._fields]

    @property
    def types(self) -> List[DataType]:
        return [f.type for f in self._fields]

    def __len__(self) -> int:
        return len(self._fields)

    @property
    def num_fields(self) -> int:
        return len(self._fields)

    def field(self, i: int) -> Field:
        return self._fields[i]

    def field_by_name(self, name: str) -> Optional[Field]:
        i = self._index.get(name, -1)
        return self._fields[i] if i >= 0 else None

    def field_index(self, name: str) -> int:
        return self._index.get(name, -1)

    def has_field(self, name: str) -> bool:
        return name in self._index

    def add_field(self, i: int, f: Field) -> "Schema":
        fields = list(self._fields)
        fields.insert(i, f)
        return Schema(fields, self.metadata)

    def remove_field(self, i: int) -> "Schema":
        fields = list(self._fields)
        fields.pop(i)
        return Schema(fields, self.metadata)

    def set_field(self, i: int, f: Field) -> "Schema":
        fields = list(self._fields)
        fields[i] = f
        return Schema(fields, self.metadata)

    def with_metadata(self, md: Metadata) -> "Schema":
        return Schema(self._fields, md)

    def equals(self, other: "Schema", check_metadata: bool = False) -> bool:
        if len(self) != len(other) or not all(
                a.equals(b, check_metadata)
                for a, b in zip(self._fields, other._fields)):
            return False
        return not check_metadata or self.metadata == other.metadata

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Schema):
            return NotImplemented
        return self.equals(other)

    def __repr__(self):
        return "schema<" + ", ".join(
            f"{f.name}: {f.type}" for f in self._fields) + ">"


def field(name: str, type: DataType, nullable: bool = True,
          metadata: Metadata = EMPTY_METADATA) -> Field:
    return Field(name, type, nullable, metadata)


def schema(fields, metadata: Metadata = EMPTY_METADATA) -> Schema:
    """A Schema of Fields, (name, type) pairs or a {name: type} dict."""
    if isinstance(fields, dict):
        fields = [Field(k, v) for k, v in fields.items()]
    return Schema([f if isinstance(f, Field) else Field(f[0], f[1])
                   for f in fields], metadata)


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Implicit cast target of a binary numeric kernel (numpy promotion,
    as the reference's DispatchBest, compute/exec.go:100, and the JAX
    package's compute/kernels.py): two temporal values combine only
    when they share a type."""
    from .compute.errors import ArrowNotImplemented
    if a == b:
        return a
    if not (a.is_numeric and b.is_numeric):
        raise ArrowNotImplemented(f"no common type for {a} and {b}")
    return from_numpy_dtype(np.promote_types(a.np_dtype, b.np_dtype))
