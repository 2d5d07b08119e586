"""Array builders (after arrow_go_tpu/array/builders.py; reference
arrow/array/builder.go:385 and the per-type builders, the dictionary
builder keyed by a memo table, reference arrow/array/dictionary.go:632).

Each builder collects Python values row by row and `finish` gives the
port's typed HostArray: a leaf builder's rows through
device/block.from_pylist (a string-like or fixed_size_binary column
coded in first-occurrence order), a nested builder's children through
their own builders. The JAX contract holds: `append(None)` appends a
null for every builder, `finish` resets the builder, and a builder with
no null gives no validity (`data.validity` is None). `append_values` of
a numpy array takes its values in one step.
"""
from __future__ import annotations

import datetime
from typing import Any, List

import numpy as np

from .. import dtypes as dt
from ..compute.scalars import _unscaled, infer_type  # noqa: F401
from ..device.block import (HostArray, ListViewArray, RunEndEncodedArray,
                            dictionary_values, from_pylist, nested_array,
                            null_array)
from .arrays import DictionaryArray


class Builder:
    """Base builder: `append`, `append_null`, `append_nulls`,
    `append_values`, `null_count`, `len()` and `finish`, which resets it
    (the reference's Builder.NewArray: a second `finish` with no append
    between gives an empty array)."""

    def __init__(self, type: dt.DataType):
        self.type = type
        self._valid: List[bool] = []

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "append" in cls.__dict__:
            orig = cls.__dict__["append"]

            def append(self, v, _orig=orig):
                if v is None:
                    return self.append_null()
                return _orig(self, v)

            append.__doc__ = orig.__doc__
            cls.append = append

    def __len__(self) -> int:
        return len(self._valid)

    @property
    def null_count(self) -> int:
        return len(self._valid) - sum(self._valid)

    def append(self, v) -> None:
        raise NotImplementedError

    def append_null(self) -> None:
        raise NotImplementedError

    def append_nulls(self, n: int) -> None:
        for _ in range(n):
            self.append_null()

    def append_values(self, values) -> None:
        for v in values:
            if v is None:
                self.append_null()
            else:
                self.append(v)

    def _mask(self):
        """The validity mask, None when no row is null."""
        return None if all(self._valid) else np.array(self._valid, np.bool_)

    def finish(self) -> HostArray:
        raise NotImplementedError


class _LeafBuilder(Builder):
    """A flat column's builder: its rows as Python values (None: null),
    finished by from_pylist."""

    def __init__(self, type: dt.DataType):
        super().__init__(type)
        self._values: List[Any] = []

    def _convert(self, v):
        return v

    def append(self, v) -> None:
        self._values.append(self._convert(v))
        self._valid.append(True)

    def append_null(self) -> None:
        self._values.append(None)
        self._valid.append(False)

    def finish(self) -> HostArray:
        out = from_pylist(self._values, self.type)
        self._values, self._valid = [], []
        return out


class NullBuilder(Builder):
    def append(self, v) -> None:
        self._valid.append(False)

    def append_null(self) -> None:
        self._valid.append(False)

    def finish(self) -> HostArray:
        n = len(self._valid)
        self._valid = []
        return null_array(n)


class BooleanBuilder(_LeafBuilder):
    def __init__(self, type: dt.DataType = dt.bool_):
        super().__init__(type)

    def _convert(self, v):
        return bool(v)


_EPOCH_DATE = datetime.date(1970, 1, 1)


class NumericBuilder(_LeafBuilder):
    """The integers, floats and temporal types (a date as its days, a
    datetime as its units, as the JAX builder coerces them)."""

    def _convert(self, v):
        t = self.type
        if t.id == dt.TypeId.DATE32 and isinstance(v, datetime.date):
            return (v - _EPOCH_DATE).days
        if t.id == dt.TypeId.TIMESTAMP and isinstance(v, datetime.datetime):
            epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
            return int((v - epoch).total_seconds() * t.unit.multiplier)
        return v

    def append_values(self, values) -> None:
        if isinstance(values, np.ndarray) and values.dtype != object:
            self._values.extend(values.tolist())
            self._valid.extend([True] * len(values))
            return
        super().append_values(values)


class IntervalBuilder(_LeafBuilder):
    def _convert(self, v):
        return tuple(v)


class DecimalBuilder(_LeafBuilder):
    """Decimals scaled exactly (ValueError when one does not fit the
    scale), floats rounded, ints taken as unscaled values."""

    def _convert(self, v):
        return _unscaled(v, self.type.scale)


class FixedSizeBinaryBuilder(_LeafBuilder):
    def _convert(self, v):
        v = bytes(v)
        if len(v) != self.type.byte_width:
            raise ValueError(f"fixed_size_binary[{self.type.byte_width}] "
                             f"got {len(v)} bytes")
        return v


class BinaryBuilder(_LeafBuilder):
    def __init__(self, type: dt.DataType = dt.binary):
        super().__init__(type)


class BinaryViewBuilder(_LeafBuilder):
    def __init__(self, type: dt.DataType = dt.binary_view):
        super().__init__(type)


class ListViewBuilder(Builder):
    """list_view / large_list_view: each row's offset and size into the
    child `value_builder` fills."""

    def __init__(self, type: dt.DataType):
        super().__init__(type)
        self.value_builder = make_builder(type.value_type)
        self._offsets: List[int] = []
        self._sizes: List[int] = []

    def append(self, v) -> None:
        self._valid.append(True)
        self._offsets.append(len(self.value_builder))
        self.value_builder.append_values(v)
        self._sizes.append(len(self.value_builder) - self._offsets[-1])

    def append_null(self) -> None:
        self._valid.append(False)
        self._offsets.append(len(self.value_builder))
        self._sizes.append(0)

    def finish(self) -> HostArray:
        out = ListViewArray(self.type, self._mask(), self._offsets,
                            self._sizes, self.value_builder.finish())
        self._valid, self._offsets, self._sizes = [], [], []
        return out


class ListBuilder(Builder):
    def __init__(self, type: dt.DataType):
        super().__init__(type)
        self.value_builder = make_builder(type.value_type)
        self._offsets: List[int] = [0]

    def append(self, v) -> None:
        self._valid.append(True)
        self.value_builder.append_values(v)
        self._offsets.append(len(self.value_builder))

    def append_null(self) -> None:
        self._valid.append(False)
        self._offsets.append(len(self.value_builder))

    def finish(self) -> HostArray:
        out = nested_array(self.type, len(self._valid), self._mask(),
                           [self.value_builder.finish()], self._offsets)
        self._valid, self._offsets = [], [0]
        return out


class MapBuilder(Builder):
    """map: each row's (key, value) pairs (a dict or pairs) as entries of
    the struct `entry_builder`."""

    def __init__(self, type: dt.DataType):
        super().__init__(type)
        self.entry_builder = make_builder(type.value_type)
        self._offsets: List[int] = [0]

    def append(self, v) -> None:
        self._valid.append(True)
        items = v.items() if isinstance(v, dict) else v
        for k, val in items:
            self.entry_builder.append({"key": k, "value": val})
        self._offsets.append(len(self.entry_builder))

    def append_null(self) -> None:
        self._valid.append(False)
        self._offsets.append(len(self.entry_builder))

    def finish(self) -> HostArray:
        out = nested_array(self.type, len(self._valid), self._mask(),
                           [self.entry_builder.finish()], self._offsets)
        self._valid, self._offsets = [], [0]
        return out


class FixedSizeListBuilder(Builder):
    def __init__(self, type: dt.DataType):
        super().__init__(type)
        self.value_builder = make_builder(type.value_type)

    def append(self, v) -> None:
        v = list(v)
        if len(v) != self.type.list_size:
            raise ValueError("fixed size list length mismatch")
        self._valid.append(True)
        self.value_builder.append_values(v)

    def append_null(self) -> None:
        self._valid.append(False)
        self.value_builder.append_nulls(self.type.list_size)

    def finish(self) -> HostArray:
        out = nested_array(self.type, len(self._valid), self._mask(),
                           [self.value_builder.finish()])
        self._valid = []
        return out


class StructBuilder(Builder):
    """struct: a dict (a missing key is a null field) or a sequence of
    field values a row, into one `field_builders` entry a field."""

    def __init__(self, type: dt.DataType):
        super().__init__(type)
        self.field_builders = [make_builder(f.type) for f in type.fields()]

    def append(self, v) -> None:
        self._valid.append(True)
        if isinstance(v, dict):
            v = [v.get(f.name) for f in self.type.fields()]
        for fb, x in zip(self.field_builders, v):
            fb.append(x)

    def append_null(self) -> None:
        self._valid.append(False)
        for fb in self.field_builders:
            fb.append_null()

    def finish(self) -> HostArray:
        out = nested_array(self.type, len(self._valid), self._mask(),
                           [fb.finish() for fb in self.field_builders])
        self._valid = []
        return out


class DictionaryBuilder(Builder):
    """Memo-table dictionary builder (the reference MemoTable
    GetOrInsert: dictionary values in first-occurrence order)."""

    def __init__(self, type: dt.DataType):
        super().__init__(type)
        self._memo: dict = {}
        self._indices: List[int] = []

    def append(self, v) -> None:
        key = bytes(v) if isinstance(v, (bytearray, memoryview)) else v
        self._valid.append(True)
        self._indices.append(self._memo.setdefault(key, len(self._memo)))

    def append_null(self) -> None:
        self._valid.append(False)
        self._indices.append(0)

    def finish(self) -> HostArray:
        vt = self.type.value_type
        uniq = list(self._memo)
        values = dictionary_values(uniq, vt) if vt.codes_on_device else \
            from_pylist(uniq, vt).values
        out = DictionaryArray(
            np.array(self._indices, self.type.index_type.np_dtype),
            self._mask(), self.type, values)
        self._valid, self._indices, self._memo = [], [], {}
        return out


class RunEndEncodedBuilder(Builder):
    """run_end_encoded: a row equal to the one before extends its run."""

    def __init__(self, type: dt.DataType):
        super().__init__(type)
        self._values_builder = make_builder(type.values_type)
        self._run_ends: List[int] = []
        self._sentinel = object()
        self._last: Any = self._sentinel
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, v) -> None:
        self._push(v)

    def append_null(self) -> None:
        self._push(None)

    def _push(self, v) -> None:
        self._n += 1
        if self._run_ends and v == self._last and v is not self._sentinel:
            self._run_ends[-1] = self._n
        else:
            self._values_builder.append(v)
            self._run_ends.append(self._n)
            self._last = v

    def finish(self) -> HostArray:
        rt = self.type.run_ends_type
        out = RunEndEncodedArray(
            HostArray(np.array(self._run_ends, rt.np_dtype), None, rt),
            self._values_builder.finish(), self._n)
        self._run_ends, self._n, self._last = [], 0, self._sentinel
        return out


def make_builder(type: dt.DataType) -> Builder:
    """The builder of a type (NotImplementedError for a union or an
    extension type, as in the JAX package)."""
    tid = type.id
    if tid == dt.TypeId.NULL:
        return NullBuilder(type)
    if tid == dt.TypeId.BOOL:
        return BooleanBuilder(type)
    if type.is_numeric or tid in (dt.TypeId.DATE32, dt.TypeId.DATE64,
                                  dt.TypeId.TIME32, dt.TypeId.TIME64,
                                  dt.TypeId.TIMESTAMP, dt.TypeId.DURATION,
                                  dt.TypeId.INTERVAL_MONTHS):
        return NumericBuilder(type)
    if tid in (dt.TypeId.INTERVAL_DAY_TIME,
               dt.TypeId.INTERVAL_MONTH_DAY_NANO):
        return IntervalBuilder(type)
    if type.is_decimal:
        return DecimalBuilder(type)
    if tid == dt.TypeId.FIXED_SIZE_BINARY:
        return FixedSizeBinaryBuilder(type)
    if tid in (dt.TypeId.BINARY, dt.TypeId.STRING,
               dt.TypeId.LARGE_BINARY, dt.TypeId.LARGE_STRING):
        return BinaryBuilder(type)
    if tid in (dt.TypeId.BINARY_VIEW, dt.TypeId.STRING_VIEW):
        return BinaryViewBuilder(type)
    if tid in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST):
        return ListBuilder(type)
    if tid in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        return ListViewBuilder(type)
    if tid == dt.TypeId.MAP:
        return MapBuilder(type)
    if tid == dt.TypeId.FIXED_SIZE_LIST:
        return FixedSizeListBuilder(type)
    if tid == dt.TypeId.STRUCT:
        return StructBuilder(type)
    if tid == dt.TypeId.DICTIONARY:
        return DictionaryBuilder(type)
    if tid == dt.TypeId.RUN_END_ENCODED:
        return RunEndEncodedBuilder(type)
    raise NotImplementedError(f"builder for {type}")
