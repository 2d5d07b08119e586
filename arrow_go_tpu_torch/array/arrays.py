"""The JAX package's host arrays (arrow_go_tpu/array/arrays.py) over the
port's HostArray.

`Array` is device/block.HostArray, and each JAX class is a HostArray
subclass of the same name: constructing a HostArray gives the class of
its type (block._class_for), so `array`, `from_numpy`, `from_pylist`,
`concat_arrays`, `column_to_host` and every reader return them, and
every port function keeps taking them. The port keeps its one
representation: numpy values and a bool mask, a string-like or
fixed_size_binary column as int32 codes into a host dictionary (its
`type` T, its class T's: StringArray, BinaryArray, ...; the numpy
values in `dict_values`), a dictionary column as codes of its index
type into `dict_values` (a DictionaryArray, whose `dictionary` is an
Array of the value type), a nested column as child HostArrays. The JAX
methods read it: `BinaryArray.offsets` / `value_bytes` /
`value_lengths` / `total_values_bytes` the rows its codes name,
`DictionaryArray.indices` / `dictionary` / `decode`,
`DecimalArray.unscaled_array`, `StructArray.field`.

`ArrayData` is the JAX container (type, length, buffers, children,
dictionary, offset, null count) over the port's Buffers. `Array.data`
builds it from the column (array/layout.py, the C data interface's
layout code); `make_array` turns one back into the typed HostArray and
keeps it, so `make_array(d).data` is `d`. A slice keeps its source, so
its `data` is the source's at the slice's `offset`, as in the JAX
package.

The factories: `array` builds through device/block.from_pylist with the
type compute/scalars.infer_type gives (a run_end_encoded or list view
type through its builder), `nulls` through null_array (or
compute/nested_selection.null_rows), and `from_numpy` wraps the values;
`concat_arrays` is array/concat.py's. Where the port's values differ
from the JAX ones (a coded column's `values` are its codes, a nested
column's `values` None), ROADMAP §3 records it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import dtypes as dt
from ..device import block
from ..device.block import (ExtensionArray, HostArray, LargeListViewArray,
                            ListViewArray, RunEndEncodedArray, UnionArray,
                            from_pylist, null_array)
from ..memory import bitutil
from ..memory.buffer import Buffer

Array = HostArray


# ---------------------------------------------------------------------------
# ArrayData
# ---------------------------------------------------------------------------

class ArrayData:
    """Type + length + buffers + children: the Arrow layout of an array
    (the JAX package's ArrayData; reference arrow/array.go:54)."""

    __slots__ = ("type", "length", "buffers", "children", "dictionary",
                 "offset", "_null_count")

    def __init__(self, type: dt.DataType, length: int,
                 buffers: Sequence[Optional[Buffer]],
                 children: Sequence["ArrayData"] = (),
                 dictionary: Optional["ArrayData"] = None,
                 null_count: Optional[int] = None,
                 offset: int = 0):
        self.type = type
        self.length = int(length)
        self.buffers = list(buffers)
        self.children = list(children)
        self.dictionary = dictionary
        self.offset = int(offset)
        self._null_count = null_count

    @property
    def null_count(self) -> int:
        if self._null_count is None:
            if self.type.id == dt.TypeId.NULL:
                self._null_count = self.length
            elif not self.buffers or self.buffers[0] is None:
                self._null_count = 0
            else:
                self._null_count = self.length - bitutil.count_set_bits(
                    self.buffers[0].data, self.offset, self.length)
        return self._null_count

    @property
    def validity(self) -> Optional[Buffer]:
        return self.buffers[0] if self.buffers else None

    def slice(self, offset: int, length: int) -> "ArrayData":
        return ArrayData(self.type, length, self.buffers, self.children,
                         self.dictionary, None, self.offset + offset)

    def __repr__(self):
        return (f"ArrayData({self.type}, len={self.length}, "
                f"nulls={self._null_count})")


def array_data(arr: HostArray, t: Optional[dt.DataType] = None
               ) -> ArrayData:
    """The ArrayData of a column under field type t (its own field type
    by default) at offset 0, a run_end_encoded one at its offset."""
    from . import layout
    if t is None:
        t = arr.type
    bufs, kids = layout.column_buffers(arr, t)
    children = [c.data if c.type == ct else array_data(c, ct)
                for ct, c in kids]
    dictionary = array_data(layout.dictionary_column(arr, t)) \
        if t.id == dt.TypeId.DICTIONARY else None
    return ArrayData(t, len(arr),
                     [None if b is None else Buffer.wrap(b) for b in bufs],
                     children, dictionary, layout.null_count(arr, t),
                     arr.offset if t.id == dt.TypeId.RUN_END_ENCODED else 0)


def make_array(data: ArrayData) -> HostArray:
    """The typed HostArray of an ArrayData: rows [offset, offset +
    length) of its layout (array/layout.py), keeping `data`."""
    from . import layout

    def reader(buf: Optional[Buffer]):
        if buf is None:
            return None
        return lambda nbytes: buf.data if nbytes is None else \
            buf.data[:nbytes]

    arr = layout.import_column(
        data.type, data.length, data.offset, data._null_count,
        [reader(b) for b in data.buffers],
        lambda i, ct: make_array(data.children[i]),
        lambda: make_array(data.dictionary))
    arr._data = data
    arr._offset = data.offset
    return arr


# ---------------------------------------------------------------------------
# the typed classes
# ---------------------------------------------------------------------------

class NullArray(HostArray):
    pass


class BooleanArray(HostArray):
    pass


class NumericArray(HostArray):
    """Every fixed-width one-value type: the integers, floats, temporal
    types, intervals (their numpy `values`)."""


class TimestampArray(NumericArray):
    pass


class Date32Array(NumericArray):
    pass


class Date64Array(NumericArray):
    pass


class Time32Array(NumericArray):
    pass


class Time64Array(NumericArray):
    pass


class DurationArray(NumericArray):
    pass


class IntervalArray(NumericArray):
    pass


class DecimalArray(HostArray):
    """decimal32 / decimal64 (unscaled int32 / int64 values) and
    decimal128 / decimal256 ((n, 2) / (n, 4) int64 limbs); `to_pylist`
    gives Decimals, `unscaled(i)` row i's unscaled int."""

    @property
    def byte_width(self) -> int:
        return self.type.bit_width // 8

    def unscaled_array(self) -> np.ndarray:
        """All unscaled values as an object array of Python ints."""
        out = np.empty(self.length, dtype=object)
        out[:] = self.unscaled()
        return out


class FixedSizeBinaryArray(HostArray):
    """fixed_size_binary: codes into a host dictionary of its distinct
    byte strings."""


def _encoded(v) -> bytes:
    return v.encode("utf-8", "surrogateescape") if isinstance(v, str) \
        else bytes(v)


class _CodedBytes(HostArray):
    """The byte-string reads of a coded string-like column."""

    def value_bytes(self, i: int) -> bytes:
        """Row i's bytes (b"" for a null row, as its layout holds it)."""
        if not self.is_valid(i):
            return b""
        return _encoded(self.dict_values[int(self.values[i])])

    def value_lengths(self) -> np.ndarray:
        """The byte length of each row (0 for a null row), int64."""
        lens = np.fromiter((len(_encoded(v)) for v in self.dict_values),
                           np.int64, len(self.dict_values))
        if not len(lens):
            return np.zeros(self.length, np.int64)
        out = lens[np.asarray(self.values, np.int64)]
        if self.mask is not None:
            out = np.where(self.mask, out, 0)
        return out


class BinaryArray(_CodedBytes):
    """binary (and the string and large types under it): `offsets`, the
    offsets of its layout (`data`, absolute for a slice, as in the JAX
    package), over the rows its codes name."""

    @property
    def offsets(self) -> np.ndarray:
        d = self.data
        return d.buffers[1].view(d.type.offset_dtype)[
            d.offset: d.offset + d.length + 1]

    @offsets.setter
    def offsets(self, value) -> None:
        """A coded column holds no offsets (HostArray.__init__ sets None)."""

    def total_values_bytes(self) -> int:
        return int(self.value_lengths().sum())


class StringArray(BinaryArray):
    pass


class LargeBinaryArray(BinaryArray):
    pass


class LargeStringArray(BinaryArray):
    pass


class BinaryViewArray(_CodedBytes):
    """binary_view (and string_view under it): `views`, the 16-byte
    view structs of its layout."""

    @property
    def views(self) -> np.ndarray:
        d = self.data
        return d.buffers[1].data[d.offset * 16:(d.offset + d.length) * 16]


class StringViewArray(BinaryViewArray):
    pass


class ListArray(HostArray):
    """list: `offsets` (n + 1, absolute into the child) and the child
    `children[0]`."""


class LargeListArray(ListArray):
    pass


class MapArray(ListArray):
    pass


class FixedSizeListArray(HostArray):
    pass


class StructArray(HostArray):
    def field(self, i) -> HostArray:
        """Child i (or the child named i)."""
        if isinstance(i, str):
            i = self.type.field_index(i)
        return self.children[i]

    @property
    def num_fields(self) -> int:
        return len(self.children)


class DictionaryArray(HostArray):
    """A dictionary column: codes of `type.index_type` (its `values`,
    `indices` as an Array) into `dictionary`, an Array of the value
    type as in the JAX package. The values it holds are `dict_values`,
    a numpy array (str / bytes objects for a string-like value type)."""

    @property
    def indices(self) -> HostArray:
        it = self.type.index_type
        return HostArray(np.asarray(self.values, it.np_dtype), self.mask, it)

    @property
    def dictionary(self) -> HostArray:
        """The dictionary's values as an Array of the value type (a
        string-like one coded over the same values)."""
        return block.dictionary_as_array(self.dict_values,
                                        self.type.value_type)

    @dictionary.setter
    def dictionary(self, values) -> None:
        if isinstance(values, HostArray):
            values = block.dictionary_from_array(values,
                                                 self.type.value_type)
        self.dict_values = values

    def decode(self) -> HostArray:
        """dictionary[indices] as a column of the value type (a string-
        like one coded over the same values)."""
        vt = self.type.value_type
        codes = np.asarray(self.values, np.int64)
        if self.mask is not None:
            codes = np.where(self.mask, codes, 0)
        if vt.codes_on_device:
            return HostArray(codes.astype(np.int32), self.mask, vt,
                             self.dict_values)
        vals = np.asarray(self.dict_values)
        out = vals[codes] if len(vals) else np.zeros(len(codes), vals.dtype)
        return HostArray(out, self.mask, vt)


block._CLASSES.update({
    dt.TypeId.NULL: NullArray,
    dt.TypeId.BOOL: BooleanArray,
    **{tid: NumericArray for tid in (
        dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32, dt.TypeId.INT64,
        dt.TypeId.UINT8, dt.TypeId.UINT16, dt.TypeId.UINT32,
        dt.TypeId.UINT64, dt.TypeId.FLOAT16, dt.TypeId.FLOAT32,
        dt.TypeId.FLOAT64)},
    dt.TypeId.DATE32: Date32Array, dt.TypeId.DATE64: Date64Array,
    dt.TypeId.TIME32: Time32Array, dt.TypeId.TIME64: Time64Array,
    dt.TypeId.TIMESTAMP: TimestampArray, dt.TypeId.DURATION: DurationArray,
    dt.TypeId.INTERVAL_MONTHS: IntervalArray,
    dt.TypeId.INTERVAL_DAY_TIME: IntervalArray,
    dt.TypeId.INTERVAL_MONTH_DAY_NANO: IntervalArray,
    **{tid: DecimalArray for tid in (
        dt.TypeId.DECIMAL32, dt.TypeId.DECIMAL64, dt.TypeId.DECIMAL128,
        dt.TypeId.DECIMAL256)},
    dt.TypeId.FIXED_SIZE_BINARY: FixedSizeBinaryArray,
    dt.TypeId.BINARY: BinaryArray, dt.TypeId.STRING: StringArray,
    dt.TypeId.LARGE_BINARY: LargeBinaryArray,
    dt.TypeId.LARGE_STRING: LargeStringArray,
    dt.TypeId.BINARY_VIEW: BinaryViewArray,
    dt.TypeId.STRING_VIEW: StringViewArray,
    dt.TypeId.LIST: ListArray, dt.TypeId.LARGE_LIST: LargeListArray,
    dt.TypeId.MAP: MapArray,
    dt.TypeId.FIXED_SIZE_LIST: FixedSizeListArray,
    dt.TypeId.STRUCT: StructArray,
    dt.TypeId.DICTIONARY: DictionaryArray,
})

__all__ = [
    "Array", "ArrayData", "BinaryArray", "BinaryViewArray", "BooleanArray",
    "Date32Array", "Date64Array", "DecimalArray", "DictionaryArray",
    "DurationArray", "ExtensionArray", "FixedSizeBinaryArray",
    "FixedSizeListArray", "IntervalArray", "LargeBinaryArray",
    "LargeListArray", "LargeListViewArray", "LargeStringArray", "ListArray",
    "ListViewArray", "MapArray", "NullArray", "NumericArray",
    "RunEndEncodedArray", "StringArray", "StringViewArray", "StructArray",
    "Time32Array", "Time64Array", "TimestampArray", "UnionArray",
    "array", "from_numpy", "make_array", "nulls",
    "take_host", "with_validity"]


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------

def from_numpy(values: np.ndarray, mask: Optional[np.ndarray] = None,
               type: Optional[dt.DataType] = None) -> HostArray:
    """A fixed-width HostArray of numpy values (+ a validity mask, True =
    valid; one with no null is dropped)."""
    values = np.asarray(values)
    if type is None:
        type = dt.from_numpy_dtype(values.dtype)
    values = np.ascontiguousarray(values, dtype=type.np_dtype)
    if mask is not None:
        mask = np.asarray(mask, np.bool_)
        if mask.all():
            mask = None
    return HostArray(values, mask, type)


def nulls(length: int, type: dt.DataType = dt.null) -> HostArray:
    """`length` null rows of `type` (compute/nested_selection.null_rows: a
    union or extension type raises ArrowNotImplemented, as the JAX
    package builds neither)."""
    if type.id == dt.TypeId.NULL:
        return null_array(length)
    from ..compute.nested_selection import null_rows
    return null_rows(type, length)


def with_validity(arr: HostArray, mask: np.ndarray) -> HostArray:
    """`arr` with its validity replaced by `mask` (True = valid; one
    with no null is dropped). A null column, and the types whose nulls
    are their children's (unions, run_end_encoded), come back as they
    are."""
    if arr.type.id in (dt.TypeId.NULL, dt.TypeId.SPARSE_UNION,
                       dt.TypeId.DENSE_UNION, dt.TypeId.RUN_END_ENCODED):
        return arr
    mask = np.asarray(mask, np.bool_)
    if mask.all():
        mask = None
    if isinstance(arr, ListViewArray):
        return ListViewArray(arr.type, mask, arr.offsets, arr.sizes,
                             arr.children[0])
    if isinstance(arr, ExtensionArray):
        return ExtensionArray(arr.type, with_validity(arr.storage, mask
                                                      if mask is not None
                                                      else np.ones(len(arr),
                                                                   bool)))
    out = type(arr)(arr.values, mask, arr.type, arr.dict_values,
                    offsets=arr.offsets if arr.type.is_nested else None,
                    children=arr.children, length=arr.length)
    return out


def take_host(arr: HostArray, indices: np.ndarray) -> HostArray:
    """Rows `indices` of a host column (negative: a null row; past the
    end: ArrowIndexError), compute/nested_selection.take_host_vec."""
    from ..compute.nested_selection import take_host_vec
    idx = np.asarray(indices, np.int64)
    return take_host_vec(arr, np.where(idx < 0, -1, idx))


def array(values, type: Optional[dt.DataType] = None,
          mask: Optional[np.ndarray] = None) -> HostArray:
    """A HostArray of Python values or a numpy array (the JAX package's
    `array`): a HostArray as it is, a numpy array of a fixed-width dtype
    by from_numpy, anything else by from_pylist under `type` or, without
    one, the type its first non-null value gives (`mask` is read on the
    numpy path only, as in the JAX package; a run_end_encoded or list
    view type through its builder)."""
    if isinstance(values, HostArray):
        return values
    if isinstance(values, np.ndarray) and values.dtype != object:
        return from_numpy(values, mask, type)
    from ..compute.scalars import infer_type
    values = list(values)
    t = type if type is not None else infer_type(values)
    if t.id in (dt.TypeId.RUN_END_ENCODED, dt.TypeId.LIST_VIEW,
                dt.TypeId.LARGE_LIST_VIEW):
        from .builders import make_builder     # no from_pylist layout
        b = make_builder(t)
        b.append_values(values)
        return b.finish()
    return from_pylist(values, t)
