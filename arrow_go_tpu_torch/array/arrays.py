"""The JAX package's array factories (arrow_go_tpu/array/arrays.py:584,
:605, :658 and array/concat.py:24) over the port's HostArray stand-in:
`array` builds through device/block.from_pylist with the type
compute/scalars.infer_type gives, `nulls` through null_array (or
compute/nested_selection.null_rows), `from_numpy` wraps the values,
and `concat_arrays` is device/block.concat_host_arrays. Each returns a
HostArray; a string column comes back dictionary-coded, its field type
the value type (`field_type`)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import dtypes as dt
from ..device.block import (HostArray, concat_host_arrays, from_pylist,
                            null_array)


def field_type(arr: HostArray) -> dt.DataType:
    """The field type of a HostArray: a dictionary-coded string or binary
    column (int32 codes) is a column of its value type, as the readers'
    schemas name it; any other array its own type."""
    t = arr.type
    if t.id == dt.TypeId.DICTIONARY and t.value_type.codes_on_device \
            and t.index_type == dt.int32:
        return t.value_type
    return t


def _same_type(got: dt.DataType, want: dt.DataType) -> bool:
    return got == want or (got.id == dt.TypeId.DICTIONARY
                           and got.value_type == want)


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


def array(values, type: Optional[dt.DataType] = None,
          mask: Optional[np.ndarray] = None) -> HostArray:
    """A HostArray of Python values or a numpy array (the JAX package's
    `array`): a HostArray as it is, a numpy array of a fixed-width dtype
    by from_numpy, anything else by from_pylist under `type` or, without
    one, the type its first non-null value gives (`mask` is read on the
    numpy path only, as in the JAX package)."""
    if isinstance(values, HostArray):
        return values
    if isinstance(values, np.ndarray) and values.dtype != object:
        return from_numpy(values, mask, type)
    from ..compute.scalars import infer_type
    values = list(values)
    return from_pylist(values, type if type is not None
                       else infer_type(values))


def concat_arrays(arrays: Sequence[HostArray],
                  type: Optional[dt.DataType] = None) -> HostArray:
    """One HostArray of the arrays' rows in order (concat_host_arrays);
    ValueError for no array or a type other than the first's (or
    `type`)."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("concat of zero arrays")
    t = type or field_type(arrays[0])
    for a in arrays:
        if not _same_type(a.type, t):
            raise ValueError(f"concat type mismatch: {a.type} vs {t}")
    return concat_host_arrays(arrays)
