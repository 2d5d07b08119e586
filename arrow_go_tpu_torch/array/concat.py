"""Array concatenation (after arrow_go_tpu/array/concat.py; reference
arrow/array/concat.go:879): one HostArray of the arrays' rows in order,
device/block.concat_host_arrays. Dictionary columns unify their
dictionaries in first-occurrence order and map each array's codes into
the unified one, a null row's code 0 (the JAX module's memo and index
transpose); an explicit DictionaryArray stays one."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import dtypes as dt
from ..device.block import HostArray, concat_host_arrays
from .arrays import DictionaryArray


def concat_arrays(arrays: Sequence[HostArray],
                  type: Optional[dt.DataType] = None) -> HostArray:
    """One HostArray of the arrays' rows in order; ValueError for no array
    or a type other than the first's (or `type`)."""
    arrays = list(arrays)
    if not arrays:
        raise ValueError("concat of zero arrays")
    t = type or arrays[0].type
    for a in arrays:
        if a.type != t:
            raise ValueError(f"concat type mismatch: {a.type} vs {t}")
    out = concat_host_arrays(arrays)
    if out.dict_values is None:
        return out
    codes = out.values if out.mask is None else \
        np.where(out.mask, out.values, 0).astype(out.values.dtype)
    cls = DictionaryArray if isinstance(arrays[0], DictionaryArray) \
        else HostArray
    return cls(codes, out.mask, out.type, out.dict_values)
