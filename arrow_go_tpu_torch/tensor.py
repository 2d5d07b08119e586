"""Dense n-dimensional tensors over numeric columns (reference
arrow/tensor/tensor.go:141 tensor.New: shape, strides, row- and
column-major checks).

Port of arrow_go_tpu/tensor.py over a HostArray. `to_device` gives the
tensor as a contiguous torch tensor on the card (the JAX package gives a
jax array in HBM); uint16, uint32 and uint64 come as their bits in
int16, int32 and int64, the port's storage of them (dtypes.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import dtypes as dt
from . import torchenv
from .compute.errors import ArrowInvalid
from .device.block import HostArray
from .ops.convert import storage_view


def _row_major_strides(shape, itemsize: int) -> tuple:
    strides, acc = [], itemsize
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


class Tensor:
    def __init__(self, values: HostArray, shape: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 dim_names: Optional[Sequence[str]] = None):
        t = values.type
        if not t.is_numeric:
            raise ArrowInvalid("tensors require a numeric value type")
        if values.mask is not None and not values.mask.all():
            raise ArrowInvalid("tensors cannot contain nulls")
        n = int(np.prod(shape, dtype=np.int64))
        if n != len(values):
            raise ArrowInvalid(f"shape {tuple(shape)} does not match "
                               f"{len(values)} values")
        self.values = values
        self.shape = tuple(int(s) for s in shape)
        if strides is None:
            strides = _row_major_strides(self.shape, t.np_dtype.itemsize)
        self.strides = tuple(int(s) for s in strides)
        self.dim_names = list(dim_names) if dim_names else None

    @property
    def type(self) -> dt.DataType:
        return self.values.type

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def dim_name(self, i: int) -> str:
        return self.dim_names[i] if self.dim_names else ""

    @property
    def is_row_major(self) -> bool:
        return self.strides == _row_major_strides(
            self.shape, self.type.np_dtype.itemsize)

    @property
    def is_column_major(self) -> bool:
        rev = _row_major_strides(self.shape[::-1],
                                 self.type.np_dtype.itemsize)
        return self.strides == rev[::-1]

    @property
    def is_contiguous(self) -> bool:
        return self.is_row_major or self.is_column_major

    def to_numpy(self) -> np.ndarray:
        """A read-only strided view of the values."""
        return np.lib.stride_tricks.as_strided(
            np.ascontiguousarray(self.values.values), self.shape,
            self.strides, writeable=False)

    def to_device(self, device=None) -> torch.Tensor:
        """The tensor, contiguous in row-major order, on `device` (the
        card unless named)."""
        host = np.array(self.to_numpy(), order="C")
        return torch.from_numpy(storage_view(host, self.type)).to(
            torchenv.device(device))

    def value(self, *index) -> object:
        return self.to_numpy()[tuple(index)].item()

    def __repr__(self):
        return f"Tensor({self.type}, shape={self.shape})"


def tensor(data, shape=None, dim_names=None) -> Tensor:
    """A Tensor of a numpy array (its shape), of a HostArray (`shape`,
    default 1-D) or of anything np.asarray takes."""
    if isinstance(data, np.ndarray):
        flat = np.ascontiguousarray(data).ravel()
        return Tensor(HostArray(flat, None, dt.from_numpy_dtype(flat.dtype)),
                      data.shape, None, dim_names)
    if isinstance(data, HostArray):
        return Tensor(data, shape if shape is not None else (len(data),),
                      None, dim_names)
    return tensor(np.asarray(data), dim_names=dim_names)
