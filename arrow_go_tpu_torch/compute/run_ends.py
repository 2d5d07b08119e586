"""run_end_encode / run_end_decode.

Port of arrow_go_tpu/compute/run_ends.py (reference
arrow/compute/vector_run_ends.go:45-90, internal/kernels/
vector_run_end_encode.go). Run detection runs on the device, as in the
JAX package: row i starts a run when its validity differs from row
i - 1's, or both are valid and their values differ (two nulls are one
run; 0.0 and -0.0 are one run, whose value is its first row's; every
NaN starts a run of its own). A string column compares its dictionary
codes, and its run values keep the dictionary.

Where the JAX package reads the start flags back to the host and takes
np.nonzero there, the port compacts the run starts on the device with
K1 (`ops/compaction.compact_flagged`, the row index as the payload), so
only the starts and one count cross the bus, and it gathers the run
values at the starts on the device before it copies them back. The
result is a host RunEndEncodedArray (device/block.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from .. import torchenv
from ..array.record import ChunkedArray
from ..device.block import (DeviceColumn, HostArray, RunEndEncodedArray,
                            host_array_to_device, row_mask)
from ..ops.compaction import compact_flagged
from ..ops.convert import host_view
from .errors import ArrowInvalid, ArrowNotImplemented

RUN_END_TYPES = (dt.int16, dt.int32, dt.int64)


def run_starts(col: DeviceColumn) -> torch.Tensor:
    """bool[padded]: the rows of `col` that start a run (row 0 always;
    none at or past its length)."""
    v = col.values
    valid = col.validity_mask()
    prev_v = torch.cat([v[:1], v[:-1]])
    prev_valid = torch.cat([valid[:1], valid[:-1]])
    same = ((v == prev_v) & (valid == prev_valid)) | (~valid & ~prev_valid)
    start = ~same
    start[0] = True
    return start & row_mask(col.padded, col.length, col.device)


def device_runs(col: DeviceColumn):
    """(int64 run starts, the values at them, their validity), all on
    the column's device: the starts compacted by K1, with the row index
    as the payload, and one count read back. A null run's value is 0."""
    idx = torch.arange(col.padded, dtype=torch.int64, device=col.device)
    start = run_starts(col)
    starts = compact_flagged(start, (idx,))[0][:int(start.sum())]
    ok = col.validity_mask().index_select(0, starts)
    vals = torch.where(ok, col.values.index_select(0, starts),
                       torch.zeros((), dtype=col.values.dtype,
                                   device=col.device))
    return starts, vals, ok


def run_end_encode(values, run_end_type: dt.DataType = dt.int32,
                   device=None) -> RunEndEncodedArray:
    """A flat HostArray, ChunkedArray (combined) or DeviceColumn as a
    run_end_encoded array (a host column moves to `device`, the card
    unless named). A decimal128 / decimal256 limb column and a nested
    column raise ArrowNotImplemented: the JAX package fails on both."""
    if run_end_type not in RUN_END_TYPES:
        raise ArrowInvalid("run-ends must be int16/int32/int64")
    if isinstance(values, ChunkedArray):
        values = values.combine()
    if isinstance(values, HostArray):
        if values.type.is_nested:
            raise ArrowNotImplemented(f"run_end_encode of {values.type}")
        col = host_array_to_device(values, torchenv.device(device))
    elif isinstance(values, DeviceColumn):
        col = values
    else:
        raise ArrowNotImplemented(
            f"run_end_encode of {type(values).__name__}")
    if col.type.limbs:
        raise ArrowNotImplemented(f"run_end_encode of {col.type}")
    starts, vals, ok = device_runs(col)
    starts_np = starts.cpu().numpy()
    ok_np = ok.cpu().numpy()
    ends = np.append(starts_np[1:], col.length)[:len(starts_np)].astype(
        run_end_type.np_dtype)
    run_values = HostArray(host_view(vals.cpu().numpy(), col.type),
                           None if ok_np.all() else ok_np, col.type,
                           col.dict_values)
    if isinstance(values, HostArray) and values.type != col.type:
        run_values = run_values.decode()     # the host column's own type
    return RunEndEncodedArray(HostArray(ends, None, run_end_type),
                              run_values, col.length)


def run_end_decode(values) -> HostArray:
    """The logical rows of a run_end_encoded array."""
    if not isinstance(values, RunEndEncodedArray):
        raise ArrowInvalid("run_end_decode expects a run-end encoded array")
    return values.decode()
