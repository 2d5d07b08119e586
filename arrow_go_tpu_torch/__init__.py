"""arrow_go_tpu_torch: the PyTorch/CUDA port of arrow_go_tpu.

The device pipeline of the JAX package (parquet bytes -> device scan ->
expression -> DeviceBatch filter -> hash join -> group-by -> sort/take
of the group-sized result, or -> scalar aggregates) on an NVIDIA Hopper
card, with hand-written CUDA kernels where the JAX package has Pallas
kernels (csrc/) and a plain PyTorch version beside each. Module paths
mirror the JAX package. The port imports torch and numpy, never jax or
arrow_go_tpu. The top level carries the JAX package's names: the types
(`dtypes`), `Array` (the port's HostArray, whose subclasses are the
JAX array classes), `ArrayData`, `make_array`, `array`, `nulls`,
`from_numpy`, `concat_arrays`, `make_builder`, `RecordBatch` (a
HostBatch), `ChunkedArray`, `Column`, `Table`, `record_batch`, `table`
(array/) and the buffers.
`interop`, `cdata`, `flight`, `dataset`, `cli`, `tensor`, `ipc`,
`parallel` and `native` load on first use, as in the JAX package.
"""
from . import compute, dtypes, extensions, formats, memory, parquet
from . import torchenv
from .dtypes import (  # noqa: F401
    DataType, Field, Metadata, Schema, TimeUnit, TypeId,
    binary, bool_, date32, date64, decimal32, decimal64, decimal128,
    decimal256, dense_union, dictionary, duration, field, fixed_size_binary,
    fixed_size_list, float16, float32, float64, from_numpy_dtype, int8,
    int16, int32, int64, large_binary, large_list, large_string, list_,
    map_, month_interval, null, run_end_encoded, schema, sparse_union,
    string, struct, time32, time64, timestamp, uint8, uint16, uint32,
    uint64,
)
from .array.arrays import (Array, ArrayData, array, from_numpy,
                           make_array, nulls)
from .array.builders import make_builder
from .array.concat import concat_arrays
from .array.record import (ChunkedArray, Column, RecordBatch, Table,
                           record_batch, table)
from .device.block import (DeviceBatch, DeviceColumn, DeviceListColumn,
                           ExtensionArray, HostArray, HostBatch, HostColumn,
                           ListViewArray, UnionArray, batch_from_numpy,
                           batch_to_device, list_from_device,
                           list_take_device, list_to_device, null_array,
                           pad_length)
from .memory.buffer import Allocator, Buffer, TrackedAllocator

__version__ = "0.1.0"

__all__ = ["array", "compute", "concat_arrays", "dtypes", "extensions",
           "formats", "from_numpy", "make_array", "make_builder", "memory",
           "nulls", "parquet", "record_batch", "table", "torchenv",
           "Array", "ArrayData", "ChunkedArray", "Column", "RecordBatch",
           "Table",
           "Allocator", "Buffer", "TrackedAllocator",
           "DeviceBatch", "DeviceColumn", "DeviceListColumn",
           "ExtensionArray", "HostArray", "HostBatch", "HostColumn",
           "ListViewArray", "UnionArray", "batch_from_numpy",
           "batch_to_device", "list_from_device", "list_take_device",
           "list_to_device", "null_array", "pad_length"]

_LAZY = ("interop", "cdata", "flight", "dataset", "cli", "tensor", "ipc",
         "parallel", "native")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(name)
