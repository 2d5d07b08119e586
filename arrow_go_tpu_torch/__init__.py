"""arrow_go_tpu_torch: the PyTorch/CUDA port of arrow_go_tpu.

The device pipeline of the JAX package (parquet bytes -> device scan ->
expression -> DeviceBatch filter -> hash join -> group-by -> sort/take
of the group-sized result, or -> scalar aggregates) on an NVIDIA Hopper
card, with hand-written CUDA kernels where the JAX package has Pallas
kernels (csrc/) and a plain PyTorch version beside each. Module paths
mirror the JAX package. The port imports torch and numpy, never jax or
arrow_go_tpu. `interop` (the integration JSON, the protobuf wire format),
`cdata` (the C data interface) and `flight` (Arrow Flight and Flight SQL
on the port's own gRPC) load on first use, as in the JAX package;
`array` (ChunkedArray, the HostArray comparisons) and `memory` (Buffer,
Allocator, TrackedAllocator) are numpy only and load with the package.
"""
from . import array, compute, dtypes, extensions, formats, memory, parquet
from . import torchenv
from .array.record import ChunkedArray
from .device.block import (DeviceBatch, DeviceColumn, DeviceListColumn,
                           ExtensionArray, HostArray, HostBatch, HostColumn,
                           ListViewArray, UnionArray, batch_from_numpy,
                           batch_to_device, list_from_device,
                           list_take_device, list_to_device, null_array,
                           pad_length)
from .memory.buffer import Allocator, Buffer, TrackedAllocator

__all__ = ["array", "compute", "dtypes", "extensions", "formats", "memory",
           "parquet", "torchenv", "ChunkedArray", "Allocator", "Buffer",
           "TrackedAllocator",
           "DeviceBatch", "DeviceColumn", "DeviceListColumn",
           "ExtensionArray", "HostArray", "HostBatch", "HostColumn",
           "ListViewArray", "UnionArray", "batch_from_numpy",
           "batch_to_device", "list_from_device", "list_take_device",
           "list_to_device", "null_array", "pad_length"]


def __getattr__(name):
    if name in ("interop", "cdata", "flight"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(name)
