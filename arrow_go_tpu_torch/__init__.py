"""arrow_go_tpu_torch: the PyTorch/CUDA port of arrow_go_tpu.

The device pipeline of the JAX package (expression -> DeviceBatch filter
-> hash join -> group-by -> sort/take of the group-sized result) on an
NVIDIA Hopper card, with hand-written CUDA kernels where the JAX package
has Pallas kernels (csrc/) and a plain PyTorch version beside each.
Module paths mirror the JAX package. The port imports torch and numpy,
never jax or arrow_go_tpu.
"""
from . import compute, dtypes, torchenv
from .device.block import (DeviceBatch, DeviceColumn, HostArray, HostBatch,
                           batch_from_numpy, batch_to_device, pad_length)

__all__ = ["compute", "dtypes", "torchenv", "DeviceBatch", "DeviceColumn",
           "HostArray", "HostBatch", "batch_from_numpy", "batch_to_device",
           "pad_length"]
