"""Device-memory leak watcher: the analog of the reference's
CheckedAllocator.AssertSize leak detector (arrow/memory/
checked_allocator.go:33-154).

Port of arrow_go_tpu/utils/memwatch.py. PyTorch's caching allocator
owns buffer lifetime, so the per-allocation ledger becomes watermark
accounting: read the bytes the allocator has handed out on the device
(`torch.cuda.memory_allocated`), run a workload, collect garbage and
synchronize, and assert the count came back to its start. A Python
reference cycle that pins a tensor, or a cache that grows, shows as
growth. The CPU has no such counter (the JAX CPU backend gives no stats
either): there `device_live_bytes` is None and the watcher asserts
nothing.
"""
from __future__ import annotations

import gc
from typing import Optional

import torch

from .. import torchenv


def device_live_bytes(device=None) -> Optional[int]:
    """Bytes of live tensors on `device` (the card unless named), or
    None on the CPU."""
    dev = torchenv.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.memory_allocated(dev)


class DeviceMemoryWatcher:
    """Context manager asserting that a workload leaves no device memory
    behind, up to ``tolerance`` bytes of growth (state a warm kernel
    keeps, such as its per-stream scratch)::

        with DeviceMemoryWatcher(tolerance=1 << 20):
            run_query(...)
    """

    def __init__(self, device=None, tolerance: int = 1 << 20):
        self.device = torchenv.device(device)
        self.tolerance = tolerance
        self.start: Optional[int] = None
        self.end: Optional[int] = None

    def _settle(self) -> Optional[int]:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return device_live_bytes(self.device)

    def __enter__(self):
        self.start = self._settle()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        self.end = self._settle()
        if self.start is None or self.end is None:
            return False  # the CPU: nothing to assert
        growth = self.end - self.start
        if growth > self.tolerance:
            raise AssertionError(
                f"device memory leak: {growth} bytes still live after "
                f"workload (start={self.start}, end={self.end}, "
                f"tolerance={self.tolerance})")
        return False

    @property
    def growth(self) -> Optional[int]:
        if self.start is None or self.end is None:
            return None
        return self.end - self.start
