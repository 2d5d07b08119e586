"""Host buffers, allocators and bitmap utilities of the port
(memory/buffer.py, memory/bitutil.py)."""
from . import bitutil  # noqa: F401
from .buffer import (ALIGNMENT, Allocator, Buffer,  # noqa: F401
                     TrackedAllocator, default_allocator)
