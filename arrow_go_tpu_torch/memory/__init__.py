"""Host buffers and allocators of the port (memory/buffer.py)."""
from .buffer import (ALIGNMENT, Allocator, Buffer,  # noqa: F401
                     TrackedAllocator, default_allocator)
