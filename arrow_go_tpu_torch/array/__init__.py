"""The host-array leftovers of the JAX `array/` layer that the port's
HostArray / HostBatch (device/block.py) do not stand in for: ChunkedArray
(record.py) and the equality, approximate equality and edit-script diff
of HostArrays (compare.py)."""
from .compare import (DiffEdit, array_approx_equal,  # noqa: F401
                      array_equal, diff)
from .record import ChunkedArray  # noqa: F401
