"""The JAX package's `array/` layer over the port's HostArray: the typed
array classes, ArrayData and make_array (arrays.py, on the layout code
of layout.py), the builders (builders.py), concatenation (concat.py),
RecordBatch / ChunkedArray / Column / Table (record.py) and the
equality, approximate equality and edit-script diff of HostArrays
(compare.py)."""
from .arrays import *  # noqa: F401,F403
from .builders import infer_type, make_builder  # noqa: F401
from .compare import (DiffEdit, array_approx_equal,  # noqa: F401
                      array_equal, diff)
from .concat import concat_arrays  # noqa: F401
from .record import (ChunkedArray, Column, RecordBatch,  # noqa: F401
                     Table, record_batch, table)
