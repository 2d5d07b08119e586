"""The distributed tier of the port on torch.distributed (mirrors
arrow_go_tpu.parallel): one process per shard, joined by a process
group; the exchanges are its collectives."""
from .mesh import (SHARD_AXIS, global_mesh, make_mesh,  # noqa: F401
                   replicated, row_sharding)
from . import join  # noqa: F401
from . import aggregate, dist, overlap, shuffle, sort  # noqa: F401
from .api import (distributed_group_by, distributed_hash_join,  # noqa: F401
                  distributed_sort)
