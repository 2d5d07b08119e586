"""The process mesh of the distributed tier, on torch.distributed.

Port of arrow_go_tpu/parallel/mesh.py. The JAX package runs ONE process
over a mesh of D devices and `shard_map`s each step over the shards; the
port runs D processes, one shard each, joined by a torch.distributed
process group (NCCL between cards, gloo on the CPU). A `Mesh` is that
group, this process's rank in it, its size and the device the rank's
shard lives on. Every exchange of the tier is a collective of the group:

  jax.lax.all_to_all(tiled)  -> dist.all_to_all_single of [D*cap] blocks
  jax.lax.all_gather         -> dist.all_gather_into_tensor
  jax.lax.pmax               -> dist.all_reduce(MAX)

The collectives move every dtype as its bytes (a uint8 view of the same
buffer), so NCCL, which has no bool or int16, takes any column. A group
of one rank still runs each collective: no path skips it.
"""
from __future__ import annotations

import socket
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import torchenv

SHARD_AXIS = "shards"


class Mesh(NamedTuple):
    """One rank's view of the process group the tier runs over."""
    group: Optional[object]     # the ProcessGroup; None = the default one
    rank: int
    world_size: int
    device: torch.device


def free_port() -> int:
    """A free TCP port on this host (for a localhost rendezvous)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _rank_device(dev: torch.device) -> torch.device:
    """A CUDA device with its index: the current one."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of `group` (default: the initialised default group) on
    `device` (default: the card). With no process group initialised it
    starts one of world size 1 on a free localhost port: NCCL for a CUDA
    device, gloo for the CPU."""
    dev = _rank_device(torchenv.device(device))
    if not dist.is_initialized():
        dist.init_process_group(
            _backend(dev), init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def global_mesh(device=None) -> Mesh:
    """The mesh over the initialised default group: every rank of every
    host (the JAX package's mesh over all devices of all hosts), on
    `device` (default: the card). Raises RuntimeError when no process
    group is initialised: make_mesh or initialize_multihost starts one."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised; make_mesh or "
                           "initialize_multihost starts one")
    dev = _rank_device(torchenv.device(device))
    return Mesh(None, dist.get_rank(), dist.get_world_size(), dev)


def initialize_multihost(init_method: str, world_size: int, rank: int,
                         device=None) -> Mesh:
    """Join this process to a process group of `world_size` ranks at
    `init_method` (e.g. 'tcp://10.0.0.1:29500') as `rank`, and return the
    mesh over it. On a CUDA device each rank takes card rank % count. A
    process already in a group keeps it (idempotent)."""
    dev = torchenv.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), init_method=init_method,
                                world_size=world_size, rank=rank)
    return make_mesh(dev)


def local_row_range(mesh: Mesh, n_rows: int) -> Sequence[int]:
    """[start, stop) of the global rows this rank's shard owns (what a
    per-rank ingest should load), as the JAX package computes it."""
    per = -(-n_rows // mesh.world_size)
    return (mesh.rank * per, min(n_rows, (mesh.rank + 1) * per))


class Sharding(NamedTuple):
    """Where a global array lives over the mesh: row blocks, one per
    rank (`row_sharding`), or whole on every rank (`replicated`)."""
    mesh: Mesh
    rows: bool

    def put(self, data) -> torch.Tensor:
        """This rank's part of a global host array (identical on every
        rank) on the mesh device: rows [rank*N/D, (rank+1)*N/D), or all
        of it when replicated."""
        a = np.ascontiguousarray(np.asarray(data))
        if self.rows:
            D = self.mesh.world_size
            if a.shape[0] % D:
                raise ValueError(f"{a.shape[0]} rows do not split over "
                                 f"{D} shards")
            per = a.shape[0] // D
            a = a[self.mesh.rank * per:(self.mesh.rank + 1) * per]
        return torch.from_numpy(a.copy()).to(self.mesh.device)


def row_sharding(mesh: Mesh) -> Sharding:
    """Rows partitioned across ranks (the engine's 'data parallel')."""
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def all_to_all(mesh: Mesh, buf: torch.Tensor, async_op: bool = False):
    """Tiled all_to_all of a [D*cap] buffer: block j goes to rank j, and
    block i of the result came from rank i. With async_op, returns
    (result, work); the result is ready once work.wait() returns."""
    src = _bytes(buf)
    out = torch.empty_like(src)
    work = dist.all_to_all_single(out, src, group=mesh.group,
                                  async_op=async_op)
    all_to_all.bytes += src.numel()
    res = out.view(buf.dtype)
    return (res, work) if async_op else res


# bytes this process has handed each collective (a counter for
# measurement, as each kernel wrapper counts its launches)
all_to_all.bytes = 0


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[n] on every rank -> [D*n], rank i's block at i*n."""
    src = _bytes(x)
    out = torch.empty(src.shape[0] * mesh.world_size, dtype=torch.uint8,
                      device=src.device)
    # (all_gather_into_tensor was renamed all_gather_single in torch 2.13)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, src, group=mesh.group)
    all_gather.bytes += src.numel()
    return out.view(x.dtype)


all_gather.bytes = 0


def all_max(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the ranks (pmax). A bool comes back bool."""
    v = x.to(torch.int32).clone()
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=mesh.group)
    return v > 0 if x.dtype == torch.bool else v.to(x.dtype)
