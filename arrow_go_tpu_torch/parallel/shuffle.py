"""Distributed hash-partition shuffle over the process mesh.

Port of arrow_go_tpu/parallel/shuffle.py. Rows move between ranks as
one all_to_all of capacity-bounded blocks: each rank packs the rows
bound for rank p into slots [p*cap, (p+1)*cap) of a fixed [D*cap]
buffer per column; per-destination counts travel alongside; an overflow
(a bucket of more than cap rows) is flagged on the device, all-reduced,
and read by the host, which retries with a larger capacity.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .. import dtypes as dt
from .mesh import Mesh, all_max, all_to_all

_TYPES = {torch.bool: dt.bool_, torch.int8: dt.int8, torch.int16: dt.int16,
          torch.int32: dt.int32, torch.int64: dt.int64,
          torch.uint8: dt.uint8, torch.float16: dt.float16,
          torch.float32: dt.float32, torch.float64: dt.float64}


def _dt_of(x: torch.Tensor) -> dt.DataType:
    """The type a tensor of the tier holds: signed for the signed dtypes
    (the table-level API widens uint16 and uint32 columns to int64)."""
    return _TYPES[x.dtype]


def partition_of(keys_hash: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Destination rank per row from a 32-bit key hash (int64 carrying
    the u32)."""
    return (keys_hash % n_parts).to(torch.int32)


def send_slots(dest: torch.Tensor, valid: torch.Tensor, n_parts: int):
    """(dest with invalid rows at n_parts, each row's stable rank among
    the rows of its destination, counts[n_parts + 1])."""
    L = dest.shape[0]
    dev = dest.device
    dest = torch.where(valid, dest.to(torch.int64), n_parts)
    # rows grouped by destination, each group in row order (stable)
    order = torch.argsort(dest, stable=True)
    counts = torch.bincount(dest, minlength=n_parts + 1)
    start = torch.cumsum(counts, 0) - counts           # first slot per dest
    slot = torch.empty(L, dtype=torch.int64, device=dev)
    slot[order] = torch.arange(L, device=dev) - start.index_select(
        0, dest.index_select(0, order))
    return dest, slot, counts


def _pack_for_send(dest: torch.Tensor, valid: torch.Tensor, n_parts: int,
                   cap: int, columns: Sequence[torch.Tensor]):
    """Scatter rows into an [n_parts * cap] slot buffer per column: a
    row's slot is its stable rank among the rows of its destination.
    Returns (buffers, counts[n_parts] int32, overflow 0-d bool)."""
    dev = dest.device
    dest, slot, counts = send_slots(dest, valid, n_parts)
    overflow = (counts[:n_parts] > cap).any()
    # rows that are dropped or past their bucket's capacity land in one
    # spare slot, sliced off (the JAX package's scatter mode="drop")
    flat = torch.where((dest < n_parts) & (slot < cap),
                       dest * cap + slot.clamp(0, cap - 1), n_parts * cap)
    packed = []
    for col in columns:
        buf = torch.zeros(n_parts * cap + 1, dtype=col.dtype, device=dev)
        buf[flat] = col
        packed.append(buf[:n_parts * cap])
    return packed, counts[:n_parts].to(torch.int32), overflow


class ShuffleResult(NamedTuple):
    """A rank's received rows (padded to capacity) and counts by source."""
    data: Tuple[torch.Tensor, ...]    # each [D*cap] rows
    counts: torch.Tensor              # [D] rows received from each rank
    overflow: torch.Tensor            # any send bucket overflowed


def shuffle_shard_fn(mesh: Mesh, cap: int):
    """Returns the per-rank body: (dest, valid, *cols) -> (received cols
    [D*cap] each, counts[D] received from each rank, overflow all-reduced
    over the ranks)."""
    D = mesh.world_size

    def body(dest, valid, *cols):
        packed, counts, overflow = _pack_for_send(dest, valid, D, cap, cols)
        received = tuple(all_to_all(mesh, p) for p in packed)
        recv_counts = all_to_all(mesh, counts)
        return ShuffleResult(received, recv_counts, all_max(mesh, overflow))

    return body


def make_shuffle(mesh: Mesh, n_cols: int, cap: int):
    """The distributed shuffle over `mesh`.

    Per-rank inputs: dest[L], valid[L], cols[L]... (n_cols of them).
    Per-rank outputs: received cols [D*cap] each, counts [D], overflow
    (the same on every rank)."""
    body = shuffle_shard_fn(mesh, cap)

    def fn(dest, valid, *cols):
        if len(cols) != n_cols:
            raise ValueError(f"expected {n_cols} columns, got {len(cols)}")
        return body(dest, valid, *cols)

    return fn


def row_validity_mask(received: torch.Tensor, counts: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """Bool mask over a received [D*cap] buffer: slot < counts[source]."""
    D = counts.shape[0]
    i = torch.arange(D * cap, device=received.device)
    return (i % cap) < counts.index_select(0, i // cap)
