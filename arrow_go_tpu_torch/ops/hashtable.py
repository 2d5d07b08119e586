"""Vectorized open-addressing hash table in device memory.

Port of arrow_go_tpu/ops/hashtable.py: a whole column probes in
parallel, one round per probe step:

  1. unresolved rows compute pos = (h + round) mod T
  2. claim: a scatter-min of row id per slot picks one writer per slot
  3. winners whose slot is empty insert their key
  4. every unresolved row re-reads its slot: key match -> resolved

The JAX package carries the round in a `lax.while_loop` on the device.
torch has no device-side loop, so each round here ends by reading the
count of unresolved rows on the host, and the next round works on those
rows only. The table and every row's slot are the JAX package's: rows
advance one slot a round together, and a claim picks the lowest row id.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import hashing


class HashTable(NamedTuple):
    keys: torch.Tensor       # [T] stored keys (valid where occupied)
    occupied: torch.Tensor   # [T] bool
    slots: torch.Tensor      # [P] int64 slot per input row (-1 for invalid)
    n_groups: torch.Tensor   # 0-d


def _home(keys: torch.Tensor, T: int) -> torch.Tensor:
    return hashing.hash32(keys) % T


def _find(table_keys, occupied, keys, valid, h, stop_at_empty: bool):
    """Each valid row's slot (-1 if absent): rows walk from their home
    slot together, one slot a round, until their key matches (or, with
    stop_at_empty, an empty slot shows it is absent)."""
    T = table_keys.shape[0]
    slots = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    rows = torch.nonzero(valid).reshape(-1)
    r = 0
    while rows.numel() and r < T:
        pos = (h.index_select(0, rows) + r) % T
        occ = occupied.index_select(0, pos)
        hit = occ & (table_keys.index_select(0, pos)
                     == keys.index_select(0, rows))
        slots[rows[hit]] = pos[hit]
        done = hit | ~occ if stop_at_empty else hit
        rows = rows[~done]
        r += 1
    return slots


def build(keys: torch.Tensor, valid: torch.Tensor, table_size: int,
          init_keys=None, init_occupied=None) -> HashTable:
    """Insert all valid rows' keys; equal keys share a slot.

    init_keys/init_occupied: resume from an existing table (the streamed
    chunked aggregation in parallel/overlap.py inserts chunk after chunk
    into one table); they are not modified."""
    P = keys.shape[0]
    T = table_size
    dev = keys.device
    h = _home(keys, T)
    table_keys = (init_keys.clone() if init_keys is not None
                  else torch.zeros(T, dtype=keys.dtype, device=dev))
    occupied = (init_occupied.clone() if init_occupied is not None
                else torch.zeros(T, dtype=torch.bool, device=dev))
    rows = torch.nonzero(valid).reshape(-1)        # the unresolved rows
    r = 0
    while rows.numel() and r < T:
        pos = (h.index_select(0, rows) + r) % T
        # one writer per contested slot: the lowest row id
        claim = torch.full((T,), P, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, pos, rows, "amin")
        write = (claim.index_select(0, pos) == rows) & \
            ~occupied.index_select(0, pos)
        table_keys[pos[write]] = keys.index_select(0, rows[write])
        occupied[pos[write]] = True
        matched = occupied.index_select(0, pos) & (
            table_keys.index_select(0, pos) == keys.index_select(0, rows))
        rows = rows[~matched]
        r += 1
    slots = _find(table_keys, occupied, keys, valid, h, False)
    return HashTable(table_keys, occupied, slots, occupied.sum())


def group_sum(keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
              table_size: int):
    """Hash-based GROUP BY sum/count: returns (group_keys[T], sums[T],
    counts[T] int32, occupied[T], n_groups). Slot order is hash order."""
    ht = build(keys, valid, table_size)
    T = table_size
    slot = torch.where(ht.slots >= 0, ht.slots, T)
    sums = torch.zeros(T + 1, dtype=values.dtype, device=keys.device)
    sums.index_add_(0, slot, torch.where(valid, values, 0).to(values.dtype))
    counts = torch.zeros(T + 1, dtype=torch.int32, device=keys.device)
    counts.index_add_(0, slot, valid.to(torch.int32))
    return ht.keys, sums[:T], counts[:T], ht.occupied, ht.n_groups


def probe(ht_keys: torch.Tensor, occupied: torch.Tensor, query: torch.Tensor,
          qvalid: torch.Tensor):
    """Membership probe against a built table: returns (found[Q],
    slot[Q], -1 where not found)."""
    slots = _find(ht_keys, occupied, query, qvalid,
                  _home(query, ht_keys.shape[0]), True)
    return slots >= 0, slots
