"""Distributed sort over the process mesh: sample-based range
partitioning + all_to_all exchange + local sort.

Port of arrow_go_tpu/parallel/sort.py. Every rank samples its sorted
keys, the gathered samples give D-1 range splitters, rows travel to
their range's rank through the shuffle's capacity-bounded exchange, and
each rank sorts what it received. Reading the ranks in order gives the
global ascending order. Invalid (null) rows are dropped by the exchange.

Floats order as the JAX package's sort orders them (a total order:
-0.0 before 0.0, NaN last): keys compare by their radix bits
(ops/sort._orderable_bits). Sorts are stable, as jnp.argsort is.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.sort import _orderable_bits, sortable
from .mesh import Mesh, all_gather, all_max, all_to_all
from .shuffle import _pack_for_send, row_validity_mask


class DistSortResult(NamedTuple):
    keys: torch.Tensor      # [D*cap]: this rank's sorted valid rows first
    payload: tuple          # payload columns, permuted with the keys
    counts: torch.Tensor    # [1] valid rows on this rank
    overflow: torch.Tensor  # 0-d bool, the same on every rank


def _sentinel_for(dtype: torch.dtype):
    return float("inf") if dtype.is_floating_point else \
        torch.iinfo(dtype).max


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the JAX sort order of x."""
    if x.dtype.is_floating_point:
        return sortable(_orderable_bits(x))
    return x.to(torch.int64)


def splitters_of(mesh: Mesh, key: torch.Tensor, n_valid,
                 n_samples: int) -> torch.Tensor:
    """The D-1 range splitters (as order keys) from `n_samples` evenly
    spaced samples of each rank's sorted order keys; `n_valid` (a 0-d
    tensor, or None for the JAX package's sample of the whole shard)
    limits the samples to the valid prefix. Invalid rows carry the
    sentinel, so a rank with no valid row samples only sentinels."""
    L = key.shape[0]
    sk = torch.sort(key).values
    dev = key.device
    if n_valid is None:
        pos = (torch.arange(n_samples, device=dev)
               * max(L // n_samples, 1)) % L
        sample = sk.index_select(0, pos)
    else:
        pos = (torch.arange(n_samples, device=dev)
               * torch.clamp(n_valid, min=1)) // n_samples
        sample = sk.index_select(0, pos.clamp(0, L - 1))
    flat = torch.sort(all_gather(mesh, sample)).values
    S, D = flat.shape[0], mesh.world_size
    return flat.index_select(0, torch.arange(1, D, device=dev) * S // D)


def _exchange(mesh: Mesh, dest, valid, cap, cols):
    packed, counts, overflow = _pack_for_send(dest, valid, mesh.world_size,
                                              cap, cols)
    received = [all_to_all(mesh, p) for p in packed]
    return received, all_to_all(mesh, counts), all_max(mesh, overflow)


def make_distributed_sort(mesh: Mesh, cap: int, n_payload: int = 0,
                          n_samples: int = 64):
    """The distributed ascending sort.

    Per-rank inputs: keys[L], valid[L], *payload[L].
    Output: DistSortResult: rank d's first counts[0] rows are sorted and
    every key on rank d <= every key on rank d+1."""

    def run(keys, valid, *payload) -> DistSortResult:
        if len(payload) != n_payload:
            raise ValueError(f"expected {n_payload} payload columns")
        sent = _sentinel_for(keys.dtype)
        kk = order_key(torch.where(valid, keys, sent).to(keys.dtype))
        splitters = splitters_of(mesh, kk, None, n_samples)
        dest = torch.searchsorted(splitters, kk, right=True).to(torch.int32)
        received, recv_counts, overflow = _exchange(
            mesh, dest, valid, cap, (keys,) + tuple(payload))
        rmask = row_validity_mask(received[0], recv_counts, cap)
        # invalid slots take the sentinel, which sorts to the tail
        rkeys = torch.where(rmask, received[0], sent).to(keys.dtype)
        order = torch.argsort(order_key(rkeys), stable=True)
        n_local = recv_counts.sum().to(torch.int32)
        return DistSortResult(rkeys.index_select(0, order),
                              tuple(r.index_select(0, order)
                                    for r in received[1:]),
                              n_local.reshape(1), overflow)

    return run
