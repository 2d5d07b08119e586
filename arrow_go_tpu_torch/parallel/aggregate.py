"""Distributed hash aggregate: GROUP BY over the process mesh.

Port of arrow_go_tpu/parallel/aggregate.py: rows hash-partition across
the ranks (shuffle.py), then each rank groups the keys it owns with the
sort-based encode (ops/hashing.encode_codes) and scatter reductions.
The hash partition makes the ranks' keys disjoint, so group results
need no second exchange.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import bitmap, hashing
from . import shuffle as shuf
from .shuffle import _dt_of
from .mesh import Mesh


class GroupAggSpec(NamedTuple):
    agg: str   # 'sum' | 'count' | 'min' | 'max'


def _max_of(d: torch.dtype):
    return float("inf") if d.is_floating_point else torch.iinfo(d).max


def _min_of(d: torch.dtype):
    return float("-inf") if d.is_floating_point else torch.iinfo(d).min


def local_group_agg(keys: torch.Tensor, values: torch.Tensor,
                    valid: torch.Tensor, aggs: Tuple[str, ...]):
    """Group-by on one rank: returns (group_keys[P], results[len(aggs)][P],
    n_groups), groups in key order. Slots >= n_groups are padding."""
    P = keys.shape[0]
    res = hashing.encode_codes(keys, _dt_of(keys), bitmap.pack_mask(valid),
                               P, order="key")
    slot = torch.where(res.codes >= 0, res.codes, P)
    outs = []
    for agg in aggs:
        if agg == "count":
            acc = torch.zeros(P + 1, dtype=torch.int64, device=keys.device)
            acc.index_add_(0, slot, torch.ones_like(slot))
        elif agg == "sum":
            acc = torch.zeros(P + 1, dtype=values.dtype, device=keys.device)
            acc.index_add_(0, slot, torch.where(valid, values, 0).to(
                values.dtype))
        elif agg in ("min", "max"):
            fill = _max_of(values.dtype) if agg == "min" else \
                _min_of(values.dtype)
            acc = torch.full((P + 1,), fill, dtype=values.dtype,
                             device=keys.device)
            acc.scatter_reduce_(0, slot, torch.where(valid, values, fill).to(
                values.dtype), "amin" if agg == "min" else "amax")
        else:
            raise ValueError(agg)
        outs.append(acc[:P])
    # group keys: the value at each code's first row
    gkeys = keys.index_select(0, res.first_index.clamp(0, P - 1))
    return gkeys, outs, res.n_unique


def make_group_by_sum(mesh: Mesh, cap: int):
    """Distributed GROUP BY key -> sum(value), count(*).

    Per-rank inputs: keys[L] int, values[L], valid[L] bool.
    Per-rank outputs: group_keys[D*cap], sums, counts, n_groups[1], and
    the shuffle's overflow flag (the same on every rank)."""
    body = shuf.shuffle_shard_fn(mesh, cap)

    def step(keys, values, valid):
        dest = shuf.partition_of(hashing.hash32(keys, _dt_of(keys)),
                                 mesh.world_size)
        (rk, rv), counts, overflow = body(dest, valid, keys, values)
        rvalid = shuf.row_validity_mask(rk, counts, cap)
        gkeys, (sums, cnts), n_groups = local_group_agg(
            rk, rv, rvalid, ("sum", "count"))
        return gkeys, sums, cnts, n_groups.reshape(1), overflow

    return step
