"""Segment aggregation over a sorted key domain: the group-by core.

Port of arrow_go_tpu/ops/groupagg.py. Per-group sums and counts run in
the key-sorted domain: a cumulative sum, the prefix at each run's last
position moved to the front by one stable compaction (K1 on the card),
then prefix differences. Per-group min and max take one more stable
(key, value) sort: each run's first position holds its extremum, moved
to the front by the same compaction. The JAX package's chunked
cumsum/cummax were TPU compile workarounds; plain `torch.cumsum` /
`torch.cummax` take their place.
"""
from __future__ import annotations

from typing import Optional

import torch

from .compaction import compact_flagged
from .hashing import SortedEncode
from .sort import INT64_MIN, lexsort_stable

INT64_MAX = (1 << 63) - 1


def cummax_u64(v: torch.Tensor) -> torch.Tensor:
    """Running max of int64 tensors carrying u64 bit patterns (the sign
    bit is flipped so that torch's signed order is the unsigned one)."""
    return torch.cummax(v ^ INT64_MIN, 0).values ^ INT64_MIN


def _is_last(start: torch.Tensor) -> torch.Tensor:
    return torch.cat([start[1:], start.new_ones(1)])


def compact_runs(flag_keep: torch.Tensor, payloads) -> tuple:
    """Move rows where flag_keep to the front (stable): entries
    [0, n_keep) of each payload are the per-run results in key order."""
    return compact_flagged(flag_keep != 0, payloads)


def segment_sum_count(enc: SortedEncode, values: torch.Tensor,
                      valid_rows: Optional[torch.Tensor],
                      values_sorted: Optional[torch.Tensor] = None,
                      valid_sorted: Optional[torch.Tensor] = None):
    """(sums_by_run[P], counts_by_run[P] int64): per-run sum and valid
    count, indexed by run id (slots >= n_unique are padding).

    Pass values_sorted/valid_sorted (payloads carried through the
    encode sort — hashing.encode_sorted_with) to skip the gathers."""
    vs = (values_sorted if values_sorted is not None
          else values.index_select(0, enc.sidx))
    ok = enc.svalid
    if valid_sorted is not None:
        ok = ok & valid_sorted
    elif valid_rows is not None:
        ok = ok & valid_rows.index_select(0, enc.sidx)
    x = torch.where(ok, vs, torch.zeros((), dtype=vs.dtype,
                                        device=vs.device))
    cs = torch.cumsum(x, 0)
    cnt = torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32)
    sums_at_last, cnts_at_last = compact_runs(_is_last(enc.start), (cs, cnt))
    prev_sum = torch.cat([sums_at_last.new_zeros(1), sums_at_last[:-1]])
    prev_cnt = torch.cat([cnts_at_last.new_zeros(1), cnts_at_last[:-1]])
    return (sums_at_last - prev_sum,
            (cnts_at_last - prev_cnt).to(torch.int64))


def segment_min_max(key: torch.Tensor, values: torch.Tensor,
                    value_key: torch.Tensor,
                    valid_rows: Optional[torch.Tensor], op: str):
    """Per-run min ('min') or max ('max') of `values` by ONE stable
    (key, value_key) sort: each run's first position holds the extremum.

    key: the encode's int64 key in original row order (run boundaries
    where it changes; the same runs as the encode's, in the same order).
    value_key: int64 whose signed order is the values' order. Rows where
    valid_rows is False keep their key run (so run ids stay aligned with
    the encode's) but sort last within it; a run with no valid row
    returns an unspecified value, masked by the caller's count > 0.
    Returns values_by_run[P] (key order; slots >= n_unique padding)."""
    vkey = value_key if op == "min" else ~value_key
    if valid_rows is not None:
        vkey = torch.where(valid_rows, vkey, INT64_MAX)
    perm = lexsort_stable([key, vkey])
    skey = key.index_select(0, perm)
    start = torch.ones_like(skey, dtype=torch.bool)
    start[1:] = skey[1:] != skey[:-1]
    (out,) = compact_runs(start, (values.index_select(0, perm),))
    return out
