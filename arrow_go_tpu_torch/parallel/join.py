"""Distributed hash join over the process mesh, and its local core.

Port of arrow_go_tpu/parallel/join.py. `make_distributed_join` is the
narrow distributed inner join: both sides hash-partition by key over the
ranks (shuffle.py), then each rank runs the local sort-merge join of
what it received. The local core: phase 1 (`join_sorted_state`)
sorts both sides at once and counts matches with prefix sums and one
forward fill (K2 on the card); phase 2 (`join_expand`) scatters each
emitting position's owner fields to its first output slot and fills
them forward with ONE running u64 max (ops/scan.py, K2 on the card).
The right rank -> row map `rperm` comes from a stable compaction (K1 on
the card).

Inner, left/right/full outer (`join_sorted_state`) and left semi/anti
(`local_join_semi`) joins are ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import hashing
from ..ops.compaction import compact_flagged
from ..ops.scan import cummax_u32, cummax_u64_lanes
from ..ops.sort import lexsort_stable
from . import shuffle as shuf
from .mesh import Mesh, all_max


class JoinState(NamedTuple):
    """Sorted-domain join state: everything the pair expansion needs, all
    [N]-shaped (N = PL + PR)."""
    starts_j: torch.Tensor     # [N] first output slot per position
    emitting: torch.Tensor     # [N] bool: position emits >= 1 pair
    is_left: torch.Tensor      # [N] bool (valid left row at position)
    sorig: torch.Tensor        # [N] original row id at position
    rank: torch.Tensor         # [N] right rank (R_incl - 1)
    counts_pos: torch.Tensor   # [N] match count per left position
    R_before: torch.Tensor     # [N] rights before the position's group
    total: torch.Tensor        # 0-d: pairs to emit
    rperm: torch.Tensor        # [PR] right rank -> original right row


class _Sorted(NamedTuple):
    """The combined sort of [rights; lefts] and its run structure."""
    sflag: torch.Tensor        # [N] bool: invalid (null key or padding)
    sside: torch.Tensor        # [N] 0 right, 1 left
    sorig: torch.Tensor        # [N] original row id on its side
    start: torch.Tensor        # [N] bool: a valid key run starts here
    is_right: torch.Tensor     # [N] bool: valid right row
    is_left: torch.Tensor      # [N] bool: valid left row
    R_incl: torch.Tensor       # [N] valid rights at or before
    R_before: torch.Tensor     # [N] valid rights before the run


def _sort_sides(lkeys, lvalid, rkeys, rvalid) -> _Sorted:
    """One combined stable sort of [rights; lefts] on (invalid flag,
    key), run starts, and the rights before each run."""
    PL, PR = lkeys.shape[0], rkeys.shape[0]
    dev = lkeys.device
    keys_all = torch.cat([rkeys, lkeys])
    valid_all = torch.cat([rvalid, lvalid])
    # side+orig fold into ONE i32 lane (side in bit 30). It is ascending
    # in input order, so a stable sort on (flag, key) gives the JAX
    # package's 4-key (flag, khi, klo, side_orig) order exactly.
    side_orig = torch.cat([
        torch.arange(PR, dtype=torch.int32, device=dev),
        torch.arange(PL, dtype=torch.int32, device=dev) | (1 << 30)])
    flag = ~valid_all
    perm = lexsort_stable([flag.to(torch.int8), keys_all])
    sflag = flag.index_select(0, perm)
    skey = keys_all.index_select(0, perm)
    sso = side_orig.index_select(0, perm)
    sside = sso >> 30
    sorig = (sso & ((1 << 30) - 1)).to(torch.int64)
    start = torch.ones_like(sflag)
    start[1:] = skey[1:] != skey[:-1]
    start = start & ~sflag
    is_right = (sside == 0) & ~sflag
    is_left = (sside == 1) & ~sflag
    R_incl = torch.cumsum(is_right.to(torch.int64), 0)
    # rights before each group: marks at starts are monotone across
    # groups, so a running max forward-fills them. Non-start slots hold
    # 0, which gives the JAX package's max(cummax(marks or -1), 0).
    R_before = cummax_u32(torch.where(start, R_incl - is_right.to(
        torch.int64), 0))
    return _Sorted(sflag, sside, sorig, start, is_right, is_left, R_incl,
                   R_before)


def join_sorted_state(lkeys, lvalid, rkeys, rvalid,
                      how: str = "inner") -> JoinState:
    """Phase 1: one combined stable sort of [rights; lefts] on
    (invalid flag, key) + prefix-sum match counts.

    how: 'inner' | 'left outer' | 'right outer' | 'full outer'."""
    s = _sort_sides(lkeys, lvalid, rkeys, rvalid)
    is_left, is_right, start = s.is_left, s.is_right, s.start
    counts_pos = torch.where(is_left, s.R_incl - s.R_before, 0)
    if how in ("left outer", "full outer"):
        emit_pos = torch.where(is_left, torch.clamp(counts_pos, min=1), 0)
    else:
        emit_pos = counts_pos
    if how in ("right outer", "full outer"):
        # rights whose run has NO left emit one (li=-1, ri=self-rank)
        # row. Lefts in a run = L at the run's end - L before its start:
        # L_before fills forward from the start marks; L at the end fills
        # backward from the end-of-run marks by a reverse running min,
        # taken as imax - (running max of imax - marks, reversed), so
        # both fills run on K2.
        L_incl = torch.cumsum(is_left.to(torch.int64), 0)
        L_before = cummax_u32(torch.where(start, L_incl - is_left.to(
            torch.int64), 0))
        one = torch.ones(1, dtype=torch.bool, device=start.device)
        is_last = ~s.sflag & (torch.cat([start[1:], one])
                              | torch.cat([s.sflag[1:], one]))
        imax = (1 << 31) - 1
        marks = imax - torch.where(is_last, L_incl, imax)
        grp_L_end = imax - torch.flip(cummax_u32(torch.flip(marks, (0,))),
                                      (0,))
        unmatched_right = is_right & (grp_L_end - L_before == 0)
        emit_pos = emit_pos + unmatched_right.to(torch.int64)
    offsets = torch.cumsum(emit_pos, 0)
    total = offsets[-1]
    rank = s.R_incl - 1
    # rights in key-sorted order ARE rank order: the stable compaction
    # of the right positions is the rank -> row map
    PR = rkeys.shape[0]
    rperm = compact_flagged(is_right, (s.sorig,))[0][:max(PR, 1)]
    return JoinState(offsets - emit_pos, emit_pos > 0, is_left, s.sorig,
                     rank, counts_pos, s.R_before, total, rperm)


def join_expand(st: JoinState, cap_out: int):
    """Phase 2: the gather-free pair expansion. Each emitting position
    sets its first output slot (slots are distinct); the owner fields
    ride two u64 packs whose high word is the (monotone) output base,
    filled forward by one running max:

      pack A: [base:32][owner_left:1][matched:1][orig_or_rank:30]
      pack B: [base:32][R_before:32]

    Returns (li, ri, overflow): li = original left rows, ri = right
    KEY-SORTED ranks (-1 = no pair / padding)."""
    dev = st.starts_j.device
    overflow = st.total > cap_out
    # scatter into cap_out + 1 slots; the last one takes the
    # non-emitting positions and is dropped (JAX's mode="drop")
    tgt = torch.where(st.emitting, torch.clamp(st.starts_j, 0, cap_out - 1),
                      cap_out)
    field = torch.where(st.is_left, st.sorig, st.rank)
    lane_hi = st.starts_j
    lane_a = ((st.is_left.to(torch.int64) << 31)
              | ((st.counts_pos > 0).to(torch.int64) << 30) | field)
    lane_b = torch.where(st.emitting, st.R_before, 0)

    def scatter(lane):
        buf = torch.zeros(cap_out + 1, dtype=torch.int64, device=dev)
        buf.index_put_((tgt,), lane)
        return buf[:cap_out]

    fill_hi, fill_a, fill_b = cummax_u64_lanes(
        scatter(lane_hi), [scatter(lane_a), scatter(lane_b)])
    f_left = ((fill_a >> 31) & 1) != 0
    f_match = ((fill_a >> 30) & 1) != 0
    f_field = fill_a & ((1 << 30) - 1)
    j = torch.arange(cap_out, dtype=torch.int64, device=dev)
    r_rank = fill_b + (j - fill_hi)
    in_range = j < st.total
    li = torch.where(in_range & f_left, f_field, -1)
    ri = torch.where(in_range & f_left & f_match, r_rank,
                     torch.where(in_range & ~f_left, f_field, -1))
    return li, ri, overflow


def local_join_inner(lkeys, lvalid, rkeys, rvalid, cap_out: int,
                     how: str = "inner"):
    """Sort-merge inner join of one pair of key columns.

    Returns (li[cap_out], ri[cap_out], rperm[PR], n_out, overflow):
    li = original left row ids; ri = right-side KEY-SORTED ranks
    (-1 = no match / padding); rperm[rank] = original right row.
    Sides are limited to 2^30 rows per call (rank/id pack in 30 bits).
    """
    st = join_sorted_state(lkeys, lvalid, rkeys, rvalid, how)
    li, ri, overflow = join_expand(st, cap_out)
    return li, ri, st.rperm, st.total, overflow


def local_join_semi(lkeys, lvalid, rkeys, rvalid, how: str):
    """Semi/anti verdict per ORIGINAL left row (the sort-merge probe of
    local_join_inner). how: 'left semi' | 'left anti'.

    A left row matches when its run holds a right. The verdict goes back
    to row order by one scatter over every left-side position, invalid
    rows included (their verdict is False), where the JAX package sorts
    by original row."""
    s = _sort_sides(lkeys, lvalid, rkeys, rvalid)
    PL = lkeys.shape[0]
    matched = s.is_left & (s.R_incl - s.R_before > 0)
    # right positions go to slot PL, which is dropped
    out = torch.zeros(PL + 1, dtype=torch.bool, device=lkeys.device)
    out[torch.where(s.sside == 1, s.sorig, PL)] = matched
    out = out[:PL]
    if how == "left anti":
        return ~out & lvalid
    return out & lvalid


def make_distributed_join(mesh: Mesh, cap_shuffle: int, cap_out: int):
    """Distributed inner join on int64 keys with one payload column per
    side.

    Per-rank inputs: lkeys, lvals, lvalid, rkeys, rvals, rvalid.
    Per-rank outputs: joined key, lval, rval (padding -1/0 beyond n_out),
    n_out[1], overflow flag (the same on every rank)."""
    D = mesh.world_size
    body = shuf.shuffle_shard_fn(mesh, cap_shuffle)

    def step(lkeys, lvals, lvalid, rkeys, rvals, rvalid):
        ldest = shuf.partition_of(hashing.hash32(lkeys, shuf._dt_of(lkeys)),
                                  D)
        (slk, slv), lcounts, lov = body(ldest, lvalid, lkeys, lvals)
        rdest = shuf.partition_of(hashing.hash32(rkeys, shuf._dt_of(rkeys)),
                                  D)
        (srk, srv), rcounts, rov = body(rdest, rvalid, rkeys, rvals)
        lrows = shuf.row_validity_mask(slk, lcounts, cap_shuffle)
        rrows = shuf.row_validity_mask(srk, rcounts, cap_shuffle)
        li, ri, rperm, n_out, jov = local_join_inner(slk, lrows, srk, rrows,
                                                     cap_out)
        lidx = li.clamp(0, slk.shape[0] - 1)
        out_k = torch.where(li >= 0, slk.index_select(0, lidx), -1)
        out_l = torch.where(li >= 0, slv.index_select(0, lidx), 0)
        # ri is a key-sorted right RANK: permute the payload once
        # (build-sized gather), then the per-pair gather rides ranks
        srv_ranked = srv.index_select(0, rperm.clamp(0, srv.shape[0] - 1))
        out_r = torch.where(ri >= 0, srv_ranked.index_select(
            0, ri.clamp(0, srv.shape[0] - 1)), 0)
        return (out_k, out_l, out_r, n_out.reshape(1),
                all_max(mesh, lov | rov | jov))

    return step
