"""Generalized distributed operators over the process mesh.

Port of arrow_go_tpu/parallel/dist.py: every operator takes TUPLES of
key and payload columns, so multi-column and string-keyed (dictionary
code) queries run distributed, with the two skew mechanisms built in:

- **Pre-aggregating group-by (combiner).** Each rank aggregates locally
  BEFORE the exchange, so a hot key ships at most one partial row per
  rank: exchange volume is the local groups, not the rows.
- **Hot-key joins.** Per-rank key histograms detect hot keys. Keys hot
  on the probe side (path A) broadcast their build rows to every rank
  and their probe rows never move; keys hot on the build side (path B)
  spread (salt) their build rows round-robin over the ranks and
  broadcast their probe rows.

Each builder returns a callable that takes this rank's shard tensors
and returns this rank's outputs; counts stay on the device and overflow
flags come back all-reduced. No step reads the device on the host.

Where torch differs from JAX the JAX rule is reproduced: scatters with
out-of-range targets write one spare slot that is sliced off (JAX's
mode="drop"), gathers clamp their indices, sorts are stable, and the
hot-key top-k breaks count ties toward the lower index (a stable sort
by count, descending), as jax.lax.top_k does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import dtypes as dt
from ..ops import bitmap, groupagg, hashing
from ..ops import sort as sort_ops
from ..ops.sort import _orderable_bits, sortable
from . import join as pjoin
from . import shuffle as shuf
from .mesh import Mesh, all_gather, all_max, all_to_all
from .shuffle import _dt_of
from .sort import _exchange, _sentinel_for, order_key, splitters_of

BIG = 1 << 62                     # marks an unused hot-list slot
INT64_MAX = (1 << 63) - 1
_GOLDEN = 0x9E3779B1


def _hash_multi(keys: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Combined 32-bit hash over multiple key columns (int64 carrying
    the u32): h * 0x9E3779B1 ^ hash(k) in u32 arithmetic."""
    h = None
    for k in keys:
        hk = hashing.hash32(k, _dt_of(k))
        h = hk if h is None else hashing._mul_u32(h, _GOLDEN) ^ hk
    return h


def _combined_local_key(keys: Tuple[torch.Tensor, ...], valid: torch.Tensor):
    """Multi-column key -> one combined int64 per row (-1 = null/invalid):
    cardinality-multiplied per-column codes (key order)."""
    L = keys[0].shape[0]
    words = bitmap.pack_mask(valid)
    combined = None
    for k in keys:
        res = hashing.encode_codes(k, _dt_of(k), words, L, order="key")
        part = torch.where(res.codes >= 0, res.codes, -1)
        if combined is None:
            combined = part
        else:
            combined = torch.where((combined >= 0) & (part >= 0),
                                   combined * (res.n_unique + 1) + part, -1)
    return combined


def _local_codes(keys: Tuple[torch.Tensor, ...], valid: torch.Tensor):
    """Per-rank dense codes over a multi-column key (exact equality
    within the rank), in key order."""
    combined = _combined_local_key(keys, valid)
    return hashing.encode_codes(combined, dt.int64,
                                bitmap.pack_mask(combined >= 0),
                                combined.shape[0], order="key")


# ---------------------------------------------------------------------------
# distributed group-by with local pre-aggregation
# ---------------------------------------------------------------------------

_MERGE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def _segment_group(keys: Tuple[torch.Tensor, ...], valid: torch.Tensor,
                   specs):
    """Per-rank group-by by SEGMENT aggregation (ops/groupagg).
    specs: ((values, agg, value_valid_mask_or_None), ...); the value
    mask excludes null VALUES while the row keeps its key run.
    Returns (gkeys by run, gvalid, partial arrays by run, n_unique)."""
    L = keys[0].shape[0]
    dev = keys[0].device
    combined = _combined_local_key(keys, valid)
    rows_ok = valid & (combined >= 0)
    # sum/count values + masks ride the encode sort as payload lanes
    payloads = []
    plan = []
    for v, agg, vmask in specs:
        vi = mi = None
        if agg in ("sum", "count"):
            vi = len(payloads)
            payloads.append(v if v.dtype.is_floating_point
                            else v.to(torch.int64))
            if vmask is not None:
                mi = len(payloads)
                payloads.append(vmask)
        plan.append((vi, mi))
    enc, spay = hashing.encode_sorted_with(
        combined, dt.int64, bitmap.pack_mask(rows_ok), L, tuple(payloads))
    (first_by_run,) = groupagg.compact_runs(enc.start, (enc.sidx,))
    first_by_run = first_by_run.clamp(0, L - 1)
    gkeys = tuple(k.index_select(0, first_by_run) for k in keys)
    gvalid = torch.arange(L, device=dev) < enc.n_unique
    # the min/max sort's key: the encode's runs in its order, invalid
    # rows last (the JAX package's flag operand)
    mm_key = torch.where(rows_ok, combined, INT64_MAX)
    parts = []
    for (v, agg, vmask), (vi, mi) in zip(specs, plan):
        if agg in ("sum", "count"):
            s, c = groupagg.segment_sum_count(
                enc, v, None, values_sorted=spay[vi],
                valid_sorted=None if mi is None else spay[mi])
            parts.append(c if agg == "count" else s)
        elif agg in ("min", "max"):
            vkey = sortable(_orderable_bits(v, _dt_of(v)))
            parts.append(groupagg.segment_min_max(mm_key, v, vkey, vmask,
                                                  agg))
        else:
            raise ValueError(agg)
    return gkeys, gvalid, tuple(parts), enc.n_unique


def _expand_aggs(agg_specs):
    """Every agg expands to partials that carry enough state to merge AND
    to decide output validity (an all-null group emits null):
    sum/min/max/mean ship a valid-value COUNT partial alongside.
    Returns (partial specs, finishers); finisher = (agg, n consumed)."""
    partials = []        # (val_idx, partial_agg)
    finishers = []       # (final_agg, consumed)
    for vi, agg in agg_specs:
        if agg in ("mean", "sum"):
            partials += [(vi, "sum"), (vi, "count")]
            finishers.append((agg, 2))
        elif agg in ("min", "max"):
            partials += [(vi, agg), (vi, "count")]
            finishers.append((agg, 2))
        elif agg == "count":
            partials.append((vi, "count"))
            finishers.append((agg, 1))
        else:
            raise ValueError(agg)
    return tuple(partials), tuple(finishers)


def make_distributed_group_by(mesh: Mesh, cap: int, n_keys: int,
                              agg_specs: Tuple[Tuple[int, str], ...],
                              n_vals: int):
    """Distributed GROUP BY over multi-column keys.

    agg_specs: ((val_index, 'sum'|'count'|'min'|'max'|'mean'), ...).
    Per-rank inputs: *keys, *vals, valid, *val_valids (one bool mask per
    value column: null VALUES are excluded from sum/min/max/mean and not
    counted by count).
    Per-rank outputs: key columns (group reps, key order), final agg
    columns, per-agg validity masks (False = all-null group), n_groups[1],
    overflow flag (the same on every rank)."""
    partial_specs, finishers = _expand_aggs(tuple(agg_specs))
    # each distinct partial is computed and shipped once (the JAX package
    # repeats, e.g., the count partial that several aggs share)
    uniq = tuple(dict.fromkeys(partial_specs))
    at = [uniq.index(p) for p in partial_specs]
    body = shuf.shuffle_shard_fn(mesh, cap)

    def step(*args):
        keys = args[:n_keys]
        vals = args[n_keys:n_keys + n_vals]
        valid = args[n_keys + n_vals]
        vvalids = args[n_keys + n_vals + 1: n_keys + 2 * n_vals + 1]

        # 1. local pre-aggregation: one partial row per local group
        specs1 = tuple((vals[vi], pa, vvalids[vi] & valid)
                       for vi, pa in uniq)
        gkeys, gvalid, parts, _ = _segment_group(keys, valid, specs1)

        # 2. shuffle PARTIALS by key hash (volume = local groups)
        dest = shuf.partition_of(_hash_multi(gkeys), mesh.world_size)
        received, counts, overflow = body(dest, gvalid, *(gkeys + parts))
        rkeys = received[:n_keys]
        rparts = received[n_keys:]
        rvalid = shuf.row_validity_mask(rkeys[0], counts, cap)

        # 3. final merge: re-encode the received keys, merge partials. A
        # min/max partial of a group with no valid value is garbage: its
        # value's count partial masks it.
        specs2 = []
        for (vi, pa), rp in zip(uniq, rparts):
            vmask2 = (rparts[uniq.index((vi, "count"))] > 0) & rvalid \
                if pa in ("min", "max") else None
            specs2.append((rp, _MERGE[pa], vmask2))
        out_keys, _, by_uniq, n_unique2 = _segment_group(
            rkeys, rvalid, tuple(specs2))
        merged = [by_uniq[j] for j in at]
        outs, valids = [], []
        i = 0
        for agg, consumed in finishers:
            if agg == "mean":
                s, c = merged[i], merged[i + 1]
                outs.append(s.to(torch.float64)
                            / torch.clamp(c, min=1).to(torch.float64))
                valids.append(c > 0)
            elif agg in ("sum", "min", "max"):
                outs.append(merged[i])
                valids.append(merged[i + 1] > 0)
            else:                       # count: always valid
                outs.append(merged[i])
                valids.append(torch.ones(merged[i].shape[0],
                                          dtype=torch.bool,
                                          device=merged[i].device))
            i += consumed
        return (out_keys, tuple(outs), tuple(valids), n_unique2.reshape(1),
                overflow)

    return step


# ---------------------------------------------------------------------------
# distributed join: multi-key, multi-payload, join types, hot keys
# ---------------------------------------------------------------------------

def _local_pairs(lcodes, lvalid, rcodes, rvalid, cap_out: int, how: str):
    """Local sort-merge join of two code columns (parallel/join.py)."""
    if how in ("left semi", "left anti"):
        return pjoin.local_join_semi(lcodes, lvalid, rcodes, rvalid, how)
    return pjoin.local_join_inner(lcodes, lvalid, rcodes, rvalid, cap_out,
                                  how=how)


def _top_k(cnt: torch.Tensor, K: int):
    """(values, indices) of the K largest counts, ties to the lower
    index (jax.lax.top_k's order)."""
    order = torch.sort(cnt, descending=True, stable=True).indices[:K]
    return cnt.index_select(0, order), order


def _hot_key_list(mesh: Mesh, keys: Tuple[torch.Tensor, ...], valid,
                  K: int, thresh: int):
    """Per-rank top-K hot detection + all_gather union: a sorted [D*K]
    int64 list of the combined key hashes of hot keys (BIG marks unused
    slots). A hash collision only costs an unneeded broadcast, never a
    wrong result (the join codes re-check equality)."""
    h = torch.where(valid, _hash_multi(keys), -1)
    L = h.shape[0]
    res = hashing.encode_codes(h, dt.int64, bitmap.pack_mask(valid), L,
                               order="key")
    cnt = torch.zeros(L + 1, dtype=torch.int32, device=h.device)
    cnt.index_add_(0, torch.where(res.codes >= 0, res.codes, L),
                   torch.ones(L, dtype=torch.int32, device=h.device))
    topv, topi = _top_k(cnt[:L], K)
    first = res.first_index.clamp(0, L - 1)
    cand = h.index_select(0, first.index_select(0, topi))
    cand = torch.where(topv > thresh, cand, BIG)
    return torch.sort(all_gather(mesh, cand)).values


def _in_sorted(sorted_list: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    pos = torch.searchsorted(sorted_list, x)
    return sorted_list.index_select(
        0, pos.clamp(0, sorted_list.shape[0] - 1)) == x


def _gather_cols(cols, idx):
    """Each column at idx; 0 (False) where idx < 0."""
    out = []
    for c in cols:
        g = c.index_select(0, idx.clamp(0, c.shape[0] - 1))
        out.append(torch.where(idx >= 0, g, torch.zeros(
            (), dtype=c.dtype, device=c.device)))
    return tuple(out)


def _ranked(cols, rperm):
    """Right-side columns permuted into key-sorted rank order."""
    return tuple(c.index_select(0, rperm.clamp(0, c.shape[0] - 1))
                 for c in cols)


def _append_unmatched(outs, srcs, un, base, cap_buf: int):
    """Append the rows where `un` (values from srcs columns; None = zero
    fill) into outs at offset base. Returns (outs, count, overflow)."""
    k = torch.cumsum(un.to(torch.int64), 0) - 1
    n_add = un.sum()
    tgt = torch.where(un & (base + k < cap_buf), base + k, cap_buf)
    new = []
    for arr, src in zip(outs, srcs):
        if src is None:
            src = torch.zeros(un.shape[0], dtype=arr.dtype, device=arr.device)
        pad = torch.cat([arr, arr.new_zeros(1)])
        pad[tgt] = src.to(arr.dtype)
        new.append(pad[:cap_buf])
    return tuple(new), base + n_add, (base + n_add) > cap_buf


def make_distributed_join(mesh: Mesh, cap_shuffle: int, cap_out: int,
                          n_keys: int = 1, n_lpay: int = 1, n_rpay: int = 1,
                          how: str = "inner", hot_k: int = 0,
                          hot_thresh: int = 0, cap_hot: int = 0,
                          cap_hot_out: int = 0):
    """Distributed join over multi-column keys with payloads.

    how: 'inner' | 'left outer' | 'right outer' | 'full outer' |
    'left semi' | 'left anti'. Semi/anti take ONE extra trailing input
    `lnull` (bool): True marks REAL left rows whose key is null
    (excluded from lvalid); 'left anti' ORs them into the verdict (SQL
    semantics); pass zeros when keys have no nulls.
    hot_k > 0 turns on skew handling with two per-rank top-hot_k lists
    (count > hot_thresh):
    - PROBE-hot keys (path A): their build rows broadcast to every rank,
      their probe rows never move. For right/full outer a broadcast
      build row's matched flags union over the ranks and only its ORIGIN
      rank emits it unmatched.
    - BUILD-hot keys (path B, inner/left outer/semi/anti): their build
      rows are SALTED round-robin over the ranks through the normal
      exchange and their probe rows broadcast. Unmatched broadcast
      probe rows (left outer) emit once at their origin rank.
    Capacities: cap_hot broadcast rows per rank, cap_hot_out output pairs
    per rank per path.

    Per-rank inputs: *lkeys, *lpays, lvalid, *rkeys, *rpays, rvalid
    (+ lnull for semi/anti).
    Per-rank outputs: key cols + left payloads + right payloads of the
    pairs (slots >= n_out padded 0), rmatch, n_out[1], overflow; for
    semi/anti (verdict over the left rows, overflow). With hot_k the
    tuple carries THREE (keys, lp, rp, rmatch, n) groups: exchanged,
    path A, path B."""
    D = mesh.world_size
    me = mesh.rank
    nl = n_keys + n_lpay
    semi = how in ("left semi", "left anti")
    # build-side salting applies where probe-row replication is an exact
    # decomposition; right/full outer take the probe-hot path only
    salt_b = bool(hot_k) and how in ("inner", "left outer", "left semi",
                                     "left anti")
    body = shuf.shuffle_shard_fn(mesh, cap_shuffle)

    def broadcast_hot(cols_in, hot, n_first):
        """Compact local hot rows to [cap_hot], all_gather them in BLOCK
        layout (slot d*cap_hot+i came from rank d). Returns (first
        n_first cols, the other cols, rows mask, local compact position
        per row, overflow)."""
        pos = torch.cumsum(hot.to(torch.int64), 0) - 1
        nhot = hot.sum()
        tgt = torch.where(hot & (pos < cap_hot), pos, cap_hot)
        gathered = []
        for c in cols_in:
            buf = torch.zeros(cap_hot + 1, dtype=c.dtype, device=c.device)
            buf[tgt] = c
            gathered.append(all_gather(mesh, buf[:cap_hot]))
        ns = all_gather(mesh, torch.clamp(nhot, max=cap_hot).reshape(1))
        rows = shuf.row_validity_mask(gathered[0], ns, cap_hot)
        return (tuple(gathered[:n_first]), tuple(gathered[n_first:]), rows,
                pos, all_max(mesh, nhot > cap_hot))

    def matched_everywhere(idx, perm, HB):
        """Per-broadcast-slot matched flags unioned over the ranks: idx
        are join ranks, perm maps rank -> broadcast slot."""
        slots = torch.where(idx >= 0, perm.index_select(
            0, idx.clamp(0, HB - 1)), HB)
        m = torch.zeros(HB + 1, dtype=torch.bool, device=idx.device)
        m[slots] = True
        return all_max(mesh, m[:HB])

    def mine(flags, pos, hot):
        """The origin rank's own rows of a [D*cap_hot] broadcast flag."""
        myslot = me * cap_hot + pos.clamp(0, cap_hot - 1)
        return flags.index_select(0, myslot) & hot & (pos < cap_hot)

    def codes_of(a_keys, a_rows, b_keys, b_rows):
        """Codes of two key tuples in ONE code space (exact equality)."""
        n = a_keys[0].shape[0]
        both = tuple(torch.cat([a, b]) for a, b in zip(a_keys, b_keys))
        res = _local_codes(both, torch.cat([a_rows, b_rows]))
        return res.codes[:n], res.codes[n:]

    def hot_semi(lkeys, lhot, rkeys, rpays, rhot):
        hk, _, hrows, _, hovf = broadcast_hot(rkeys + rpays, rhot, n_keys)
        lc, rc = codes_of(lkeys, lhot, hk, hrows)
        return _local_pairs(lc, lhot, rc, hrows, 1, how), hovf

    def hot_semi_salted(lhotB, lpos, hkeys_l, hrows_l, srk, rrows):
        """Verdict of broadcast PROBE rows against each rank's received
        (salted) build rows, unioned over the ranks; the origin rank
        reads back its own rows."""
        lc, rc = codes_of(hkeys_l, hrows_l, srk, rrows)
        verd = _local_pairs(lc, hrows_l, rc, rrows, 1, "left semi")
        got = mine(all_max(mesh, verd), lpos, lhotB)
        return ~got & lhotB if how == "left anti" else got

    def step(*args):
        lkeys = args[:n_keys]
        lpays = args[n_keys:nl]
        lvalid = args[nl]
        rkeys = args[nl + 1: nl + 1 + n_keys]
        rpays = args[nl + 1 + n_keys: nl + 1 + n_keys + n_rpay]
        rvalid = args[nl + 1 + n_keys + n_rpay]
        lnull = args[nl + 2 + n_keys + n_rpay] if semi else None

        lv, rv = lvalid, rvalid
        rv_ex = rvalid
        if hot_k:
            # keys hot by PROBE counts: path A; keys hot by BUILD counts:
            # path B. A key hot on both sides takes the salt path.
            lhash = _hash_multi(lkeys)
            rhash = _hash_multi(rkeys)
            hotP = _hot_key_list(mesh, lkeys, lvalid, hot_k, hot_thresh)
            if salt_b:
                hotB = _hot_key_list(mesh, rkeys, rvalid, hot_k, hot_thresh)
                lhotB = _in_sorted(hotB, lhash) & lvalid
                rhotB = _in_sorted(hotB, rhash) & rvalid
            else:
                lhotB = torch.zeros_like(lvalid)
                rhotB = torch.zeros_like(rvalid)
            lhot = _in_sorted(hotP, lhash) & lvalid & ~lhotB
            rhot = _in_sorted(hotP, rhash) & rvalid & ~rhotB
            lv = lvalid & ~lhot & ~lhotB
            rv = rvalid & ~rhot & ~rhotB
            rv_ex = rv | rhotB          # salted rows ride the exchange

        # normal path: hash exchange of the non-hot rows (+ salted hot
        # build rows at round-robin destinations)
        ldest = shuf.partition_of(_hash_multi(lkeys), D)
        lrecv, lcounts, lov = body(ldest, lv, *(lkeys + lpays))
        rdest = shuf.partition_of(_hash_multi(rkeys), D)
        if hot_k and salt_b:
            iota_r = torch.arange(rkeys[0].shape[0], device=rdest.device)
            rdest = torch.where(rhotB, (iota_r % D).to(torch.int32), rdest)
        rrecv, rcounts, rov = body(rdest, rv_ex, *(rkeys + rpays))
        slk, slp = lrecv[:n_keys], lrecv[n_keys:]
        srk, srp = rrecv[:n_keys], rrecv[n_keys:]
        lrows = shuf.row_validity_mask(slk[0], lcounts, cap_shuffle)
        rrows = shuf.row_validity_mask(srk[0], rcounts, cap_shuffle)
        lcodes, rcodes = codes_of(slk, lrows, srk, rrows)

        if semi:
            # match where the left rows landed, then send the verdicts
            # back by the reverse all_to_all and read each row's slot
            m = _local_pairs(lcodes, lrows, rcodes, rrows, 1, how)
            back = all_to_all(mesh, m)
            dest_l, slot, _ = shuf.send_slots(ldest, lv, D)
            flat = dest_l.clamp(0, D - 1) * cap_shuffle + \
                slot.clamp(0, cap_shuffle - 1)
            verdict = back.index_select(0, flat) & lv
            sem_ov = lov | rov
            if hot_k:
                # probe-hot left rows never moved: their verdict comes
                # from the broadcast build side
                hverd, hovf = hot_semi(lkeys, lhot, rkeys, rpays, rhot)
                verdict = torch.where(lhot, hverd, verdict)
                # build-hot (salted) left rows broadcast
                hkl, _, hrows_l, lpos, bovf = broadcast_hot(lkeys, lhotB,
                                                            n_keys)
                verdict = torch.where(lhotB, hot_semi_salted(
                    lhotB, lpos, hkl, hrows_l, srk, rrows), verdict)
                # a hot row past cap_hot never broadcast: surface it
                sem_ov = sem_ov | hovf | bovf
            if how == "left anti":
                # null-key left rows match nothing (SQL semantics)
                verdict = verdict | lnull
            return verdict, all_max(mesh, sem_ov)

        li, ri, rperm, n_out, jov = _local_pairs(lcodes, lrows, rcodes,
                                                 rrows, cap_out, how)
        out_keys = _gather_cols(slk, li)
        out_lp = _gather_cols(slp, li)
        # ri is a key-sorted right RANK: permute payloads once by rperm
        out_rp = _gather_cols(_ranked(srp, rperm), ri)
        if how in ("right outer", "full outer"):
            # unmatched-RIGHT rows (li=-1) carry their key from the right
            rkeys_out = _gather_cols(_ranked(srk, rperm), ri)
            out_keys = tuple(torch.where(li >= 0, a, b)
                             for a, b in zip(out_keys, rkeys_out))
        rmatch = (li >= 0) & (ri >= 0)
        overflow = lov | rov | jov

        if not hot_k:
            return (out_keys, out_lp, out_rp, rmatch, n_out.reshape(1),
                    all_max(mesh, overflow))

        # ---- path A: probe-hot keys: broadcast the hot build rows and
        # join them against the LOCAL hot probe rows (they never moved)
        hk, hp, hrows, rpos, hbov = broadcast_hot(rkeys + rpays, rhot,
                                                  n_keys)
        lc, rc = codes_of(lkeys, lhot, hk, hrows)
        how_h = "left outer" if how in ("left outer", "full outer") \
            else "inner"
        hli, hri, hrperm, hn, hovf = _local_pairs(lc, lhot, rc, hrows,
                                                  cap_hot_out, how_h)
        hout_keys = _gather_cols(lkeys, hli)
        hout_lp = _gather_cols(lpays, hli)
        hout_rp = _gather_cols(_ranked(hp, hrperm), hri)
        hrmatch = (hli >= 0) & (hri >= 0)
        overflow = overflow | hovf | hbov
        if how in ("right outer", "full outer"):
            # a broadcast build row is on EVERY rank: union its matched
            # flags, then only its ORIGIN rank emits it unmatched
            matched_b = matched_everywhere(hri, hrperm, hk[0].shape[0])
            un_r = mine(~matched_b, rpos, rhot)
            outs = hout_keys + hout_lp + hout_rp + (hrmatch,)
            srcs = rkeys + (None,) * n_lpay + rpays + (None,)
            outs, hn, ovf2 = _append_unmatched(outs, srcs, un_r, hn,
                                               cap_hot_out)
            hout_keys = outs[:n_keys]
            hout_lp = outs[n_keys:n_keys + n_lpay]
            hout_rp = outs[n_keys + n_lpay:n_keys + n_lpay + n_rpay]
            hrmatch = outs[-1]
            overflow = overflow | ovf2

        # ---- path B: build-hot keys: the build rows were SALTED through
        # the exchange; their probe rows broadcast and join each rank's
        # received build rows. Each build row lives on ONE rank, so every
        # pair is emitted once.
        hkl, hpl, hrows_l, lpos, bbov = broadcast_hot(lkeys + lpays, lhotB,
                                                      n_keys)
        HBl = hkl[0].shape[0]
        lc, rc = codes_of(hkl, hrows_l, srk, rrows)
        bli, bri, brperm, bn, bovf = _local_pairs(lc, hrows_l, rc, rrows,
                                                  cap_hot_out, "inner")
        bout_keys = _gather_cols(hkl, bli)
        bout_lp = _gather_cols(hpl, bli)
        bout_rp = _gather_cols(_ranked(srp, brperm), bri)
        brmatch = (bli >= 0) & (bri >= 0)
        overflow = overflow | bovf | bbov
        if how in ("left outer", "full outer"):
            # unmatched broadcast probe rows emit once, at their origin
            matched_l = matched_everywhere(
                torch.where(bli >= 0, bli, -1),
                torch.arange(HBl, device=bli.device), HBl)
            un_l = mine(~matched_l, lpos, lhotB)
            outs = bout_keys + bout_lp + bout_rp + (brmatch,)
            srcs = lkeys + lpays + (None,) * n_rpay + (None,)
            outs, bn, ovf3 = _append_unmatched(outs, srcs, un_l, bn,
                                               cap_hot_out)
            bout_keys = outs[:n_keys]
            bout_lp = outs[n_keys:n_keys + n_lpay]
            bout_rp = outs[n_keys + n_lpay:n_keys + n_lpay + n_rpay]
            brmatch = outs[-1]
            overflow = overflow | ovf3

        return (out_keys, out_lp, out_rp, rmatch, n_out.reshape(1),
                hout_keys, hout_lp, hout_rp, hrmatch, hn.reshape(1),
                bout_keys, bout_lp, bout_rp, brmatch, bn.reshape(1),
                all_max(mesh, overflow))

    return step


# ---------------------------------------------------------------------------
# distributed multi-key sort
# ---------------------------------------------------------------------------

def make_distributed_sort_multi(mesh: Mesh, cap: int, n_keys: int,
                                n_payload: int = 0, n_samples: int = 64,
                                descending: Tuple[bool, ...] = ()):
    """Range-partition on the primary key (equal primaries land on one
    rank), exchange all key + payload columns, local multi-key sort
    (ops/sort.argsort_multi). Reading the ranks in order yields the
    global multi-key order.

    Per-rank inputs: *keys, valid, *payload.
    Per-rank outputs: (sorted keys, payload, counts[1], overflow)."""
    desc = tuple(descending) + (False,) * (n_keys - len(descending))

    def body(*args):
        keys = args[:n_keys]
        valid = args[n_keys]
        payload = args[n_keys + 1:]
        k0 = keys[0]
        kprim = order_key(torch.where(valid, k0, _sentinel_for(k0.dtype)).to(
            k0.dtype))
        # samples of the VALID prefix only: a mostly-padding rank must not
        # skew the splitters toward the sentinel
        splitters = splitters_of(mesh, kprim, valid.sum(), n_samples)
        dest = torch.searchsorted(splitters, kprim, right=True).to(
            torch.int32)
        received, recv_counts, overflow = _exchange(
            mesh, dest, valid, cap, tuple(keys) + tuple(payload))
        rmask = shuf.row_validity_mask(received[0], recv_counts, cap)
        rkeys = received[:n_keys]
        words = bitmap.pack_mask(rmask)
        # padding slots sort to the tail by their validity flag (the
        # exchange already dropped the real nulls)
        ops = [sort_ops.sort_key(rk, _dt_of(rk), words, rk.shape[0],
                                 descending=desc[i])
               for i, rk in enumerate(rkeys)]
        perm = sort_ops.argsort_multi(ops)
        n_local = recv_counts.sum().to(torch.int32)
        return (tuple(rk.index_select(0, perm) for rk in rkeys),
                tuple(rp.index_select(0, perm) for rp in received[n_keys:]),
                n_local.reshape(1), overflow)

    return body
