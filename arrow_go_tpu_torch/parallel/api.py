"""Table-level entry points for the distributed tier.

Port of arrow_go_tpu/parallel/api.py. The builders in parallel/dist.py
speak per-rank tensors; these wrappers speak the port's data model: a
HostBatch in, a HostBatch out. Every rank is handed the whole HostBatch
(as every JAX process holds the whole array in multiproc.global_put)
and takes its row block [rank*P/D, (rank+1)*P/D) of the batch padded
to P = ceil(max(n, 1) / (128*D)) * 128*D rows, the JAX package's
padding. String keys ride as their dictionary codes and are decoded on
the way out. Each rank returns the whole result, gathered in rank
order, so at the same D the result equals the JAX API's RecordBatch.

Counts and overflow flags are read on the host here, and only here.
Columns of the tier are flat: a uint16 or uint32 column rides widened
to int64 (exact for its hash, order and equality), a uint64 column as
its int64 bits, which only a payload may be (its order as a key is not
the signed one).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..array.record import host_batch
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import (DeviceBatch, HostArray, HostBatch,
                            concat_host_arrays, device_batch_to_host)
from . import dist
from .mesh import Mesh, all_gather, make_mesh


def _as_batch(data) -> HostBatch:
    """A DeviceBatch's rows on the host, a Table's chunks combined
    (array/record.host_batch), a HostBatch as it is."""
    data = host_batch(data)
    if isinstance(data, DeviceBatch):
        return device_batch_to_host(data)
    if not isinstance(data, HostBatch):
        raise TypeError(f"expected a HostBatch, got {type(data).__name__}")
    return data


def _tier_values(c: HostArray, name: str, key: bool) -> np.ndarray:
    """A column's values as the tier carries them (see the module doc)."""
    if c.dict_values is not None:
        return np.asarray(c.values, np.int32)
    t = c.type
    if t.limbs or c.values.ndim != 1:
        raise ArrowNotImplemented(
            f"distributed ops need flat columns ({name})")
    if t.id in (dt.TypeId.UINT16, dt.TypeId.UINT32):
        return c.values.astype(np.int64)
    if t.id == dt.TypeId.UINT64:
        if key:
            raise ArrowNotImplemented(
                f"distributed ops take no uint64 key ({name})")
        return c.values.view(np.int64)
    return c.values


def _shard_columns(hb: HostBatch, names: Sequence[str], mesh: Mesh,
                   key: bool = False):
    """This rank's row block of each named column on the mesh device.
    Returns (values, per-column valid masks, combined valid mask,
    HostArrays for decode, n_rows)."""
    D = mesh.world_size
    n = hb.num_rows
    P = -(-max(n, 1) // (128 * D)) * (128 * D)
    per = P // D
    lo = mesh.rank * per
    k = max(min(n - lo, per), 0)              # real rows in the block
    dev = mesh.device
    arrays, masks, cols = [], [], []
    valid = None
    in_block = torch.arange(per, device=dev) < k
    for nm in names:
        c = hb.column(nm)
        # the block's real rows copy straight into the zero-padded tensor
        vals = _tier_values(c, nm, key)
        t = torch.zeros(per, dtype=torch.from_numpy(vals[:0]).dtype,
                        device=dev)
        t[:k] = torch.from_numpy(np.ascontiguousarray(vals[lo:lo + k]))
        arrays.append(t)
        if c.mask is None:
            mt = in_block
        else:
            mt = torch.zeros(per, dtype=torch.bool, device=dev)
            mt[:k] = torch.from_numpy(np.ascontiguousarray(
                c.mask[lo:lo + k]))
        masks.append(mt)
        valid = mt if valid is None else valid & mt
        cols.append(c)
    if valid is None:
        valid = in_block
    return arrays, masks, valid, cols, n


def _collect(mesh: Mesh, cols, count: torch.Tensor) -> List[np.ndarray]:
    """Each rank's [0, count) prefix of each column, gathered in rank
    order onto every rank's host."""
    counts = all_gather(mesh, count.to(torch.int64).reshape(1)).cpu().numpy()
    M = int(counts.max())
    if M == 0:
        return [np.zeros(0, torch.empty(0, dtype=c.dtype).numpy().dtype)
                for c in cols]
    out = []
    for c in cols:
        g = all_gather(mesh, c[:M].contiguous()).cpu().numpy()
        out.append(np.concatenate([g[d * M:d * M + int(counts[d])]
                                   for d in range(mesh.world_size)]))
    return out


def _decode_key(vals: np.ndarray, col: HostArray,
                mask: Optional[np.ndarray] = None) -> HostArray:
    """Values back to a HostArray of the column's type; mask (True =
    valid) restores the nulls that rode the exchange as a bool column."""
    if col.dict_values is not None:
        codes = np.clip(vals.astype(np.int64), 0,
                        max(len(col.dict_values) - 1, 0)).astype(np.int32)
        return HostArray(codes, mask, col.type, col.dict_values)
    return HostArray(vals.astype(col.type.np_dtype, copy=False), mask,
                     col.type)


def _batch(names, cols) -> HostBatch:
    n = len(cols[0]) if cols else 0
    return HostBatch(dt.Schema([dt.Field(nm, c.type)
                                for nm, c in zip(names, cols)]), cols, n)


def distributed_group_by(data, keys, aggregations: Sequence[Tuple[str, str]],
                         mesh: Optional[Mesh] = None,
                         cap: Optional[int] = None,
                         device=None) -> HostBatch:
    """GROUP BY across the mesh (pre-aggregating, skew-proof). Output
    columns: keys then '<col>_<agg>', agg one of sum, count, min, max,
    mean; groups in rank order, each rank's in key order. Null-key rows
    are dropped."""
    hb = _as_batch(data)
    if isinstance(keys, str):
        keys = [keys]
    mesh = mesh or make_mesh(device)
    val_names: List[str] = []
    agg_specs = []
    for cname, agg in aggregations:
        if cname not in val_names:
            val_names.append(cname)
        agg_specs.append((val_names.index(cname), agg))
    key_arrays, _, valid, key_cols, _ = _shard_columns(hb, keys, mesh,
                                                       key=True)
    val_arrays, val_masks, _, val_cols, _ = _shard_columns(hb, val_names,
                                                           mesh)
    if cap is None:
        cap = max(128, key_arrays[0].shape[0])
    fn = dist.make_distributed_group_by(mesh, cap, len(keys),
                                        tuple(agg_specs), len(val_names))
    keys_out, aggs_out, valids_out, ngroups, overflow = fn(
        *key_arrays, *val_arrays, valid, *val_masks)
    if bool(overflow):
        raise ArrowInvalid("distributed group_by capacity overflow; "
                           "raise cap")
    got = _collect(mesh, list(keys_out) + list(aggs_out) + list(valids_out),
                   ngroups)
    nk, na = len(keys), len(aggregations)
    cols = [_decode_key(v, kc) for v, kc in zip(got[:nk], key_cols)]
    names = list(keys)
    for (cname, agg), (vi, _), vals, mask in zip(
            aggregations, agg_specs, got[nk:nk + na], got[nk + na:]):
        c = val_cols[vi]
        if agg in ("min", "max") and c.dict_values is None:
            vals = vals.astype(c.type.np_dtype)
        elif agg == "sum" and c.type.is_unsigned_integer:
            vals = vals.view(np.uint64)
        cols.append(HostArray(vals, None if mask.all() else mask,
                              dt.from_numpy_dtype(vals.dtype)))
        names.append(f"{cname}_{agg}")
    return _batch(names, cols)


def distributed_hash_join(left, right, keys, mesh: Optional[Mesh] = None,
                          cap_shuffle: Optional[int] = None,
                          cap_out: Optional[int] = None,
                          hot_k: int = 0, hot_thresh: int = 0,
                          left_suffix: str = "",
                          right_suffix: str = "_right",
                          device=None) -> HostBatch:
    """Inner join across the mesh (multi-column keys; hot_k > 0 turns on
    the hot-key paths for Zipf-skewed keys)."""
    lhb, rhb = _as_batch(left), _as_batch(right)
    if isinstance(keys, str):
        keys = [keys]
    mesh = mesh or make_mesh(device)
    D = mesh.world_size
    lpay = [f.name for f in lhb.schema.fields if f.name not in keys]
    rpay = [f.name for f in rhb.schema.fields if f.name not in keys]

    lk, _, lvalid, lk_cols, _ = _shard_columns(lhb, keys, mesh, key=True)
    lp, lp_masks, _, lp_cols, _ = _shard_columns(lhb, lpay, mesh)
    rk, _, rvalid, rk_cols, _ = _shard_columns(rhb, keys, mesh, key=True)
    rp, rp_masks, _, rp_cols, _ = _shard_columns(rhb, rpay, mesh)
    # nullable payloads: each payload's validity rides the exchange as an
    # extra bool payload column and is rebuilt into nulls below
    lp = lp + lp_masks
    rp = rp + rp_masks
    # string keys must share ONE code space across both sides
    for nm, lc, rc in zip(keys, lk_cols, rk_cols):
        if (lc.dict_values is None) != (rc.dict_values is None):
            raise ArrowInvalid(f"join key {nm}: both sides must be "
                               "strings or both numeric")
        if lc.dict_values is not None and \
                list(lc.dict_values) != list(rc.dict_values):
            raise ArrowNotImplemented(
                f"join key {nm}: dictionary code spaces differ; "
                "unify dictionaries before a distributed join")
    P = lk[0].shape[0] * D                    # the padded global rows
    if cap_shuffle is None:
        cap_shuffle = max(256, P // D)
    if cap_out is None:
        # per-rank pair capacity: 8x the GLOBAL row count by default
        # (overflow raises rather than truncating)
        cap_out = 8 * P
    fn = dist.make_distributed_join(
        mesh, cap_shuffle, cap_out, n_keys=len(keys),
        n_lpay=len(lp), n_rpay=len(rp), hot_k=hot_k,
        hot_thresh=hot_thresh,
        cap_hot=max(cap_shuffle // 4, 64) if hot_k else 0,
        cap_hot_out=cap_out if hot_k else 0)
    out = fn(*lk, *lp, lvalid, *rk, *rp, rvalid)
    if bool(out[-1]):
        raise ArrowInvalid("distributed join capacity overflow; raise caps")

    def collect(keys_o, lp_o, rp_o, counts):
        got = _collect(mesh, list(keys_o) + list(lp_o) + list(rp_o), counts)
        nk, nlp, nrp = len(keys), len(lpay), len(rpay)
        kg, lg, rg = got[:nk], got[nk:nk + 2 * nlp], got[nk + 2 * nlp:]
        cols = [_decode_key(v, kc) for v, kc in zip(kg, lk_cols)]
        names = list(keys)
        for i, (nm, pc_) in enumerate(zip(lpay, lp_cols)):
            mask = lg[nlp + i]
            cols.append(_decode_key(lg[i], pc_, None if mask.all() else mask))
            names.append(nm + left_suffix)
        for i, (nm, pc_) in enumerate(zip(rpay, rp_cols)):
            mask = rg[nrp + i]
            cols.append(_decode_key(rg[i], pc_, None if mask.all() else mask))
            names.append(nm + (right_suffix if nm + left_suffix in names
                               else ""))
        return cols, names

    if hot_k:
        (ok, olp, orp, _rm, n_out, hk, hlp, hrp, _hrm, hn,
         bk, blp, brp, _brm, bn, _ov) = out
        c1, names = collect(ok, olp, orp, n_out)
        c2, _ = collect(hk, hlp, hrp, hn)
        c3, _ = collect(bk, blp, brp, bn)
        return _batch(names, [concat_host_arrays([a, b, c])
                              for a, b, c in zip(c1, c2, c3)])
    ok, olp, orp, _rm, n_out, _ov = out
    cols, names = collect(ok, olp, orp, n_out)
    return _batch(names, cols)


def distributed_sort(data, keys, mesh: Optional[Mesh] = None,
                     cap: Optional[int] = None, descending=(),
                     device=None) -> HostBatch:
    """Multi-key sort across the mesh: range partition on the primary key
    + per-rank multi-key sort; reading the ranks in order is the global
    order. Null-key rows are dropped (the exchange contract)."""
    hb = _as_batch(data)
    if isinstance(keys, str):
        keys = [keys]
    mesh = mesh or make_mesh(device)
    pay = [f.name for f in hb.schema.fields if f.name not in keys]
    karrs, _, valid, kcols, _ = _shard_columns(hb, keys, mesh, key=True)
    parrs, pmasks, _, pcols, _ = _shard_columns(hb, pay, mesh)
    # nullable payloads: validity rides as extra bool payload columns
    parrs = parrs + pmasks
    if cap is None:
        cap = karrs[0].shape[0] * mesh.world_size   # all rows on one rank
    fn = dist.make_distributed_sort_multi(
        mesh, cap, n_keys=len(keys), n_payload=len(parrs),
        descending=tuple(descending))
    keys_out, pay_out, counts, overflow = fn(*karrs, valid, *parrs)
    if bool(overflow):
        raise ArrowInvalid("distributed sort capacity overflow; raise cap")
    got = _collect(mesh, list(keys_out) + list(pay_out), counts)
    nk, npay = len(keys), len(pay)
    cols = [_decode_key(v, kc) for v, kc in zip(got[:nk], kcols)]
    for i, pc_ in enumerate(pcols):
        mask = got[nk + npay + i]
        cols.append(_decode_key(got[nk + i], pc_,
                                None if mask.all() else mask))
    return _batch(list(keys) + pay, cols)
