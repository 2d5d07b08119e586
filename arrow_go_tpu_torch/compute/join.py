"""Hash join over DeviceBatches and HostBatches (single device).

Port of arrow_go_tpu/compute/join.py: both sides' keys are encoded into
ONE shared code space (a sort-based encode over the concatenated key
column; string keys first map their two dictionaries into one), then
the sort-merge core (parallel/join.py) counts the pairs; the host reads
that count once to size the output bucket (count-then-materialize), the
pair expansion runs at that capacity, and only the projected output
columns are gathered. Null keys never match (SQL semantics); an outer
join keeps its outer side's null-key rows, with a null opposite side.
Spans (utils/metrics.py): `hash_join` and its phases, `semi_verdict`;
every device->host read goes through `metrics.host_read`.

DeviceBatch inputs return a DeviceBatch (inner and the outer types).
HostBatch inputs (a RecordBatch or a Table among them: the JAX
package's RecordBatch path) return a RecordBatch for all eight types; a long probe side streams
through the join in chunks of `probe_chunk` rows where the join type
decomposes over probe rows. A carried nested column (a HostColumn, or
a nested column of a HostBatch) gathers on the host through the pair
indices (compute/nested_selection.py) on both routes, as the JAX
package's join does; a key column must be flat.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import dtypes as dt
from .. import torchenv
from ..array.record import RecordBatch, host_batch
from ..device.block import (DeviceBatch, DeviceColumn, HostArray, HostBatch,
                            HostColumn, concat_host_arrays,
                            device_batch_to_host, host_batch_to_device,
                            pad_length, row_mask)
from ..ops import bitmap, hashing, selection
from ..ops.compaction import compact_flagged
from ..parallel.join import join_expand, join_sorted_state, local_join_semi
from ..utils.metrics import metrics
from .errors import ArrowInvalid, ArrowNotImplemented
from .functions import shared_dict_codes
from .nested_selection import take_host_vec

_HOWS = ("inner", "left outer", "right outer", "full outer",
         "left semi", "left anti", "right semi", "right anti")
_DEVICE_HOWS = ("inner", "left outer", "right outer", "full outer")

#: probe rows per chunk when the probe side streams through the join
#: core: expansion buffers scale with the chunk, not the table
PROBE_CHUNK_DEFAULT = 1 << 23

#: join types where probe-side chunking is an exact decomposition (each
#: left row's output depends only on itself and the build side)
_CHUNKABLE = ("inner", "left outer", "left semi", "left anti")


def _key_codes(left: DeviceBatch, right: DeviceBatch,
               left_keys: Sequence[str], right_keys: Sequence[str]):
    """Shared-space dense codes for both sides (-1 = null/padding)."""
    PL = left.padded
    combined = None
    for lname, rname in zip(left_keys, right_keys):
        lc, rc = left.column(lname), right.column(rname)
        if lc.type.id == dt.TypeId.DICTIONARY or \
                rc.type.id == dt.TypeId.DICTIONARY:
            lv, rv, _ = shared_dict_codes(lc, rc, "join keys")
            t = dt.int32
        else:
            if lc.values.dtype != rc.values.dtype:
                raise ArrowInvalid(
                    f"join key dtype mismatch: {lc.type} vs {rc.type}")
            lv, rv, t = lc.values, rc.values, lc.type
        both = torch.cat([lv, rv])
        words = bitmap.pack_mask(torch.cat([lc.validity_mask(),
                                            rc.validity_mask()]))
        res = hashing.encode_codes(both, t, words, both.shape[0],
                                   order="key")
        part = torch.where(res.codes >= 0, res.codes, -1)
        if combined is None:
            combined = part
        else:
            card = res.n_unique + 1
            combined = torch.where((combined >= 0) & (part >= 0),
                                   combined * card + part, -1)
    return combined[:PL], combined[PL:]


def _key_lists(keys, left_keys, right_keys):
    if keys is not None:
        left_keys = right_keys = [keys] if isinstance(keys, str) else list(
            keys)
    if isinstance(left_keys, str):
        left_keys = [left_keys]
    if isinstance(right_keys, str):
        right_keys = [right_keys]
    return list(left_keys), list(right_keys)


def hash_join(left, right, keys=None, *, left_keys=None, right_keys=None,
              join_type: str = "inner", left_suffix: str = "",
              right_suffix: str = "_right",
              probe_chunk: Optional[int] = None,
              output_columns: Optional[Sequence[str]] = None, device=None):
    """Join two DeviceBatches or two HostBatches.

    DeviceBatch in (either side; a HostBatch beside it moves to its
    device): the joined columns stay on the device and a DeviceBatch
    returns; inner and outer types only. HostBatch in: a RecordBatch
    returns, as in the JAX package, for all eight types; the join runs on `device` (the card
    unless named). `output_columns` projects the output: only the named
    columns (post-suffix names) are gathered."""
    left, right = host_batch(left), host_batch(right)
    if join_type not in _HOWS:
        raise ArrowNotImplemented(f"join type {join_type!r}")
    left_keys, right_keys = _key_lists(keys, left_keys, right_keys)
    if isinstance(left, DeviceBatch) or isinstance(right, DeviceBatch):
        if join_type not in _DEVICE_HOWS:
            raise ArrowNotImplemented(
                "device-batch join supports inner/outer types")
        dev = (left if isinstance(left, DeviceBatch) else right
               ).device_columns[0].device

        def on_device(batch, keys):
            # a HostBatch's dictionary keys are renumbered as on the
            # HostBatch route, so the row order matches it
            return batch if isinstance(batch, DeviceBatch) else \
                host_batch_to_device(_renumber_keys(batch, keys), dev)
        with metrics.span("hash_join", rows=left.length if isinstance(
                left, DeviceBatch) else left.num_rows, device=dev):
            ldb, rdb = on_device(left, left_keys), on_device(right,
                                                             right_keys)
            return _join_device(ldb, rdb, left_keys, right_keys, join_type,
                                left_suffix, right_suffix, output_columns)
    if not (isinstance(left, HostBatch) and isinstance(right, HostBatch)):
        raise ArrowNotImplemented(
            "the port joins DeviceBatches or HostBatches")
    with metrics.span("hash_join", rows=left.num_rows,
                      device=torchenv.device(device)):
        return _join_host(left, right, left_keys, right_keys, join_type,
                          left_suffix, right_suffix, probe_chunk,
                          output_columns, device)


def _join_host(left, right, left_keys, right_keys, join_type, left_suffix,
               right_suffix, probe_chunk, output_columns, device):
    """The HostBatch route: a RecordBatch for all eight types, a long
    probe side in chunks where the join type decomposes over probe
    rows."""
    chunk = probe_chunk or PROBE_CHUNK_DEFAULT
    if left.num_rows > chunk and join_type in _CHUNKABLE:
        parts = [_join_host(left.slice(lo, chunk), right, left_keys,
                            right_keys, join_type, left_suffix, right_suffix,
                            chunk, output_columns, device)
                 for lo in range(0, left.num_rows, chunk)]
        return RecordBatch(parts[0].schema, [
            concat_host_arrays([p.columns[i] for p in parts])
            for i in range(len(parts[0].columns))],
            sum(p.num_rows for p in parts))
    ldb = host_batch_to_device(_renumber_keys(left, left_keys), device)
    rdb = host_batch_to_device(_renumber_keys(right, right_keys), device)
    if join_type in _DEVICE_HOWS:
        out = device_batch_to_host(_join_device(
            ldb, rdb, left_keys, right_keys, join_type, left_suffix,
            right_suffix, output_columns))
    else:
        verdict = semi_verdict(ldb, rdb, left_keys, right_keys, join_type)
        kept = right if join_type.startswith("right") else left
        out = _project(_select_left(kept, verdict), output_columns)
    return RecordBatch(out.schema, out.columns, out.num_rows)


def semi_verdict(ldb: DeviceBatch, rdb: DeviceBatch, left_keys: Sequence[str],
                 right_keys: Sequence[str], join_type: str) -> torch.Tensor:
    """The semi / anti verdict on the device: a bool tensor over the
    padded rows of the kept side (the left side for the left forms, the
    right side for the right forms, which are the left forms with the
    sides swapped), False on padding. A null key matches nothing, so an
    anti join keeps its row."""
    if join_type not in _HOWS[4:]:
        raise ArrowInvalid(f"not a semi or anti join: {join_type!r}")
    with metrics.span("semi_verdict",
                      device=ldb.column(left_keys[0]).values.device):
        lcodes, rcodes = _key_codes(ldb, rdb, left_keys, right_keys)
        if join_type.startswith("right"):
            ldb, rdb, lcodes, rcodes = rdb, ldb, rcodes, lcodes
        how = "left semi" if join_type.endswith("semi") else "left anti"
        in_l = row_mask(ldb.padded, ldb.length, lcodes.device)
        verdict = local_join_semi(lcodes, in_l & (lcodes >= 0), rcodes,
                                  row_mask(rdb.padded, rdb.length,
                                           rcodes.device)
                                  & (rcodes >= 0), how)
        if how == "left anti":
            verdict = verdict | ~(lcodes >= 0)
        return verdict & in_l


def _renumber_keys(batch: HostBatch, keys) -> HostBatch:
    """The batch with each dictionary key column's dictionary renumbered
    by first occurrence among its valid rows (unused values dropped), as
    the JAX package encodes a RecordBatch's strings: the shared key codes,
    and so the output's row order, then match it, chunk by chunk too."""
    cols = list(batch.columns)
    for name in keys:
        i = batch.schema.field_index(name)
        arr = cols[i]
        if arr.dict_values is None:
            continue
        valid = arr.validity_bools()
        uniq, first = np.unique(arr.values[valid], return_index=True)
        order = uniq[np.argsort(first, kind="stable")]
        remap = np.zeros(max(len(arr.dict_values), 1), np.int32)
        remap[order] = np.arange(len(order), dtype=np.int32)
        codes = np.where(valid, remap[np.clip(arr.values, 0,
                                              len(remap) - 1)], 0)
        cols[i] = HostArray(codes.astype(np.int32), arr.mask, arr.type,
                            arr.dict_values[order])
    return HostBatch(batch.schema, cols, batch.num_rows)


def _project(batch: HostBatch, cols) -> HostBatch:
    if cols is None:
        return batch
    want = set(cols)
    keep = [i for i, f in enumerate(batch.schema.fields) if f.name in want]
    return HostBatch(dt.Schema([batch.schema.fields[i] for i in keep]),
                     [batch.columns[i] for i in keep], batch.num_rows)


def _select_left(batch: HostBatch, mask: torch.Tensor) -> HostBatch:
    """The rows of `batch` where `mask` (over its padded rows) is set."""
    idx = np.flatnonzero(metrics.host_read(mask[:batch.num_rows],
                                           "semi_rows"))
    return HostBatch(batch.schema, [take_host_vec(c, idx)
                                    for c in batch.columns], len(idx))


def _join_device(ldb, rdb, left_keys, right_keys, join_type, left_suffix,
                 right_suffix, output_columns):
    """Two phases sharing the sorted state: phase 1 sorts and counts, the
    host reads `total` (and an outer join's null-key counts, in the same
    copy) to size the output bucket, phase 2 expands at that capacity.
    Spans: hash_join.key_codes, .sorted_state, .size_read, .expand and
    .emit (utils/metrics.py)."""
    dev = ldb.column(left_keys[0]).values.device
    with metrics.span("hash_join.key_codes", device=dev):
        lcodes, rcodes = _key_codes(ldb, rdb, left_keys, right_keys)
    PL, PR = ldb.padded, rdb.padded
    with metrics.span("hash_join.sorted_state", device=dev):
        in_l = row_mask(PL, ldb.length, dev)
        in_r = row_mask(PR, rdb.length, dev)
        st = join_sorted_state(lcodes, in_l & (lcodes >= 0), rcodes,
                               in_r & (rcodes >= 0), how=join_type)
        # outer joins also emit the NULL-KEY rows of their outer side:
        # they match nothing but stay in the output with a null opposite
        # side
        null_left = in_l & (lcodes < 0) if join_type in (
            "left outer", "full outer") else None
        null_right = in_r & (rcodes < 0) if join_type in (
            "right outer", "full outer") else None
        reads = [st.total] + [m.sum() for m in (null_left, null_right)
                              if m is not None]
    with metrics.span("hash_join.size_read", device=dev):
        # the single host read
        counts = list(map(int, metrics.host_read(torch.stack(reads),
                                                 "join_size")))
    total = counts[0]
    n_null_l = counts[1] if null_left is not None else 0
    n_null_r = counts[-1] if null_right is not None else 0
    out_n = total + n_null_l + n_null_r
    with metrics.span("hash_join.expand", device=dev):
        li, ri, _ = join_expand(st, pad_length(max(out_n, 1)))
        # ri arrives as key-sorted right RANKS: resolve them to right rows
        ri = torch.where(ri >= 0, selection.gather(st.rperm, ri), -1)
        for mask, n, idx, at in ((null_left, n_null_l, li, total),
                                 (null_right, n_null_r, ri,
                                  total + n_null_l)):
            if n:
                iota = torch.arange(mask.shape[0], dtype=torch.int64,
                                    device=dev)
                (rows,) = compact_flagged(mask, (iota,))
                idx[at:at + n] = rows[:n]
    with metrics.span("hash_join.emit", device=dev):
        return _emit_join_output(ldb, rdb, li, ri, out_n, left_keys,
                                 right_keys, join_type, left_suffix,
                                 right_suffix, output_columns)


def _gather_column(col, idx: torch.Tensor, out_n: int, trim_to: int,
                   host_idx: dict):
    """A column's output rows: a DeviceColumn gathers on its device, a
    HostColumn (a nested column) on the host through the pair indices
    read once a side (host_idx caches them), as the JAX package does."""
    if isinstance(col, HostColumn):
        key = id(idx)
        if key not in host_idx:
            host_idx[key] = metrics.host_read(
                idx[:out_n], "join_pairs").astype(np.int64)
        return HostColumn(take_host_vec(col.array, host_idx[key]))
    vals = selection.gather(col.values, idx)[:trim_to]
    words = selection.take_validity(col.validity, idx, out_n, idx.shape[0])
    return DeviceColumn(vals, words[:(trim_to + 31) // 32], out_n, col.type,
                        col.dict_values)


def _emit_join_output(ldb, rdb, li, ri, out_n, left_keys, right_keys,
                      join_type, left_suffix, right_suffix,
                      output_columns) -> DeviceBatch:
    """Gather the projected output columns through the pair indices (-1
    = a null row of that side). The right key columns are left out of
    an inner join only."""
    trim_to = min(pad_length(max(out_n, 1)), li.shape[0])
    want = None if output_columns is None else set(output_columns)
    # suffix decisions use the FULL (unprojected) left name set so a
    # column's output name does not depend on what else was projected
    full_left = {f.name + left_suffix for f in ldb.schema.fields}

    def right_name(f):
        return f.name + (right_suffix
                         if (f.name + left_suffix) in full_left else "")

    fields: List[dt.Field] = []
    cols: List[DeviceColumn] = []
    host_idx = {}
    for f, c in zip(ldb.schema.fields, ldb.columns):
        name = f.name + left_suffix
        if want is None or name in want:
            fields.append(f.with_name(name))
            cols.append(_gather_column(c, li, out_n, trim_to, host_idx))
    rkey_set, lkey_set = set(right_keys), set(left_keys)
    for f, c in zip(rdb.schema.fields, rdb.columns):
        if join_type == "inner" and f.name in rkey_set and \
                f.name in lkey_set:
            continue
        name = right_name(f)
        if want is None or name in want:
            fields.append(f.with_name(name))
            cols.append(_gather_column(c, ri, out_n, trim_to, host_idx))
    return DeviceBatch(dt.Schema(fields), cols, out_n)
