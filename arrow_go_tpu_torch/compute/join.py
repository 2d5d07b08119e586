"""Hash join over DeviceBatches (single device, inner).

Port of the DeviceBatch path of arrow_go_tpu/compute/join.py: both
sides' keys are encoded into ONE shared code space (a sort-based encode
over the concatenated key column), then the sort-merge core
(parallel/join.py) counts the pairs; the host reads that count once to
size the output bucket (count-then-materialize), the pair expansion
runs at that capacity, and only the projected output columns are
gathered. Null keys never match (SQL semantics).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import dtypes as dt
from ..device.block import DeviceBatch, DeviceColumn, pad_length, row_mask
from ..ops import bitmap, hashing, selection
from ..parallel.join import join_expand, join_sorted_state
from .errors import ArrowInvalid, ArrowNotImplemented


def _key_codes(left: DeviceBatch, right: DeviceBatch,
               left_keys: Sequence[str], right_keys: Sequence[str]):
    """Shared-space dense codes for both sides (-1 = null/padding)."""
    PL = left.padded
    combined = None
    for lname, rname in zip(left_keys, right_keys):
        lc, rc = left.column(lname), right.column(rname)
        if lc.values.dtype != rc.values.dtype:
            raise ArrowInvalid(
                f"join key dtype mismatch: {lc.type} vs {rc.type}")
        both = torch.cat([lc.values, rc.values])
        words = bitmap.pack_mask(torch.cat([lc.validity_mask(),
                                            rc.validity_mask()]))
        res = hashing.encode_codes(both, lc.type, words, both.shape[0],
                                   order="key")
        part = torch.where(res.codes >= 0, res.codes, -1)
        if combined is None:
            combined = part
        else:
            card = res.n_unique + 1
            combined = torch.where((combined >= 0) & (part >= 0),
                                   combined * card + part, -1)
    return combined[:PL], combined[PL:]


def hash_join(left: DeviceBatch, right: DeviceBatch, keys=None, *,
              left_keys=None, right_keys=None, join_type: str = "inner",
              left_suffix: str = "", right_suffix: str = "_right",
              output_columns: Optional[Sequence[str]] = None) -> DeviceBatch:
    """Join two DeviceBatches; the joined columns stay on the device.

    `output_columns` projects the output: only the named columns
    (post-suffix names) are gathered."""
    if join_type != "inner":
        raise ArrowNotImplemented(f"join type {join_type!r} is not ported")
    if not (isinstance(left, DeviceBatch) and isinstance(right, DeviceBatch)):
        raise ArrowNotImplemented("the port joins DeviceBatches")
    if keys is not None:
        left_keys = right_keys = [keys] if isinstance(keys, str) else list(
            keys)
    if isinstance(left_keys, str):
        left_keys = [left_keys]
    if isinstance(right_keys, str):
        right_keys = [right_keys]
    return _join_device(left, right, list(left_keys), list(right_keys),
                        left_suffix, right_suffix, output_columns)


def _join_device(ldb, rdb, left_keys, right_keys, left_suffix,
                 right_suffix, output_columns):
    """Two phases sharing the sorted state: phase 1 sorts and counts, the
    host reads `total` to size the output bucket, phase 2 expands at
    that capacity."""
    lcodes, rcodes = _key_codes(ldb, rdb, left_keys, right_keys)
    PL, PR = ldb.padded, rdb.padded
    lvalid = row_mask(PL, ldb.length, lcodes.device) & (lcodes >= 0)
    rvalid = row_mask(PR, rdb.length, rcodes.device) & (rcodes >= 0)
    st = join_sorted_state(lcodes, lvalid, rcodes, rvalid, how="inner")
    out_n = int(st.total)                       # the single host read
    cap = pad_length(max(out_n, 1))
    li, ri_rank, _ = join_expand(st, cap)
    return _emit_join_output(ldb, rdb, li, ri_rank, st.rperm, out_n,
                             left_keys, right_keys, left_suffix,
                             right_suffix, output_columns)


def _gather_column(col: DeviceColumn, idx: torch.Tensor, out_n: int,
                   trim_to: int) -> DeviceColumn:
    vals = selection.gather(col.values, idx)[:trim_to]
    words = selection.take_validity(col.validity, idx, out_n, idx.shape[0])
    return DeviceColumn(vals, words[:(trim_to + 31) // 32], out_n, col.type)


def _emit_join_output(ldb, rdb, li, ri_rank, rperm, out_n, left_keys,
                      right_keys, left_suffix, right_suffix,
                      output_columns) -> DeviceBatch:
    """Gather the projected output columns through the pair indices."""
    trim_to = min(pad_length(max(out_n, 1)), li.shape[0])
    want = None if output_columns is None else set(output_columns)
    # suffix decisions use the FULL (unprojected) left name set so a
    # column's output name does not depend on what else was projected
    full_left = {f.name + left_suffix for f in ldb.schema.fields}

    def right_name(f):
        return f.name + (right_suffix
                         if (f.name + left_suffix) in full_left else "")

    # ri arrives as key-sorted right RANKS: resolve them to right rows
    ri = torch.where(ri_rank >= 0, selection.gather(rperm, ri_rank), -1)
    fields: List[dt.Field] = []
    cols: List[DeviceColumn] = []
    for f, c in zip(ldb.schema.fields, ldb.columns):
        name = f.name + left_suffix
        if want is None or name in want:
            fields.append(f.with_name(name))
            cols.append(_gather_column(c, li, out_n, trim_to))
    rkey_set, lkey_set = set(right_keys), set(left_keys)
    for f, c in zip(rdb.schema.fields, rdb.columns):
        if f.name in rkey_set and f.name in lkey_set:
            continue
        name = right_name(f)
        if want is None or name in want:
            fields.append(f.with_name(name))
            cols.append(_gather_column(c, ri, out_n, trim_to))
    return DeviceBatch(dt.Schema(fields), cols, out_n)
