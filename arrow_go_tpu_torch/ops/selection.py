"""Selection: filter and take over device columns.

Port of arrow_go_tpu/ops/selection.py. Filters are count-then-
materialize: the stable compaction (ops/compaction.py, K1 on the card)
moves the selected rows to the front and returns the count as a device
scalar; trimming to the true length happens only at a host boundary.

Null-selection semantics match the reference's FilterOptions
(DropNulls / EmitNulls, vector_selection.go:34).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import bitmap
from .compaction import compact_flagged


def _selection(mask: torch.Tensor, mask_validity: Optional[torch.Tensor],
               n, null_selection: str):
    """(sel, is_null_slot): rows the filter emits, and which of them are
    null rows (emit_null on a null mask slot)."""
    P = mask.shape[0]
    valid = bitmap.length_words(P, n, mask.device)
    if mask_validity is not None:
        mv = bitmap.expand_words(mask_validity & valid, P)
    else:
        mv = bitmap.expand_words(valid, P)
    if null_selection == "emit_null":
        sel = (mask | ~mv) & bitmap.expand_words(valid, P)
        return sel, ~mv & sel
    return mask & mv, torch.zeros_like(mask)


def filter_indices(mask: torch.Tensor, mask_validity: Optional[torch.Tensor],
                   n, null_selection: str = "drop"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean mask -> (dense indices[P], count).

    null_selection='drop': null mask slots select nothing; 'emit_null':
    null mask slots emit a null row, encoded as index -1. Slots beyond
    the dense prefix hold the unselected row indices."""
    sel, is_null_slot = _selection(mask, mask_validity, n, null_selection)
    count = sel.sum()
    src = torch.arange(mask.shape[0], dtype=torch.int64, device=mask.device)
    src = torch.where(is_null_slot, -1, src)
    (out,) = compact_flagged(sel, (src,))
    return out, count


def filter_with_payload(mask: torch.Tensor,
                        mask_validity: Optional[torch.Tensor], n, cols,
                        null_selection: str = "drop"):
    """Filter that carries value columns THROUGH the compaction instead of
    gathering afterwards. Returns (compacted cols tuple, null-row mask
    over the padded domain, count)."""
    sel, is_null_slot = _selection(mask, mask_validity, n, null_selection)
    count = sel.sum()
    if null_selection == "emit_null":
        res = compact_flagged(sel, (is_null_slot,) + tuple(cols))
        return tuple(res[1:]), res[0], count
    # drop-nulls: the null-row lane is identically zero — skip it
    res = compact_flagged(sel, tuple(cols))
    return res, torch.zeros_like(mask), count


def gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Bounds-safe gather (negative/overflow indices clamp; validity handles
    their nullness)."""
    safe = torch.clamp(indices, 0, values.shape[0] - 1)
    return values.index_select(0, safe)


def take_validity(validity: Optional[torch.Tensor], indices: torch.Tensor,
                  count, P_out: int) -> torch.Tensor:
    """Gather packed validity through an index vector; -1 indices and slots
    beyond `count` become invalid."""
    in_range = (indices >= 0) & (torch.arange(
        indices.shape[0], device=indices.device) < count)
    if validity is None:
        mask = in_range
    else:
        word = torch.clamp(indices, 0, validity.shape[0] * 32 - 1)
        bits = (validity.index_select(0, word // 32) >> (word % 32).to(
            torch.int32)) & 1
        mask = in_range & (bits == 1)
    return bitmap.pack_mask(mask[:P_out])


def take_indices_checked(indices: torch.Tensor,
                         indices_validity: Optional[torch.Tensor], n_idx,
                         n_src) -> torch.Tensor:
    """Bounds check for take (reference take with BoundsCheck): the count
    of valid rows below n_idx whose index is outside [0, n_src), as a
    0-d device tensor (the caller raises)."""
    P = indices.shape[0]
    row = torch.arange(P, device=indices.device) < n_idx
    if indices_validity is not None:
        row = row & bitmap.expand_words(indices_validity, P)
    bad = row & ((indices < 0) | (indices >= n_src))
    return bad.sum(dtype=torch.int32)
