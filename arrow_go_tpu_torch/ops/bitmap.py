"""Device-side packed-bitmap ops (validity words).

Port of arrow_go_tpu/ops/bitmap.py. Words are LSB-first within a word,
word w bit b <-> row w*32+b. The JAX package holds them as uint32; here
they are int32 tensors carrying the same bit patterns. `>>` on int32 is
arithmetic, so every right shift is masked afterwards, and word values
are built in int64 and wrapped to int32 at the end (`_to_words`).
"""
from __future__ import annotations

from typing import Optional

import torch

WORD_BITS = 32
_U32 = 0xFFFFFFFF


def _to_words(w64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low 32 bits."""
    return torch.where(w64 >= (1 << 31), w64 - (1 << 32), w64).to(torch.int32)


def _as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 tensor holding their unsigned values."""
    return words.to(torch.int64) & _U32


def expand_words(words: torch.Tensor, padded: int) -> torch.Tensor:
    """Packed words -> bool mask of shape (padded,)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:padded].to(torch.bool)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool mask -> packed words (zero-pads to a word boundary)."""
    P = mask.shape[0]
    if P % WORD_BITS:
        mask = torch.cat([mask, mask.new_zeros(WORD_BITS - P % WORD_BITS)])
    m = mask.reshape(-1, WORD_BITS).to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=mask.device)
    return _to_words((m << shifts[None, :]).sum(dim=1))


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Total set bits (0-d int64 tensor on the words' device)."""
    v = _as_u32(words)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & _U32) >> 24
    return v.sum()


def words_and(a: Optional[torch.Tensor],
              b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Null-intersection of two packed validity buffers (the executor-kernel
    contract NullHandling=Intersection, reference compute/exec/kernel.go:457)."""
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def words_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def words_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a ^ b


def words_not(a: torch.Tensor, padded: int) -> torch.Tensor:
    """NOT with padding bits kept zero."""
    return ~a & _pad_guard(a.shape[0], padded, a.device)


def _low_bits(rem: torch.Tensor) -> torch.Tensor:
    """Words with the low `rem` bits set (rem in [0, 32])."""
    ones = (torch.ones_like(rem) << rem) - 1
    return _to_words(torch.where(rem >= WORD_BITS, _U32, ones))


def _pad_guard(nwords: int, padded: int, device) -> torch.Tensor:
    """Word mask that zeroes bits >= padded (all-ones when padded==nwords*32)."""
    idx = torch.arange(nwords, dtype=torch.int64, device=device) * WORD_BITS
    return _low_bits(torch.clamp(padded - idx, 0, WORD_BITS))


def length_words(padded: int, length, device) -> torch.Tensor:
    """Packed words of the row mask i < length."""
    nwords = padded // WORD_BITS
    idx = torch.arange(nwords, dtype=torch.int64, device=device) * WORD_BITS
    return _low_bits(torch.clamp(length - idx, 0, WORD_BITS))
