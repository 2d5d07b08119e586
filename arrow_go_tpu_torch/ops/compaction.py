"""Stable partition by a keep flag: the engine-wide compaction primitive.

Port of arrow_go_tpu/ops/compaction.py. Every "move flagged rows to the
front, keep order" step (filter, the join's rank -> row map, group-by
run boundaries, segment aggregates) goes through `compact_flagged`.

On a CUDA tensor it launches K1 (csrc/compaction.cu), the hand-written
Hopper kernel that replaces the TPU stitch kernel `_stitch`, and counts
the launch and its `least_bytes` as `kernel.K1` (utils/metrics.py). On
a CPU tensor it runs the plain version, a stable argsort on ~keep (no
count). Both give the whole stable partition: kept rows in order, then
the un-kept rows in order. The JAX package's 32-bit lane codec and roll-and-merge were
TPU workarounds and have no counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import cuda_build
from ..torchenv import use_kernels
from ..utils.metrics import metrics

_MAX_PAYLOADS = 16             # MAX_PAYLOADS in csrc/compaction.cu
_TILE = 4096                   # TILE in csrc/compaction.cu
_SCRATCH_WORDS = 3             # sizeof(Scratch) / 8 in csrc/compaction.cu
_ctypes_ready = False


def compact_flagged_plain(keep: torch.Tensor,
                          payloads: Sequence[torch.Tensor]) -> tuple:
    """Plain version: one stable argsort on ~keep, then a gather of each
    payload (the JAX package's `_sort_compact`)."""
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    return tuple(_gather(p, order) for p in payloads)


# torch's index_select has no kernels for these; their bits move as the
# signed type of the same width
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _gather(p: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    signed = _SIGNED_VIEW.get(p.dtype)
    if signed is None:
        return p.index_select(0, order)
    return p.view(signed).index_select(0, order).view(p.dtype)


def compact_flagged(keep: torch.Tensor,
                    payloads: Sequence[torch.Tensor]) -> tuple:
    """Stable-move rows where `keep` to the front of every payload.

    Entries [0, sum(keep)) of each output hold the kept rows in original
    order; the rest hold the un-kept rows in original order. Output
    length == input length; dtypes are kept.
    """
    payloads = tuple(payloads)
    if not use_kernels(keep):
        return compact_flagged_plain(keep, payloads)
    return _compact_cuda(keep, payloads)


def least_bytes(keep: torch.Tensor,
                payloads: Sequence[torch.Tensor]) -> int:
    """The bytes K1 moves at the least, the model of its bound: the keep
    flags read once, every payload read once and written once."""
    n = keep.numel()
    return n + 2 * n * sum(p.element_size() for p in payloads)


def _lib():
    global _ctypes_ready
    lib = cuda_build.load("compaction")
    if not _ctypes_ready:
        p = ctypes.c_void_p
        lib.agt_compact.argtypes = [p, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, p, p, p, p, p, p, p]
        lib.agt_compact.restype = ctypes.c_int
        _ctypes_ready = True
    return lib


def _check_inputs(keep: torch.Tensor, payloads: Tuple[torch.Tensor, ...]):
    if keep.dtype != torch.bool or keep.dim() != 1 or \
            not keep.is_contiguous():
        raise ValueError("compact_flagged: keep must be a contiguous 1-D "
                         "bool tensor")
    if not 1 <= len(payloads) <= _MAX_PAYLOADS:
        raise ValueError(f"compact_flagged: 1..{_MAX_PAYLOADS} payloads, "
                         f"got {len(payloads)}")
    for p in payloads:
        if p.device != keep.device:
            raise ValueError(f"compact_flagged: payload on {p.device}, "
                             f"keep on {keep.device}")
        if p.dim() != 1 or p.shape[0] != keep.shape[0]:
            raise ValueError("compact_flagged: payloads must be 1-D and as "
                             "long as keep")
        if not p.is_contiguous():
            raise ValueError("compact_flagged: payloads must be contiguous")
        if p.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"compact_flagged: element size "
                             f"{p.element_size()} not supported")


def _aligned(t: torch.Tensor) -> int:
    """1 when the kernel may read `t` with 16-byte loads."""
    return int(t.data_ptr() % 16 == 0)


def _compact_cuda(keep: torch.Tensor, payloads: Tuple[torch.Tensor, ...]):
    _check_inputs(keep, payloads)
    outs = tuple(torch.empty_like(p) for p in payloads)
    n = keep.shape[0]
    if n == 0:
        return outs
    lib = _lib()
    k = len(payloads)
    with torch.cuda.device(keep.device):
        stream = torch.cuda.current_stream(keep.device).cuda_stream
        stat = torch.empty(-(-n // _TILE), dtype=torch.int64,
                           device=keep.device)
        srcs = (ctypes.c_void_p * k)(*[p.data_ptr() for p in payloads])
        dsts = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
        sizes = (ctypes.c_int * k)(*[p.element_size() for p in payloads])
        aligned = (ctypes.c_int * k)(*[_aligned(p) for p in payloads])
        cuda_build.check(lib.agt_compact(
            keep.data_ptr(), n, _aligned(keep), k, srcs, dsts, sizes,
            aligned, stat.data_ptr(),
            cuda_build.stream_scratch("compaction", keep.device, stream,
                                      _SCRATCH_WORDS).data_ptr(),
            stream), "K1 compact")
    metrics.kernel("K1", least_bytes(keep, payloads))
    return outs
