"""Running u64 maximum of (hi, lo) packs: the join's forward fill.

Port of arrow_go_tpu/ops/scan.py. The join's pair expansion fills its
owner fields forward with a running max of u64 packs (parallel/join.py);
several lo lanes share one hi lane.

On a CUDA tensor `cummax_u64_lanes` launches K2 (csrc/scan.cu), the
hand-written Hopper kernel that replaces the TPU scan kernel. On a CPU
tensor it runs the plain version: a cummax over each pack as int64 with
the sign bit flipped, an exact u64 order (ops/groupagg.cummax_u64).
Both take every length.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from .. import cuda_build
from ..torchenv import use_kernels

_MAX_LO = 4                    # MAX_LO in csrc/scan.cu
_TILE = 512 * 8                # TILE in csrc/scan.cu
_ctypes_ready = False


def cummax_u64_lanes_plain(hi: torch.Tensor, los: Sequence[torch.Tensor]
                           ) -> List[torch.Tensor]:
    """Plain version: per lane, the running max of (hi << 32) | lo."""
    from .groupagg import cummax_u64
    out_hi = None
    res = []
    for lo in los:
        f = cummax_u64((hi << 32) | lo)
        if out_hi is None:
            out_hi = (f >> 32) & 0xFFFFFFFF
        res.append(f & 0xFFFFFFFF)
    return [out_hi] + res


def cummax_u64_lanes(hi: torch.Tensor, los: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """Inclusive running max of the packs (hi, lo_i) in flat order.

    hi, los: int64 tensors carrying u32 values, all of one length.
    Returns [hi_fill, lo_i_fill...] (int64 carrying u32): element j of
    lo_i_fill is the low word of the u64 max of the packs (hi, lo_i)
    over [0, j]; hi_fill is the high word of lane 0's.
    """
    los = list(los)
    if not use_kernels(hi):
        return cummax_u64_lanes_plain(hi, los)
    return _cummax_cuda(hi, los)


cummax_u64_lanes.launches = 0


def cummax_u32(x: torch.Tensor) -> torch.Tensor:
    """Running max of one int64 lane carrying u32 values: the hi lane of
    `cummax_u64_lanes` with a zero lo lane (torch.cummax on the card is
    a slow per-row scan)."""
    return cummax_u64_lanes(x, [torch.zeros_like(x)])[0]


def _lib():
    global _ctypes_ready
    lib = cuda_build.load("scan")
    if not _ctypes_ready:
        p = ctypes.c_void_p
        lib.agt_cummax_u64_lanes.argtypes = [
            p, ctypes.c_int, p, p, p, ctypes.c_longlong, p, p]
        lib.agt_cummax_u64_lanes.restype = ctypes.c_int
        _ctypes_ready = True
    return lib


def _cummax_cuda(hi: torch.Tensor, los: List[torch.Tensor]):
    if not 1 <= len(los) <= _MAX_LO:
        raise ValueError(f"cummax_u64_lanes: 1..{_MAX_LO} lo lanes, "
                         f"got {len(los)}")
    for t in [hi] + los:
        if t.dtype != torch.int64 or t.dim() != 1 or \
                not t.is_contiguous():
            raise ValueError("cummax_u64_lanes: lanes must be contiguous "
                             "1-D int64 tensors")
        if t.device != hi.device or t.shape[0] != hi.shape[0]:
            raise ValueError("cummax_u64_lanes: lanes must share one "
                             "device and one length")
    n = hi.shape[0]
    out_hi = torch.empty_like(hi)
    out_los = [torch.empty_like(lo) for lo in los]
    if n == 0:
        return [out_hi] + out_los
    lib = _lib()
    k = len(los)
    tiles = -(-n // _TILE)
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream(hi.device).cuda_stream
        scratch = torch.empty(k * tiles, dtype=torch.int64, device=hi.device)
        in_ptrs = (ctypes.c_void_p * k)(*[lo.data_ptr() for lo in los])
        out_ptrs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in out_los])
        cuda_build.check(lib.agt_cummax_u64_lanes(
            hi.data_ptr(), k, in_ptrs, out_hi.data_ptr(), out_ptrs, n,
            scratch.data_ptr(), stream), "K2 cummax_u64_lanes")
    cummax_u64_lanes.launches += 1
    return [out_hi] + out_los
