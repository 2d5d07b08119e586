"""Running u64 maximum of (hi, lo) packs: the join's forward fill.

Port of arrow_go_tpu/ops/scan.py. The join's pair expansion fills its
owner fields forward with a running max of u64 packs (parallel/join.py);
several lo lanes share one hi lane. The join state's one-lane fills
(`cummax_u32`) are the hi-only mode: no lo lane is read or written.

On a CUDA tensor `cummax_u64_lanes` and `cummax_u32` launch K2
(csrc/scan.cu), the hand-written Hopper kernel that replaces the TPU
scan kernel, one launch a call, counted with its `least_bytes` as
`kernel.K2` (utils/metrics.py). On a CPU tensor they run the plain
versions: a cummax over each pack as int64 with the sign bit flipped,
an exact u64 order (ops/groupagg.cummax_u64), and a cummax of the low
32 bits. Both take every length.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from .. import cuda_build
from ..torchenv import use_kernels
from ..utils.metrics import metrics

_MAX_LO = 4                    # MAX_LO in csrc/scan.cu
_TILE = 256 * 8                # TILE in csrc/scan.cu
_EPOCHS = (1 << 30) - 1        # epochs 1 .. 2^30 - 1 (a hi-only status word)
_epoch: Dict[Tuple[int, int], int] = {}
_ctypes_ready = False


def cummax_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the hi-only mode: the running max of the low 32
    bits of x, as the hi lane of `cummax_u64_lanes_plain(x, [zeros])`
    gives it."""
    return torch.cummax(x & 0xFFFFFFFF, 0).values


def cummax_u64_lanes_plain(hi: torch.Tensor, los: Sequence[torch.Tensor]
                           ) -> List[torch.Tensor]:
    """Plain version: per lane, the running max of (hi << 32) | lo; with
    no lo lane, the hi-only mode."""
    from .groupagg import cummax_u64
    if not los:
        return [cummax_u32_plain(hi)]
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

    hi, los: int64 tensors carrying u32 values, all of one length, 0 to
    4 lo lanes. Returns [hi_fill, lo_i_fill...] (int64 carrying u32):
    element j of lo_i_fill is the low word of the u64 max of the packs
    (hi, lo_i) over [0, j]; hi_fill is the high word of lane 0's, or with
    no lo lane the running max of hi.
    """
    los = list(los)
    if not use_kernels(hi):
        return cummax_u64_lanes_plain(hi, los)
    return _cummax_cuda(hi, los)


def least_bytes(n: int, lo_lanes: int) -> int:
    """The bytes K2 moves at the least, the model of its bound: the hi
    lane and each lo lane, n int64 each, read once and written once."""
    return 2 * n * 8 * (1 + lo_lanes)


def cummax_u32(x: torch.Tensor) -> torch.Tensor:
    """Running max of one int64 lane carrying u32 values: K2's hi-only
    mode, one lane read and one written (torch.cummax on the card is a
    slow per-row scan)."""
    return cummax_u64_lanes(x, [])[0]


def _lib():
    global _ctypes_ready
    lib = cuda_build.load("scan")
    if not _ctypes_ready:
        p = ctypes.c_void_p
        lib.agt_cummax_u64_lanes.argtypes = [
            p, ctypes.c_int, p, p, p, ctypes.c_longlong, ctypes.c_int, p,
            ctypes.c_longlong, ctypes.c_ulonglong, p]
        lib.agt_cummax_u64_lanes.restype = ctypes.c_int
        _ctypes_ready = True
    return lib


def _next_epoch(device: torch.device, stream: int,
                scratch: torch.Tensor) -> int:
    """This call's epoch on the stream's scratch. When the epochs wrap,
    the status words are zeroed first, so none from an earlier call can
    look current."""
    key = (device.index, stream)
    last = _epoch.get(key, 0)
    epoch = last % _EPOCHS + 1
    if last == _EPOCHS:
        scratch.zero_()
    _epoch[key] = epoch
    return epoch


def _cummax_cuda(hi: torch.Tensor, los: List[torch.Tensor]):
    if not 0 <= len(los) <= _MAX_LO:
        raise ValueError(f"cummax_u64_lanes: 0..{_MAX_LO} lo lanes, "
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
    aligned = all(t.data_ptr() % 16 == 0 for t in [hi, out_hi] + los
                  + out_los)
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream(hi.device).cuda_stream
        # the ticket, a status word a tile, _MAX_LO value words a tile
        scratch = cuda_build.stream_scratch(
            "scan", hi.device, stream, 1 + tiles * (1 + _MAX_LO))
        cap = (scratch.numel() - 1) // (1 + _MAX_LO)
        epoch = _next_epoch(hi.device, stream, scratch)
        in_ptrs = (ctypes.c_void_p * k)(*[lo.data_ptr() for lo in los]) \
            if k else None
        out_ptrs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in out_los]) \
            if k else None
        cuda_build.check(lib.agt_cummax_u64_lanes(
            hi.data_ptr(), k, in_ptrs, out_hi.data_ptr(), out_ptrs, n,
            int(aligned), scratch.data_ptr(), cap, epoch, stream),
            "K2 cummax_u64_lanes")
    metrics.kernel("K2", least_bytes(n, k))
    return [out_hi] + out_los
