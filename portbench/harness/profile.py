"""What the traced run reads from torch.profiler, and K1's shapes.

`profiled(fn)` runs fn under torch.profiler (CPU and CUDA activities)
and reduces the trace to a DeviceTrace: every device activity (kernel,
copy, fill) with its start and length, and every stage the host marked
(record_function), so that each idle gap of the device can be named by
the stage the host was in. The device's busy time is the union of its
activities' intervals, its idle share 1 - busy / wall (the arithmetic of
chip_smoke.py's profile_device).

`capture_k1()` rebinds `compact_flagged` in the port's modules that call
it (chip_smoke.py's capture_k1) and records each call's shape: rows,
and each payload's element size. It keeps no tensor and does not sync.
A call site that it does not rebind is not seen; the K1 reader then
finds fewer calls than the profiler's K1 launches and reports nothing.
"""
from __future__ import annotations

import bisect
import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import List, Tuple

_LOOKBACK = 64      # marks searched back for the one open at a gap


@dataclass
class DeviceTrace:
    """Device activities [(name, start_us, dur_us)] in start order, the
    host's stage marks [(name, start_us, end_us)], the wall time of the
    profiled part, and K1's captured calls [(site, rows, [sizes])]."""
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    marks: List[Tuple[str, float, float]] = field(default_factory=list)
    wall_s: float = 0.0
    k1_calls: List[tuple] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, s, d in self.ops:
            e = s + d
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def by_name(self) -> List[Tuple[str, float, int]]:
        """(name, device seconds, launches), most time first."""
        acc = {}
        for name, _, d in self.ops:
            s, n = acc.get(name, (0.0, 0))
            acc[name] = (s + d / 1e6, n + 1)
        return sorted(((k, s, n) for k, (s, n) in acc.items()),
                      key=lambda r: -r[1])

    def idle_by_stage(self) -> List[Tuple[str, float]]:
        """Device idle time between activities, summed by the host stage
        (the innermost mark) open at each gap's start; "harness" where
        none is."""
        marks = sorted(self.marks, key=lambda m: m[1])
        starts = [m[1] for m in marks]
        acc = {}
        end = self.ops[0][1] + self.ops[0][2] if self.ops else 0.0
        for _, s, d in self.ops[1:]:
            if s > end:
                # the latest-started mark still open at `end`; marks nest
                # two deep (a query, its stage), so it is among the last
                # few that started
                name = "harness"
                i = bisect.bisect_right(starts, end) - 1
                for j in range(i, max(i - _LOOKBACK, -1), -1):
                    if marks[j][2] > end:
                        name = marks[j][0]
                        break
                acc[name] = acc.get(name, 0.0) + (s - end) / 1e6
            end = max(end, s + d)
        return sorted(acc.items(), key=lambda kv: -kv[1])


def profiled(fn):
    """(fn's result, DeviceTrace) of one run of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    tr = DeviceTrace(wall_s=wall)
    # the raw events: building torch's event tree would take minutes
    events = [(e.name(), e.device_type() == DeviceType.CUDA,
               e.is_user_annotation(), e.start_ns() / 1e3,
               e.duration_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()]
    tr.marks = [(n, s, s + d) for n, cuda, mark, s, d in events
                if mark and not cuda and ":" in n]
    # a mark shows on the device's timeline too, as the span of its
    # kernels: that is no activity of the device
    names = {m[0] for m in tr.marks}
    tr.ops = [(n, s, d) for n, cuda, mark, s, d in events
              if cuda and not mark and n not in names]
    tr.ops.sort(key=lambda o: o[1])
    return out, tr


@contextlib.contextmanager
def capture_k1(calls: list):
    """Within the block, every K1 call of the port's call sites appends
    (site, rows, [payload element sizes]) to `calls`."""
    from arrow_go_tpu_torch.compute import join as cjoin
    from arrow_go_tpu_torch.ops import compaction, groupagg, selection
    from arrow_go_tpu_torch.parallel import join as pjoin
    k1 = compaction.compact_flagged

    def recording(keep, payloads):
        payloads = tuple(payloads)
        site = sys._getframe(1).f_code.co_name
        if site == "compact_runs":            # groupagg's thin wrapper
            site = sys._getframe(2).f_code.co_name
        calls.append((site, keep.numel(),
                      [p.element_size() for p in payloads]))
        return k1(keep, payloads)

    mods = (selection, groupagg, pjoin, cjoin)
    saved = [m.compact_flagged for m in mods]
    for m in mods:
        m.compact_flagged = recording
    try:
        yield calls
    finally:
        for m, f in zip(mods, saved):
            m.compact_flagged = f
