"""Engine observability: per-function counters and timing, and a
profiler trace.

Port of arrow_go_tpu/utils/metrics.py. `metrics` is the process's
registry: `compute.call_function` records each call in it (calls, host
seconds, rows) while `metrics.enable()` is on. The time is taken on the
host clock with no device synchronize, as the JAX package takes it, so
on the card it is the dispatch time, not the device time. `trace` runs
torch.profiler over a region (the JAX package runs jax.profiler) and
writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

from .. import torchenv


@dataclass
class OpStats:
    calls: int = 0
    total_s: float = 0.0
    rows: int = 0
    bytes: int = 0

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.calls * 1e3 if self.calls else 0.0

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.total_s if self.total_s else 0.0


class Metrics:
    """Thread-safe per-operator counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: Dict[str, OpStats] = defaultdict(OpStats)
        self.enabled = False

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._ops.clear()

    def record(self, op: str, seconds: float, rows: int = 0,
               nbytes: int = 0) -> None:
        with self._lock:
            st = self._ops[op]
            st.calls += 1
            st.total_s += seconds
            st.rows += rows
            st.bytes += nbytes

    @contextlib.contextmanager
    def time_op(self, op: str, rows: int = 0,
                nbytes: int = 0) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(op, time.perf_counter() - t0, rows, nbytes)

    def snapshot(self) -> Dict[str, OpStats]:
        with self._lock:
            return {k: OpStats(v.calls, v.total_s, v.rows, v.bytes)
                    for k, v in self._ops.items()}

    def report(self) -> str:
        lines = [f"{'op':<28}{'calls':>8}{'mean ms':>10}{'rows/s':>14}"]
        for op, st in sorted(self.snapshot().items()):
            lines.append(f"{op:<28}{st.calls:>8}{st.mean_ms:>10.3f}"
                         f"{st.rows_per_s:>14.0f}")
        return "\n".join(lines)


metrics = Metrics()


@contextlib.contextmanager
def trace(name: str = "arrow_go_tpu", log_dir: Optional[str] = None,
          device=None):
    """torch.profiler over the region, with the CUDA activity when
    `device` (the card unless named) is a card. On exit it writes the
    Chrome trace `<log_dir>/<name>.json` (log_dir: a new temporary
    directory unless given). Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile
    dev = torchenv.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="agt_trace_")
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
