"""Engine observability: the port's spans and counters, and a profiler
trace.

Port of arrow_go_tpu/utils/metrics.py, grown into the port's one tracing
system. `metrics` is the process's registry.

Spans are on while `metrics.enable()` is, and while a torch profiler
records, so that a profiled region shows the port's spans with no call
to this module. `metrics.span(name, rows=0, device=None)` then records
the span's name, its host start and end in Unix ns (the clock that
torch.profiler stamps its events with) and the index of its parent
span. It opens a `torch.profiler.record_function` range named
`agt.<name>`, so a profiler trace shows the span over its kernels, and
on a CUDA `device` it records a pair of timing events on the device's
current stream, with no synchronize: `snapshot()` waits for them and
gives the span's device ms, the stream's elapsed time from the span's
first launch to its end (idle gaps between its launches included, so
where the host paces the stream it reads the dispatch, not the device's
work). The operators and their phases carry the events:
compute/join.py (hash_join, semi_verdict), compute/groupby.py
(group_by), compute/functions.py (sort_indices, take, filter) and
compute/expression.py (execute_scalar_expression).
`compute.call_function` records each call as a span of host time only,
and its calls, host seconds and rows in `Snapshot.ops`, as the JAX
package records them (`record` adds one there). While spans are off,
`span()` returns one shared no-op context.

Counters are always on: integer adds under the registry's lock.

  kernel.K1 / K2 / K3   launches, and the least bytes they move (the
                        model of each kernel's bound in PERF.md)
  sort                  the port's device sorts, and their rows x key
                        passes (ops/sort.py, compute/groupby.py)
  host_read.<site>      device->host reads through `host_read`, and
                        their bytes

While spans are on, each counter event is a record too (kind "count",
no duration, its amount the counter's), and each host read a span (kind
"host_read", range `agt.host_read.<site>`), so that the counts of a
profiled region can be told from the process's totals. Records stay in
memory until `reset()`, at most `max_records` of them: past that, spans
and counter events are not recorded (the counters and `Snapshot.ops`
still count) and `dropped` counts them, so that a long profile of a
service holds a bounded registry.

`trace` runs torch.profiler over a region, so with spans on, and writes
a Chrome trace.
"""
from __future__ import annotations

import contextlib
import copy
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .. import torchenv

# whether a torch profiler records in this process: the check that
# torch's own record_function makes (no public name in torch 2.x)
_profiling = torch._C._autograd._profiler_enabled


@dataclass
class OpStats:
    """A call_function name's calls, host seconds and rows."""
    calls: int = 0
    total_s: float = 0.0
    rows: int = 0

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.calls * 1e3 if self.calls else 0.0


@dataclass
class SpanRecord:
    """One record. `kind`: "op" (an operator or one of its phases),
    "call" (a call_function call), "host_read" (a device->host read;
    `name` is its site) or "count" (a counter event, start = end;
    `name` is the counter). `parent` is the index of the enclosing
    span's record, -1 for none; times are Unix ns; `amount` is what a
    host read or a counter event added to its counter (bytes, or rows x
    passes); `device_ms` is None where no CUDA events were recorded."""
    name: str
    kind: str
    start_ns: int = 0
    end_ns: int = 0
    parent: int = -1
    rows: int = 0
    amount: float = 0
    device_ms: Optional[float] = None


@dataclass
class Counter:
    """Events, and what they added: bytes, or rows x passes."""
    count: int = 0
    total: float = 0


@dataclass
class Snapshot:
    """Copies of the call_function stats, the records and the
    counters."""
    ops: Dict[str, OpStats] = field(default_factory=dict)
    spans: List[SpanRecord] = field(default_factory=list)
    counters: Dict[str, Counter] = field(default_factory=dict)


_NOOP = contextlib.nullcontext()


class _Span:
    """An open span: its record, its profiler range and its events."""
    __slots__ = ("_m", "_rec", "_label", "_stream", "_range", "_events")

    def __init__(self, m: "Metrics", rec: SpanRecord, label: str,
                 stream=None):
        self._m, self._rec, self._label = m, rec, label
        self._stream, self._events = stream, None

    def __enter__(self):
        m, rec = self._m, self._rec
        stack = m._stack()
        rec.parent = stack[-1] if stack else -1
        index = m._keep(rec)
        self._range = torch.profiler.record_function(self._label)
        if self._stream is not None and index >= 0:
            self._events = m._event_pair(self._stream.device_index)
            self._events[0].record(self._stream)
        rec.start_ns = time.time_ns()
        self._range.__enter__()
        stack.append(index)
        return self

    def __exit__(self, *exc):
        m, rec = self._m, self._rec
        if self._events is not None:
            self._events[1].record(self._stream)
        self._range.__exit__(None, None, None)
        rec.end_ns = time.time_ns()
        m._stack().pop()
        if self._events is not None:
            with m._lock:
                m._pending.append((rec, self._stream.device_index,
                                   self._events))
        if rec.kind == "call":
            m.record(rec.name, (rec.end_ns - rec.start_ns) / 1e9, rec.rows)
        return False


class Metrics:
    """The process's spans and counters (thread-safe)."""

    max_records = 1 << 18

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ops: Dict[str, OpStats] = {}
        self._spans: List[SpanRecord] = []
        self._pending: List[tuple] = []   # (record, device index, events)
        self._free: Dict[int, list] = {}  # device index -> spare events
        self._counters: Dict[str, Counter] = {}
        self.dropped = 0
        self.enabled = False

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    @property
    def recording(self) -> bool:
        """Whether spans are on: enabled, or a torch profiler records."""
        return self.enabled or _profiling()

    def reset(self) -> None:
        """Drop every record, call_function stat and counter (call it
        with no span open)."""
        with self._lock:
            self._ops.clear()
            self._spans.clear()
            self._pending.clear()
            self._counters.clear()
            self.dropped = 0

    def record(self, op: str, seconds: float, rows: int = 0) -> None:
        """One call of `op` in `Snapshot.ops`: its host seconds and
        rows."""
        with self._lock:
            st = self._ops.get(op)
            if st is None:
                st = self._ops[op] = OpStats()
            st.calls += 1
            st.total_s += seconds
            st.rows += rows

    # -- spans -------------------------------------------------------------

    def span(self, name: str, rows: int = 0, device=None):
        """A span over the block, with device ms where `device` is a CUDA
        device; the shared no-op context while spans are off."""
        if not self.recording:
            return _NOOP
        stream = None
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
        return _Span(self, SpanRecord(name, "op", rows=rows), f"agt.{name}",
                     stream)

    def time_op(self, op: str, rows: int = 0):
        """call_function's span: host time only, counted in `ops`."""
        if not self.recording:
            return _NOOP
        return _Span(self, SpanRecord(op, "call", rows=rows), f"agt.{op}")

    def _stack(self) -> List[int]:
        """This thread's open spans, as record indices (-1: not kept)."""
        local = self._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        return stack

    def _keep(self, rec: SpanRecord) -> int:
        """Appends `rec` to the records and gives its index; -1, and one
        more `dropped`, where `max_records` are held."""
        with self._lock:
            if len(self._spans) < self.max_records:
                self._spans.append(rec)
                return len(self._spans) - 1
            self.dropped += 1
            return -1

    def _event_pair(self, index: int):
        with self._lock:
            free = self._free.get(index)
            if free:
                return free.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # -- counters ----------------------------------------------------------

    def _count(self, key: str, amount, record: bool = True) -> None:
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            c.count += 1
            c.total += amount
        if record and self.recording:
            now = time.time_ns()
            stack = self._stack()
            self._keep(SpanRecord(key, "count", now, now,
                                  stack[-1] if stack else -1,
                                  amount=amount))

    def kernel(self, name: str, least_bytes: int) -> None:
        """One launch of kernel `name` and the least bytes it moves."""
        self._count(f"kernel.{name}", least_bytes)

    def sort(self, rows: int, passes: int = 1) -> None:
        """One device sort of `rows` rows in `passes` stable key
        passes."""
        self._count("sort", rows * passes)

    def host_read(self, t: torch.Tensor, site: str):
        """`t` on the host: a Python number for a 0-d tensor, else a
        numpy array. The operator path's one way to read the device:
        counted as host_read.<site>, and while spans are on a span of
        its own (range `agt.host_read.<site>`), host time only."""
        size = t.numel() * t.element_size()
        self._count(f"host_read.{site}", size, record=False)
        if not self.recording:
            return _to_host(t)
        with _Span(self, SpanRecord(site, "host_read", rows=t.numel(),
                                    amount=size),
                   f"agt.host_read.{site}"):
            return _to_host(t)

    # -- reading -----------------------------------------------------------

    def counter(self, key: str) -> Counter:
        """A copy of one counter (zero where nothing was counted)."""
        with self._lock:
            return copy.copy(self._counters.get(key, Counter()))

    def snapshot(self) -> Snapshot:
        """Copies of the call_function stats, the records and the
        counters. The CUDA events of every closed span are waited for
        and resolved into its device ms first."""
        with self._lock:
            pending, self._pending = self._pending, []
        for rec, _, (start, end) in pending:
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
        with self._lock:
            for _, index, pair in pending:
                self._free.setdefault(index, []).append(pair)
            return Snapshot(
                {k: copy.copy(v) for k, v in self._ops.items()},
                [copy.copy(r) for r in self._spans],
                {k: copy.copy(v) for k, v in self._counters.items()})

    def report(self) -> str:
        """Calls, rows and device ms by span, then the counters."""
        snap = self.snapshot()
        by: Dict[str, list] = {}
        for r in snap.spans:
            if r.kind == "count":
                continue
            row = by.setdefault(f"{r.kind}:{r.name}", [0, 0, None])
            row[0] += 1
            row[1] += r.rows
            if r.device_ms is not None:
                row[2] = (row[2] or 0.0) + r.device_ms
        lines = [f"{'span':<36}{'calls':>8}{'rows':>14}{'device ms':>12}"]
        for name, (calls, rows, ms) in sorted(by.items()):
            lines.append(f"{name:<36}{calls:>8}{rows:>14}"
                         + (f"{ms:>12.3f}" if ms is not None
                            else f"{'-':>12}"))
        lines.append(f"{'counter':<36}{'count':>8}{'total':>14}")
        for name, c in sorted(snap.counters.items()):
            lines.append(f"{name:<36}{c.count:>8}{c.total:>14.6g}")
        return "\n".join(lines)


def _to_host(t: torch.Tensor):
    h = t.cpu()
    return h.item() if h.dim() == 0 else h.numpy()


metrics = Metrics()


@contextlib.contextmanager
def trace(name: str = "arrow_go_tpu", log_dir: Optional[str] = None,
          device=None):
    """torch.profiler over the region, with the CUDA activity when
    `device` (the card unless named) is a card; the port's spans record
    while it does. On exit it writes the Chrome trace
    `<log_dir>/<name>.json` (log_dir: a new temporary directory unless
    given). Yields log_dir."""
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
