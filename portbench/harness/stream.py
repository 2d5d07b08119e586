"""The closed-loop query stream and the stage marks around its layers.

One client sends the next query when the last one's host result is back
(TPC-H's power test, clause 5.3.3). A query's latency runs from its send
to its host result; the window runs from the first send to the last
result, and no query is sent once `seconds` have passed.

A plan marks its stages with `ctx.span(name)`. In the untimed modes a
mark does nothing. In "spans" mode it synchronizes the device at the
stage's start and end and records the host clock between (these syncs
change the timing, so only per-layer numbers read them). In "profile"
mode it names the stage in the profiler's trace
(torch.profiler.record_function), with no sync.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch


@dataclass
class Answer:
    """One query instance of the window."""
    query: str
    set_index: int
    sent_s: float
    latency_ms: Optional[float] = None
    result: object = None
    error: Optional[str] = None


@dataclass
class Part:
    """One part of a window, in one mode."""
    mode: str
    answers: List[Answer] = field(default_factory=list)
    spans: List[tuple] = field(default_factory=list)   # (query, stage, ms)
    window_s: float = 0.0


class Ctx:
    """What a plan sees besides its tables and parameters: the device
    it runs on and the stage marks."""

    def __init__(self, device: torch.device):
        self.device = device
        self.mode = "plain"
        self.query = ""
        self.part: Optional[Part] = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, stage: str):
        if self.mode == "spans":
            self.sync()
            t = time.perf_counter()
            yield
            self.sync()
            self.part.spans.append((self.query, stage,
                                    (time.perf_counter() - t) * 1e3))
        elif self.mode == "profile":
            with torch.profiler.record_function(f"{self.query}:{stage}"):
                yield
        else:
            yield


def run_part(ctx: Ctx, mode: str, seconds: float, sched, run_query:
             Callable) -> Part:
    """Run the schedule `sched` (an iterator of (query, set index)) for
    `seconds` in `mode`; `run_query(q, k)` runs one instance and returns
    its host result."""
    part = Part(mode)
    ctx.mode, ctx.part = mode, part
    ctx.sync()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        q, k = next(sched)
        a = Answer(q, k, time.perf_counter() - start)
        ctx.query = q
        t = time.perf_counter()
        try:
            if mode == "profile":
                with torch.profiler.record_function(f"{q}:other"):
                    a.result = run_query(q, k)
            else:
                a.result = run_query(q, k)
            a.latency_ms = (time.perf_counter() - t) * 1e3
        except Exception as e:        # noqa: BLE001 - a failed answer counts
            a.error = f"{type(e).__name__}: {e}"
        part.answers.append(a)
    ctx.sync()
    part.window_s = time.perf_counter() - start
    ctx.mode, ctx.part, ctx.query = "plain", None, ""
    return part
