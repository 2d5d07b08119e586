"""One run of one cell: set-up, the window, the check, the result line.

  1. the configuration's tables made from the seed on the device;
  2. loaded as the port's resident DeviceBatches;
  3. each query warmed once with each of its substitution sets;
  4. the closed-loop stream for `seconds` (with --trace 1: its last
     PROFILE_S seconds, or half where that is less, under torch.profiler,
     and the rest before them with stage marks);
  5. the port's state freed, the plain reference run over the same
     generated tables, every answer of the window held against it;
  6. the metrics of the cell's lists in BENCHMARK.json, each read by its
     own reader, and the result line.
"""
from __future__ import annotations

import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from portbench.harness import check, params, profile, stream, tables
from portbench.harness.spec import Cell, reader

FORBIDDEN = ("jax", "jaxlib", "flax", "arrow_go_tpu")
PROFILE_S = 10.0       # the profiled part of a traced window, at most
_NAME = 160            # characters of a kernel's name kept in the breakdown
ACC = {"float64": torch.float64, "float32": torch.float32,
        "int64": torch.int64, "int32": torch.int32}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Window:
    """What an end-to-end reader sees: every answer of the window, the
    window's seconds (first send to last result) and the set-up's."""
    answers: List[stream.Answer]
    window_s: float
    setup_s: float

    @property
    def latencies_ms(self) -> List[float]:
        return [a.latency_ms for a in self.answers if a.error is None]


@dataclass
class Traced:
    """What a per-layer reader sees: the stage marks of the first part,
    the device trace of the second, and each part's answered queries."""
    spans: List[tuple]
    span_queries: int
    trace: profile.DeviceTrace
    profile_queries: int
    notes: List[str] = field(default_factory=list)

    def log(self, msg: str) -> None:
        self.notes.append(msg)
        log(msg)


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the benchmark's process must
    not hold, compared whole (arrow_go_tpu_torch is not arrow_go_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda",
             wrap_query: Optional[Callable] = None) -> Optional[dict]:
    """One run; returns the result line's object, or None where the
    process holds a forbidden module once the result is made.
    `wrap_query(run_query)` wraps each instance's call (q, k): tests
    break the timed path with it."""
    dev = torch.device(device)
    ctx = stream.Ctx(dev)
    cuda = dev.type == "cuda"
    if cuda:
        # the CUDA context is the process's start, as the imports are:
        # made before the set-up's clock starts
        torch.cuda.init()
        torch.empty(1, device=dev)
        ctx.sync()
    t0 = time.perf_counter()
    gen = cell.generator().generate(cell.config, seed, dev)
    ctx.sync()
    log(f"tables: {tables.table_bytes(gen)} bytes generated in "
        f"{time.perf_counter() - t0:.3f} s, rows "
        + ", ".join(f"{t} {len(next(iter(c.values())).values)}"
                    for t, c in gen.items()))
    t1 = time.perf_counter()
    port = tables.to_port(gen)
    ctx.sync()
    log(f"loaded as DeviceBatches in {time.perf_counter() - t1:.3f} s")
    plans = cell.plans()
    sets = params.draw_sets(cell.mix, seed)

    def run_query(q: str, k: int):
        return plans[q].run(port, sets[q][k], ctx)

    call = run_query if wrap_query is None else wrap_query(run_query)

    def answer(q: str, k: int):
        return check.normalize(call(q, k))

    warm = {}
    for q, k in params.instances(cell.mix, seed):
        t1 = time.perf_counter()
        answer(q, k)
        warm[q] = warm.get(q, 0.0) + time.perf_counter() - t1
    log("warm-up s: " + ", ".join(f"{q} {s:.3f}" for q, s in warm.items()))
    if trace:
        profile.profiled(lambda: torch.ones(8, device=dev).sum().item())
    ctx.sync()
    # what set-up made stays for the whole run: out of the collector's
    # scans, as a long-running service freezes its start-up objects, so
    # that a collection in the window scans what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"setup_s {setup_s!r}, set-up peak {setup_peak} bytes")

    sched = params.schedule(cell.mix, seed)
    traced = None
    if trace:
        prof_s = min(PROFILE_S, seconds / 2)
        first = stream.run_part(ctx, "spans", seconds - prof_s, sched,
                                answer)
        k1_calls: list = []
        with profile.capture_k1(k1_calls):
            second, dtrace = profile.profiled(lambda: stream.run_part(
                ctx, "profile", prof_s, sched, answer))
        dtrace.k1_calls = k1_calls
        parts = [first, second]
        traced = Traced(first.spans, _answered(first), dtrace,
                        _answered(second))
    else:
        parts = [stream.run_part(ctx, "plain", seconds, sched, answer)]
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"window peak {window_peak} bytes")
    answers = [a for p in parts for a in p.answers]
    log("latency ms by query (n, median, max): " + _by_query(answers))

    del port, plans
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    refs = cell.references()
    acc = ACC[cell.config["accumulate"]]
    wants = {}
    for a in answers:
        key = (a.query, a.set_index)
        if key not in wants:
            wants[key] = check.normalize(
                refs[a.query].run(gen, sets[a.query][a.set_index], acc))
    correct, checks = check.judge(answers, wants, cell.config["limits"])
    log(f"reference: {len(wants)} answers in "
        f"{time.perf_counter() - t:.3f} s for {len(answers)} compared")

    if trace:
        metrics = _read("layer_metrics", cell.per_layer, traced)
        busy = traced.trace.busy_s
        extra = {"busy_s": busy, "window_s": traced.trace.wall_s}
    else:
        window = Window(answers, sum(p.window_s for p in parts), setup_s)
        metrics = _read("e2e_metrics", cell.end_to_end, window)
        extra = {}
    out = {
        "correct": correct,
        "attempted": len(answers),
        "failed": sum(a.error is not None for a in answers),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else dev.type,
                   "count": cell.chips,
                   "memory_peak_bytes": max(setup_peak, window_peak),
                   **extra},
    }
    if trace:
        out["breakdown"] = {
            "device_ops": [[n[:_NAME], s] for n, s, _ in
                           traced.trace.by_name()[:10]],
            "idle_gaps": [[n, s] for n, s in
                          traced.trace.idle_by_stage()[:10]]}
    for a in answers:
        if a.error is not None:
            log(f"failed: {a.query} set {a.set_index}: {a.error}")
    out["checks"] = checks
    # last, once the references and the metric readers have run too
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return None
    return out


def _by_query(answers) -> str:
    lat: Dict[str, list] = {}
    for a in answers:
        if a.error is None:
            lat.setdefault(a.query, []).append(a.latency_ms)
    return ", ".join(f"{q} {len(v)} {sorted(v)[len(v) // 2]:.3f} "
                     f"{max(v):.3f}" for q, v in sorted(lat.items()))


def _answered(part: stream.Part) -> int:
    return sum(a.error is None for a in part.answers)


def _read(kind: str, metrics: List[dict], rec) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        v = reader(kind, m["name"])(rec)
        if v is None or (isinstance(v, float) and not math.isfinite(v)):
            log(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def emit(out: dict) -> None:
    """The check lines last on standard error, the result line last on
    standard output."""
    for line in check.report_lines(out["checks"]):
        log(line)
    print(json.dumps(out), flush=True)
