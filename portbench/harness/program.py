"""The port's own spans and counters (arrow_go_tpu_torch/utils/metrics.py)
as the per-layer readers see them.

The port records its spans while torch.profiler records, so after a
traced run its registry holds the records of the window's profiled part
and of nothing else: the set-up's profiled call runs no port code, and
no other part runs under the profiler. `snapshot(t)` gives them: the
`Traced` record's `program` attribute where it has one (a snapshot made
by the caller, as the tests' hand-made records carry), else the port's
registry, snapshotted once and kept on `t` for the next reader. None
where the program keeps no such records (a tree before the port's spans)
or they are empty.

A record's times are Unix ns, the clock of the profiler's events (the
DeviceTrace's microseconds).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Sequence


def snapshot(t):
    snap = getattr(t, "program", None)
    if snap is None:
        try:
            from arrow_go_tpu_torch.utils.metrics import metrics
        except ImportError:
            return None
        snap = t.program = metrics.snapshot()
        dropped = getattr(metrics, "dropped", 0)
        if dropped:
            t.log(f"the port's registry dropped {dropped} records past "
                  "its cap: the counts below are short")
    if not getattr(snap, "spans", None):
        return None
    return snap


def outermost(spans: Sequence, names) -> List:
    """The operator records named in `names` that no operator record
    named in `names` encloses."""
    out = []
    for r in spans:
        if r.kind != "op" or r.name not in names:
            continue
        p = r.parent
        while p >= 0 and not (spans[p].kind == "op"
                              and spans[p].name in names):
            p = spans[p].parent
        if p < 0:
            out.append(r)
    return out


def phases_ms(t, spans: Sequence, prefix: str) -> None:
    """Logs the stream-elapsed ms (CUDA events) per answered query of
    each phase span named `<prefix>.<phase>`."""
    acc: Dict[str, float] = {}
    for r in spans:
        if r.kind == "op" and r.name.startswith(prefix + ".") and \
                r.device_ms is not None:
            acc[r.name] = acc.get(r.name, 0.0) + r.device_ms
    if acc:
        t.log(f"{prefix} phases, stream ms per query: " + ", ".join(
            f"{k} {v / t.profile_queries:.3f}" for k, v in acc.items()))


def counted(spans: Sequence, name: str) -> List:
    """The counter events of counter `name` (kind "count")."""
    return [r for r in spans if r.kind == "count" and r.name == name]


def by_query(records: Sequence, marks: Sequence) -> Dict[str, list]:
    """{query: [instances, records, amount]}: each record counted in the
    query instance whose `<query>:other` mark (the stream's mark around
    each instance, DeviceTrace.marks) holds its start."""
    inst = sorted((s, e, name[:-len(":other")]) for name, s, e in marks
                  if name.endswith(":other"))
    starts = [s for s, _, _ in inst]
    out: Dict[str, list] = {}
    for _, _, q in inst:
        out.setdefault(q, [0, 0, 0])[0] += 1
    for r in records:
        x = r.start_ns / 1e3
        i = bisect.bisect_right(starts, x) - 1
        if i >= 0 and x <= inst[i][1]:
            acc = out[inst[i][2]]
            acc[1] += 1
            acc[2] += r.amount
    return out


def per_instance(records: Sequence, marks: Sequence, amount: bool) -> str:
    """`<query> <per instance> (n <instances>)` for each query, the
    records' count or their amount per instance."""
    return ", ".join(
        f"{q} {(a if amount else c) / n:.3f} (n {n})"
        for q, (n, c, a) in sorted(by_query(records, marks).items()))


def label(r) -> str:
    """A record's name as its profiler range has it, less `agt.`."""
    return f"host_read.{r.name}" if r.kind == "host_read" else r.name


def idle_by_span(spans: Sequence, ops: Sequence) -> Dict[str, float]:
    """Device idle seconds between the activities `ops` [(name, start_us,
    dur_us)] in start order, summed by the innermost span open at each
    gap's start (DeviceTrace.idle_by_stage's arithmetic); a gap that
    opens with no span open is left out."""
    timed = sorted((r.start_ns / 1e3, i) for i, r in enumerate(spans)
                   if r.kind != "count")
    starts = [s for s, _ in timed]
    acc: Dict[str, float] = {}
    if not ops:
        return acc
    end = ops[0][1] + ops[0][2]
    for _, s, d in ops[1:]:
        if s > end:
            r = _open_at(spans, timed, starts, end)
            if r is not None:
                acc[label(r)] = acc.get(label(r), 0.0) + (s - end) / 1e6
        end = max(end, s + d)
    return acc


def _open_at(spans, timed, starts, x: float):
    """The innermost span open at `x` (us), or None. Spans of one thread
    nest, so it is the latest-started span, or the nearest of its
    ancestors, still open at x."""
    i = bisect.bisect_right(starts, x) - 1
    j = timed[i][1] if i >= 0 else -1
    while j >= 0:
        r = spans[j]
        if r.end_ns / 1e3 > x:
            return r
        j = r.parent
    return None
