"""The port's spans and counters (utils/metrics.py) on the CPU: spans
nest with their parents, are on while enabled or while a torch profiler
records and are one shared no-op otherwise; a long profile holds at most
`max_records` records; the host read and sort counts of a group-by and
of a join are exact; the kernel counters stay put on the plain versions;
the kernels' least-byte models give PERF.md's bounds; many threads lose
no count."""
import importlib
import sys
import threading

import numpy as np
import pytest
import torch

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch.device.block import batch_to_device, pad_length
from arrow_go_tpu_torch.ops import compaction, reductions, scan
from arrow_go_tpu_torch.utils.metrics import Metrics, metrics, trace

# the module (the package's `metrics` name is the registry)
metrics_mod = importlib.import_module("arrow_go_tpu_torch.utils.metrics")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM (data sheet), PERF.md's bounds


@pytest.fixture
def reg():
    """The process's registry, emptied and enabled for the test."""
    metrics.reset()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.disable()
        metrics.reset()


def _batches(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    db = batch_to_device({"a": rng.integers(0, 5, n),
                          "b": rng.integers(0, 3, n),
                          "c": rng.integers(0, 2, n),
                          "v": rng.normal(size=n)}, device="cpu")
    dim = batch_to_device({"k": np.arange(5), "w": np.arange(5) * 10},
                          device="cpu")
    return db, dim


def _ops(snap):
    return [r for r in snap.spans if r.kind != "count"]


def test_spans_nest_with_their_parents(reg):
    with reg.span("a", rows=3):
        with reg.span("b"):
            with reg.span("c"):
                pass
            with reg.span("d"):
                pass
    with reg.span("e"):
        pass
    spans = reg.snapshot().spans
    by = {r.name: (i, r) for i, r in enumerate(spans)}
    parent = {name: (spans[r.parent].name if r.parent >= 0 else None)
              for name, (_, r) in by.items()}
    assert parent == {"a": None, "b": "a", "c": "b", "d": "b", "e": None}
    a = by["a"][1]
    assert a.rows == 3 and a.kind == "op" and a.device_ms is None
    for name, (_, r) in by.items():
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = spans[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_disabled_spans_record_nothing_and_open_no_range(monkeypatch):
    m = Metrics()

    def no_range(*a, **k):
        raise AssertionError("a disabled span opened a profiler range")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not m.recording
    s = m.span("x", rows=5, device=torch.device("cpu"))
    assert s is m.span("y") is m.time_op("z")
    with s, m.time_op("z", rows=2):
        m.sort(10, 2)
        assert m.host_read(torch.tensor(7), "site") == 7
    snap = m.snapshot()
    assert snap.spans == [] and snap.ops == {}
    # the counters count all the same
    assert m.counter("sort").total == 20
    assert m.counter("host_read.site").count == 1


def test_trace_enables_and_restores(tmp_path):
    """Spans record inside trace() and stop after it; `enabled` is the
    caller's throughout."""
    m = metrics
    m.reset()
    was = m.enabled
    try:
        for before in (False, True):
            m.enabled = before
            with trace("t", log_dir=str(tmp_path), device="cpu"):
                assert m.recording and m.enabled is before
                with m.span("in_trace"):
                    pass
            assert m.recording is before and m.enabled is before
        assert [r.name for r in m.snapshot().spans] == ["in_trace"] * 2
        assert (tmp_path / "t.json").exists()
    finally:
        m.enabled = was
        m.reset()


def test_a_long_profile_holds_at_most_max_records():
    """Under a profiler, with no reset, the records stop at
    `max_records`; the spans past it are counted in `dropped`, and the
    counters and call stats still count every event."""
    from torch.profiler import ProfilerActivity, profile
    m = Metrics()
    m.max_records = 10
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(40):
            with m.span("op"):
                m.sort(4)
                with m.time_op("call", rows=2):
                    pass
    snap = m.snapshot()
    assert len(snap.spans) == 10 and m.dropped == 110
    assert len(m._pending) == 0
    assert snap.counters["sort"].count == 40
    assert snap.ops["call"].calls == 40 and snap.ops["call"].rows == 80
    # a span past the cap still nests its children under nothing kept
    assert all(r.parent < len(snap.spans) for r in snap.spans)
    m.reset()
    assert m.dropped == 0
    m.enable()
    with m.span("again"):
        pass
    assert [r.name for r in m.snapshot().spans] == ["again"]


def test_record_adds_a_call_as_the_jax_registry_does():
    m = Metrics()
    m.record("sum", 0.5, rows=10)
    m.record("sum", 0.25)
    st = m.snapshot().ops["sum"]
    assert (st.calls, st.total_s, st.rows) == (2, 0.75, 10)
    assert st.mean_ms == 375.0
    assert m.snapshot().spans == []


def test_a_profiler_turns_spans_on_with_its_clock():
    """Under torch.profiler the spans record with no enable(), and the
    profiler's copy of a span starts on the span's clock."""
    from torch.profiler import ProfilerActivity, profile
    metrics.reset()
    db, dim = _batches()
    assert not metrics.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert metrics.recording
        pc.group_by(db, ["a", "b"], [("v", "sum")])
    assert not metrics.recording
    spans = metrics.snapshot().spans
    metrics.reset()
    ours = {r.name: r for r in spans if r.kind == "op"}
    assert set(ours) == {"group_by", "group_by.program", "group_by.to_host"}
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("agt.")}
    assert {"agt.group_by", "agt.group_by.program", "agt.group_by.to_host",
            "agt.host_read.group_count"} <= set(kineto)
    assert not any(":" in name for name in kineto)
    for name, r in ours.items():
        # the span's stamp is taken just before its range opens; a CPU
        # test host is shared, so the bound is loose here (the card's
        # check is 50 us)
        off_us = (kineto[f"agt.{name}"].start_ns() - r.start_ns) / 1e3
        assert 0 <= off_us < 20_000, (name, off_us)


def test_group_by_host_reads_and_sorts_are_exact(reg, monkeypatch):
    """A 3-key group-by with one sum: the group count, each key's values
    and validity words, the sum and its validity (9 reads); its sorts
    are each key's encode (a validity flag and the key: 2 passes), the
    combined key's encode (2 passes) and the first-occurrence argsort
    (1 pass), every one over the padded rows."""
    db, _ = _batches()
    P = pad_length(1000)
    sorted_rows = _count_sorts(monkeypatch)
    g = pc.group_by(db, ["a", "b", "c"], [("v", "sum")])
    assert g.num_rows == 30
    snap = reg.snapshot()
    reads = [r.name for r in snap.spans if r.kind == "host_read"]
    assert reads == ["group_count"] + ["group_keys",
                                       "group_key_validity"] * 3 + [
        "group_values", "group_validity"]
    assert snap.counters["sort"].count == 5
    assert snap.counters["sort"].total == 3 * 2 * P + 2 * P + P
    assert snap.counters["sort"].total == sum(sorted_rows)
    assert sum(r.amount for r in snap.spans if r.kind == "count"
               and r.name == "sort") == snap.counters["sort"].total
    assert {r.name for r in _ops(snap) if r.kind == "op"} == {
        "group_by", "group_by.program", "group_by.to_host"}
    for r in snap.spans:
        if r.kind == "host_read":
            assert snap.spans[r.parent].name == "group_by.to_host"
        if r.kind == "count":
            assert snap.spans[r.parent].name == "group_by.program"


def test_hash_join_host_reads_and_sorts_are_exact(reg, monkeypatch):
    """One inner join: one host read (the pair count); the key encode
    (flag and key) and the sorted state (flag and key) each sort both
    sides' padded rows in 2 passes."""
    db, dim = _batches()
    PL, PR = pad_length(1000), pad_length(5)
    sorted_rows = _count_sorts(monkeypatch)
    j = pc.hash_join(db, dim, left_keys=["a"], right_keys=["k"])
    assert j.length == 1000
    snap = reg.snapshot()
    assert [(r.name, snap.spans[r.parent].name) for r in snap.spans
            if r.kind == "host_read"] == [("join_size",
                                           "hash_join.size_read")]
    assert snap.counters["host_read.join_size"].total == 8
    assert snap.counters["sort"].count == 2
    assert snap.counters["sort"].total == 2 * 2 * (PL + PR) == \
        sum(sorted_rows)
    phases = [r.name for r in snap.spans if r.kind == "op"]
    assert phases == ["hash_join", "hash_join.key_codes",
                      "hash_join.sorted_state", "hash_join.size_read",
                      "hash_join.expand", "hash_join.emit"]
    assert all(snap.spans[r.parent].name == "hash_join"
               for r in snap.spans if r.kind == "op" and r.parent >= 0)


def _count_sorts(monkeypatch):
    """Rows each torch.sort / torch.argsort call sorts, from here on; K1's
    plain version (a CPU stand-in for the kernel, no device sort on the
    card) takes its rows by masks instead, so that every sort counted
    is one the card runs."""
    rows = []
    sort, argsort = torch.sort, torch.argsort

    def counted_sort(x, *a, **k):
        rows.append(x.shape[0])
        return sort(x, *a, **k)

    def counted_argsort(x, *a, **k):
        rows.append(x.shape[0])
        return argsort(x, *a, **k)

    def compact_plain(keep, payloads):
        order = torch.cat([torch.nonzero(keep).flatten(),
                           torch.nonzero(~keep).flatten()])
        return tuple(p.index_select(0, order) for p in payloads)
    monkeypatch.setattr(torch, "sort", counted_sort)
    monkeypatch.setattr(torch, "argsort", counted_argsort)
    monkeypatch.setattr(compaction, "compact_flagged_plain", compact_plain)
    return rows


def test_semi_verdict_and_operators_are_spans(reg):
    db, dim = _batches()
    from arrow_go_tpu_torch.compute.join import semi_verdict
    v = semi_verdict(db, dim, ["a"], ["k"], "left semi")
    mask = pc.execute_scalar_expression(pc.field("v") > 0, db)
    f = pc.filter(db, mask)
    idx = pc.sort_indices(f, pc.SortOptions([pc.SortKey("v")]))
    pc.take(f, idx)
    names = [r.name for r in reg.snapshot().spans if r.kind == "op"]
    assert names == ["semi_verdict", "execute_scalar_expression", "filter",
                     "sort_indices", "take"]
    assert bool(v[:1000].all())
    reads = [r.name for r in reg.snapshot().spans if r.kind == "host_read"]
    assert reads == ["filter_count", "take_bounds"]


def test_kernel_counters_stay_put_on_the_plain_versions(reg):
    before = {k: metrics.counter(f"kernel.{k}") for k in ("K1", "K2", "K3")}
    db, dim = _batches()
    pc.group_by(db, ["a", "b"], [("v", "sum"), ("v", "min")])
    pc.hash_join(db, dim, left_keys=["a"], right_keys=["k"],
                 join_type="full outer")
    keep = torch.tensor([True, False, True])
    compaction.compact_flagged(keep, (torch.arange(3),))
    scan.cummax_u64_lanes(torch.arange(3), [torch.arange(3)])
    reductions.reduce_with_count_host(torch.arange(3.0), None, 3, "sum")
    after = {k: metrics.counter(f"kernel.{k}") for k in ("K1", "K2", "K3")}
    assert after == before
    assert all(c.count == 0 for c in after.values())
    assert not [r for r in reg.snapshot().spans
                if r.name.startswith("kernel.")]


@pytest.mark.parametrize("kernel, shape, bound_ms", [
    # PERF.md's kernel table: K1 at Q3's filter (2**26 padded rows, three
    # 8-byte payloads), K2 at the Q3 expansion (2 lo lanes), K3's f64 sum
    # and its int32 min with validity words over SF10 lineitem
    ("K1", (1 << 26, (8, 8, 8)), 0.9816),
    ("K2", (33_554_432, 2), 0.4808),
    ("K3", (59_986_052, torch.float64, False), 0.1433),
    ("K3", (59_986_052, torch.int32, True), 0.0739),
])
def test_least_bytes_give_the_bounds_of_perf_md(kernel, shape, bound_ms):
    meta = torch.device("meta")
    if kernel == "K1":
        n, sizes = shape
        dtypes = {1: torch.int8, 4: torch.int32, 8: torch.int64}
        nbytes = compaction.least_bytes(
            torch.empty(n, dtype=torch.bool, device=meta),
            [torch.empty(n, dtype=dtypes[s], device=meta) for s in sizes])
    elif kernel == "K2":
        nbytes = scan.least_bytes(*shape)
    else:
        n, dtype, words = shape
        nbytes = reductions.least_bytes(
            torch.empty(n, dtype=dtype, device=meta),
            torch.empty(-(-n // 32), dtype=torch.int32, device=meta)
            if words else None, n)
    assert round(nbytes / HBM_BYTES_PER_S * 1e3, 4) == bound_ms


def test_counters_record_while_spans_are_on_and_reset_drops_them(reg):
    reg.kernel("K9", 100)
    reg.sort(10, 3)
    with reg.span("s"):
        reg.kernel("K8", 5)
    snap = reg.snapshot()
    counts = [(r.name, r.amount, r.parent) for r in snap.spans
              if r.kind == "count"]
    assert counts == [("kernel.K9", 100, -1), ("sort", 30, -1),
                      ("kernel.K8", 5, 2)]
    assert snap.counters["kernel.K9"].count == 1
    text = reg.report()
    assert "device ms" in text and "rows/s" not in text
    assert "op:s" in text and "kernel.K9" in text
    reg.reset()
    snap = reg.snapshot()
    assert snap.spans == [] and snap.counters == {} and snap.ops == {}


def test_host_read_gives_numbers_and_arrays(reg):
    assert reg.host_read(torch.tensor(3), "a") == 3
    assert reg.host_read(torch.tensor(True), "b") is True
    arr = reg.host_read(torch.arange(4, dtype=torch.int32), "c")
    assert isinstance(arr, np.ndarray) and arr.tolist() == [0, 1, 2, 3]
    snap = reg.snapshot()
    assert [(r.name, r.rows, r.amount) for r in snap.spans] == [
        ("a", 1, 8), ("b", 1, 1), ("c", 4, 16)]
    assert snap.counters["host_read.c"].total == 16


def test_threads_lose_no_count_and_keep_their_own_parents():
    m = Metrics()
    m.enable()
    n_threads, n_iter = 12, 300
    errors = []

    def work(k):
        try:
            for _ in range(n_iter):
                with m.span(f"outer{k}"):
                    m.sort(2, 1)
                    with m.span(f"inner{k}"):
                        m.kernel(f"K{k}", 3)
        except Exception as e:        # noqa: BLE001 - reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    snap = m.snapshot()
    assert snap.counters["sort"].count == n_threads * n_iter
    assert snap.counters["sort"].total == 2 * n_threads * n_iter
    assert sum(c.total for key, c in snap.counters.items()
               if key.startswith("kernel.")) == 3 * n_threads * n_iter
    assert len(snap.spans) == 4 * n_threads * n_iter
    for r in snap.spans:
        if r.name.startswith("outer"):
            assert r.parent == -1
            continue
        p = snap.spans[r.parent]
        if r.name.startswith("inner"):
            assert p.name == f"outer{r.name[5:]}"
        elif r.name == "sort":
            assert p.name.startswith("outer")
        else:                         # kernel.K<k> inside inner<k>
            assert p.name == f"inner{r.name[8:]}"


def test_the_module_names_no_removed_fields():
    src = open(metrics_mod.__file__).read()
    assert "rows_per_s" not in src and "nbytes" not in src
    assert not hasattr(metrics_mod.OpStats(), "bytes")
    assert not hasattr(compaction.compact_flagged, "launches")
    assert not hasattr(scan.cummax_u64_lanes, "launches")
    assert not hasattr(reductions.reduce, "launches")
