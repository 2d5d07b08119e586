"""The readers of the port's own spans and counters, on records made by
hand, on a tree without them, and in a traced run on the CPU; and the
profiled trace, whose device-side copies of the port's ranges are no
device activity."""
import pytest
import torch

from arrow_go_tpu_torch.utils.metrics import SpanRecord, Snapshot
from portbench.harness import profile
from portbench.harness.cell import Traced
from portbench.harness.profile import DeviceTrace
from portbench.harness.spec import reader

NEW = ("hash_join_span_ms_per_query", "group_by_span_ms_per_query",
       "sorted_rows_per_query", "host_reads_per_query",
       "program_idle_ms_per_query", "k2_roofline_share")
US = 1_000          # ns in a microsecond


def _traced(spans, ops=(), pq=2, wall_s=1.0):
    t = Traced([], 0, DeviceTrace(list(ops), [], wall_s, []), pq)
    t.program = Snapshot(spans=list(spans))
    return t


def _op(name, start_us, end_us, parent=-1, ms=None, kind="op", amount=0):
    return SpanRecord(name, kind, start_us * US, end_us * US, parent,
                      amount=amount, device_ms=ms)


def test_join_and_group_by_spans_count_the_outermost_only():
    spans = [_op("hash_join", 0, 100, ms=30.0),              # 0
             _op("hash_join.key_codes", 1, 20, 0, ms=10.0),  # 1
             _op("semi_verdict", 200, 300, ms=6.0),          # 2
             _op("hash_join", 400, 500, ms=None),            # 3: no events
             _op("group_by", 600, 700, ms=4.0),              # 4
             _op("hash_join", 610, 620, 4, ms=1.0),          # 5: inside
             _op("group_by", 800, 900, ms=2.0)]
    t = _traced(spans, pq=4)
    assert reader("layer_metrics", "hash_join_span_ms_per_query")(t) == \
        pytest.approx((30.0 + 6.0 + 1.0) / 4)
    assert "hash_join phases, stream ms per query: hash_join.key_codes " \
        "2.500" in t.notes
    assert reader("layer_metrics", "group_by_span_ms_per_query")(t) == \
        pytest.approx(6.0 / 4)
    nested = [_op("hash_join", 0, 100, ms=30.0),
              _op("hash_join", 10, 20, 0, ms=10.0)]
    assert reader("layer_metrics", "hash_join_span_ms_per_query")(
        _traced(nested, pq=1)) == 30.0
    assert reader("layer_metrics", "hash_join_span_ms_per_query")(
        _traced([_op("filter", 0, 1, ms=1.0)])) is None


def test_sorted_rows_and_host_reads_per_query():
    spans = [_op("group_by", 0, 100),
             _op("sort", 5, 5, 0, kind="count", amount=2048),
             _op("sort", 6, 6, 0, kind="count", amount=1024),
             _op("group_count", 50, 51, 0, kind="host_read", amount=8),
             _op("group_keys", 52, 53, 0, kind="host_read", amount=80),
             _op("kernel.K1", 7, 7, 0, kind="count", amount=99)]
    t = _traced(spans, pq=2)
    # the stream's mark around each query instance
    t.trace.marks = [("q3:other", 0.0, 60.0), ("q3:group_by", 0.0, 60.0),
                     ("q4:other", 51.5, 200.0)]
    assert reader("layer_metrics", "sorted_rows_per_query")(t) == 1536.0
    assert reader("layer_metrics", "host_reads_per_query")(t) == 1.0
    assert any("group_count 0.500" in n for n in t.notes)
    assert "host reads per instance by query: q3 1.000 (n 1), " \
        "q4 1.000 (n 1)" in t.notes
    assert "sorted rows x passes per instance by query: q3 3072.000 " \
        "(n 1), q4 0.000 (n 1)" in t.notes
    none = _traced([_op("filter", 0, 1)])
    assert reader("layer_metrics", "sorted_rows_per_query")(none) is None
    assert reader("layer_metrics", "host_reads_per_query")(none) is None


def test_program_idle_names_the_innermost_open_span():
    spans = [_op("group_by", 100, 1000),                            # 0
             _op("group_by.program", 100, 400, 0),                  # 1
             _op("sort", 150, 150, 1, kind="count", amount=10),     # 2
             _op("group_by.to_host", 400, 1000, 0),                 # 3
             _op("group_count", 450, 600, 3, kind="host_read"),     # 4
             _op("group_keys", 700, 720, 3, kind="host_read")]      # 5
    ops = [("k", 0.0, 120.0),      # busy to 120
           ("k", 200.0, 100.0),    # gap 120-200 in group_by.program
           ("k", 500.0, 10.0),     # gap 300-500: opens in .program
           ("k", 800.0, 10.0),     # gap 510-800: host_read.group_count
           ("k", 1200.0, 10.0)]    # gap 810-1200: .to_host, then none
    t = _traced(spans, ops, pq=2)
    got = reader("layer_metrics", "program_idle_ms_per_query")(t)
    # 80 + 200 + 290 + 390 us of idle, all opening under a span
    assert got == pytest.approx((80 + 200 + 290 + 390) / 1e3 / 2)
    from portbench.harness import program
    idle = program.idle_by_span(spans, ops)
    assert idle == pytest.approx({"group_by.program": 280e-6,
                                  "host_read.group_count": 290e-6,
                                  "group_by.to_host": 390e-6})
    # a gap that opens after every span closed counts for none
    late = ops + [("k", 1500.0, 10.0)]
    assert program.idle_by_span(spans, late) == pytest.approx(idle)
    assert reader("layer_metrics", "program_idle_ms_per_query")(
        _traced(spans, [], pq=2)) is None


def test_k2_share_needs_every_launch_counted():
    k2 = [_op("kernel.K2", i, i, kind="count", amount=1_675_000_000)
          for i in range(2)]
    ops = [("void cummax_kernel<2>(Lanes, long long)", 0.0, 1000.0),
           ("void cummax_kernel<0>(Lanes, long long)", 2000.0, 1000.0),
           ("scatter_kernel", 3000.0, 50.0)]
    t = _traced(k2, ops)
    # 3.35e9 bytes at 3.35e12 B/s is 1 ms; the kernels took 2 ms
    assert reader("layer_metrics", "k2_roofline_share")(t) == \
        pytest.approx(50.0)
    short = _traced(k2[:1], ops)
    assert reader("layer_metrics", "k2_roofline_share")(short) is None
    assert any("not reported" in n for n in short.notes)
    assert reader("layer_metrics", "k2_roofline_share")(
        _traced(k2, ops[2:])) is None


@pytest.mark.parametrize("name", NEW)
def test_a_tree_without_the_port_spans_reads_nothing(name, monkeypatch):
    """The parent's registry snapshots a dict of call stats and keeps no
    records: every new reader gives None and raises nothing."""
    from arrow_go_tpu_torch.utils import metrics as registry
    monkeypatch.setattr(registry, "snapshot", lambda: {})
    t = Traced([], 0, DeviceTrace([("cummax_kernel", 0.0, 1.0)], [], 1.0,
                                  []), 3)
    assert reader("layer_metrics", name)(t) is None
    empty = _traced([])
    assert reader("layer_metrics", name)(empty) is None


class _Event:
    def __init__(self, name, cuda, mark, start_us, dur_us):
        from torch.autograd import DeviceType
        self._v = (name, DeviceType.CUDA if cuda else DeviceType.CPU, mark,
                   int(start_us * 1e3), int(dur_us * 1e3))

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def is_user_annotation(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def _fake_profile(events):
    class _Results:
        def events(self):
            return events

    class _Prof:
        def __init__(self, activities=None):
            self.profiler = type("P", (), {"kineto_results": _Results()})()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False
    return _Prof


def test_device_copies_of_the_port_ranges_are_no_device_activity(
        monkeypatch):
    """A range of the port's shows in the trace as a host range and as
    its device-side copy, a CUDA event that kineto flags as a user
    annotation (seen on the H100 with PyTorch 2.11): the profiled trace
    keeps neither, so busy time, idle gaps and the idle share read the
    same as without them."""
    base = [_Event("q3:group_by", False, True, 0.0, 1000.0),
            _Event("q3:group_by", True, True, 10.0, 900.0),
            _Event("kernel_a", True, False, 10.0, 100.0),
            _Event("kernel_b", True, False, 400.0, 100.0),
            _Event("kernel_c", True, False, 800.0, 110.0)]
    port = [_Event("agt.group_by", False, True, 5.0, 990.0),
            _Event("agt.group_by", True, True, 10.0, 900.0),
            _Event("agt.host_read.group_count", False, True, 200.0, 150.0),
            _Event("agt.sort_indices", True, True, 400.0, 100.0)]
    traces = []
    for events in (base, base + port):
        monkeypatch.setattr(torch.profiler, "profile",
                            _fake_profile(events))
        _, tr = profile.profiled(lambda: None)
        tr.wall_s = 1e-3
        traces.append(tr)
    plain, ported = traces
    assert ported.ops == plain.ops
    assert [o[0] for o in ported.ops] == ["kernel_a", "kernel_b",
                                          "kernel_c"]
    assert ported.marks == plain.marks
    assert ported.busy_s == plain.busy_s
    assert ported.idle_by_stage() == plain.idle_by_stage()
    share = reader("layer_metrics", "device_idle_share")
    t_plain = Traced([], 0, plain, 1)
    t_ported = Traced([], 0, ported, 1)
    assert share(t_ported) == share(t_plain)
    assert reader("layer_metrics", "sort_device_ms_per_query")(
        t_ported) is None


def test_a_traced_run_on_the_cpu_reads_the_port_counts():
    """Under the CPU profiler the port records its spans with no switch
    in the harness: the counts read, the device times do not (no CUDA
    events, no device trace)."""
    from arrow_go_tpu_torch.utils.metrics import metrics
    from portbench.harness import cell as runner
    from portbench.tests.conftest import small_cell
    metrics.reset()
    c = small_cell("tpch-sf10.agg")
    out = runner.run_cell(c, 2 ** 31 + 11, 0.6, True, device="cpu")
    assert out["correct"] is True
    got = out["metrics"]
    assert got["host_reads_per_query"]["unit"] == "reads"
    assert got["host_reads_per_query"]["value"] > 1
    assert got["sorted_rows_per_query"]["value"] > 0
    for name in ("group_by_span_ms_per_query", "program_idle_ms_per_query",
                 "k2_roofline_share", "hash_join_span_ms_per_query"):
        assert name not in got
    assert not metrics.enabled
    metrics.reset()
