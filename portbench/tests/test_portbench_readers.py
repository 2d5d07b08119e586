"""The metric readers on records made by hand."""
import math

import pytest

from portbench.harness.cell import Traced, Window
from portbench.harness.profile import DeviceTrace
from portbench.harness.spec import reader
from portbench.harness.stream import Answer


def _window(lat, window_s=2.0, setup_s=30.0):
    answers = [Answer("q", 0, 0.0, latency_ms=x) for x in lat]
    answers.append(Answer("q", 0, 0.0, error="planted"))
    return Window(answers, window_s, setup_s)


def test_end_to_end_readers():
    w = _window([10.0, 20.0, 40.0, 80.0])
    assert reader("e2e_metrics", "queries_per_s")(w) == 2.0
    assert reader("e2e_metrics", "query_ms_geomean")(w) == pytest.approx(
        math.sqrt(20.0 * 40.0))
    assert reader("e2e_metrics", "query_ms_p95")(w) == pytest.approx(74.0)
    assert reader("e2e_metrics", "setup_s")(w) == 30.0


def _traced(ops, marks=(), k1=(), wall_s=1.0, spans=(), sq=4, pq=2):
    tr = DeviceTrace(list(ops), list(marks), wall_s, list(k1))
    return Traced(list(spans), sq, tr, pq)


def test_busy_is_the_union_of_intervals():
    t = _traced([("a", 0.0, 100.0), ("b", 50.0, 100.0),
                 ("c", 300.0, 100.0)], wall_s=1e-3)
    assert t.trace.busy_s == pytest.approx(250e-6)
    assert reader("layer_metrics", "device_idle_share")(t) == \
        pytest.approx(75.0)


def test_idle_gaps_named_by_the_open_stage():
    marks = [("q3:other", 0.0, 1000.0), ("q3:hash_join", 100.0, 400.0),
             ("q4:other", 1100.0, 2000.0)]
    ops = [("k", 0.0, 100.0), ("k", 300.0, 100.0), ("k", 1050.0, 10.0),
           ("k", 1200.0, 10.0)]
    gaps = dict(_traced(ops, marks).trace.idle_by_stage())
    assert gaps["q3:hash_join"] == pytest.approx(200e-6)
    assert gaps["q3:other"] == pytest.approx(650e-6)
    assert gaps["harness"] == pytest.approx(140e-6)


def test_span_readers():
    spans = [("q3", "hash_join", 30.0), ("q3", "group_by", 10.0),
             ("q4", "hash_join", 10.0)]
    t = _traced([], spans=spans, sq=4)
    assert reader("layer_metrics", "hash_join_ms_per_query")(t) == 10.0
    assert reader("layer_metrics", "group_by_ms_per_query")(t) == 2.5
    assert reader("layer_metrics", "hash_join_ms_per_query")(
        _traced([], spans=[("q6", "filter", 1.0)])) is None


def test_sort_reader():
    ops = [("void cub::DeviceRadixSortOnesweepKernel<...>", 0.0, 300.0),
           ("at::native::bitonicSortKVInPlace", 400.0, 100.0),
           ("scatter_kernel", 600.0, 50.0)]
    assert reader("layer_metrics", "sort_device_ms_per_query")(
        _traced(ops, pq=2)) == pytest.approx(0.2)


def test_k1_roofline():
    rows = 1_000_000
    least = (rows + 2 * rows * (8 + 4)) / 3.35e12
    ops = [("count_kernel(unsigned char const*, long long)", 0.0,
            least * 0.25e6),
           ("scatter_kernel(unsigned char const*, long long)", 10.0,
            least * 0.75e6 * 3)]
    t = _traced(ops, k1=[("filter_batch", rows, [8, 4])])
    assert reader("layer_metrics", "k1_roofline_share")(t) == \
        pytest.approx(100.0 / 2.5)


def test_k1_roofline_refuses_a_missed_call_site():
    ops = [("scatter_kernel", 0.0, 10.0), ("scatter_kernel", 20.0, 10.0)]
    t = _traced(ops, k1=[("filter_batch", 1000, [8])])
    assert reader("layer_metrics", "k1_roofline_share")(t) is None
    assert "not reported" in t.notes[-1]
