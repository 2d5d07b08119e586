"""The port's temporal rounding against the JAX package's: floor, ceil and
round for every unit with multiples 1 and 3, on date32, date64,
timestamp(s/ms/us/ns) and time32/time64, with values before 1970; each
flag (week_starts_monday, ceil_is_strictly_greater,
calendar_based_origin); UTC, a fixed offset and a named zone. Values
and validity bit for bit."""
import numpy as np
import pytest
import torch

from arrow_go_tpu.compute import temporal as jtemp
from arrow_go_tpu.compute.errors import ArrowInvalid as JaxInvalid

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute import temporal
from test_torch_types import jax_column, port_column, same_column

UNITS = ["nanosecond", "microsecond", "millisecond", "second", "minute",
         "hour", "day", "week", "month", "quarter", "year"]
TYPES = [dt.date32, dt.date64, dt.timestamp("s"), dt.timestamp("ms"),
         dt.timestamp("us"), dt.timestamp("ns"), dt.time32("s"),
         dt.time32("ms"), dt.time64("us"), dt.time64("ns")]
MODES = ("floor_temporal", "ceil_temporal", "round_temporal")
SPAN_NS = 3 * 10 ** 18          # about +-95 years around 1970


def tick_ns(t) -> int:
    if t == dt.date32:
        return 86_400 * 10 ** 9
    if t == dt.date64:
        return 10 ** 6
    return 10 ** 9 // t.unit.multiplier


def temporal_values(t, n: int, rng) -> np.ndarray:
    """n values of t: before and after 1970 for dates and timestamps,
    within a day for times; some on unit boundaries."""
    tick = tick_ns(t)
    if t.id in (dt.TypeId.TIME32, dt.TypeId.TIME64):
        span = 86_400 * 10 ** 9 // tick
        v = rng.integers(0, span, n)
    else:
        span = SPAN_NS // tick
        v = rng.integers(-span, span, n)
    v[:4] = [0, -1, 1, span // 7]
    v[4:12] = v[4:12] // max(3_600 * 10 ** 9 // tick, 1) * max(
        3_600 * 10 ** 9 // tick, 1)            # whole hours
    return v.astype(t.np_dtype)


def _both(t, unit, multiple, mode, flags, n=64, seed=0):
    rng = np.random.default_rng(seed)
    v = temporal_values(t, n, rng)
    mask = rng.random(n) < 0.9
    outcomes = []
    for fn, col in ((getattr(jtemp, mode), jax_column(v, mask, t)),
                    (getattr(temporal, mode), port_column(v, mask, t))):
        try:
            outcomes.append(fn(col, multiple=multiple, unit=unit, **flags))
        except (JaxInvalid, pc.ArrowInvalid) as e:
            outcomes.append(e)
    return outcomes


def _check(want, got):
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__, (want, got)
        return
    assert not isinstance(got, Exception), got
    same_column(got, want)


@pytest.mark.parametrize("multiple", [1, 3])
@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("t", TYPES, ids=str)
def test_rounding_matches_jax(t, unit, multiple):
    for mode in MODES:
        _check(*_both(t, unit, multiple, mode, {}))


FLAGS = [{"week_starts_monday": False}, {"ceil_is_strictly_greater": True},
         {"calendar_based_origin": True}]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: next(iter(f)))
@pytest.mark.parametrize("unit", ["minute", "hour", "day", "week",
                                  "month"])
@pytest.mark.parametrize("t", [dt.date32, dt.timestamp("ms"),
                               dt.timestamp("ns")], ids=str)
def test_rounding_flags_match_jax(t, unit, flags):
    for mode in MODES:
        _check(*_both(t, unit, 2, mode, flags, seed=1))


@pytest.mark.parametrize("tz", ["UTC", "+05:30", "-08:00",
                                "America/New_York"])
@pytest.mark.parametrize("unit", ["hour", "day", "week", "month",
                                  "quarter", "year"])
def test_rounding_in_a_zone_matches_jax(unit, tz):
    t = dt.timestamp("ms", tz)
    for mode in MODES:
        for flags in ({}, {"calendar_based_origin": True}):
            if tz[0] not in "+-U" and unit == "hour" and not flags:
                continue      # a named zone's hour has no offset to apply
            _check(*_both(t, unit, 1, mode, flags, n=40, seed=2))


def test_named_zone_result_returns_to_the_column_device():
    v = np.array([1_700_000_000_000, -86_400_000 * 400], np.int64)
    col = port_column(v, None, dt.timestamp("ms", "America/New_York"))
    out = temporal.floor_temporal(col, unit="day")
    assert out.values.device == col.values.device
    assert out.values.dtype == col.values.dtype


@pytest.mark.parametrize("bad", [{"unit": "fortnight"}, {"multiple": 0}])
def test_bad_arguments_raise_as_jax(bad):
    _check(*_both(dt.timestamp("s"), bad.get("unit", "day"),
                  bad.get("multiple", 1), "floor_temporal", {}))


def test_a_non_temporal_column_raises_as_jax():
    v = np.arange(5, dtype=np.int64)
    with pytest.raises(JaxInvalid):
        jtemp.floor_temporal(jax_column(v, None, dt.int64))
    with pytest.raises(pc.ArrowInvalid):
        temporal.floor_temporal(port_column(v, None, dt.int64))


# ---------------------------------------------------------------------------
# host input: a HostArray or a ChunkedArray moves to the device and the
# result is a DeviceColumn there, as the JAX package's is
# (tests/test_temporal.py:_ours_vs_oracle)
# ---------------------------------------------------------------------------

def _host_both(t, form, n=90, seed=3):
    import arrow_go_tpu as jagt
    import arrow_go_tpu_torch as tagt
    from test_torch_types import jax_type
    rng = np.random.default_rng(seed)
    v = temporal_values(t, n, rng)
    mask = rng.random(n) < 0.9
    ja = jagt.from_numpy(v, mask, jax_type(t))
    ta = tagt.from_numpy(v, mask, t)
    if form == "chunked":
        cuts = [(0, 40), (40, 41), (41, n)]
        ja = jagt.ChunkedArray([ja.slice(a, b - a) for a, b in cuts])
        ta = tagt.ChunkedArray([ta.slice(a, b - a) for a, b in cuts])
    return ja, ta


@pytest.mark.parametrize("form", ["array", "chunked"])
@pytest.mark.parametrize("unit", ["second", "hour", "day", "week", "month",
                                  "year"])
@pytest.mark.parametrize("t", [dt.date32, dt.timestamp("ms"),
                               dt.timestamp("us", "UTC"),
                               dt.timestamp("s", "+05:30")], ids=str)
def test_host_input_rounds_on_the_device_as_jax(t, unit, form,
                                                monkeypatch):
    from arrow_go_tpu_torch import torchenv
    from arrow_go_tpu_torch.device.block import DeviceColumn
    ja, ta = _host_both(t, form)
    for mode in MODES:
        want = getattr(jtemp, mode)(ja, multiple=2, unit=unit)
        got = getattr(pc, mode)(ta, multiple=2, unit=unit, device="cpu")
        assert isinstance(got, DeviceColumn)
        same_column(got, want)
    # without `device`, the port's default device: the card, here mapped
    # to the CPU as a test may
    monkeypatch.setattr(torchenv, "device",
                        lambda dev=None: torch.device("cpu"))
    same_column(pc.floor_temporal(ta, unit=unit),
                jtemp.floor_temporal(ja, unit=unit))


def test_host_input_without_a_device_needs_the_card(monkeypatch):
    _, ta = _host_both(dt.date32, "array")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.floor_temporal(ta, unit="month")


def test_host_input_through_the_registry_matches_jax():
    import arrow_go_tpu.compute as jpc
    ja, ta = _host_both(dt.timestamp("ms"), "chunked")
    opts = {"unit": "minute", "multiple": 15}
    want = jpc.call_function("round_temporal", [ja], opts)
    got = pc.call_function("round_temporal", [ta], opts, device="cpu")
    assert got.to_pylist() == want.to_pylist()
