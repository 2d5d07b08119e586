"""The port's casts against the JAX package's `cast_device` and
`cast_host`: every (from, to) pair of bool, the eleven numeric types and
the temporal types, safe, with only float truncation allowed, and
unsafe, over rows holding NaN, infinities, out-of-range values,
fractions and nulls; where the JAX cast raises, the port raises the same
class. Values are compared bit for bit (float64 -> float16 included: the
port rounds once, as XLA does)."""
import importlib

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu.compute import errors as jerr
from arrow_go_tpu.device.block import DeviceColumn as JaxColumn

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.device.block import HostArray, column_to_host
from test_torch_types import (NUMERIC, jax_column, port_column,
                              same_column, values_of)
from torch_parity import jax_type

# (each package's compute namespace has a `cast` function beside the
# module of that name)
jcast = importlib.import_module("arrow_go_tpu.compute.cast")
cast = importlib.import_module("arrow_go_tpu_torch.compute.cast")

TEMPORAL = [dt.date32, dt.date64, dt.timestamp("s"), dt.timestamp("ms"),
            dt.timestamp("us", "UTC"), dt.time32("s"), dt.time64("us"),
            dt.duration("ms")]
TYPES = [dt.bool_] + NUMERIC + TEMPORAL
OPTIONS = {"safe": (cast.CastOptions.safe, jcast.CastOptions.safe),
           "float_truncate": (lambda: cast.CastOptions(
               allow_float_truncate=True), lambda: jcast.CastOptions(
                   allow_float_truncate=True)),
           "unsafe": (cast.CastOptions.unsafe, jcast.CastOptions.unsafe)}


def source_values(t, rng) -> np.ndarray:
    """60 values of t: the type's extremes, and for floats NaN, +-inf,
    +-1e20, 2**63, 300.7, -1.5, fractions and whole numbers; temporal
    values whole seconds but for a few."""
    if t.is_floating:
        v = np.round(rng.standard_normal(60) * 100, 1).astype(t.np_dtype)
        v[:12] = [np.nan, np.inf, -np.inf, 1e20, -1e20, 2.0 ** 63, 300.7,
                  -1.5, 0.5, 255.0, -128.0, 65504.0]
        v[12:30] = np.round(v[12:30])         # whole numbers pass checks
        return v
    if t.is_temporal:
        v = rng.integers(-10 ** 6, 10 ** 6, 60).astype(t.np_dtype)
        if getattr(t, "unit", None) is not None:
            v[5:] *= t.unit.multiplier // (10 if t.unit.multiplier > 1
                                           else 1)
        return v
    v = values_of(t, 60, rng)
    if t.is_integer:
        v[30:] = rng.integers(0, 100, 30).astype(t.np_dtype)
    return v


def _cast_both(src, to, options):
    rng = np.random.default_rng(int(src.id) * 31 + src.bit_width)
    v = source_values(src, rng)
    mask = rng.random(60) < 0.9
    mask[:12] = True
    outcomes = []
    for make, col in ((OPTIONS[options][1], jax_column(v, mask, src)),
                      (OPTIONS[options][0], port_column(v, mask, src))):
        try:
            if isinstance(col, JaxColumn):
                out = jcast.cast_device(col, jax_type(to), make())
            else:
                out = cast.cast_device(col, to, make())
            outcomes.append(out)
        except (jerr.ArrowError, pc.ArrowError) as e:
            outcomes.append(e)
    return outcomes


@pytest.mark.parametrize("options", list(OPTIONS))
@pytest.mark.parametrize("to", TYPES, ids=str)
@pytest.mark.parametrize("src", TYPES, ids=str)
def test_cast_device_matches_jax(src, to, options):
    want, got = _cast_both(src, to, options)
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (type(want), got)
        assert type(got).__name__ == type(want).__name__, (want, got)
        return
    assert not isinstance(got, Exception), (got, want)
    same_column(got, want)


def test_float_to_int_saturates_as_jax_does():
    v = np.array([np.nan, 1e20, -1e20, 300.7, -1.5, 2.0 ** 63, 2.0 ** 64])
    for to, want in ((dt.int64, [0, 2 ** 63 - 1, -2 ** 63, 300, -1,
                                 2 ** 63 - 1, 2 ** 63 - 1]),
                     (dt.int8, [0, 127, -128, 127, -1, 127, 127]),
                     (dt.uint8, [0, 255, 0, 255, 0, 255, 255]),
                     (dt.uint64, [0, 2 ** 64 - 1, 0, 300, 0, 2 ** 63,
                                  2 ** 64 - 1])):
        got = cast.cast_device(port_column(v, None, dt.float64), to,
                               cast.CastOptions.unsafe())
        assert column_to_host(got).values.tolist() == want
        with pytest.raises(pc.ArrowInvalid):
            cast.cast_device(port_column(v, None, dt.float64), to)


def test_time_truncation_raises_unless_allowed():
    ms = port_column(np.array([86_400_000, 86_400_001], np.int64), None,
                     dt.timestamp("ms"))
    with pytest.raises(pc.ArrowInvalid, match="lose data"):
        cast.cast_device(ms, dt.timestamp("s"))
    out = cast.cast_device(ms, dt.timestamp("s"),
                           cast.CastOptions(allow_time_truncate=True))
    assert column_to_host(out).values.tolist() == [86_400, 86_400]


def test_date32_to_timestamp_keeps_the_number_as_jax_does():
    """date32 has no unit, so the reference reinterprets the day count as
    ticks of the timestamp; the port matches it."""
    v = np.array([1, 19000, -3], np.int32)
    got = cast.cast_device(port_column(v, None, dt.date32),
                           dt.timestamp("ms"))
    want = jcast.cast_device(jax_column(v, None, dt.date32),
                             jax_type(dt.timestamp("ms")))
    same_column(got, want)
    assert column_to_host(got).values.tolist() == [1, 19000, -3]


def test_numeric_dictionary_decodes_as_jax():
    from arrow_go_tpu.compute import functions as jf
    v = np.array([5, 7, 5, 300, 7], np.int64)
    mask = np.array([1, 1, 0, 1, 1], bool)
    want = jcast.cast_device(jf.dictionary_encode(jax_column(v, mask,
                                                             dt.int64)),
                             jax_type(dt.float32))
    got = cast.cast_device(pc.dictionary_encode(port_column(v, mask,
                                                            dt.int64)),
                           dt.float32)
    same_column(got, want)


STRINGS = ["1", "-5", " 42 ", "300", "70000", "3000000000", "1.5", "true",
           "0", "nan", "abc", "-0.25", "1e3"]
PARSE_TARGETS = [dt.int8, dt.int16, dt.int32, dt.int64, dt.uint8,
                 dt.uint32, dt.uint64, dt.float32, dt.float64, dt.bool_]


def _string_arrays(values, valid):
    jarr = agt.array([v if ok else None for v, ok in zip(values, valid)],
                     agt.dtypes.string)
    codes = np.arange(len(values), dtype=np.int32)
    dictionary = np.empty(len(values), dtype=object)
    dictionary[:] = values
    tarr = HostArray(codes, valid, dt.string, dictionary)
    return jarr, tarr


@pytest.mark.parametrize("to", PARSE_TARGETS, ids=str)
@pytest.mark.parametrize("value", STRINGS)
def test_string_parse_matches_jax(value, to):
    valid = np.array([True, False])
    jarr, tarr = _string_arrays([value, "9"], valid)
    try:
        want = jcast.cast_host(jarr, jax_type(to)).to_pylist()
    except (jerr.ArrowError, OverflowError, ValueError) as e:
        with pytest.raises(pc.ArrowError):
            cast.cast_host(tarr, to)
        assert isinstance(e, (jerr.ArrowInvalid, OverflowError)), e
        return
    got = cast.cast_host(tarr, to).to_pylist()
    assert [type(x) for x in got] == [type(x) for x in want]
    assert repr(got) == repr(want)


@pytest.mark.parametrize("value,to", [
    ("2024-02-29", dt.date32), ("1969-07-20", dt.date32),
    ("2024-02-29 13:45:01.250", dt.timestamp("ms")),
    ("1965-01-01T00:00:07", dt.timestamp("s"))])
def test_string_parse_to_temporal_matches_jax(value, to):
    jarr, tarr = _string_arrays([value], np.array([True]))
    want = jcast.cast_host(jarr, jax_type(to))
    got = cast.cast_host(tarr, to)
    assert got.type == to
    np.testing.assert_array_equal(got.values, want.to_numpy())


@pytest.mark.parametrize("value,to,ticks", [
    ("13:45:01", dt.time32("s"), 49_501),
    ("13:45:01.000250", dt.time64("us"), 49_501_000_250)])
def test_string_parse_to_time_deviates_from_jax(value, to, ticks):
    """The JAX package's builder takes no datetime.time (TypeError); the
    port gives the ticks since midnight (a recorded deviation)."""
    jarr, tarr = _string_arrays([value], np.array([True]))
    with pytest.raises(TypeError):
        jcast.cast_host(jarr, jax_type(to))
    assert cast.cast_host(tarr, to).values.tolist() == [ticks]


@pytest.mark.parametrize("src", [dt.bool_, dt.int8, dt.uint64, dt.float16,
                                 dt.float32, dt.float64, dt.date32,
                                 dt.date64, dt.timestamp("ms"),
                                 dt.timestamp("us"), dt.time32("s"),
                                 dt.time64("us"), dt.duration("s")],
                         ids=str)
@pytest.mark.parametrize("to", [dt.string, dt.binary], ids=str)
def test_format_to_string_matches_jax(src, to):
    rng = np.random.default_rng(11)
    v = source_values(src, rng)[:40]
    if src.is_temporal:
        v = np.abs(v) % (86_400 * src.unit.multiplier if hasattr(
            src, "unit") else 100_000)
    mask = rng.random(40) < 0.9
    want = jcast.cast_host(agt.from_numpy(v, mask, jax_type(src)),
                           jax_type(to))
    got = cast.cast_host(HostArray(v, mask, src), to)
    assert got.type == to and type(got).__name__ == type(want).__name__
    assert got.to_pylist() == want.to_pylist()


def test_cast_through_the_registry_routes_as_jax():
    """A DeviceColumn casts on its device, to a string on the host; a
    HostArray casts on the host when a side is a string, else on the
    device and back."""
    v = np.array([1.5, -2.0, 7.25])
    col = port_column(v, None, dt.float64)
    out = pc.cast(col, dt.int32, safe=False)
    assert out.values.device.type == "cpu" and out.type == dt.int32
    assert column_to_host(out).values.tolist() == [1, -2, 7]
    s = pc.cast(col, dt.string)
    assert isinstance(s, HostArray) and s.to_pylist() == ["1.5", "-2",
                                                          "7.25"]
    h = pc.cast(HostArray(v, None, dt.float64), dt.float32, device="cpu")
    assert isinstance(h, HostArray) and h.values.dtype == np.float32
    back = pc.call_function("cast_double", [s])
    assert isinstance(back, HostArray) and back.to_pylist() == v.tolist()
    with pytest.raises(pc.ArrowInvalid):
        pc.cast(col, dt.int32)


@pytest.mark.parametrize("to", [dt.binary, dt.string], ids=str)
def test_string_binary_recast_matches_jax(to):
    src = dt.binary if to == dt.string else dt.string
    values = ["MAIL", "SHIP", "AIR"]
    valid = np.array([True, False, True])
    jarr = agt.array([(v.encode() if src == dt.binary else v)
                      if ok else None for v, ok in zip(values, valid)],
                     jax_type(src))
    dictionary = np.empty(3, dtype=object)
    dictionary[:] = [v.encode() if src == dt.binary else v for v in values]
    tarr = HostArray(np.arange(3, dtype=np.int32), valid, src, dictionary)
    got = cast.cast_host(tarr, to)
    want = jcast.cast_host(jarr, jax_type(to))
    assert got.type == to and type(got).__name__ == type(want).__name__
    assert got.to_pylist() == want.to_pylist()
