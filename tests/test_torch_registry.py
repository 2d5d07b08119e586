"""The port's function registry against the JAX package's: the names the
port does not register are exactly MISSING, and every name it registers,
called through `call_function` in both packages on the same small
inputs (DeviceColumns, and a host array that goes to the device and
back, beside scalars), gives the same result."""
import importlib

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import registry as jreg
from arrow_go_tpu.compute.run_ends import run_end_encode
from arrow_go_tpu.device.block import DeviceBatch as JaxBatch
from arrow_go_tpu.device.block import DeviceColumn as JaxColumn
from arrow_go_tpu.device.block import to_device

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute import registry
from arrow_go_tpu_torch.device.block import (DeviceBatch, DeviceColumn,
                                             HostArray, host_array_to_device)
from test_torch_types import jax_column, port_column, same_column
from torch_parity import (jax_batch, jax_type, port_array, port_batch,
                          port_type, same_array)

jcast = importlib.import_module("arrow_go_tpu.compute.cast")

# JAX names whose functions the port does not have: none (the casts to
# the view, large and fixed-size binaries, the month-day-nano interval,
# dictionaries and extensions came with those types).
MISSING = set()

PORT_NAMES = registry.default_registry().function_names()
N = 96


def test_missing_names_are_exactly_the_recorded_set():
    jax_names = set(jreg.default_registry().function_names())
    assert set(PORT_NAMES) <= jax_names
    assert jax_names - set(PORT_NAMES) == MISSING


def _data():
    """The inputs, made with numpy from a seed: (values, mask, type)."""
    rng = np.random.default_rng(21)
    mask = rng.random(N) < 0.85
    f = np.round(rng.uniform(0.1, 0.9, N), 3)
    f[:3] = [np.nan, 0.5, 0.25]
    return {
        "f": (f, mask, dt.float64),
        "g": (np.round(rng.uniform(0.1, 0.9, N), 3), None, dt.float64),
        "i": (rng.integers(-40, 40, N), mask, dt.int64),
        "j": (rng.integers(1, 9, N), None, dt.int64),
        "p": (rng.random(N) < 0.5, mask, dt.bool_),
        "q": (rng.random(N) < 0.5, rng.random(N) < 0.8, dt.bool_),
        "d": (rng.integers(-800, 20_000, N).astype(np.int32), mask,
              dt.date32),
        "idx": (rng.integers(0, N, N), None, dt.int64),
        "m": (np.array([f"{x / 1000:.3f}" for x in rng.integers(
            -10**9, 10**9, N)], dtype=object), mask, dt.string),
    }


DATA = _data()
_RNG = np.random.default_rng(22)
# nested host arguments: (Python rows, the JAX type)
NESTED = {
    "lst": ([None if _RNG.random() < 0.1 else
             [None if _RNG.random() < 0.1 else int(x)
              for x in _RNG.integers(-50, 50, _RNG.integers(0, 4))]
             for _ in range(N)], "list<int32>"),
    "pairs": ([None if _RNG.random() < 0.1 else
               [int(x) for x in _RNG.integers(-50, 50, 2)]
               for _ in range(N)], "list<int32>"),
    "st": ([{"a": int(x), "b": float(x) / 4} for x in
            _RNG.integers(0, 9, N)], "struct<a: int32, b: double>"),
}


def _nested_type(name: str):
    from arrow_go_tpu import dtypes as jdt
    return {"list<int32>": jdt.list_(jdt.int32),
            "struct<a: int32, b: double>": jdt.struct(
                {"a": jdt.int32, "b": jdt.float64})}[name]


def _nested_targets():
    """(JAX type, port type) of each nested cast case."""
    from arrow_go_tpu import dtypes as jdt
    pairs = {"cast_list": jdt.list_(jdt.float64),
             "cast_large_list": jdt.large_list(jdt.int64),
             "cast_fixed_size_list": jdt.fixed_size_list(jdt.int64, 2),
             "cast_struct": jdt.struct({"a": jdt.int64, "b": jdt.float64})}
    return {k: (v, port_type(v)) for k, v in pairs.items()}


# casts the JAX package refuses (its struct cast fails; from an int64
# column, its casts to a dictionary, an extension and a fixed-size binary
# raise ArrowNotImplemented and to a month-day-nano interval TypeError);
# the port refuses them with ArrowNotImplemented
BOTH_REFUSE = {"cast_struct", "cast_dictionary", "cast_extension",
               "cast_fixed_sized_binary", "cast_month_day_nano_interval"}
# (the JAX type, the port's) of the casts whose target takes parameters
# the registry's dict of defaults does not name
_REFUSED_TARGETS = {
    "cast_dictionary": lambda m: m.dictionary(m.int32, m.int64),
    "cast_extension": lambda m: m.ExtensionType(m.int8, "arrow.bool8"),
    "cast_fixed_sized_binary": lambda m: m.fixed_size_binary(8)}
FLOAT_BINARY = {"power", "atan2", "logb"}
FLOAT_UNARY = {"sqrt", "exp", "expm1", "sin", "cos", "tan", "asin", "acos",
               "atan", "sinh", "cosh", "tanh", "ln", "log10", "log2",
               "log1p", "floor", "ceil", "trunc", "abs", "sign", "negate"}


def _base(name: str) -> str:
    name = {"sub": "subtract", "sub_unchecked": "subtract_unchecked",
            "not": "invert", "is_not_null": "is_valid"}.get(name, name)
    return name[:-len("_unchecked")] if name.endswith("_unchecked") \
        else name


def _case(name: str):
    """(argument names or scalars, options for the JAX call, options for
    the port's call)."""
    base = _base(name)
    from arrow_go_tpu_torch.compute import kernels
    if base in kernels._ARITH_BINARY:
        if base in FLOAT_BINARY:
            return ["f", "g"], None, None
        if base.startswith("shift"):
            return ["i", 3], None, None
        return ["i", "j"], None, None
    if base in kernels._ARITH_UNARY:
        return (["f"] if base in FLOAT_UNARY else ["i"]), None, None
    if base in ("round", "round_to_multiple"):
        o = {"ndigits": 1, "mode": "half_up"} if base == "round" else \
            {"multiple": 0.25, "mode": "half_towards_zero"}
        return ["f"], o, o
    if base.endswith("_temporal"):
        o = {"unit": "month", "multiple": 2}
        return ["d"], o, o
    if base in kernels._COMPARE:
        return ["i", "j"], None, None
    if base in kernels._BOOLEAN or base in kernels._KLEENE:
        return ["p", "q"], None, None
    if base == "invert":
        return ["p"], None, None
    if base in ("is_null", "is_valid", "is_nan", "is_finite"):
        return ["f"], None, None
    if base in _nested_targets():
        jt, tt = _nested_targets()[base]
        arg = {"cast_fixed_size_list": "pairs",
               "cast_struct": "st"}.get(base, "lst")
        return [arg], {"to_type": jt}, {"to_type": tt}
    if base == "make_struct":
        o = {"field_names": ["x", "y"]}
        return ["i", "f", 5], o, o
    if base == "value_counts":
        return ["i"], None, None
    if base == "cast":
        return (["f"], {"to_type": jax_type(dt.int32),
                        "options": jcast.CastOptions.unsafe()},
                {"to_type": dt.int32, "options": pc.CastOptions.unsafe()})
    if base in _REFUSED_TARGETS:
        from arrow_go_tpu import dtypes as jdt
        make = _REFUSED_TARGETS[base]
        return ["i"], {"to_type": make(jdt)}, {"to_type": make(dt)}
    if base.startswith("cast_"):
        from arrow_go_tpu_torch.compute.functions import CAST_TARGETS
        to = CAST_TARGETS[base] or {
            "cast_time32": dt.time32("s"), "cast_time64": dt.time64("us"),
            "cast_timestamp": dt.timestamp("ms"),
            "cast_duration": dt.duration("s"),
            "cast_decimal": dt.decimal128(20, 3),
            "cast_decimal256": dt.decimal256(50, 3)}[base]
        if to.is_decimal:       # the one decimal cast: from strings
            return (["m_host"], {"to_type": jax_type(to)},
                    {"to_type": to})
        return (["f" if to.is_numeric or to == dt.bool_ else "i"],
                {"to_type": jax_type(to),
                 "options": jcast.CastOptions.unsafe()},
                {"to_type": to, "options": pc.CastOptions.unsafe()})
    if base in ("filter", "array_filter"):
        return ["batch", "p_nonnull"], None, None
    if base in ("take", "array_take"):
        # (the JAX take reads its indices on the host)
        return ["f_host", "idx_host"], None, None
    if base in ("sort_indices", "unique", "dictionary_encode", "sort",
                "run_end_encode"):
        return ["i"], None, None
    if base == "run_end_decode":
        return ["ree"], None, None
    if base in ("is_in", "index_in"):
        vs = [3, -7, None, 11]
        return (["i"], jf.SetLookupOptions(value_set=vs),
                pc.SetLookupOptions(value_set=vs))
    if base == "fill_null":
        return ["f", 0.125], None, None
    if base == "if_else":
        return ["q_nonnull", "f", "g"], None, None
    # the scalar aggregates
    return (["p"] if base in ("any", "all") else ["f"]), None, None


def _args(spec, host_first: bool):
    """Both packages' arguments; with host_first the first column goes as
    a host array."""
    jargs, targs = [], []
    for k, a in enumerate(spec):
        if not isinstance(a, str):
            jargs.append(a)
            targs.append(a)
            continue
        if a in NESTED:
            rows, tname = NESTED[a]
            jarr = agt.array(rows, _nested_type(tname))
            jargs.append(jarr)
            targs.append(port_array(jarr))
            continue
        if a == "ree":                  # the encoded runs of a column
            v, mask, t = DATA["j"]
            jargs.append(run_end_encode(agt.from_numpy(v, mask)))
            targs.append(pc.run_end_encode(HostArray(v, mask, t),
                                           device="cpu"))
            continue
        if a == "batch":
            data = {k: DATA[k][0] for k in ("f", "i", "d")}
            jdb = jax_batch(data, {k: DATA[k][1] for k in ("f", "i")})
            jargs.append(jdb)
            targs.append(port_batch(jdb))
            continue
        key, nonnull = a.split("_")[0], a.endswith("_nonnull")
        v, mask, t = DATA[key]
        mask = None if nonnull else mask
        if t == dt.string:              # decimal strings, as host arrays
            from arrow_go_tpu_torch.device.block import factorize
            codes, dictionary = factorize(v, mask)
            jargs.append(agt.array([x if ok else None
                                    for x, ok in zip(v.tolist(), mask)]))
            targs.append(HostArray(codes, mask, dt.dictionary(dt.int32, t),
                                   dictionary))
        elif host_first and k == 0 or a.endswith("_host"):
            jargs.append(agt.from_numpy(v, mask, jax_type(t)))
            targs.append(HostArray(v, mask, t))
        else:
            jargs.append(jax_column(v, mask, t))
            targs.append(port_column(v, mask, t))
    return jargs, targs


def _same(got, want, rtol=None) -> None:
    """got (the port's) against want (the JAX package's); with rtol,
    floats agree to it on the valid rows (a transcendental function or
    sqrt may differ in the last place between XLA and torch)."""
    if rtol is not None and isinstance(want, (JaxColumn, agt.Array)):
        if isinstance(want, agt.Array):
            want = to_device(want)
            got = host_array_to_device(got, "cpu")
        assert str(got.type) == str(want.type)
        n = want.length
        ok = np.asarray(want.validity_mask())[:n]
        np.testing.assert_array_equal(got.validity_mask()[:n].numpy(), ok)
        np.testing.assert_allclose(got.values[:n].numpy()[ok],
                                   np.asarray(want.values)[:n][ok],
                                   rtol=rtol)
        return
    if isinstance(want, JaxBatch):
        assert isinstance(got, DeviceBatch)
        assert got.schema.names == want.schema.names
        for g, w in zip(got.columns, want.columns):
            _same(g, w)
        return
    if isinstance(want, JaxColumn):
        assert isinstance(got, DeviceColumn)
        if want.dictionary is not None:       # dictionary_encode
            assert list(got.dict_values) == want.dictionary.to_pylist()
            got = DeviceColumn(got.values, got.validity, got.length,
                               dt.int32)
            want = JaxColumn(want.values, want.validity, want.length,
                             jax_type(dt.int32))
        same_column(got, want)
        return
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
        return
    if isinstance(got, HostArray) and got.type.is_nested:
        same_array(got, want)
        return
    if isinstance(got, HostArray):
        if got.type.is_decimal:
            assert str(got.type) == str(want.type)
            assert got.to_pylist() == want.to_pylist()
            return
        if got.dict_values is not None:
            assert got.to_pylist() == want.to_pylist()
            return
        same_column(host_array_to_device(got, "cpu"), to_device(want))
        return
    if isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-9)
        return
    assert got == want and type(got) is type(want), (got, want)


# JAX calls that pass `options` to a function that takes none (TypeError
# there): the port's registry calls the function; it is held against the
# JAX function called directly
JAX_TYPE_ERROR = {"fill_null": jf.fill_null, "if_else": jf.if_else}


@pytest.mark.parametrize("name", PORT_NAMES)
def test_call_function_matches_jax(name):
    spec, jopts, topts = _case(name)
    base = _base(name)
    rtol = 1e-14 if base in FLOAT_BINARY or base in FLOAT_UNARY - {
        "floor", "ceil", "trunc", "abs", "sign", "negate"} else None
    for host_first in (False, True):
        if host_first and spec[0] in ("batch", "d"):
            continue          # a batch is no host array; the JAX date32
            # host array holds datetime.date values
        jargs, targs = _args(spec, host_first)
        if name in BOTH_REFUSE:
            with pytest.raises(Exception):
                jreg.call_function(name, jargs, jopts)
            with pytest.raises(pc.ArrowNotImplemented):
                registry.call_function(name, targs, topts, device="cpu")
            continue
        if name in JAX_TYPE_ERROR:
            with pytest.raises(TypeError):
                jreg.call_function(name, jargs, jopts)
            want = JAX_TYPE_ERROR[name](*jargs)
        else:
            want = jreg.call_function(name, jargs, jopts)
        got = registry.call_function(name, targs, topts, device="cpu")
        _same(got, want, rtol)


def test_child_registry_chains_to_the_default():
    child = registry.new_child_registry()
    child.register(registry.Function(
        "twice", registry.FunctionKind.SCALAR, registry.Arity.unary(),
        lambda a, options=None: pc.arithmetic_binary("multiply", a, 2)))
    assert "twice" in child and "add" in child
    assert "twice" not in registry.default_registry()
    v, mask, t = DATA["i"]
    out = registry.call_function("twice", [HostArray(v, mask, t)],
                                 registry=child, device="cpu")
    np.testing.assert_array_equal(out.values[mask], v[mask] * 2)
    with pytest.raises(pc.ArrowKeyError):
        registry.call_function("no_such_function", [1])
    with pytest.raises(pc.ArrowNotImplemented):
        registry.call_function("add", [1])
