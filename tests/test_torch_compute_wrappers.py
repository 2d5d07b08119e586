"""The port's compute module against the JAX package's: it exposes every
public name of `arrow_go_tpu.compute`, and each typed wrapper (`add` ...
`stddev`, with `and_` / `or_` and the builtin-shadowing `sum`, `min`,
`max`, `abs`, `round`, `any` and `all`) gives the JAX wrapper's result
on the registry test's data (its seeded columns, options and
comparison: ints and bools bit for bit, transcendental functions at
rtol 1e-14), with the first column as a device column and as a host
array."""
import types

import pytest

import arrow_go_tpu.compute as jpc

import arrow_go_tpu_torch.compute as pc
from test_torch_registry import (FLOAT_BINARY, FLOAT_UNARY, JAX_TYPE_ERROR,
                                 _args, _case, _same)


def _public(m) -> set:
    """A module's public names, less its submodules and the typing and
    __future__ names its imports leave."""
    out = set()
    for n in dir(m):
        v = getattr(m, n)
        if n.startswith("_") or isinstance(v, types.ModuleType) or \
                type(v).__module__ in ("typing", "__future__"):
            continue
        out.add(n)
    return out


WRAPPERS = sorted(n for n, f in vars(jpc).items()
                  if getattr(f, "__qualname__", "").startswith(
                      ("_wrap1.", "_wrap2.")))


def test_the_public_surface_is_the_jax_one():
    assert _public(jpc) - _public(pc) == set()
    assert len(WRAPPERS) == 60


@pytest.mark.parametrize("name", WRAPPERS)
def test_typed_wrapper_matches_jax(name):
    jfn, fn = getattr(jpc, name), getattr(pc, name)
    reg = jfn.__name__               # and_ -> "and", or_ -> "or"
    assert fn.__name__ == reg
    assert reg not in JAX_TYPE_ERROR
    spec, jopts, topts = _case(reg)
    rtol = 1e-14 if reg in FLOAT_BINARY or reg in FLOAT_UNARY - {
        "floor", "ceil", "trunc", "abs", "sign", "negate"} else None
    for host_first in (False, True):
        jargs, targs = _args(spec, host_first)
        want = jfn(*jargs, options=jopts)
        got = fn(*targs, options=topts, device="cpu")
        _same(got, want, rtol)


# ---------------------------------------------------------------------------
# ChunkedArray and Decimal arguments (the JAX registry takes both)
# ---------------------------------------------------------------------------

def _chunked(seed: int, kind: str):
    """The same seeded 3-chunk column with nulls in both packages."""
    import numpy as np

    import arrow_go_tpu as jagt
    import arrow_go_tpu_torch as tagt
    rng = np.random.default_rng(seed)
    v = rng.integers(-50, 50, 300) if kind == "int" else \
        rng.normal(0.0, 10.0, 300)
    valid = rng.random(300) >= 0.1
    cuts = [(0, 70), (70, 71), (71, 300)]
    return (jagt.ChunkedArray([jagt.from_numpy(v[a:b], valid[a:b])
                               for a, b in cuts]),
            tagt.ChunkedArray([tagt.from_numpy(v[a:b], valid[a:b])
                               for a, b in cuts]))


@pytest.mark.parametrize("name", ["add", "multiply", "subtract", "less",
                                  "greater_equal", "equal", "and_"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_binary_wrappers_take_chunked_arrays_as_jax(name, kind):
    (ja, ta), (jb, tb) = _chunked(1, kind), _chunked(2, kind)
    if name == "and_":
        ja, ta = jpc.less(ja, 0), pc.less(ta, 0, device="cpu")
        jb, tb = jpc.greater(jb, 0), pc.greater(tb, 0, device="cpu")
    want = getattr(jpc, name)(ja, jb)
    got = getattr(pc, name)(ta, tb, device="cpu")
    assert got.to_pylist() == want.to_pylist()
    # a ChunkedArray beside a scalar, padded alike
    if name != "and_":
        assert getattr(pc, name)(ta, 7, device="cpu").to_pylist() == \
            getattr(jpc, name)(ja, 7).to_pylist()


@pytest.mark.parametrize("name", ["sum", "min", "max", "mean", "count",
                                  "negate", "abs", "is_null"])
def test_unary_wrappers_take_chunked_arrays_as_jax(name):
    ja, ta = _chunked(3, "int")
    want = getattr(jpc, name)(ja)
    got = getattr(pc, name)(ta, device="cpu")
    if hasattr(want, "to_pylist"):
        assert got.to_pylist() == want.to_pylist()
    else:
        assert got == pytest.approx(want, rel=1e-12)


def test_call_function_takes_a_chunked_array_as_jax():
    """tests/test_compute.py::test_chunked_array_input."""
    ja, ta = _chunked(4, "int")
    want = jpc.call_function("multiply", [ja, 3])
    got = pc.call_function("multiply", [ta, 3], device="cpu")
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "less",
                                "equal"])
@pytest.mark.parametrize("scalar", ["1.25", "-0.5", "3"])
def test_decimal_scalars_through_call_function_as_jax(op, scalar):
    """tests/test_misc_components.py::test_decimal_device_arithmetic:
    a decimal.Decimal scalar beside a decimal128 column, mixed scales."""
    from decimal import Decimal

    import arrow_go_tpu as jagt
    import arrow_go_tpu_torch as tagt
    from arrow_go_tpu import dtypes as jdt
    from arrow_go_tpu_torch import dtypes as tdt
    vals = [Decimal("1.10"), None, Decimal("-3.25"), Decimal("99.99"),
            Decimal("0.00")]
    ja = jagt.array(vals, jdt.decimal128(10, 2))
    ta = tagt.array(vals, tdt.decimal128(10, 2))
    want = jpc.call_function(op, [ja, Decimal(scalar)])
    got = pc.call_function(op, [ta, Decimal(scalar)], device="cpu")
    assert got.to_pylist() == want.to_pylist()
    assert str(got.type) == str(want.type)


def test_can_cast_takes_the_jax_keywords():
    from arrow_go_tpu import dtypes as jdt
    from arrow_go_tpu_torch import dtypes as tdt
    for a, b in (("int32", "float64"), ("float64", "int8"),
                 ("date32", "timestamp"), ("bool_", "int64")):
        ja, jb = getattr(jdt, a), getattr(jdt, b, None)
        ta, tb = getattr(tdt, a), getattr(tdt, b, None)
        if jb is None or not isinstance(jb, jdt.DataType):
            jb, tb = jdt.timestamp("ms"), tdt.timestamp("ms")
        assert pc.can_cast(from_type=ta, to_type=tb) == \
            jpc.can_cast(from_type=ja, to_type=jb)
