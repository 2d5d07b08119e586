"""The parity faults F15-F23 (ROADMAP §3), each fed through both packages
on the CPU with the same inputs: the port's result equals the JAX
package's, or, for F19, F20 and F23, is the refusal asserted beside what
the JAX package does.
"""
import json

import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jc
import arrow_go_tpu.compute.expression as je
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.compute import registry as jreg
from arrow_go_tpu.compute import substrait as js
from arrow_go_tpu.device.block import batch_to_device as jax_batch_to_device
from arrow_go_tpu.device.block import from_device, to_device

import arrow_go_tpu_torch as tagt
import arrow_go_tpu_torch.compute as tc
import arrow_go_tpu_torch.compute.expression as te
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.compute import registry as treg
from arrow_go_tpu_torch.compute import substrait as ts
from arrow_go_tpu_torch.compute.errors import ArrowNotImplemented
from arrow_go_tpu_torch.compute.functions import _HOST_SMALL
from arrow_go_tpu_torch.compute.functions import (agg_max, agg_min,
                                                 agg_product, agg_stddev,
                                                 agg_variance)
from arrow_go_tpu_torch.device.block import (DeviceColumn, check_storage,
                                             column_to_host,
                                             host_array_to_device,
                                             host_batch_to_device)

CPU = "cpu"


def _rows(x):
    return x.to_pydict() if hasattr(x, "to_pydict") else x.to_pylist()


def _same(j, p):
    """The same class name, type (or schema) and rows, each row's Python
    type too (their JSON texts equal: 1 is not 1.0)."""
    assert type(p).__name__ == type(j).__name__
    assert str(getattr(p, "type", getattr(p, "schema", None))) == \
        str(getattr(j, "type", getattr(j, "schema", None)))
    assert _rows(p) == _rows(j)
    assert json.dumps(_rows(p)) == json.dumps(_rows(j))


# ---------------------------------------------------------------------------
# F15: sort_indices / sort of a Table
# ---------------------------------------------------------------------------

def _two_chunks(P, a, b=None):
    half = len(a) // 2 + 1
    batches = []
    for lo, hi in ((0, half), (half, len(a))):
        cols = {"a": P.array(a[lo:hi])}
        if b is not None:
            cols["b"] = P.array(b[lo:hi])
        batches.append(P.record_batch(cols))
    return P.Table.from_batches(batches)


def test_f15_sort_indices_and_sort_of_a_table():
    jt = _two_chunks(agt, [3, None, 1, 2, 5])
    tt = _two_chunks(tagt, [3, None, 1, 2, 5])
    assert tt.column("a").num_chunks == 2
    jo = jc.SortOptions([jc.SortKey("a")])
    to = tc.SortOptions([tc.SortKey("a")])
    want = jc.sort_indices(jt, jo)
    assert want.to_pylist() == [2, 3, 0, 4, 1]
    _same(want, tc.sort_indices(tt, to, device=CPU))
    got = tc.sort(tt, to, device=CPU)
    assert isinstance(got, tagt.Table)
    _same(jc.sort(jt, jo), got)


def test_f15_a_table_longer_than_the_host_path_sorts_on_device():
    rng = np.random.default_rng(15)
    n = _HOST_SMALL + 904
    a = [None if x < 0 else int(x) for x in rng.integers(-3, 40, n)]
    b = [float(x) for x in rng.normal(size=n)]
    jt, tt = _two_chunks(agt, a, b), _two_chunks(tagt, a, b)
    keys = [("a", "descending"), ("b", "ascending")]
    jo = jc.SortOptions([jc.SortKey(k, o) for k, o in keys])
    to = tc.SortOptions([tc.SortKey(k, o) for k, o in keys])
    _same(jc.sort_indices(jt, jo), tc.sort_indices(tt, to, device=CPU))
    _same(jc.sort(jt, jo), tc.sort(tt, to, device=CPU))


# ---------------------------------------------------------------------------
# F16: make_struct of ChunkedArrays
# ---------------------------------------------------------------------------

def test_f16_make_struct_of_chunked_arrays():
    def table(P):
        return P.Table.from_batches([
            P.record_batch({"a": P.array([1]), "b": P.array([3.0])}),
            P.record_batch({"a": P.array([2]), "b": P.array([4.0])})])
    jt, tt = table(agt), table(tagt)
    want = jc.make_struct(jt.column(0), jt.column(1))
    got = tc.make_struct(tt.column(0), tt.column(1))
    assert got.to_pylist() == [{"0": 1, "1": 3.0}, {"0": 2, "1": 4.0}]
    _same(want, got)
    _same(jreg.call_function("make_struct", [jt.column(0), jt.column(1)]),
          treg.call_function("make_struct", [tt.column(0), tt.column(1)],
                             device=CPU))


# ---------------------------------------------------------------------------
# F17: call_function("unique") of a host string column
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_f17_registry_unique_of_strings_is_a_string_array(chunked):
    vals = ["b", None, "a", "b"]

    def arg(P):
        if chunked:
            return P.ChunkedArray([P.array(vals[:2]), P.array(vals[2:])])
        return P.array(vals)
    want = jreg.call_function("unique", [arg(agt)])
    got = treg.call_function("unique", [arg(tagt)], device=CPU)
    assert str(got.type) == "utf8"
    _same(want, got)
    _same(got, tc.unique(arg(tagt), device=CPU))


# ---------------------------------------------------------------------------
# F18: to_pylist of a numeric dictionary column
# ---------------------------------------------------------------------------

DICT_VALUES = {
    "int8": [-128, 127, None, -128], "int16": [-32768, 5, None, 5],
    "int32": [2**31 - 1, -7, None, -7], "int64": [-2**63, 1, None, 1],
    "uint8": [255, 0, None, 255], "uint16": [65535, 1, None, 1],
    "uint32": [2**32 - 1, 3, None, 3], "uint64": [2**64 - 1, 0, None, 0],
    "float16": [0.5, 65504.0, None, 0.5], "float32": [3e38, 0.1, None, 0.1],
    "float64": [1e300, -0.25, None, -0.25], "bool": [True, False, None, True],
    "date32": [0, 19000, None, -5],
}


def _dict_type(m, name):
    return getattr(m, {"bool": "bool_"}.get(name, name))


@pytest.mark.parametrize("name", list(DICT_VALUES))
def test_f18_numeric_dictionary_to_pylist_gives_python_values(name):
    vals = DICT_VALUES[name]
    want = jc.dictionary_encode(agt.array(vals, _dict_type(jdt, name)))
    got = tc.dictionary_encode(tagt.array(vals, _dict_type(tdt, name)),
                               device=CPU)
    rows = got.to_pylist()
    assert rows == want.to_pylist()
    assert [type(v) for v in rows] == [type(v) for v in want.to_pylist()]
    assert json.dumps(rows) == json.dumps(want.to_pylist())
    # a batch holding it (HostBatch.to_pylist) and the registry's route
    batch = tagt.record_batch({"d": got})
    json.dumps(batch.to_pylist())
    reg = treg.call_function("dictionary_encode",
                             [tagt.array(vals, _dict_type(tdt, name))],
                             device=CPU)
    assert json.dumps(reg.to_pylist()) == json.dumps(want.to_pylist())


# ---------------------------------------------------------------------------
# F19: the numeric aggregates of a string column
# ---------------------------------------------------------------------------

STRINGS = ["b", None, "a", "b", "c"]


def _string_args(kind):
    if kind == "string":
        return agt.array(STRINGS), tagt.array(STRINGS)
    return (jc.dictionary_encode(agt.array(STRINGS)),
            tc.dictionary_encode(tagt.array(STRINGS), device=CPU))


@pytest.mark.parametrize("kind", ["string", "dictionary"])
@pytest.mark.parametrize("name", ["min", "max", "min_max", "sum", "mean",
                                  "product", "variance", "stddev"])
def test_f19_numeric_aggregates_of_strings_are_refused(name, kind):
    """A deviation on purpose: the JAX package answers one of its own
    dictionary codes (max 3 of the string column, where the port's codes
    would give 2); the port refuses."""
    ja, ta = _string_args(kind)
    jr = jreg.call_function(name, [ja])
    assert jr is not None
    if kind == "string" and name in ("min", "max", "min_max"):
        assert jr == {"min": 0, "max": 3,
                      "min_max": {"min": 0, "max": 3}}[name]
    with pytest.raises(ArrowNotImplemented):
        treg.call_function(name, [ta], device=CPU)
    direct = {"min_max": tc.min_max, "sum": tc.sum, "mean": tc.mean,
              "min": agg_min, "max": agg_max, "product": agg_product,
              "variance": agg_variance, "stddev": agg_stddev}[name]
    with pytest.raises(ArrowNotImplemented):
        direct(ta, device=CPU)


# ---------------------------------------------------------------------------
# F20: arithmetic and math of string-like columns
# ---------------------------------------------------------------------------

JAX_FAILS = ["negate", "abs", "sign", "floor", "ceil", "trunc",
             "negate_unchecked", "abs_unchecked", "round_to_multiple"]
JAX_CODES = ["sqrt", "exp", "ln", "sin", "cos", "tanh", "log10",
             "sqrt_unchecked", "atan"]


@pytest.mark.parametrize("kind", ["string", "dictionary"])
@pytest.mark.parametrize("name", JAX_FAILS + JAX_CODES)
def test_f20_arithmetic_of_strings_is_refused(name, kind):
    """A deviation on purpose: the JAX package fails (AttributeError) on
    the first group and computes the float functions over its own codes
    (sqrt of row 2 is sqrt(2), where the port's codes would give 1.0);
    the port refuses both."""
    ja, ta = _string_args(kind)
    if name in JAX_FAILS:
        with pytest.raises(AttributeError):
            jreg.call_function(name, [ja])
    else:
        jr = jreg.call_function(name, [ja])
        assert str(jr.type) == "double"
        if name == "sqrt" and kind == "string":
            assert jr.to_pylist()[2] == pytest.approx(np.sqrt(2))
    with pytest.raises(ArrowNotImplemented):
        treg.call_function(name, [ta], device=CPU)
    col = host_array_to_device(ta, CPU)
    with pytest.raises(ArrowNotImplemented):
        treg.call_function(name, [col])


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "mod", "max_element_wise",
                                  "min_element_wise", "power", "atan2"])
def test_f20_binary_arithmetic_of_strings_is_refused(name):
    ja, ta = _string_args("string")
    with pytest.raises((AttributeError, NotImplementedError)):
        jreg.call_function(name, [ja, agt.array([1, 2, 3, 4, 5])])
    for args in ([ta, ta], [ta, 1], [1, ta],
                 [ta, tagt.array([1, 2, 3, 4, 5])]):
        with pytest.raises(ArrowNotImplemented):
            treg.call_function(name, args, device=CPU)
    col = host_array_to_device(ta, CPU)
    with pytest.raises(ArrowNotImplemented):
        tc.arithmetic_binary(name, col, 2)


# ---------------------------------------------------------------------------
# F21: bool operands of the math functions
# ---------------------------------------------------------------------------

BOOLS = [True, True, False, False, None]
DIVISORS = [True, False, True, False, True]


@pytest.mark.parametrize("name", ["abs", "floor", "ceil", "trunc",
                                  "abs_unchecked", "floor_unchecked"])
def test_f21_unary_math_of_bools_gives_the_bool_column(name):
    want = jreg.call_function(name, [agt.array(BOOLS)])
    got = treg.call_function(name, [tagt.array(BOOLS)], device=CPU)
    assert str(got.type) == "bool"
    _same(want, got)


@pytest.mark.parametrize("name", ["divide", "divide_unchecked"])
@pytest.mark.parametrize("rhs", ["column", "scalar"])
def test_f21_divide_of_bools_gives_the_jax_bools(name, rhs):
    def args(P):
        return [P.array(BOOLS), P.array(DIVISORS) if rhs == "column"
                else True]
    want = jreg.call_function(name, args(agt))
    got = treg.call_function(name, args(tagt), device=CPU)
    if rhs == "column":
        assert got.to_pylist() == [True, True, False, True, None]
    _same(want, got)


@pytest.mark.parametrize("name,args", [
    ("sign", lambda P: [P.array(BOOLS)]),
    ("sign_unchecked", lambda P: [P.array(BOOLS)]),
    ("negate", lambda P: [P.array(BOOLS)]),
    ("negate_unchecked", lambda P: [P.array(BOOLS)]),
    ("subtract", lambda P: [P.array(BOOLS), P.array(DIVISORS)]),
    ("subtract_unchecked", lambda P: [P.array(BOOLS), True]),
    ("any", lambda P: [P.array([0.5, None, 0.0])]),
    ("all", lambda P: [P.array([0.5, None, 0.0])])])
def test_f21_type_errors_match_jax(name, args):
    with pytest.raises(TypeError):
        jreg.call_function(name, args(agt))
    with pytest.raises(TypeError) as err:
        treg.call_function(name, args(tagt), device=CPU)
    assert "bool tensor" not in str(err.value)
    assert "not implemented for" not in str(err.value)


# ---------------------------------------------------------------------------
# F22: fill_null / if_else keep their declared type's storage
# ---------------------------------------------------------------------------

def _pair(P):
    return P.array([3, None, 1, -7]), P.array([2.5, 5.5, None, -0.5])


def test_f22_fill_null_of_device_columns_keeps_int64_storage():
    ji, jf_ = _pair(agt)
    ti, tf = _pair(tagt)
    want = from_device(jc.fill_null(to_device(ji), to_device(jf_)))
    col = tc.fill_null(host_array_to_device(ti, CPU),
                       host_array_to_device(tf, CPU))
    assert isinstance(col, DeviceColumn)
    assert col.values.dtype == col.type.torch_dtype == torch.int64
    check_storage(col)
    _same(want, column_to_host(col))
    assert want.to_pylist() == [3, 5, 1, -7]


def test_f22_registry_fill_null_truncates_where_jax_raises():
    """The JAX registry's fill_null raises TypeError (decided on purpose,
    ROADMAP §3); the port's gives the direct function's int64 result."""
    with pytest.raises(TypeError):
        jreg.call_function("fill_null", list(_pair(agt)))
    got = treg.call_function("fill_null", list(_pair(tagt)), device=CPU)
    assert str(got.type) == "int64"
    assert got.to_pylist() == [3, 5, 1, -7]
    assert got.values.dtype == np.int64
    ti, tf = _pair(tagt)
    col = treg.call_function("fill_null", [host_array_to_device(ti, CPU),
                                           host_array_to_device(tf, CPU)])
    check_storage(col)


COND = [True, False, None, False]


@pytest.mark.parametrize("route", ["host", "device", "registry"])
def test_f22_if_else_keeps_left_type_storage(route):
    def args(P):
        return [P.array(COND), P.array([1, 2, 3, 4]),
                P.array([1.5, 2.5, 3.5, None])]
    want = jc.if_else(*args(agt))
    assert want.to_pylist() == [1, 2, None, None]
    if route == "host":
        got = tc.if_else(*args(tagt), device=CPU)
    elif route == "device":
        col = tc.if_else(*[host_array_to_device(a, CPU)
                           for a in args(tagt)])
        assert col.values.dtype == torch.int64
        check_storage(col)
        got = column_to_host(col)
    else:
        with pytest.raises(TypeError):
            jreg.call_function("if_else", args(agt))
        got = treg.call_function("if_else", args(tagt), device=CPU)
    _same(want, got)


def _f22_batches():
    data = {"c": COND, "i": [3, None, 1, -7], "f": [2.5, 5.5, None, -0.5]}
    jrb = agt.record_batch({k: agt.array(v) for k, v in data.items()})
    trb = tagt.record_batch({k: tagt.array(v) for k, v in data.items()})
    return jrb, trb


@pytest.mark.parametrize("fname", ["fill_null", "if_else"])
def test_f22_compiled_and_eager_expressions_keep_storage(fname):
    jrb, trb = _f22_batches()
    args = ["i", "f"] if fname == "fill_null" else ["c", "i", "f"]
    jx = je.call(fname, [je.field(a) for a in args])
    tx = te.call(fname, [te.field(a) for a in args])
    want = from_device(je.execute_scalar_expression(
        jx, jax_batch_to_device(jrb)))
    db = host_batch_to_device(trb, CPU)
    eager = te.execute_scalar_expression(tx, db)
    compiled = te.compile_expression(tx, trb.schema)(db)
    for col in (eager, compiled):
        check_storage(col)
        assert col.values.dtype == torch.int64
        _same(want, column_to_host(col))


def test_f22_substrait_if_else_keeps_storage():
    jrb, trb = _f22_batches()
    jx = je.call("if_else", [je.field("c"), je.field("i"), je.field("f")])
    tx = te.call("if_else", [te.field("c"), te.field("i"), te.field("f")])
    jb = js.serialize_expressions({"e": jx}, schema=jrb.schema)
    tb = ts.serialize_expressions({"e": tx}, schema=trb.schema)
    want = je.execute_scalar_expression(
        js.deserialize_expressions(jb).expressions["e"], jrb)
    db = host_batch_to_device(trb, CPU)
    for blob in (tb, jb):
        col = te.execute_scalar_expression(
            ts.deserialize_expressions(blob).expressions["e"], db)
        check_storage(col)
        _same(want, column_to_host(col))


# ---------------------------------------------------------------------------
# F23: the registry's cast of a date to month_day_nano_interval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", ["date32", "date64", "timestamp", "time32",
                                 "duration"])
@pytest.mark.parametrize("name", ["cast_month_day_nano_interval",
                                  "cast day_time_interval"])
def test_f23_casts_to_a_structured_interval_raise_type_error(name, src):
    """Arrow has no such cast; the JAX package fails in jnp with
    TypeError, and the port raises TypeError too."""
    def arg(m, P):
        t = {"date32": m.date32, "date64": m.date64,
             "timestamp": m.timestamp("ms"), "time32": m.time32("ms"),
             "duration": m.duration("s")}[src]
        return P.array([0, 19000, None], t)

    def call(reg, m, P, **kw):
        if name.startswith("cast "):
            return reg.call_function("cast", [arg(m, P)],
                                     {"to_type": getattr(m, name[5:])}, **kw)
        return reg.call_function(name, [arg(m, P)], **kw)
    with pytest.raises(TypeError):
        call(jreg, jdt, agt)
    with pytest.raises(TypeError):
        call(treg, tdt, tagt, device=CPU)
