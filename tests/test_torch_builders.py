"""The port's array/builders.py against the JAX package's builders on
the same appends: every builder family's values, validity, null count,
reset on `finish` and Arrow layout (`data`, byte for byte), make_builder
of every type the JAX package builds, infer_type, and the refusals."""
import datetime
import decimal as pydec

import numpy as np
import pytest

from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.array import builders as jbuild

from arrow_go_tpu_torch.array import builders as tbuild
from test_torch_arrays_api import same_data
from torch_parity import port_type, same_array

# the cases of tests/test_arrays.py::test_builder_append_none_is_null
NONE_CASES = [
    (jdt.int64, [1, None, 3]),
    (jdt.bool_, [True, None]),
    (jdt.string, ["a", None]),
    (jdt.binary_view, [b"xy", None]),
    (jdt.fixed_size_binary(2), [b"ab", None]),
    (jdt.decimal128(10, 2), [None]),
    (jdt.list_(jdt.int64), [[1], None, [2, 3]]),
    (jdt.ListViewType(jdt.int64), [[1], None]),
    (jdt.map_(jdt.string, jdt.int64), [{"k": 1}, None]),
    (jdt.fixed_size_list(jdt.int64, 2), [[1, 2], None]),
    (jdt.struct({"x": jdt.int64}), [{"x": 1}, None]),
    (jdt.dictionary(jdt.int32, jdt.string), ["a", None, "a"]),
    (jdt.run_end_encoded(jdt.int32, jdt.string), ["a", "a", None]),
]


def _build(mod, t, vals, each=True):
    b = mod.make_builder(t)
    if each:
        for v in vals:
            b.append(v)
    else:
        b.append_values(vals)
    return b


@pytest.mark.parametrize("jt,vals", NONE_CASES, ids=lambda x: str(x))
def test_builder_append_none_is_null(jt, vals):
    t = port_type(jt)
    jb, tb = _build(jbuild, jt, vals), _build(tbuild, t, vals)
    assert len(tb) == len(vals)
    # the JAX run_end_encoded builder counts no row (its len() is its
    # unused validity list's); the port's counts its rows (ROADMAP §3)
    assert len(jb) == (0 if jt.id == jdt.TypeId.RUN_END_ENCODED
                       else len(vals))
    assert type(tb).__name__ == type(jb).__name__
    if jt.id != jdt.TypeId.RUN_END_ENCODED:
        assert tb.null_count == jb.null_count == sum(v is None for v in vals)
    ja, ta = jb.finish(), tb.finish()
    assert type(ta).__name__ == type(ja).__name__
    assert ta.to_pylist() == ja.to_pylist()
    if jt.id != jdt.TypeId.RUN_END_ENCODED:     # REE nulls live in values
        assert ta.null_count == ja.null_count
    same_data(ta.data, ja.data, str(jt))
    # finish() reset the builder: the next finish is an empty array
    assert len(tb.finish()) == len(jb.finish()) == 0


def _values(t, rng, n):
    """Seeded Python values of a JAX type (None ~15%)."""
    def one(t):
        if rng.random() < 0.15:
            return None
        tid = t.id
        if tid == jdt.TypeId.BOOL:
            return bool(rng.integers(0, 2))
        if t.is_integer:
            info = np.iinfo(t.np_dtype)
            return int(rng.integers(max(info.min, -99), min(info.max, 99)))
        if t.is_floating:
            return float(np.float16(rng.standard_normal()))
        if tid in (jdt.TypeId.DATE32, jdt.TypeId.DATE64, jdt.TypeId.TIME32,
                   jdt.TypeId.TIME64, jdt.TypeId.TIMESTAMP,
                   jdt.TypeId.DURATION, jdt.TypeId.INTERVAL_MONTHS):
            return int(rng.integers(0, 1000))
        if tid == jdt.TypeId.INTERVAL_DAY_TIME:
            return (int(rng.integers(-9, 9)), int(rng.integers(0, 999)))
        if tid == jdt.TypeId.INTERVAL_MONTH_DAY_NANO:
            return tuple(int(x) for x in rng.integers(-9, 9, 3))
        if t.is_decimal:
            return pydec.Decimal(int(rng.integers(-10 ** 6, 10 ** 6))
                                 ).scaleb(-t.scale)
        if tid == jdt.TypeId.FIXED_SIZE_BINARY:
            return rng.bytes(t.byte_width)
        if t.is_binary_like:
            w = ["", "ab", "a value past twelve bytes", "é"][
                int(rng.integers(0, 4))]
            return w if tid in (jdt.TypeId.STRING, jdt.TypeId.LARGE_STRING,
                                jdt.TypeId.STRING_VIEW) else w.encode()
        if tid in (jdt.TypeId.LIST, jdt.TypeId.LARGE_LIST,
                   jdt.TypeId.LIST_VIEW, jdt.TypeId.LARGE_LIST_VIEW):
            return [one(t.value_type) for _ in range(rng.integers(0, 4))]
        if tid == jdt.TypeId.FIXED_SIZE_LIST:
            return [one(t.value_type) for _ in range(t.list_size)]
        if tid == jdt.TypeId.STRUCT:
            return {f.name: one(f.type) for f in t.fields()}
        if tid == jdt.TypeId.MAP:
            return {f"k{i}": one(t.item_type)
                    for i in range(rng.integers(0, 3))}
        if tid == jdt.TypeId.DICTIONARY:
            return ["x", "y", "z"][int(rng.integers(0, 3))]
        if tid == jdt.TypeId.RUN_END_ENCODED:
            return int(rng.integers(0, 2))
        return None
    return [one(t) for _ in range(n)]


TYPES = {
    "null": jdt.null, "bool": jdt.bool_, "int8": jdt.int8,
    "uint16": jdt.uint16, "int32": jdt.int32, "uint64": jdt.uint64,
    "float16": jdt.float16, "float32": jdt.float32, "float64": jdt.float64,
    "date32": jdt.date32, "date64": jdt.date64, "time32": jdt.time32("s"),
    "time64": jdt.time64("ns"), "timestamp": jdt.timestamp("ms", "UTC"),
    "duration": jdt.duration("us"), "month_interval": jdt.month_interval,
    "day_time_interval": jdt.day_time_interval,
    "month_day_nano_interval": jdt.month_day_nano_interval,
    "decimal32": jdt.decimal32(9, 2), "decimal64": jdt.decimal64(18, 3),
    "decimal128": jdt.decimal128(30, 4), "decimal256": jdt.decimal256(60, 5),
    "fixed_size_binary": jdt.fixed_size_binary(4), "string": jdt.string,
    "binary": jdt.binary, "large_string": jdt.large_string,
    "large_binary": jdt.large_binary, "string_view": jdt.string_view,
    "binary_view": jdt.binary_view, "list": jdt.list_(jdt.int16),
    "large_list": jdt.large_list(jdt.string),
    "list_view": jdt.ListViewType(jdt.int32),
    "large_list_view": jdt.LargeListViewType(jdt.string),
    "fixed_size_list": jdt.fixed_size_list(jdt.float64, 3),
    "struct": jdt.struct({"a": jdt.int32, "b": jdt.string}),
    "map": jdt.map_(jdt.string, jdt.float64),
    "dictionary<int8, utf8>": jdt.dictionary(jdt.int8, jdt.string),
    "dictionary<int32, int64>": jdt.dictionary(jdt.int32, jdt.int64),
    "run_end_encoded": jdt.run_end_encoded(jdt.int16, jdt.int64),
    "list<struct>": jdt.list_(jdt.struct({"x": jdt.int8})),
}


@pytest.mark.parametrize("each", [True, False], ids=["append",
                                                     "append_values"])
@pytest.mark.parametrize("name", TYPES)
def test_make_builder_of_every_type(name, each):
    jt = TYPES[name]
    if jt.id == jdt.TypeId.DICTIONARY and jt.value_type == jdt.int64:
        vals = [None if v is None else {"x": 4, "y": -1, "z": 9}[v]
                for v in _values(jt, np.random.default_rng(7), 64)]
    else:
        vals = _values(jt, np.random.default_rng(sum(map(ord, name))), 64)
    ja = _build(jbuild, jt, vals, each).finish()
    ta = _build(tbuild, port_type(jt), vals, each).finish()
    assert type(ta).__name__ == type(ja).__name__
    assert ta.to_pylist() == ja.to_pylist()
    if jt.id not in (jdt.TypeId.RUN_END_ENCODED, jdt.TypeId.DICTIONARY):
        same_array(ta, ja, name)
    same_data(ta.data, ja.data, name)


def test_append_values_of_numpy_arrays():
    rng = np.random.default_rng(1)
    v = rng.integers(-2 ** 40, 2 ** 40, 1000)
    b = tbuild.make_builder(port_type(jdt.int64))
    b.append_values(v)
    b.append_null()
    b.append_values(v[:3])
    a = b.finish()
    assert len(a) == 1004 and a.null_count == 1
    jb = jbuild.make_builder(jdt.int64)
    jb.append_values(v)
    jb.append_null()
    jb.append_values(v[:3])
    same_array(a, jb.finish(), "numpy appends")
    d = tbuild.make_builder(port_type(jdt.date32))
    d.append_values(np.arange(5, dtype=np.int32))
    d.append(datetime.date(1970, 1, 10))
    assert d.finish().to_pylist() == [0, 1, 2, 3, 4, 9]


INFER = [[1, None, 2], [1.5, None], [True, False], ["a", None], [b"x"],
         [None, None], [pydec.Decimal("1.25"), pydec.Decimal("3.5")],
         [datetime.datetime(2020, 1, 1)], [datetime.date(2020, 1, 1)],
         [{"a": 1, "b": None}, {"b": "x"}], [[1, 2], None, [3]],
         [np.int32(4)], [np.float32(1.5)]]


@pytest.mark.parametrize("vals", INFER, ids=lambda v: str(v)[:24])
def test_infer_type(vals):
    assert tbuild.infer_type(vals) == port_type(jbuild.infer_type(vals))


def test_the_refusals():
    for mod, d in ((jbuild, jdt), (tbuild, None)):
        def t(jt):
            return jt if d is not None else port_type(jt)
        with pytest.raises(NotImplementedError):
            mod.make_builder(t(jdt.sparse_union([jdt.field("a", jdt.int8)])))
        with pytest.raises(ValueError):
            mod.make_builder(t(jdt.fixed_size_binary(2))).append(b"abc")
        with pytest.raises(ValueError):
            mod.make_builder(t(jdt.decimal64(10, 1))).append(
                pydec.Decimal("1.25"))
        with pytest.raises(ValueError):
            mod.make_builder(t(jdt.fixed_size_list(jdt.int8, 2))).append([1])
        with pytest.raises(ValueError):
            mod.infer_type([object()])
