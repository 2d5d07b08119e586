"""The port's line-delimited JSON reader and writer
(arrow_go_tpu_torch/formats/json.py) against the JAX package's
(arrow_go_tpu/formats/json.py): the same lines read by both (flat,
nested structs and lists, nulls, missing keys, a given schema, mixed
values, and the inputs both refuse, by exception class), write_json
byte for byte for every type, the type inference of both packages'
`infer_type` on every kind of value, round trips and pyarrow's reader
as an extra oracle."""
import datetime
import decimal
import io

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.array.builders import infer_type as jax_infer_type
from arrow_go_tpu.formats import json as jjson

from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute.scalars import infer_type
from arrow_go_tpu_torch.device.block import HostBatch, from_pylist
from arrow_go_tpu_torch.formats import json as tjson
from torch_parity import port_array, port_type, same_table


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:              # the class is compared across
        return None, type(e).__name__


def _same_read(data: bytes, schema=None):
    jo = jjson.ReadOptions(schema=None if schema is None else jdt.Schema(
        [jdt.Field(n, t(jdt)) for n, t in schema]))
    to = tjson.ReadOptions(schema=None if schema is None else dt.Schema(
        [dt.Field(n, t(dt)) for n, t in schema]))
    want, jerr = _outcome(lambda: jjson.read_json(data, jo))
    got, terr = _outcome(lambda: tjson.read_json(data, to))
    assert terr == jerr, (terr, jerr)
    if jerr is None:
        same_table(got, want, repr(data[:40]))
    return got


READ_CASES = {
    "basic": b'{"a": 1, "b": "x"}\n{"a": null, "b": "y"}\n{"a": 3}\n',
    "nested": b'{"s": {"x": 1}, "l": [1, 2]}\n{"s": {"x": 2}, "l": []}\n',
    "nested_nulls": b'{"s": {"x": 1, "y": "a"}, "l": [1, null]}\n'
                    b'{"s": null, "l": null}\n{"s": {"y": "b"}}\n',
    "deep": b'{"r": {"l": [{"v": 1.5}, {"v": null}], "t": true}}\n'
            b'{"r": {"l": [], "t": false}}\n',
    "list_of_lists": b'{"l": [[1, 2], [], null]}\n{"l": [[3]]}\n',
    "missing_keys": b'{"a": 1}\n{"b": "x"}\n{"c": 2.5, "a": 4}\n',
    "key_order": b'{"z": 1, "a": 2}\n{"m": 3, "z": 4}\n',
    "floats": b'{"f": 1.5}\n{"f": -0.0}\n{"f": 1e300}\n{"f": null}\n',
    "int_then_float": b'{"v": 1}\n{"v": 2.5}\n',
    "float_then_int": b'{"v": 1.5}\n{"v": 2}\n',
    "bools": b'{"b": true}\n{"b": false}\n{"b": null}\n',
    "bool_then_int": b'{"b": true}\n{"b": 2}\n',
    "int_then_string": b'{"v": 1}\n{"v": "x"}\n',
    "all_null": b'{"n": null}\n{"n": null}\n',
    "unicode": '{"s": "ünï"}\n{"s": "α"}\n{"s": "ünï"}\n'.encode(),
    "big_ints": b'{"i": 9223372036854775807}\n{"i": -9223372036854775808}\n',
    "too_big_int": b'{"i": 9223372036854775808}\n',
    "blank_lines": b'\n{"a": 1}\n   \n{"a": 2}\n\n',
    "crlf": b'{"a": 1}\r\n{"a": 2}\r\n',
    "empty": b"",
    "not_json": b'{"a": 1}\n{oops}\n',
    "not_an_object": b'[1, 2]\n',
    "empty_objects": b'{}\n{}\n',
}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_read_matches_jax(case):
    _same_read(READ_CASES[case])


SCHEMA_CASES = {
    "narrow_types": (b'{"a": 1, "b": 2.5, "c": "x"}\n{"a": null, "b": 1}\n',
                     [("a", lambda d: d.int32), ("b", lambda d: d.float32),
                      ("c", lambda d: d.string)]),
    "subset_and_missing": (b'{"a": 1, "b": 2}\n{"a": 3}\n',
                           [("b", lambda d: d.int64),
                            ("z", lambda d: d.string)]),
    "bool_and_binary": (b'{"b": true, "y": "ab"}\n{"b": null, "y": null}\n',
                        [("b", lambda d: d.bool_),
                         ("y", lambda d: d.binary)]),
    "list_and_struct": (b'{"l": [1, 2], "s": {"x": 1}}\n{"l": null}\n',
                        [("l", lambda d: d.list_(d.int16)),
                         ("s", lambda d: d.struct([d.Field("x",
                                                           d.int8)]))]),
    "timestamp_units": (b'{"t": 1577836800000}\n{"t": null}\n',
                        [("t", lambda d: d.timestamp("ms"))]),
    "date_days": (b'{"d": 18262}\n', [("d", lambda d: d.date32)]),
    "decimal_of_floats": (b'{"m": 1.25}\n{"m": 3}\n',
                          [("m", lambda d: d.decimal128(10, 2))]),
    "map_of_objects": (b'{"m": {"k": 1, "j": 2}}\n{"m": null}\n',
                       [("m", lambda d: d.map_(d.string, d.int64))]),
    "large_string": (b'{"s": "x"}\n{"s": "y"}\n',
                     [("s", lambda d: d.large_string)]),
}


@pytest.mark.parametrize("case", sorted(SCHEMA_CASES))
def test_given_schema_matches_jax(case):
    data, schema = SCHEMA_CASES[case]
    _same_read(data, schema)


def test_json_tests_of_the_jax_package():
    """tests/test_formats.py's JSON reads through the port."""
    t = tjson.read_json(b'{"a": 1, "b": "x"}\n{"a": null, "b": "y"}\n'
                        b'{"a": 3}\n')
    assert t.to_pydict() == {"a": [1, None, 3], "b": ["x", "y", None]}
    t = tjson.read_json(b'{"s": {"x": 1}, "l": [1, 2]}\n'
                        b'{"s": {"x": 2}, "l": []}\n')
    assert t.to_pydict() == {"s": [{"x": 1}, {"x": 2}], "l": [[1, 2], []]}


def test_read_from_paths_and_streams(tmp_path):
    data = READ_CASES["nested_nulls"]
    p = tmp_path / "x.jsonl"
    p.write_bytes(data)
    want = jjson.read_json(data)
    for src in (str(p), io.BytesIO(data), io.StringIO(data.decode())):
        same_table(tjson.read_json(src), want)


INFER_CASES = [
    [1, None, 3], [True, 1], [1.5, 2], ["x", None], [b"ab"],
    [decimal.Decimal("1.25"), decimal.Decimal("3.5")],
    [decimal.Decimal("10"), decimal.Decimal("1.125")],
    [datetime.datetime(2020, 1, 1)], [datetime.date(2020, 1, 1)],
    [{"a": 1, "b": None}, {"b": "x"}], [[1, 2], None, []],
    [[None], [1.5]], [{"a": [1]}, {"a": None}], [(1, 2)],
    [np.int32(3)], [np.float32(1.5)], [np.bool_(True)], [None, None],
    [{"a": {"b": 1}}], [[[1], []]],
]


@pytest.mark.parametrize("case", range(len(INFER_CASES)))
def test_infer_type_matches_jax_builders(case):
    """The port's compute/scalars.infer_type against the JAX
    array/builders.infer_type on every kind of value."""
    values = INFER_CASES[case]
    assert infer_type(values) == port_type(jax_infer_type(values))


def test_infer_type_refuses_like_jax():
    for values in ([object()], [{1, 2}]):
        with pytest.raises(ValueError):
            jax_infer_type(values)
        with pytest.raises(ValueError):
            infer_type(values)


def _tables():
    return {
        "flat": agt.table({"i": [1, None, 3], "s": ["a", "b", None],
                           "f": [0.5, float("nan"), -0.0],
                           "b": [True, False, None]}),
        "nested": agt.table({
            "l": agt.array([[1], [2, 3], None], jdt.list_(jdt.int64)),
            "s": agt.array([{"x": 1, "y": "a"}, None, {"x": None, "y": "c"}],
                           jdt.struct([jdt.Field("x", jdt.int64),
                                       jdt.Field("y", jdt.string)]))}),
        "binary_decimal": agt.table({
            "y": agt.array([b"ab", b"\xff", None], jdt.binary),
            "d": agt.array([decimal.Decimal("1.25"), None,
                            decimal.Decimal("-3.50")],
                           jdt.decimal128(10, 2))}),
        "temporal": agt.table({
            "d": agt.array([datetime.date(2020, 1, 1), None,
                            datetime.date(1969, 12, 31)], jdt.date32),
            "t": agt.array([datetime.datetime(2020, 1, 1, 3), None,
                            datetime.datetime(1970, 1, 1)],
                           jdt.timestamp("ms"))}),
        "narrow": agt.table({"i8": agt.array([1, -2, None], jdt.int8),
                             "u64": agt.array([2 ** 64 - 1, 0, 7],
                                              jdt.uint64),
                             "f32": agt.array([0.1, None, 2.0],
                                              jdt.float32)}),
        "unicode": agt.table({"s": ["ünï", "α", "\"q\""]}),
        "empty": agt.table({"i": agt.array([], jdt.int64)}),
    }


def _port_batch(t) -> HostBatch:
    cols = [from_pylist(c.to_pylist(), port_type(c.type)) if c.type.is_decimal
            else port_array(c) for c in (t.column(i).combine()
                                         for i in range(t.num_columns))]
    return HostBatch(dt.Schema([dt.Field(f.name, port_type(f.type))
                                for f in t.schema.fields]), cols, t.num_rows)


@pytest.mark.parametrize("sink", ["bytes", "text", "path"])
@pytest.mark.parametrize("table", sorted(_tables()))
def test_write_json_is_the_jax_bytes(table, sink, tmp_path):
    t = _tables()[table]
    if sink == "path":
        jp, tp = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
        jjson.write_json(t, str(jp))
        tjson.write_json(_port_batch(t), str(tp))
        assert tp.read_bytes() == jp.read_bytes()
        return
    js, ts = (io.BytesIO(), io.BytesIO()) if sink == "bytes" else (
        io.StringIO(), io.StringIO())
    jjson.write_json(t, js)
    tjson.write_json(_port_batch(t), ts)
    assert ts.getvalue() == js.getvalue()


@pytest.mark.parametrize("table", ["flat", "nested", "unicode"])
def test_round_trip_matches_jax(table):
    """tests/test_formats.py::test_json_roundtrip through both packages:
    the port's bytes read back by both readers."""
    t = _tables()[table]
    buf = io.BytesIO()
    tjson.write_json(_port_batch(t), buf)
    _same_read(buf.getvalue())
    back = tjson.read_json(buf.getvalue())
    jback = jjson.read_json(buf.getvalue())
    assert back.to_pydict().keys() == jback.to_pydict().keys()


def test_json_matches_pyarrow():
    """tests/test_formats.py::test_json_matches_pyarrow: pyarrow's
    reader as a third opinion."""
    pajson = pytest.importorskip("pyarrow.json")
    data = b'{"a": 1, "b": "x"}\n{"a": 2, "b": null}\n'
    ours = tjson.read_json(data)
    assert ours.to_pydict() == pajson.read_json(io.BytesIO(data)).to_pydict()
    same_table(ours, jjson.read_json(data))


def test_json_orders_path_matches_jax():
    """chip_smoke.py's json_orders at 20,000 orders: its expected bytes
    (json.dumps of each row) are the JAX writer's and the port's for the
    same rows; read back, filtered by o_odate and o_custkey summed, it
    equals numpy and the JAX reader's table."""
    import chip_smoke as cs
    li, orders = cs.make_data(80_000, 20_000)
    cs.add_join_columns(li, orders)
    n = 20_000
    want = cs.orders_json_text(orders, n)
    hb = cs.orders_json_batch(orders, n)
    jt = agt.table({c: hb.column(c).to_pylist() for c in cs.JSON_COLUMNS})
    js, ts = io.BytesIO(), io.BytesIO()
    jjson.write_json(jt, js)
    tjson.write_json(hb, ts)
    assert js.getvalue() == ts.getvalue() == want
    got_hb, _, got = cs.json_orders(want, "cpu", {})
    keep = orders["o_odate"][:n] < cs.JSON_ODATE_MAX
    assert got == {"sum": int(orders["o_custkey"][:n][keep].sum()),
                   "count": int(keep.sum())}
    same_table(got_hb, jjson.read_json(want))
