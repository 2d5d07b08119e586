"""The port's Substrait bridge (arrow_go_tpu_torch/compute/substrait.py)
against the JAX package's: the same expressions over the same schema
serialize to the same ExtendedExpression bytes, but for the producer
string of the version message (ROADMAP §3); each package decodes the
other's bytes into the same tree; pyarrow.substrait's bytes (Acero's
producer) decode in both into the same tree, whose evaluation over the
same batch agrees (ints and bools exactly, float64 at rtol 1e-9); the
refusals raise the same exception classes. The expressions: those of
tests/test_substrait.py, TPC-H Q6's and Q1's, every `_TO_SUBSTRAIT`
name and `_unchecked` variant, cast, if_else, nested field paths and
every literal kind."""
import datetime

import numpy as np
import pytest
import torch

import arrow_go_tpu.compute.expression as je
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.compute import substrait as js
from arrow_go_tpu.compute.errors import ArrowInvalid as JArrowInvalid
from arrow_go_tpu.compute.errors import \
    ArrowNotImplemented as JArrowNotImplemented

import arrow_go_tpu_torch as agt_torch
import arrow_go_tpu_torch.compute.expression as te
from arrow_go_tpu_torch import compute as tpc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.compute import substrait as ts
from arrow_go_tpu_torch.compute.errors import (ArrowInvalid,
                                               ArrowNotImplemented)
from arrow_go_tpu_torch.device.block import column_to_host
from arrow_go_tpu_torch.interop import protowire as pw
from torch_parity import host_tables

pa = pytest.importorskip("pyarrow")
import pyarrow.compute as pc  # noqa: E402
import pyarrow.substrait as ps  # noqa: E402

PACKAGES = {"jax": (je, jdt, js), "port": (te, tdt, ts)}


def _schema(m: str, fields):
    """A schema of (name, type builder) pairs in package `m`."""
    dtm = PACKAGES[m][1]
    return dtm.Schema([dtm.Field(n, f(dtm), True) for n, f in fields])


BASIC = [("a", lambda d: d.int64), ("b", lambda d: d.float64),
         ("s", lambda d: d.string)]
WIDE = [("a", lambda d: d.int64), ("b", lambda d: d.float64),
        ("c", lambda d: d.int32), ("s", lambda d: d.string),
        ("p", lambda d: d.bool_), ("q", lambda d: d.bool_),
        ("d", lambda d: d.date32), ("f", lambda d: d.float32),
        ("st", lambda d: d.struct([d.Field("x", d.int64),
                                   d.Field("y", d.struct([
                                       d.Field("z", d.float64)]))]))]
LINEITEM = [("l_qty", lambda d: d.int32), ("l_price", lambda d: d.float64),
            ("l_disc", lambda d: d.float64), ("l_tax", lambda d: d.float64),
            ("l_sdate", lambda d: d.int32),
            ("l_rflag", lambda d: d.string),
            ("l_lstatus", lambda d: d.string)]


# -- expression builders, one function of the package module each ----------

def _jax_tests(m):
    """The expressions of tests/test_substrait.py."""
    x, dtm, _ = PACKAGES[m]
    f, lit, call = x.field, x.literal, x.call
    return {
        "gt": call("greater", [f("a"), lit(3)]),
        "mix": call("and_kleene", [call("greater", [f("a"), lit(3)]),
                                   call("less", [f("b"), lit(9.5)])]),
        "arith": call("add", [f("a"), f("a")]),
        "e": call("multiply", [call("add", [f("a"), lit(1)]), f("a")]),
        "cast": call("cast", [f("a")], {"to_type": dtm.float64}),
        "cond": call("if_else", [call("greater", [f("a"), lit(0)]),
                                 f("a"), lit(0)]),
        "u": call("add_unchecked", [f("a"), lit(1)]),
    }


def _q6(m):
    """TPC-H Q6's predicate and revenue (chip_smoke.py:q6_expression)."""
    x = PACKAGES[m][0]
    f, lit, call = x.field, x.literal, x.call
    conds = [call("greater_equal", [f("l_sdate"), lit(8766)]),
             call("less", [f("l_sdate"), lit(9131)]),
             call("greater_equal", [f("l_disc"), lit(0.05)]),
             call("less_equal", [f("l_disc"), lit(0.07)]),
             call("less", [f("l_qty"), lit(24)])]
    pred = conds[0]
    for c in conds[1:]:
        pred = call("and", [pred, c])
    return {"pred": pred,
            "revenue": call("multiply", [f("l_price"), f("l_disc")])}


def _q1(m):
    """TPC-H Q1's projections: disc_price and charge."""
    x = PACKAGES[m][0]
    f, lit, call = x.field, x.literal, x.call
    disc_price = call("multiply", [f("l_price"),
                                   call("subtract", [lit(1.0),
                                                     f("l_disc")])])
    return {"disc_price": disc_price,
            "charge": call("multiply", [disc_price,
                                        call("add", [lit(1.0),
                                                     f("l_tax")])]),
            "where": call("less_equal", [f("l_sdate"), lit(10471)])}


BINARY = ["equal", "not_equal", "greater", "less", "greater_equal",
          "less_equal", "add", "subtract", "multiply", "divide", "power"]
BOOLEAN = ["and", "and_kleene", "or", "or_kleene", "xor"]
UNARY_NUM = ["negate", "sqrt", "abs", "ceil", "floor", "is_null",
             "is_valid", "is_nan", "is_finite"]
UNCHECKED = ["add", "subtract", "multiply", "divide", "negate", "power",
             "sqrt", "abs"]


def _names(m):
    """One call of every `_TO_SUBSTRAIT` name (and each `_unchecked`
    variant) over fields and literals of the WIDE schema."""
    x = PACKAGES[m][0]
    f, lit, call = x.field, x.literal, x.call
    out = {}
    for n in BINARY:
        out[n] = call(n, [f("a"), lit(7)])
        out[n + "_f"] = call(n, [f("b"), f("f")])
        out[n + "_c"] = call(n, [f("c"), lit(2)])
    for n in BOOLEAN:
        out[n] = call(n, [f("p"), f("q")])
    out["invert"] = call("invert", [f("p")])
    for n in UNARY_NUM:
        out[n] = call(n, [f("b")])
        out[n + "_i"] = call(n, [f("c")])
    for n in UNCHECKED:
        args = [f("a"), lit(3)] if n in BINARY else [f("a")]
        out[n + "_unchecked"] = call(n + "_unchecked", args)
    return out


def _casts(m):
    x, dtm, _ = PACKAGES[m]
    f, call = x.field, x.call
    targets = {"i8": dtm.int8, "i16": dtm.int16, "i32": dtm.int32,
               "i64": dtm.int64, "f32": dtm.float32, "f64": dtm.float64,
               "bool": dtm.bool_, "str": dtm.string, "bin": dtm.binary,
               "d32": dtm.date32, "ts": dtm.timestamp("us"),
               "tstz": dtm.timestamp("us", "UTC"), "t64": dtm.time64("us"),
               "dec": dtm.decimal128(20, 3),
               "fsb": dtm.fixed_size_binary(5), "list": dtm.list_(
                   dtm.Field("element", dtm.int32, True)),
               "struct": dtm.struct([dtm.Field("x", dtm.int64, False)]),
               "map": dtm.map_(dtm.string, dtm.float64)}
    return {k: call("cast", [f("a")], {"to_type": t})
            for k, t in targets.items()}


def _selections(m):
    """if_else and nested field paths."""
    x = PACKAGES[m][0]
    f, lit, call = x.field, x.literal, x.call
    return {
        "if_else": call("if_else", [f("p"), f("a"), lit(0)]),
        "if_else_f": call("if_else", [call("less", [f("b"), lit(0.5)]),
                                      f("b"), f("f")]),
        "nested": call("negate", [f("st", "x")]),
        "deep": call("add", [f("st", "y", "z"), lit(1.5)]),
        "nested_cmp": call("greater", [f("st.y.z"), f("b")]),
        "bare_nested": f("st", "y"),
        "bare": f("c"),
    }


LITERALS = {"true": True, "false": False, "zero": 0, "int": 123456789,
            "neg": -42, "big": 2 ** 62, "float": 2.5, "negf": -1e-300,
            "str": "héllo", "empty": "", "bytes": b"\x00\xff",
            "date": datetime.date(2020, 6, 1), "null": None}


def _literals(m):
    x = PACKAGES[m][0]
    return {k: x.call("equal", [x.field("a"), x.literal(v)])
            for k, v in LITERALS.items()}


SETS = {"jax_tests": (_jax_tests, BASIC), "q6": (_q6, LINEITEM),
        "q1": (_q1, LINEITEM), "names": (_names, WIDE),
        "casts": (_casts, WIDE), "selections": (_selections, WIDE),
        "literals": (_literals, WIDE)}


def _version(producer: str) -> bytes:
    """The version message as the last field of an ExtendedExpression."""
    inner = bytearray()
    pw.put_field_varint(inner, 2, 44)
    pw.put_field_str(inner, 5, producer)
    out = bytearray()
    pw.put_field_msg(out, 7, inner)
    return bytes(out)


JAX_VERSION = _version("arrow_go_tpu")
PORT_VERSION = _version(ts.PRODUCER)


def _bytes(m, build, fields, only=None):
    exprs = build(m)
    if only is not None:
        exprs = {only: exprs[only]}
    return PACKAGES[m][2].serialize_expressions(exprs,
                                                schema=_schema(m, fields))


def _same_but_producer(port: bytes, jax: bytes) -> None:
    assert jax.endswith(JAX_VERSION) and port.endswith(PORT_VERSION)
    assert port[:-len(PORT_VERSION)] == jax[:-len(JAX_VERSION)]


def _same_tree(got, want, what=""):
    """A port expression tree equal to a JAX one: node kinds, function
    names, field paths, literal values and types, a cast's target."""
    assert type(got).__name__ == type(want).__name__, what
    if isinstance(want, je.Literal):
        assert type(got.value) is type(want.value), what
        assert got.value == want.value, what
    elif isinstance(want, je.FieldRef):
        assert tuple(got.path) == tuple(want.path), what
    else:
        assert got.function == want.function, what
        assert len(got.args) == len(want.args), what
        if want.function == "cast":
            assert str(got.options["to_type"]) == \
                str(want.options["to_type"]), what
        for i, (g, w) in enumerate(zip(got.args, want.args)):
            _same_tree(g, w, f"{what}.{i}")


def _cases():
    for set_name, (build, _) in SETS.items():
        for key in build("jax"):
            yield set_name, key


CASES = list(_cases())


@pytest.mark.parametrize("set_name,key", CASES)
def test_bytes_equal_the_jax_serializer(set_name, key):
    build, fields = SETS[set_name]
    _same_but_producer(_bytes("port", build, fields, key),
                       _bytes("jax", build, fields, key))


@pytest.mark.parametrize("set_name", list(SETS))
def test_each_package_decodes_the_others_bytes(set_name):
    build, fields = SETS[set_name]
    jb, tb = _bytes("jax", build, fields), _bytes("port", build, fields)
    _same_but_producer(tb, jb)
    from_jax = ts.deserialize_expressions(jb)
    from_port = js.deserialize_expressions(tb)
    jax_own = js.deserialize_expressions(jb)
    assert list(from_jax.expressions) == list(build("jax"))
    for k, want in jax_own.expressions.items():
        _same_tree(from_jax.expressions[k], want, k)
        _same_tree(from_port.expressions[k], want, k)
    assert [str(f.type) for f in from_jax.schema.fields] == \
        [str(f.type) for f in jax_own.schema.fields]
    assert from_jax.schema.names == jax_own.schema.names


@pytest.mark.parametrize("fields", [BASIC, WIDE, LINEITEM],
                         ids=["basic", "wide", "lineitem"])
def test_schema_bytes_and_names_both_ways(fields):
    jb = js.serialize_schema(_schema("jax", fields))
    tb = ts.serialize_schema(_schema("port", fields))
    assert tb == jb
    got, want = ts.deserialize_schema(jb), js.deserialize_schema(tb)
    assert got.names == want.names
    assert [str(f.type) for f in got.fields] == \
        [str(f.type) for f in want.fields]
    assert [f.nullable for f in got.fields] == \
        [f.nullable for f in want.fields]


def test_schema_of_every_type_kind_matches():
    kinds = [("m", lambda d: d.map_(d.string, d.int64)),
             ("dec", lambda d: d.decimal128(20, 3)),
             ("ts", lambda d: d.timestamp("us")),
             ("tstz", lambda d: d.timestamp("ms", "UTC")),
             ("t64", lambda d: d.time64("ns")),
             ("fsb", lambda d: d.fixed_size_binary(7)),
             ("ll", lambda d: d.large_list(d.large_string)),
             ("lb", lambda d: d.large_binary),
             ("i8", lambda d: d.int8), ("i16", lambda d: d.int16),
             ("f32", lambda d: d.float32)]
    jb = js.serialize_schema(_schema("jax", kinds))
    assert ts.serialize_schema(_schema("port", kinds)) == jb
    got, want = ts.deserialize_schema(jb), js.deserialize_schema(jb)
    assert got.names == want.names
    assert [str(f.type) for f in got.fields] == \
        [str(f.type) for f in want.fields]


def test_pyarrow_schema_bytes_match():
    schema = pa.schema([("a", pa.int64()), ("b", pa.float64()),
                        ("s", pa.string())])
    theirs = bytes(memoryview(ps.serialize_schema(schema).schema))
    assert ts.serialize_schema(_schema("port", BASIC)) == theirs
    assert ts.deserialize_schema(theirs).names == ["a", "b", "s"]


def test_int_literal_output_type_is_int64_only_in_the_bytes():
    """Quirk 1 (ROADMAP §3): the encoder types `field("c") + 1` over
    int32 as int64, as the JAX bytes do; compile_expression keeps the
    eager int32."""
    schema, jschema = _schema("port", WIDE), _schema("jax", WIDE)
    expr = te.call("add", [te.field("c"), te.literal(1)])
    jexpr = je.call("add", [je.field("c"), je.literal(1)])
    assert str(ts._infer_output_type(expr, schema)) == "int64"
    assert str(je._infer_output_type(jexpr, jschema)) == "int64"
    _same_but_producer(ts.serialize_expressions({"e": expr}, schema=schema),
                       js.serialize_expressions({"e": jexpr},
                                                schema=jschema))
    db = agt_torch.batch_to_device({"c": np.arange(5, dtype=np.int32)},
                                   device="cpu")
    out = te.compile_expression(expr, db.schema)(db)
    assert out.type == tdt.int32
    assert column_to_host(out).to_pylist() == [1, 2, 3, 4, 5]


# -- pyarrow.substrait (Acero) --------------------------------------------

PA_SCHEMA = pa.schema([("a", pa.int64()), ("b", pa.float64()),
                       ("c", pa.int32()), ("p", pa.bool_()),
                       ("q", pa.bool_())])


def _pa_expressions():
    a, b, c, p, q = (pc.field(n) for n in ("a", "b", "c", "p", "q"))
    i64, f64 = (lambda v: pa.scalar(v, pa.int64())), pa.scalar
    return {
        "gt": a > i64(3), "lt": b < f64(2.5), "le": b <= f64(1.0),
        "eq": a == i64(5), "ne": c != pa.scalar(1, pa.int32()),
        "add": a + i64(1), "sub": b - f64(0.5), "mul": b * f64(2.0),
        "div": b / f64(4.0), "and": p & q, "or": p | q, "not": ~p,
        "is_null": a.is_null(), "is_valid": a.is_valid(),
        "negate": pc.negate(a), "abs": pc.abs(b), "sqrt": pc.sqrt(b),
        "power": pc.power(b, f64(2.0)), "add_checked": pc.add_checked(
            a, i64(1)), "is_nan": pc.is_nan(b), "is_finite": pc.is_finite(b),
        "idiv": pc.divide(a, i64(2)), "if_else": pc.if_else(p, a, i64(0)),
        "cast": a.cast(pa.float64(), safe=False),
        "q6like": (a >= i64(2)) & (b < f64(3.0)) & (c < pa.scalar(
            24, pa.int32())),
    }


def _pa_batch(seed: int):
    rng = np.random.default_rng(seed)
    n = 64
    data = {"a": rng.integers(-50, 50, n).astype(np.int64),
            "b": rng.standard_normal(n) * 4,
            "c": rng.integers(0, 40, n).astype(np.int32),
            "p": rng.random(n) < 0.5, "q": rng.random(n) < 0.5}
    data["b"][::9] = np.abs(data["b"][::9])
    masks = {k: rng.random(n) > 0.2 for k in ("a", "b", "p", "q")}
    return data, masks


@pytest.mark.parametrize("key", list(_pa_expressions()))
def test_pyarrow_bytes_decode_and_evaluate_in_both(key):
    blob = bytes(memoryview(ps.serialize_expressions(
        [_pa_expressions()[key]], [key], PA_SCHEMA)))
    want = js.deserialize_expressions(blob).expressions[key]
    got = ts.deserialize_expressions(blob).expressions[key]
    _same_tree(got, want, key)
    data, masks = _pa_batch(sum(map(ord, key)))
    jrb, hb = host_tables(data, masks)
    if want.function.endswith("_unchecked"):
        # neither expression evaluator takes an `_unchecked` name (the
        # JAX one is `not traceable`): both raise ArrowKeyError, and the
        # call goes through each registry
        from arrow_go_tpu.compute.errors import ArrowKeyError as JKeyError
        from arrow_go_tpu.compute.registry import call_function as jcall
        from arrow_go_tpu_torch.compute.errors import ArrowKeyError
        _raises_both(
            lambda: tpc.execute_scalar_expression(got, hb, device="cpu"),
            lambda: je.execute_scalar_expression(want, jrb),
            ArrowKeyError, JKeyError)
        jout = jcall(want.function, [
            jrb.column(a.path[0]) if isinstance(a, je.FieldRef)
            else a.value for a in want.args]).to_pylist()
        tout = tpc.call_function(got.function, [
            hb.column(a.path[0]) if isinstance(a, te.FieldRef)
            else a.value for a in got.args], device="cpu").to_pylist()
    else:
        jout = je.execute_scalar_expression(want, jrb).to_pylist()
        tout = tpc.execute_scalar_expression(got, hb,
                                             device="cpu").to_pylist()
    assert [v is None for v in tout] == [v is None for v in jout], key
    tv = [v for v in tout if v is not None]
    jv = [v for v in jout if v is not None]
    if jv and isinstance(jv[0], float):
        np.testing.assert_allclose(tv, jv, rtol=1e-9, atol=0,
                                   equal_nan=True, err_msg=key)
    else:
        assert tv == jv, key


def test_port_bytes_decode_and_filter_in_pyarrow():
    """The port's bytes read by Acero, as the JAX test holds its own."""
    exprs = _jax_tests("port")
    blob = ts.serialize_expressions(exprs, schema=_schema("port", BASIC))
    out = ps.deserialize_expressions(blob)
    assert set(out.expressions) == set(exprs)
    tbl = pa.table({"a": [1, 5, 9], "b": [1.0, 20.0, 2.0],
                    "s": ["x", "y", "z"]})
    assert tbl.filter(out.expressions["gt"]).column("a").to_pylist() == \
        [5, 9]
    assert tbl.filter(out.expressions["mix"]).column("a").to_pylist() == [9]
    assert "add_checked" not in str(out.expressions["u"])


def test_decoded_q6_evaluates_as_the_eager_one():
    """Q6's predicate through the port's bytes (decoded `and` is
    `and_kleene`) selects the rows the written tree selects, and its
    revenue is the same column."""
    rng = np.random.default_rng(16)
    n = 500
    data = {"l_qty": rng.integers(1, 51, n).astype(np.int32),
            "l_price": rng.random(n) * 1000,
            "l_disc": np.round(rng.random(n) * 0.1, 2),
            "l_tax": rng.random(n) * 0.08,
            "l_sdate": rng.integers(8500, 9500, n).astype(np.int32)}
    _, hb = host_tables(data)
    schema = _schema("port", LINEITEM[:5])
    exprs = _q6("port")
    be = ts.deserialize_expressions(ts.serialize_expressions(
        exprs, schema=schema))
    assert be.expressions["pred"].function == "and_kleene"
    for k in exprs:
        got = tpc.execute_scalar_expression(be.expressions[k], hb,
                                            device="cpu")
        want = tpc.execute_scalar_expression(exprs[k], hb, device="cpu")
        assert got.to_pylist() == want.to_pylist(), k


# -- refusals ----------------------------------------------------------------

def _raises_both(fn_port, fn_jax, port_exc, jax_exc):
    with pytest.raises(port_exc):
        fn_port()
    with pytest.raises(jax_exc):
        fn_jax()


def test_unknown_function_refused_by_both():
    def ser(m):
        x = PACKAGES[m][0]
        return PACKAGES[m][2].serialize_expressions(
            {"e": x.call("utf8_upper", [x.field("s")])},
            schema=_schema(m, BASIC))
    _raises_both(lambda: ser("port"), lambda: ser("jax"),
                 ArrowNotImplemented, JArrowNotImplemented)


def _hand_built(function: str, arg_field: int) -> bytes:
    """An ExtendedExpression of one call of `function` over field 0 whose
    argument sits in FunctionArgument field `arg_field` (3: a value, 1:
    an enum)."""
    out = bytearray()
    uri = bytearray()
    pw.put_field_varint(uri, 1, 1)
    pw.put_field_str(uri, 2, js.URI_ARITHMETIC)
    pw.put_field_msg(out, 1, uri)
    decl, fn = bytearray(), bytearray()
    pw.put_field_varint(fn, 1, 1)
    pw.put_field_varint(fn, 2, 1)
    pw.put_field_str(fn, 3, function)
    pw.put_field_msg(decl, 3, fn)
    pw.put_field_msg(out, 2, decl)
    seg, sf, fr, ex = bytearray(), bytearray(), bytearray(), bytearray()
    pw.put_field_msg(seg, 2, sf)
    pw.put_field_msg(fr, 1, seg)
    pw.put_field_msg(fr, 4, bytearray())
    pw.put_field_msg(ex, 2, fr)
    arg = bytearray()
    if arg_field == 3:
        pw.put_field_msg(arg, 3, ex)
    else:
        pw.put_field_str(arg, 1, "SOME_ENUM")
    call = bytearray()
    pw.put_field_varint(call, 1, 1)
    pw.put_field_msg(call, 4, arg)
    body = bytearray()
    pw.put_field_msg(body, 3, call)
    ref = bytearray()
    pw.put_field_msg(ref, 1, body)
    pw.put_field_str(ref, 3, "e")
    pw.put_field_msg(out, 3, ref)
    pw.put_field_msg(out, 4, bytearray(js.serialize_schema(
        _schema("jax", BASIC))))
    return bytes(out)


@pytest.mark.parametrize("function,arg_field,exc", [
    ("negate", 1, "NotImplemented"),          # an enum argument
    ("regexp_match", 3, "NotImplemented"),    # a function we lack
    ("negate", 3, None)])                     # the well-formed control
def test_hand_built_refusals_match(function, arg_field, exc):
    blob = _hand_built(function, arg_field)
    if exc is None:
        _same_tree(ts.deserialize_expressions(blob).expressions["e"],
                   js.deserialize_expressions(blob).expressions["e"])
        return
    _raises_both(lambda: ts.deserialize_expressions(blob),
                 lambda: js.deserialize_expressions(blob),
                 ArrowNotImplemented, JArrowNotImplemented)


def test_unresolved_anchor_and_unsupported_types_refused_by_both():
    blob = bytearray(_hand_built("negate", 3))
    # drop the extension declarations: anchor 1 resolves to nothing
    fields = [(f, v) for f, _, v in pw.fields(bytes(blob)) if f != 2]
    stripped = bytearray()
    for f, v in fields:
        pw.put_field_bytes(stripped, f, v)
    _raises_both(lambda: ts.deserialize_expressions(bytes(stripped)),
                 lambda: js.deserialize_expressions(bytes(stripped)),
                 ArrowInvalid, JArrowInvalid)
    for ctor in (lambda d: d.uint32, lambda d: d.duration("s"),
                 lambda d: d.date64, lambda d: d.float16):
        _raises_both(
            lambda: ts.serialize_schema(_schema("port", [("u", ctor)])),
            lambda: js.serialize_schema(_schema("jax", [("u", ctor)])),
            ArrowNotImplemented, JArrowNotImplemented)
    _raises_both(
        lambda: ts.serialize_expressions([te.field("a")], None,
                                         _schema("port", BASIC)),
        lambda: js.serialize_expressions([je.field("a")], None,
                                         _schema("jax", BASIC)),
        ArrowInvalid, JArrowInvalid)
    for v in (1j, object()):
        _raises_both(
            lambda: ts.serialize_expressions(
                {"e": te.call("equal", [te.field("a"), te.literal(v)])},
                schema=_schema("port", BASIC)),
            lambda: js.serialize_expressions(
                {"e": je.call("equal", [je.field("a"), je.literal(v)])},
                schema=_schema("jax", BASIC)),
            ArrowNotImplemented, JArrowNotImplemented)


def test_pre_epoch_date_literal_decodes_in_the_port_only():
    """A recorded deviation (ROADMAP §3): a date before 1970 is a
    negative int32, written as a sign-extended 10-byte varint by both
    encoders (the same bytes); the port decodes it, the JAX decoder
    overflows."""
    old = datetime.date(1960, 1, 2)
    blob = ts.serialize_expressions(
        {"e": te.call("less", [te.field("d"), te.literal(old)])},
        schema=_schema("port", WIDE))
    jblob = js.serialize_expressions(
        {"e": je.call("less", [je.field("d"), je.literal(old)])},
        schema=_schema("jax", WIDE))
    _same_but_producer(blob, jblob)
    assert ts.deserialize_expressions(jblob).expressions["e"].args[1] \
        .value == old
    with pytest.raises(OverflowError):
        js.deserialize_expressions(blob)
    pa_blob = bytes(memoryview(ps.serialize_expressions(
        [pc.field("d") < pa.scalar(old, pa.date32())], ["e"],
        pa.schema([("d", pa.date32())]))))
    assert ts.deserialize_expressions(pa_blob).expressions["e"].args[1] \
        .value == old


def test_compute_exposes_the_bridge():
    assert tpc.serialize_expressions is ts.serialize_expressions
    assert tpc.deserialize_expressions is ts.deserialize_expressions
    assert tpc.BoundExpressions is ts.BoundExpressions
    be = tpc.deserialize_expressions(_bytes("port", _q6, LINEITEM))
    assert isinstance(be, tpc.BoundExpressions)
    assert repr(be).startswith("BoundExpressions(")


# -- the slice as a whole: chip_smoke.py's substrait_q6 on the CPU -----------

PATH_ROWS = 200_000


def _to_jax(e):
    """The JAX package's tree of a port expression (a cast's target by
    torch_parity.jax_type)."""
    from torch_parity import jax_type
    if isinstance(e, te.Literal):
        return je.literal(e.value)
    if isinstance(e, te.FieldRef):
        return je.field(*e.path)
    opts = e.options
    if e.function == "cast":
        opts = {**opts, "to_type": jax_type(opts["to_type"])}
    return je.call(e.function, [_to_jax(a) for a in e.args], opts)


def test_chip_smoke_substrait_q6_matches_jax():
    """Q6 and Q1's projections from Substrait bytes at 200,000 rows
    through chip_smoke.py's own functions: the port decodes the JAX
    serializer's bytes (equal to its own but for the producer) and runs
    substrait_q6, equal to the eager compute_q6 bit for bit and to the
    JAX package's decode of the port's bytes run through the JAX
    functions; the decoded projections equal q1_projections bit for
    bit."""
    import chip_smoke as cs
    from torch_parity import jax_batch, jax_type
    import arrow_go_tpu.compute as jpc
    from arrow_go_tpu.compute.functions import agg_sum as jax_agg_sum
    from test_torch_dataset import _jproject
    li, _ = cs.make_data(PATH_ROWS, PATH_ROWS // 4)
    cs.add_quantity(li)
    cs.add_q1_columns(li)
    cols = {c: li[c] for c in cs.SUBSTRAIT_COLUMNS}
    db = agt_torch.batch_to_device(cols, device="cpu")
    exprs = {"pred": cs.q6_expression(), "revenue": te.call(
        "multiply", [te.field("l_price"), te.field("l_disc")])}
    jschema = jdt.Schema([jdt.Field(f.name, jax_type(f.type), f.nullable)
                          for f in db.schema.fields])
    blob = ts.serialize_expressions(exprs, schema=db.schema)
    jblob = js.serialize_expressions({k: _to_jax(v) for k, v in
                                      exprs.items()}, schema=jschema)
    _same_but_producer(blob, jblob)
    be = ts.deserialize_expressions(jblob)
    got = cs.substrait_q6(be, db)
    cs.check_q6(got, cs.q6_oracle(li))
    assert got == cs.compute_q6(db)
    jbe = js.deserialize_expressions(blob)
    jdb = jax_batch(cols)
    li_f = jpc.filter(_jproject(jdb, ["l_price", "l_disc"]),
                      jpc.execute_scalar_expression(
                          jbe.expressions["pred"], jdb))
    rev = jpc.execute_scalar_expression(jbe.expressions["revenue"], li_f)
    assert got["count"] == li_f.length
    np.testing.assert_allclose(got["revenue"], jax_agg_sum(rev), rtol=1e-9)
    q1 = ts.deserialize_expressions(ts.serialize_expressions(
        cs.q1_substrait_expressions(), schema=db.schema))
    for name, col in zip(("disc_price", "charge"), cs.q1_projections(db)):
        via = tpc.execute_scalar_expression(q1.expressions[name], db)
        assert via.values.view(torch.int64).equal(
            col.values.view(torch.int64)), name
