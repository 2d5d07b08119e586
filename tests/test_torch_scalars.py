"""The port's scalars against the JAX package's: the cases of
tests/test_misc_components.py (inferred types, validity, equality,
broadcasts, parsing, casts), plus decimals, dates, timestamps, nested
values and null scalars, through both packages. Broadcast columns are
compared value for value (same_array), a typeless null's to the JAX
package's null column."""
import datetime
import decimal

import numpy as np
import pytest

import arrow_go_tpu.compute as jpc
from arrow_go_tpu import dtypes as jdt

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute.scalars import infer_type
from torch_parity import jax_type, same_array

VALUES = [5, -3, 2.5, True, False, "x", b"yz", decimal.Decimal("1.25"),
          decimal.Decimal("-0.500"), datetime.date(2020, 1, 2),
          datetime.datetime(2020, 1, 1, 5, 6, 7, 8),
          datetime.datetime(2021, 3, 4, 1, tzinfo=datetime.timezone.utc),
          np.int32(7), np.float32(0.25), [1, None, 3], {"a": 1, "b": 2.5},
          [{"a": 1}, None]]


@pytest.mark.parametrize("v", VALUES, ids=repr)
def test_inferred_scalars_match_jax(v):
    s, js = pc.scalar(v), jpc.scalar(v)
    assert str(s.type) == str(js.type)
    assert s.as_py() == js.as_py() and s.value is v and s.is_valid
    assert s == pc.scalar(v) and s == v
    if not isinstance(v, (list, dict)):     # (those are unhashable)
        assert hash(s) == hash(pc.scalar(v))
    same_array(pc.make_array_from_scalar(s, 3),
               jpc.make_array_from_scalar(js, 3), repr(v))


def test_the_misc_components_cases():
    s = pc.scalar(5)
    assert s.type == dt.int64 and s.as_py() == 5 and s.is_valid
    n = pc.scalar(None, dt.float64)
    assert not n.is_valid
    assert pc.scalar(5) == pc.scalar(5)
    assert pc.scalar(5) != pc.scalar(6)
    assert pc.make_array_from_scalar(pc.scalar("x"), 3).to_pylist() == \
        ["x", "x", "x"]
    assert pc.make_array_from_scalar(pc.scalar(None, dt.int32),
                                     2).to_pylist() == [None, None]
    assert pc.parse_scalar(dt.int32, "42").as_py() == 42
    assert pc.parse_scalar(dt.float64, "1.5").as_py() == 1.5
    assert pc.parse_scalar(dt.bool_, "true").as_py() is True
    assert pc.parse_scalar(dt.decimal128(10, 2), "1.25").as_py() == \
        decimal.Decimal("1.25")
    assert pc.scalar(5).cast(dt.float64, device="cpu").as_py() == 5.0


TYPED = [(None, "int32"), (None, "double"), (None, "utf8"),
         (None, "decimal128(10, 2)"), (None, "date32"),
         (7, "uint64"), (2 ** 64 - 1, "uint64"), (-7, "int8"),
         (1.5, "halffloat"), (3, "decimal32(7, 2)"),
         (decimal.Decimal("12.3"), "decimal64(15, 2)"),
         (decimal.Decimal("-12.25"), "decimal256(50, 3)"),
         (2.675, "decimal128(10, 2)"), (datetime.date(1969, 12, 31),
                                        "date32"),
         (datetime.datetime(2020, 1, 1, 1), "timestamp[ms]"),
         (12, "time32[s]"), (1234, "duration[ms]"), (10, "date64")]


def _types(name: str):
    t = dt.type_for_name(name)
    return t, jax_type(t)


@pytest.mark.parametrize("v,tname", TYPED, ids=repr)
def test_typed_scalars_and_their_broadcasts_match_jax(v, tname):
    t, jt = _types(tname)
    s, js = pc.scalar(v, t), jpc.scalar(v, jt)
    assert s.is_valid == js.is_valid and str(s.type) == str(js.type)
    assert repr(s) == repr(js)
    same_array(pc.make_array_from_scalar(s, 4),
               jpc.make_array_from_scalar(js, 4), repr((v, tname)))


def test_a_typeless_null_broadcasts_to_the_jax_null_column():
    s, js = pc.scalar(None), jpc.scalar(None)
    assert s.type == dt.null and str(s.type) == str(js.type) == "null"
    assert not s.is_valid and repr(s) == repr(js)
    for n in (0, 2, 5):
        got, want = pc.make_array_from_scalar(s, n), \
            jpc.make_array_from_scalar(js, n)
        assert got.type == dt.null and str(want.type) == "null"
        same_array(got, want, f"null x {n}")
        assert got.to_pylist() == want.to_pylist() == [None] * n
    assert s.cast(dt.int32).type == dt.int32
    assert not s.cast(dt.int32).is_valid


PARSE = [("bool", "FALSE"), ("bool", "1"), ("int8", "-12"),
         ("uint32", "4000000000"), ("float", "2.5"), ("double", "-1e300"),
         ("decimal128(10, 2)", "-3.75"), ("decimal64(12, 4)", "1"),
         ("date32", "2024-02-29"), ("timestamp[ms]", "2020-01-01T05:06:07"),
         ("utf8", "hello"), ("binary", "raw")]


@pytest.mark.parametrize("tname,text", PARSE, ids=repr)
def test_parse_scalar_matches_jax(tname, text):
    t, jt = _types(tname)
    s, js = pc.parse_scalar(t, text), jpc.parse_scalar(jt, text)
    assert s.as_py() == js.as_py() and type(s.as_py()) is type(js.as_py())
    assert str(s.type) == str(js.type)


@pytest.mark.parametrize("tname,text", [("bool", "maybe"),
                                        ("time32[s]", "01:00:00"),
                                        ("duration[s]", "5")], ids=repr)
def test_parse_scalar_refusals_match_jax(tname, text):
    t, jt = _types(tname)
    with pytest.raises(jpc.ArrowInvalid):
        jpc.parse_scalar(jt, text)
    with pytest.raises(pc.ArrowInvalid):
        pc.parse_scalar(t, text)


CASTS = [(5, None, "double"), (5.75, None, "int32"), (5, None, "utf8"),
         ("12", None, "int64"), ("2020-01-02", None, "date32"),
         (True, None, "int8"), (300, "int64", "uint16"),
         (decimal.Decimal("1.25"), None, "double"),
         ("-7.125", None, "decimal128(12, 3)")]


@pytest.mark.parametrize("v,frm,to", CASTS, ids=repr)
def test_scalar_casts_match_jax(v, frm, to):
    t, jt = _types(to)
    ft, jft = _types(frm) if frm else (None, None)
    try:
        want = jpc.scalar(v, jft).cast(jt)
    except Exception as e:            # the port fails with the same class
        with pytest.raises(Exception) as info:
            pc.scalar(v, ft).cast(t, device="cpu")
        assert type(info.value).__name__ == type(e).__name__
        return
    got = pc.scalar(v, ft).cast(t, device="cpu")
    assert str(got.type) == str(want.type)
    assert got.as_py() == want.as_py(), (got, want)


def test_infer_type_follows_the_jax_builders():
    from arrow_go_tpu.array.builders import infer_type as jinfer
    for rows in ([], [None], [None, 3], [1.5, None], [[1], [2.5]],
                 [{"a": None}, {"a": 1}], [decimal.Decimal("1.5"),
                                           decimal.Decimal("2.25")],
                 [np.uint8(3)], [bytearray(b"x")]):
        assert str(infer_type(rows)) == str(jinfer(rows)), rows
    with pytest.raises(ValueError):
        infer_type([object()])
    assert str(jdt.null) == str(dt.null)
