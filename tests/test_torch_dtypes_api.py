"""The port's dtypes.py API against the JAX package's: every case of
tests/test_dtypes.py on both modules, and for every type of the JAX set
the concrete class's name, `byte_width` (or the same refusal),
`bit_width`, `is_fixed_width`, `is_primitive`, `buffer_kinds` and the
device dtype (a torch dtype in the port, ROADMAP §3), with the Schema,
Field and Metadata methods on the same inputs."""
import numpy as np
import pytest
import torch

import arrow_go_tpu as jagt
from arrow_go_tpu import dtypes as jdt

import arrow_go_tpu_torch as agt
from arrow_go_tpu_torch import dtypes as dt
from torch_parity import port_type

BOTH = [(jagt, jdt), (agt, dt)]


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_type_ids_complete(pkg, d):
    assert len(d.TypeId) == 45
    assert [(m.name, int(m)) for m in dt.TypeId] == \
        [(m.name, int(m)) for m in jdt.TypeId]


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_primitive_properties(pkg, d):
    assert d.int64.is_integer and d.int64.is_signed_integer
    assert d.uint8.is_unsigned_integer
    assert d.float32.is_floating and d.float32.is_numeric
    assert d.int32.np_dtype == np.dtype(np.int32)
    assert d.int32.bit_width == 32 and d.bool_.bit_width == 1
    assert d.string.is_binary_like and d.list_(d.int32).is_nested


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_equality(pkg, d):
    assert d.int32 == d.Int32Type() and d.int32 != d.int64
    assert d.timestamp("us") == d.timestamp("us")
    assert d.timestamp("us") != d.timestamp("ns")
    assert d.timestamp("us", "UTC") != d.timestamp("us")
    assert d.decimal128(10, 2) == d.decimal128(10, 2)
    assert d.decimal128(10, 2) != d.decimal128(11, 2)
    assert d.list_(d.int32) == d.list_(d.int32)
    assert d.list_(d.int32) != d.list_(d.int64)
    assert d.struct({"a": d.int32}) == d.struct({"a": d.int32})
    assert hash(d.int32) == hash(d.Int32Type())
    assert d.Decimal128Type(10, 2) == d.decimal128(10, 2)
    assert d.Time32Type(d.TimeUnit.SECOND) == d.time32("s")


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_schema(pkg, d):
    s = pkg.schema({"a": d.int64, "b": d.string})
    assert s.num_fields == 2 and s.field_index("b") == 1
    assert s.field_by_name("a").type == d.int64
    assert s.field_by_name("zz") is None
    assert s.has_field("a") and not s.has_field("zz")
    s2 = s.add_field(1, d.field("c", d.float64))
    assert s2.names == ["a", "c", "b"] and s.names == ["a", "b"]
    s3 = s2.remove_field(1)
    assert s3.equals(s) and s3 == s
    assert s.types == [d.int64, d.string]
    s4 = s.set_field(0, d.field("z", d.int8, False))
    assert s4.names == ["z", "b"] and not s4.field(0).nullable
    m = d.Metadata({"k": "v"})
    sm = s.with_metadata(m)
    assert sm.metadata.get("k") == "v" and sm.equals(s)
    assert not sm.equals(s, check_metadata=True)


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_metadata(pkg, d):
    m = d.Metadata({"k1": "v1", "k2": "v2"})
    assert m.get("k1") == "v1" and m.get("nope", "d") == "d"
    m2 = m.with_pair("k3", "v3")
    assert len(m2) == 3 and len(m) == 2
    assert m2.to_dict() == {"k1": "v1", "k2": "v2", "k3": "v3"}
    assert bool(m) and not bool(d.Metadata())
    assert m == d.Metadata(keys=["k1", "k2"], values=["v1", "v2"])


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_decimal_precision_bounds(pkg, d):
    with pytest.raises(ValueError):
        d.decimal32(10, 0)
    with pytest.raises(ValueError):
        d.decimal128(39, 0)
    d.decimal256(76, 10)


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_map_type(pkg, d):
    m = d.map_(d.string, d.int64)
    assert m.key_type == d.string and m.item_type == d.int64
    assert m.value_type.id == d.TypeId.STRUCT
    assert m.value_type.field_by_name("key").type == d.string
    assert m.value_type.field_by_name("nope") is None


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_field(pkg, d):
    f = d.field("x", d.int32, False, d.Metadata({"a": "b"}))
    g = f.with_type(d.int64)
    assert g.type == d.int64 and g.name == "x" and not g.nullable
    assert g.metadata.get("a") == "b"
    assert f.equals(d.field("x", d.int32, False))
    assert not f.equals(d.field("x", d.int32, False), check_metadata=True)
    assert f.with_name("y").name == "y"


def _types(d):
    return {
        "null": d.null, "bool": d.bool_, "int8": d.int8, "int16": d.int16,
        "int32": d.int32, "int64": d.int64, "uint8": d.uint8,
        "uint16": d.uint16, "uint32": d.uint32, "uint64": d.uint64,
        "float16": d.float16, "float32": d.float32, "float64": d.float64,
        "date32": d.date32, "date64": d.date64, "time32": d.time32("ms"),
        "time64": d.time64("ns"), "timestamp": d.timestamp("us", "UTC"),
        "duration": d.duration("s"), "month_interval": d.month_interval,
        "day_time_interval": d.day_time_interval,
        "month_day_nano_interval": d.month_day_nano_interval,
        "decimal32": d.decimal32(7, 2), "decimal64": d.decimal64(15, 2),
        "decimal128": d.decimal128(30, 2),
        "decimal256": d.decimal256(60, 2),
        "fixed_size_binary": d.fixed_size_binary(5), "string": d.string,
        "binary": d.binary, "large_string": d.large_string,
        "large_binary": d.large_binary, "string_view": d.string_view,
        "binary_view": d.binary_view, "list": d.list_(d.int32),
        "large_list": d.large_list(d.int32),
        "list_view": d.ListViewType(d.int32),
        "large_list_view": d.LargeListViewType(d.int32),
        "fixed_size_list": d.fixed_size_list(d.int32, 2),
        "struct": d.struct({"a": d.int32}), "map": d.map_(d.string, d.int8),
        "sparse_union": d.sparse_union([d.field("a", d.int32)]),
        "dense_union": d.dense_union([d.field("a", d.int32)]),
        "dictionary": d.dictionary(d.int16, d.string),
        "run_end_encoded": d.run_end_encoded(d.int32, d.string),
        "extension": d.ExtensionType(d.int16, "x.y"),
    }


NAMES = list(_types(jdt))


def _byte_width(t):
    try:
        return t.byte_width
    except ValueError:
        return "refused"


@pytest.mark.parametrize("name", NAMES)
def test_every_type_has_the_jax_class_and_layout(name):
    jt, t = _types(jdt)[name], _types(dt)[name]
    # the JAX class's module name (its numeric classes' __name__ is
    # "Uint8Type", "HalffloatType", ...)
    cls = next(k for k, v in vars(jdt).items() if v is type(jt))
    assert type(t) is getattr(dt, cls), (name, cls)
    assert t == port_type(jt) and str(t) == str(jt)
    assert _byte_width(t) == _byte_width(jt)
    assert t.bit_width == jt.bit_width
    assert t.is_fixed_width == jt.is_fixed_width
    assert t.is_primitive == jt.is_primitive
    assert [int(k) for k in t.buffer_kinds()] == \
        [int(k) for k in jt.buffer_kinds()]
    assert [k.name for k in dt.BufferKind] == [k.name for k in jdt.BufferKind]


@pytest.mark.parametrize("name", NAMES)
def test_the_device_dtype_is_the_ports_storage(name):
    # the JAX device_dtype is the numpy dtype a TPU column holds; the
    # port's the torch dtype its column is stored in (ROADMAP §3): the
    # same width and kind where both store values, int32 codes for a
    # string-like or fixed_size_binary type (None in the JAX package),
    # int64 limbs for decimal128 / decimal256
    jt, t = _types(jdt)[name], _types(dt)[name]
    got, want = t.device_dtype, jt.device_dtype
    assert got is None or isinstance(got, torch.dtype)
    if t.codes_on_device:
        assert got == torch.int32 and want is None
    elif t.limbs:
        assert got == torch.int64 and want is None
    elif want is None or want.names:
        assert got is None
    else:
        assert torch.empty(0, dtype=got).element_size() == want.itemsize
        assert got.is_floating_point == (want.kind == "f")
