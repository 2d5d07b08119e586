"""The port's variant type (arrow_go_tpu_torch/parquet/variant.py, the
VariantType of extensions.py, the VARIANT group of parquet/schema.py)
against the JAX package's: metadata and value bytes bit for bit, decodes
of the JAX bytes, shredding and unshredding over every typed_value kind,
variant columns written by each package's parquet writer and read by the
other's reader, and the refusals with the JAX exception classes."""
import datetime as dt_
import decimal
import io
import uuid as uuid_

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import extensions as jext
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.array.arrays import ArrayData, make_array
from arrow_go_tpu.array.builders import make_builder
from arrow_go_tpu.compute.errors import ArrowInvalid as JArrowInvalid
from arrow_go_tpu.parquet import variant as jvar

from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import extensions as ext
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.compute.errors import ArrowInvalid
from arrow_go_tpu_torch.device.block import ExtensionArray, from_pylist
from arrow_go_tpu_torch.parquet import variant as var

from torch_parity import jax_type, port_type

PRIMITIVES = [
    None, True, False, 0, -1, 127, -128, 128, 1000, -32768, 32768, 2**20,
    -2**31, 2**31, 2**40, -2**62, 2**63 - 1, 1.5, -0.25, float(10**100),
    float("inf"), "", "short", "x" * 63, "y" * 64, "unicode ünïcødé 漢字",
    b"", b"raw\x00bytes", b"z" * 300,
    decimal.Decimal("123.456"), decimal.Decimal("-0.00001"),
    decimal.Decimal("1E+3"), decimal.Decimal("12345678901234567890.123"),
    dt_.date(2024, 2, 29), dt_.date(1969, 12, 31),
    dt_.datetime(2023, 5, 1, 12, 30, 45, 123456),
    dt_.datetime(2023, 5, 1, 12, 30, 45, 123456, tzinfo=dt_.timezone.utc),
    dt_.time(23, 59, 59, 999999),
    uuid_.UUID("f24f9b64-81fa-49d1-b74e-8c09a6e31c56"),
]

NESTED = [
    {}, [], {"a": {}}, [[]], {"a": []},
    {"name": "alice", "age": 30, "tags": ["a", "b", {"k": None}],
     "address": {"city": "zurich", "zip": 8001},
     "scores": [1.5, 2.5, None, [1, [2, [3]]]],
     "meta": {"uuid": uuid_.UUID(int=7), "when": dt_.date(2020, 1, 2)}},
    list(range(1000)), {f"k{i:04d}": i for i in range(300)},
    {"zeta": 1, "alpha": 2, "mid": [3, {"beta": 4, "alpha": 5}]},
    ["s" * 70] * 300,
]


def _same(got, want):
    if isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("value", PRIMITIVES + NESTED,
                         ids=[repr(v)[:30] for v in PRIMITIVES + NESTED])
def test_encode_is_the_jax_bytes_and_decodes_as_jax(value):
    meta, val = var.encode(value)
    assert (meta, val) == jvar.encode(value)
    _same(var.decode(meta, val), jvar.decode(meta, val))
    v = var.Value(var.Metadata(meta), val)
    jv = jvar.Value(jvar.Metadata(meta), val)
    assert v.basic_type == jv.basic_type
    assert v.to_json() == jv.to_json()


@pytest.mark.parametrize("sorted_", [False, True])
@pytest.mark.parametrize("n", [0, 1, 5, 300])
def test_metadata_bytes_match_jax(sorted_, n):
    keys = sorted(f"key{i}" * (1 + i % 3) for i in range(n))
    m = var.Metadata.build(keys, sorted_and_unique=sorted_)
    jm = jvar.Metadata.build(keys, sorted_and_unique=sorted_)
    assert m.data == jm.data
    assert m.sorted_and_unique == jm.sorted_and_unique == sorted_
    assert m.offset_size == jm.offset_size
    assert m.keys == jm.keys == keys
    assert [m.id_for(k) for k in keys] == [jm.id_for(k) for k in keys]
    assert m.id_for("absent") is jm.id_for("absent") is None


def test_shared_dictionary_values_match_jax():
    values = [{"a": 1, "b": "text"}, [1, 2.5, None], "plain", 42, None,
              {"nested": {"deep": [True, False]}, "a": 7}]
    b, jb = var.Builder(), jvar.Builder()
    blobs = [b.encode_value(v) for v in values]
    assert blobs == [jb.encode_value(v) for v in values]
    assert b.metadata().data == jb.metadata().data
    meta = b.metadata().data
    assert [var.decode(meta, x) for x in blobs] == values


@pytest.mark.parametrize("meta,value", [(b"", b"\x00"),
                                        (b"\x02\x00\x00", b"\x00"),
                                        (b"\x01\x00\x00", b"")])
def test_malformed_bytes_raise_as_jax(meta, value):
    with pytest.raises(JArrowInvalid):
        jvar.decode(meta, value)
    with pytest.raises(ArrowInvalid):
        var.decode(meta, value)


def test_unknown_primitive_raises_as_jax():
    val = bytes([31 << 2])
    with pytest.raises(JArrowInvalid):
        jvar.decode(jvar.EMPTY_METADATA, val)
    with pytest.raises(ArrowInvalid):
        var.decode(var.EMPTY_METADATA, val)
    for enc, err in ((var.encode, ArrowInvalid), (jvar.encode,
                                                  JArrowInvalid)):
        with pytest.raises(err):
            enc(2 ** 63)
        with pytest.raises(err):
            enc(object())


# ---------------------------------------------------------------------------
# the extension type and shredding
# ---------------------------------------------------------------------------

def test_variant_type_matches_jax():
    t, jt = ext.variant, jext.variant
    assert str(t) == str(jt) and t.extension_name == jt.extension_name
    assert str(t.storage_type) == str(jt.storage_type)
    assert port_type(jt) == t and str(jax_type(t)) == str(jt)
    assert ext.get_extension_type("parquet.variant") == t
    assert not t.shredded and not jt.shredded


BAD_STORAGES = [
    lambda m: m.int64,
    lambda m: m.struct([m.Field("value", m.binary, False)]),
    lambda m: m.struct([m.Field("metadata", m.binary, False)]),
    lambda m: m.struct([m.Field("metadata", m.binary, True),
                        m.Field("value", m.binary, False)]),
    lambda m: m.struct([m.Field("metadata", m.binary, False),
                        m.Field("value", m.binary, True),
                        m.Field("typed_value", m.int64, False)]),
    lambda m: m.struct([m.Field("metadata", m.binary, False),
                        m.Field("value", m.binary, True),
                        m.Field("typed_value", m.int64, True),
                        m.Field("extra", m.int64, True)]),
]


@pytest.mark.parametrize("case", range(len(BAD_STORAGES)))
def test_invalid_storages_raise_the_jax_class(case):
    with pytest.raises(JArrowInvalid) as je:
        jext.VariantType(BAD_STORAGES[case](jdt))
    with pytest.raises(ArrowInvalid) as te:
        ext.VariantType(BAD_STORAGES[case](dt))
    assert str(te.value) == str(je.value)


SHRED_TYPES = {
    "bool": (lambda m: m.bool_), "int8": (lambda m: m.int8),
    "int16": (lambda m: m.int16), "int32": (lambda m: m.int32),
    "int64": (lambda m: m.int64), "float64": (lambda m: m.float64),
    "string": (lambda m: m.string), "binary": (lambda m: m.binary),
    "date32": (lambda m: m.date32),
    "timestamp": (lambda m: m.timestamp("us", "UTC")),
    "struct": (lambda m: m.struct([m.Field("lat", m.float64),
                                   m.Field("n", m.int64)])),
    "list": (lambda m: m.list_(m.int64)),
    "list_of_struct": (lambda m: m.list_(m.struct([m.Field("k", m.string)
                                                    ]))),
}
OBJECTS = [True, False, 5, -7, 300, 2 ** 40, 1.25, "text", b"raw",
           dt_.date(2021, 3, 4),
           dt_.datetime(2021, 3, 4, 5, 6, 7, tzinfo=dt_.timezone.utc),
           {"lat": 1.5, "n": 3, "tag": "x"}, {"lat": "oops"}, {},
           [1, 2, 3], ["a", 3], [None], [{"k": "v"}, {"k": 1, "z": 2}],
           None, "y" * 80]


def _columns(objs):
    """The same non-shredded variant column in both packages (a null row
    at the end)."""
    rows = []
    for o in objs:
        m, v = var.encode(o)
        rows.append({"metadata": m, "value": v})
    port = ExtensionArray(ext.variant, from_pylist(rows + [None],
                                                   ext.variant.storage_type))
    jb = make_builder(jext.variant.storage_type)
    for r in rows:
        jb.append(r)
    jb.append_null()
    d = jb.finish().data
    jax = make_array(ArrayData(jext.variant, d.length, d.buffers, d.children,
                               d.dictionary, d._null_count, d.offset))
    return port, jax


@pytest.mark.parametrize("kind", list(SHRED_TYPES))
def test_shred_and_unshred_match_jax(kind):
    objs = [o for o in OBJECTS if not (kind == "int8" and isinstance(
        o, int) and not isinstance(o, bool) and not -128 <= o < 128)
        and not (kind in ("int16", "int32") and isinstance(o, int)
                 and not isinstance(o, bool) and abs(o) >= 2 ** 15)]
    port, jax = _columns(objs)
    shred_t = SHRED_TYPES[kind](dt)
    sh = ext.shred_variant(port, shred_t)
    jsh = jext.shred_variant(jax, SHRED_TYPES[kind](jdt))
    assert str(sh.type) == str(jsh.type)
    assert sh.type.shredded and sh.type.shred_type == shred_t
    assert sh.to_pylist() == jsh.storage.to_pylist()
    un = ext.unshred_variant(sh)
    if kind == "timestamp":
        # deviation: the JAX unshred looks the unit up by its enum in a
        # dict keyed by its name and raises KeyError
        # (arrow_go_tpu/extensions.py:335); the port reads it by name
        with pytest.raises(KeyError):
            jext.unshred_variant(jsh)
    else:
        jun = jext.unshred_variant(jsh)
        assert un.to_pylist() == jun.storage.to_pylist()
    got = [None if r is None else var.decode(r["metadata"], r["value"])
           for r in un.to_pylist()]
    assert got[:-1] == objs and got[-1] is None


def test_unshred_refuses_a_plain_variant_as_jax():
    port, jax = _columns([1, "a"])
    with pytest.raises(JArrowInvalid):
        jext.unshred_variant(jax)
    with pytest.raises(ArrowInvalid):
        ext.unshred_variant(port)


# ---------------------------------------------------------------------------
# parquet: the VARIANT group, each writer read by the other reader
# ---------------------------------------------------------------------------

def _jax_table(col):
    from arrow_go_tpu.array.record import RecordBatch, Table
    return Table.from_batches([RecordBatch(
        jdt.Schema([jdt.Field("v", col.type, True)]), [col], len(col))])


@pytest.mark.parametrize("kind", [None, "struct", "list", "int64",
                                  "string"])
def test_variant_parquet_both_writers_both_readers(kind):
    objs = [{"lat": 1.5, "n": 3, "tag": "x"}, [1, 2], "plain", 42,
            {"deep": {"x": [True, None]}}, 2 ** 40, None]
    port, jax = _columns(objs)
    if kind is not None:
        port = ext.shred_variant(port, SHRED_TYPES[kind](dt))
        jax = jext.shred_variant(jax, SHRED_TYPES[kind](jdt))
    want = jax.storage.to_pylist()
    # the port's writer, read by the JAX reader and by the port's own
    buf = io.BytesIO()
    tpq.write_table({"v": port}, buf)
    blob = buf.getvalue()
    jt = jpq.ParquetFile(blob).read_table()
    jf = jt.schema.fields[0]
    assert isinstance(jf.type, jext.VariantType)
    assert str(jf.type) == str(jax.type)
    assert jt.column("v").to_pylist() == want
    els = jpq.ParquetFile(blob).metadata.schema
    assert [e for e in els if e.name == "v"][0].logicalType.VARIANT \
        is not None
    pf = tpq.ParquetFile(blob)
    assert isinstance(pf.schema.field(0).type, ext.VariantType)
    db = tpq.read_batch_device(pf, 0, columns=["v"], device="cpu")
    got = db.column("v").array
    assert got.type == port.type and got.to_pylist() == want
    # the JAX writer, read by the port's reader
    buf = io.BytesIO()
    jpq.write_table(_jax_table(jax), buf)
    pf = tpq.ParquetFile(buf.getvalue())
    assert pf.schema.field(0).type == port.type
    got = tpq.read_batch_device(pf, 0, columns=["v"], device="cpu"
                                ).column("v").array
    assert got.to_pylist() == want
    if kind is not None:
        back = ext.unshred_variant(got)
        dec = [None if r is None else var.decode(r["metadata"], r["value"])
               for r in back.to_pylist()]
        assert dec[:-1] == objs
