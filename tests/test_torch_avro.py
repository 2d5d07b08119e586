"""The port's Avro object container file reader
(arrow_go_tpu_torch/formats/avro.py) against the JAX package's
(arrow_go_tpu/formats/avro.py) on the same hand-built OCF bytes: every
primitive and logical type, enum, fixed, decimals as bytes and as
fixed, arrays, maps, nested records, unions (nullable with null first
and second, and multi-branch), blocks with a negative count and a
byte size, every codec, both tiers (the array tier of flat schemas and
the recursive one), chunked reading across blocks, the malformed inputs
(by exception class), the zstd size discovery of the port's own
decoder, and the Q6 files chip_smoke.py writes."""
import io
import json
import struct
import zlib

import numpy as np
import pytest
import zstandard

from arrow_go_tpu import native as jnative
from arrow_go_tpu.formats import avro as javro

from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import native
from arrow_go_tpu_torch.compute.errors import ArrowInvalid
from arrow_go_tpu_torch.formats import avro as tavro
from torch_parity import port_type, same_table


# -- the OCF builder of tests/test_formats.py --------------------------------

def _zigzag(v: int) -> bytes:
    u = (v << 1) ^ (v >> 63)
    out = bytearray()
    while u >= 0x80:
        out.append((u & 0x7F) | 0x80)
        u >>= 7
    out.append(u)
    return bytes(out)


def _avro_bytes(b: bytes) -> bytes:
    return _zigzag(len(b)) + b


def _compress(payload: bytes, codec: bytes) -> bytes:
    if codec == b"deflate":
        return zlib.compress(payload)[2:-4]          # raw deflate
    if codec == b"snappy":
        return jnative.snappy_compress(payload) + struct.pack(
            ">I", zlib.crc32(payload) & 0xFFFFFFFF)
    if codec == b"zstandard":
        return zstandard.ZstdCompressor().compress(payload)
    return payload


def _make_ocf(schema, blocks, codec: bytes = b"null", sync=b"S" * 16,
              negative_meta: bool = False) -> bytes:
    """An OCF of `blocks` (each a list of encoded records); the metadata
    map written as one block, or with a negative count and its byte
    size."""
    out = bytearray(b"Obj\x01")
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec}
    body = b"".join(_avro_bytes(k.encode()) + _avro_bytes(v)
                    for k, v in meta.items())
    if negative_meta:
        out += _zigzag(-len(meta)) + _zigzag(len(body))
    else:
        out += _zigzag(len(meta))
    out += body + _zigzag(0) + sync
    for recs in blocks:
        payload = _compress(b"".join(recs), codec)
        out += _zigzag(len(recs)) + _zigzag(len(payload)) + payload + sync
    return bytes(out)


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:              # the class is compared across
        return None, _kind(e)


def _kind(e: Exception) -> str:
    """An exception's class name; the port's ArrowNotImplemented, a
    NotImplementedError, counts as the JAX package's NotImplementedError
    (neither package builds a union column from Python values)."""
    name = type(e).__name__
    return "NotImplementedError" if name == "ArrowNotImplemented" else name


def _same(data: bytes, chunk: int = 0, tier: str = "auto"):
    """OCFReader over the same bytes in both packages: the same schema,
    the same batches (chunk_size `chunk`) and read_all, or the same
    exception class; with tier "records" both take the recursive tier."""
    jr, jerr = _outcome(lambda: javro.OCFReader(data, chunk_size=chunk))
    tr, terr = _outcome(lambda: tavro.OCFReader(data, chunk_size=chunk))
    assert terr == jerr, (terr, jerr)
    if jerr:
        return None, jerr
    assert (tr._plan is None) == (jr._plan is None)
    if tier == "records":
        jr._plan = tr._plan = None
    assert tr.schema == dt.Schema([dt.Field(f.name, port_type(f.type))
                                   for f in jr.schema.fields])
    got = []
    while True:
        want, jerr = _outcome(jr.read_next_batch)
        b, terr = _outcome(tr.read_next_batch)
        assert terr == jerr, (terr, jerr)
        if jerr:
            return got, jerr
        if want is None:
            assert b is None
            break
        same_table(b, want)
        got.append(b)
    for make in (lambda m: m.OCFReader(data, chunk_size=chunk),):
        jr, tr = make(javro), make(tavro)
        if tier == "records":
            jr._plan = tr._plan = None
        want, jerr = _outcome(jr.read_all)
        b, terr = _outcome(tr.read_all)
        assert terr == jerr, (terr, jerr)
        if not jerr:
            same_table(b, want)
    return got, None


# -- the schemas and records ------------------------------------------------

AVRO_SCHEMA = {
    "type": "record", "name": "row",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "name", "type": ["null", "string"]},
        {"name": "score", "type": "double"},
        {"name": "tags", "type": {"type": "array", "items": "int"}},
    ],
}


def _enc_record(id_, name, score, tags, negative_blocks=False):
    out = bytearray(_zigzag(id_))
    if name is None:
        out += _zigzag(0)
    else:
        out += _zigzag(1) + _avro_bytes(name.encode())
    out += struct.pack("<d", score)
    if tags:
        items = b"".join(_zigzag(t) for t in tags)
        if negative_blocks:
            out += _zigzag(-len(tags)) + _zigzag(len(items)) + items
        else:
            out += _zigzag(len(tags)) + items
    out += _zigzag(0)
    return bytes(out)


FLAT_AVRO_SCHEMA = {
    "type": "record", "name": "flat",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "name", "type": ["null", "string"]},
        {"name": "score", "type": "double"},
        {"name": "ok", "type": "boolean"},
        {"name": "opt", "type": ["null", "long"]},
        {"name": "col", "type": {"type": "enum", "name": "c",
                                 "symbols": ["red", "green", "blue"]}},
        {"name": "day", "type": {"type": "int", "logicalType": "date"}},
    ],
}


def _enc_flat(i):
    name = None if i % 5 == 0 else f"n{i}"
    opt = None if i % 3 == 0 else i * 7
    out = bytearray(_zigzag(i))
    out += (_zigzag(0) if name is None
            else _zigzag(1) + _avro_bytes(name.encode()))
    out += struct.pack("<d", i * 0.5)
    out += b"\x01" if i % 2 else b"\x00"
    out += _zigzag(0) if opt is None else _zigzag(1) + _zigzag(opt)
    out += _zigzag(i % 3)
    out += _zigzag(i % 1000)
    return bytes(out)


def _long(v):
    return _zigzag(v)


def _f4(v):
    return struct.pack("<f", v)


def _f8(v):
    return struct.pack("<d", v)


def _str(v):
    return _avro_bytes(v.encode())


def _bool(v):
    return b"\x01" if v else b"\x00"


def _nullable(enc, null_first=True):
    def f(v):
        if v is None:
            return _zigzag(0 if null_first else 1)
        return _zigzag(1 if null_first else 0) + enc(v)
    return f


# one flat field a type: (Avro type, encoder, values)
LONGS = [0, 1, -1, 2 ** 31, -2 ** 31 - 1, 2 ** 62, -2 ** 63, 2 ** 63 - 1,
         300, -300]
FLAT_FIELDS = {
    "null": ("null", lambda v: b"", [None] * 6),
    "boolean": ("boolean", _bool, [True, False, True, True, False, False]),
    "int": ("int", _long, [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 70000]),
    "long": ("long", _long, LONGS),
    "float": ("float", _f4, [0.5, -1.25, 3.0e30, float("inf"), 0.1, -0.0]),
    "double": ("double", _f8, [0.1, -2.5, 1e300, float("nan"), -0.0, 5.0]),
    "bytes": ("bytes", lambda v: _avro_bytes(v),
              [b"", b"ab", b"\xff\x00", b"ab", b"x" * 200, b"q"]),
    "string": ("string", _str, ["", "x", "ünï", "x", "y" * 130, "z"]),
    "date": ({"type": "int", "logicalType": "date"}, _long,
             [0, 18262, -1, 2932896, -719162, 7]),
    "time_millis": ({"type": "int", "logicalType": "time-millis"}, _long,
                    [0, 1000, 86399999, 5, 6, 7]),
    "time_micros": ({"type": "long", "logicalType": "time-micros"}, _long,
                    [0, 1000, 86399999999, 5, 6, 7]),
    "timestamp_millis": ({"type": "long", "logicalType": "timestamp-millis"},
                         _long, [0, 1577836800000, -1, 2 ** 40, 5, 6]),
    "timestamp_micros": ({"type": "long", "logicalType": "timestamp-micros"},
                         _long, [0, 1577836800000000, -1, 2 ** 52, 5, 6]),
    "uuid": ({"type": "string", "logicalType": "uuid"}, _str,
             ["123e4567-e89b-12d3-a456-426614174000", "x", "", "a", "b",
              "c"]),
    "enum": ({"type": "enum", "name": "e", "symbols": ["A", "B", "C"]},
             _long, [2, 0, 1, 1, 2, 0]),
}


@pytest.mark.parametrize("nullable", ["plain", "null_first",
                                      "null_second"])
@pytest.mark.parametrize("tier", ["auto", "records"])
@pytest.mark.parametrize("kind", sorted(FLAT_FIELDS))
def test_flat_fields_match_jax(kind, tier, nullable):
    """Every primitive and logical type (and enum) as a flat field, plain
    or nullable with null first or second, beside a long, through both
    tiers."""
    avro_t, enc, values = FLAT_FIELDS[kind]
    if nullable != "plain":
        first = nullable == "null_first"
        if kind == "null":
            return
        avro_t = ["null", avro_t] if first else [avro_t, "null"]
        enc = _nullable(enc, first)
        values = [None if i % 3 == 1 else v for i, v in enumerate(values)]
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "k", "type": "long"}, {"name": "v", "type": avro_t}]}
    recs = [_zigzag(i) + enc(v) for i, v in enumerate(values)]
    data = _make_ocf(schema, [recs[:4], recs[4:]])
    got, err = _same(data, tier=tier)
    assert err is None
    if tier == "auto":
        assert tavro.OCFReader(data)._plan is not None


def _dec_bytes(u: int, n: int = None) -> bytes:
    n = n or max(1, (u.bit_length() + 8) // 8)
    return u.to_bytes(n, "big", signed=True)


NESTED_CASES = {
    "array_of_ints": (
        {"type": "array", "items": "int"},
        [lambda: _zigzag(2) + _zigzag(5) + _zigzag(-6) + _zigzag(0),
         lambda: _zigzag(0),
         lambda: _zigzag(-2) + _zigzag(2) + _zigzag(7) + _zigzag(8)
         + _zigzag(1) + _zigzag(9) + _zigzag(0)]),
    "map_of_longs": (
        {"type": "map", "values": "long"},
        [lambda: _zigzag(1) + _str("k") + _zigzag(42) + _zigzag(0),
         lambda: _zigzag(0),
         lambda: _zigzag(-2) + _zigzag(len(_str("a") + _zigzag(1) + _str("b")
                                           + _zigzag(2)))
         + _str("a") + _zigzag(1) + _str("b") + _zigzag(2) + _zigzag(0)]),
    "map_of_arrays": (
        {"type": "map", "values": {"type": "array", "items": "string"}},
        [lambda: _zigzag(1) + _str("k") + _zigzag(1) + _str("v") + _zigzag(0)
         + _zigzag(0),
         lambda: _zigzag(0)]),
    "fixed": (
        {"type": "fixed", "name": "f4", "size": 4},
        [lambda: b"\xab\xcd\x00\x01", lambda: b"\x00\x00\x00\x00",
         lambda: b"\xab\xcd\x00\x01"]),
    "decimal_bytes": (
        {"type": "bytes", "logicalType": "decimal", "precision": 10,
         "scale": 2},
        [lambda: _avro_bytes(_dec_bytes(125)),
         lambda: _avro_bytes(_dec_bytes(-350)),
         lambda: _avro_bytes(_dec_bytes(0))]),
    "decimal_fixed": (
        {"type": "fixed", "name": "d16", "size": 16,
         "logicalType": "decimal", "precision": 38, "scale": 4},
        [lambda: _dec_bytes(10 ** 30 + 5, 16),
         lambda: _dec_bytes(-7, 16)]),
    "record": (
        {"type": "record", "name": "inner", "fields": [
            {"name": "x", "type": "int"},
            {"name": "y", "type": ["null", "string"]}]},
        [lambda: _zigzag(1) + _zigzag(1) + _str("a"),
         lambda: _zigzag(-2) + _zigzag(0)]),
    "record_of_arrays_and_maps": (
        {"type": "record", "name": "deep", "fields": [
            {"name": "l", "type": {"type": "array", "items": {
                "type": "record", "name": "pt", "fields": [
                    {"name": "v", "type": "double"}]}}},
            {"name": "m", "type": {"type": "map", "values": "boolean"}}]},
        [lambda: _zigzag(2) + _f8(1.5) + _f8(-0.5) + _zigzag(0)
         + _zigzag(1) + _str("t") + b"\x01" + _zigzag(0),
         lambda: _zigzag(0) + _zigzag(0)]),
    "named_type_reused": (
        {"type": "record", "name": "pair", "fields": [
            {"name": "a", "type": {"type": "fixed", "name": "two",
                                   "size": 2}},
            {"name": "b", "type": "two"}]},
        [lambda: b"ab" + b"cd", lambda: b"\x00\x01" + b"\xff\xfe"]),
    "nullable_array": (
        ["null", {"type": "array", "items": "long"}],
        [lambda: _zigzag(1) + _zigzag(1) + _zigzag(2 ** 40) + _zigzag(0),
         lambda: _zigzag(0)]),
    "array_null_second": (
        [{"type": "array", "items": "long"}, "null"],
        [lambda: _zigzag(0) + _zigzag(1) + _zigzag(3) + _zigzag(0),
         lambda: _zigzag(1)]),
    "enum_in_array": (
        {"type": "array", "items": {"type": "enum", "name": "s",
                                    "symbols": ["X", "Y"]}},
        [lambda: _zigzag(2) + _zigzag(1) + _zigzag(0) + _zigzag(0),
         lambda: _zigzag(1) + _zigzag(1) + _zigzag(0)]),
    "multi_branch_union": (
        ["null", "int", "string"],
        [lambda: _zigzag(1) + _zigzag(5), lambda: _zigzag(2) + _str("x"),
         lambda: _zigzag(0)]),
    "two_branch_union": (
        ["int", "string"],
        [lambda: _zigzag(0) + _zigzag(5), lambda: _zigzag(1) + _str("x")]),
}


@pytest.mark.parametrize("case", sorted(NESTED_CASES))
def test_nested_and_logical_types_match_jax(case):
    """The recursive tier: arrays and maps (blocks with a negative count
    and a byte size too), fixed, decimals as bytes and as fixed, records,
    named types, nullable arrays, unions of several types (whose dense
    union no builder of the JAX package builds: the same refusal)."""
    avro_t, encs = NESTED_CASES[case]
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "k", "type": "long"}, {"name": "v", "type": avro_t}]}
    recs = [_zigzag(i) + e() for i, e in enumerate(encs)]
    data = _make_ocf(schema, [recs])
    got, err = _same(data)
    assert tavro.OCFReader(data)._plan is None
    if case in ("multi_branch_union", "two_branch_union"):
        assert err == "NotImplementedError"


def test_union_types_and_refusals_of_both_packages():
    """A union of more than null and one type maps to a dense_union of
    member{i}; neither package builds its column (the JAX package has no
    union builder; the port refuses likewise)."""
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "u", "type": ["null", "int", "string"]}]}
    data = _make_ocf(schema, [[_zigzag(1) + _zigzag(5)]])
    jr, tr = javro.OCFReader(data), tavro.OCFReader(data)
    assert tr.schema.field(0).type == dt.dense_union(
        [dt.Field("member0", dt.int32), dt.Field("member1", dt.string)])
    assert tr.schema.field(0).type == port_type(jr.schema.field(0).type)
    with pytest.raises(NotImplementedError):
        jr.read_all()
    with pytest.raises(NotImplementedError):
        tr.read_all()


@pytest.mark.parametrize("schema,rec", [
    ("long", _zigzag(-5)), ("string", _str("top")),
    ({"type": "array", "items": "int"}, _zigzag(1) + _zigzag(3)
     + _zigzag(0)),
    (["null", "double"], _zigzag(1) + _f8(2.5))])
def test_a_schema_that_is_no_record_is_one_value_column(schema, rec):
    _same(_make_ocf(schema, [[rec, rec]]))


@pytest.mark.parametrize("codec", [b"null", b"deflate", b"snappy",
                                   b"zstandard"])
@pytest.mark.parametrize("tier", ["auto", "records"])
def test_every_codec_matches_jax(codec, tier):
    recs = [_enc_flat(i) for i in range(300)]
    data = _make_ocf(FLAT_AVRO_SCHEMA, [recs[:120], recs[120:]], codec)
    got, err = _same(data, tier=tier)
    assert err is None and sum(b.num_rows for b in got) == 300
    recs = [_enc_record(i, f"n{i}", i * 0.5, [i, -i]) for i in range(40)]
    _same(_make_ocf(AVRO_SCHEMA, [recs], codec))


def test_snappy_crc_is_not_checked_like_jax():
    """A snappy block's CRC-32 suffix is dropped unchecked, as the JAX
    reader drops it (a quirk of the reference, matched)."""
    recs = [_enc_flat(i) for i in range(20)]
    data = bytearray(_make_ocf(FLAT_AVRO_SCHEMA, [recs], b"snappy"))
    data[-17] ^= 0xFF                       # the CRC's last byte
    _same(bytes(data))
    assert tavro.read_avro(bytes(data)).num_rows == 20


@pytest.mark.parametrize("chunk", [0, -1, 1, 7, 30, 50, 51, 100, 1000])
@pytest.mark.parametrize("tier", ["auto", "records"])
def test_chunks_across_blocks_match_jax(chunk, tier):
    recs = [_enc_flat(i) for i in range(100)]
    data = _make_ocf(FLAT_AVRO_SCHEMA, [recs[:50], recs[50:80], recs[80:]])
    got, err = _same(data, chunk, tier)
    assert err is None
    assert sum(b.num_rows for b in got) == 100


def test_the_flat_tier_equals_the_recursive_one():
    """tests/test_formats.py::test_avro_flat_fast_path_parity and
    ::test_avro_flat_fast_chunked through the port."""
    recs = [_enc_flat(i) for i in range(777)]
    data = _make_ocf(FLAT_AVRO_SCHEMA, [recs])
    fast = tavro.OCFReader(data)
    assert fast._plan is not None
    slow = tavro.OCFReader(data)
    slow._plan = None
    a, b = fast.read_all(), slow.read_all()
    assert a.to_pydict() == b.to_pydict()
    d = a.to_pydict()
    assert d["id"][:3] == [0, 1, 2] and d["day"][1] == 1
    assert d["name"][0] is None and d["opt"][1] == 7
    assert d["col"][:4] == ["red", "green", "blue", "red"]
    recs = [_enc_flat(i) for i in range(100)]
    r = tavro.OCFReader(_make_ocf(FLAT_AVRO_SCHEMA, [recs[:50], recs[50:]]),
                        chunk_size=30)
    sizes, rows = [], []
    for hb in r:
        sizes.append(hb.num_rows)
        rows.extend(hb.columns[0].to_pylist())
    assert sizes == [30, 30, 30, 10] and rows == list(range(100))


def test_avro_tests_of_the_jax_package():
    """tests/test_formats.py's Avro reads through the port."""
    data = _make_ocf(AVRO_SCHEMA, [[_enc_record(1, "a", 0.5, [1, 2]),
                                    _enc_record(2, None, 1.5, [])]])
    t = tavro.read_avro(data)
    assert t.schema.names == ["id", "name", "score", "tags"]
    assert t.to_pydict() == {"id": [1, 2], "name": ["a", None],
                             "score": [0.5, 1.5], "tags": [[1, 2], []]}
    data = _make_ocf(AVRO_SCHEMA, [[_enc_record(7, "z", 2.0, [3])]],
                     b"deflate")
    assert tavro.read_avro(data).to_pydict()["id"] == [7]
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "e", "type": {"type": "enum", "name": "col",
                               "symbols": ["RED", "BLUE"]}},
        {"name": "m", "type": {"type": "map", "values": "long"}},
        {"name": "fx", "type": {"type": "fixed", "name": "f4", "size": 2}},
    ]}
    rec = _zigzag(1) + _zigzag(1) + _avro_bytes(b"k") + _zigzag(42) + \
        _zigzag(0) + b"\xAB\xCD"
    assert tavro.read_avro(_make_ocf(schema, [[rec]])).to_pydict() == {
        "e": ["BLUE"], "m": [[("k", 42)]], "fx": [b"\xab\xcd"]}
    with pytest.raises(ArrowInvalid):
        tavro.read_avro(b"nope" + b"\x00" * 50)


def test_negative_blocks_and_metadata_match_jax():
    recs = [_enc_record(i, f"n{i}", 0.25 * i, [i, i + 1, i + 2],
                        negative_blocks=True) for i in range(9)]
    _same(_make_ocf(AVRO_SCHEMA, [recs], negative_meta=True))
    _same(_make_ocf(FLAT_AVRO_SCHEMA, [[_enc_flat(i) for i in range(9)]],
                    negative_meta=True))


def _malformed():
    good = _make_ocf(FLAT_AVRO_SCHEMA, [[_enc_flat(i) for i in range(20)]])
    other_sync = good[:-16] + b"T" * 16
    return {
        "bad_magic": b"nope" + good[4:],
        "sync_mismatch": other_sync,
        "truncated_block": good[:-30],
        "truncated_header": good[:12],
        "truncated_sync": good[:-5],
        "unknown_codec": _make_ocf(FLAT_AVRO_SCHEMA, [[_enc_flat(1)]],
                                   b"lzma"),
        "bad_deflate": _make_ocf(FLAT_AVRO_SCHEMA, [[_enc_flat(1)]])
        .replace(b"null", b"deflate"),
        "no_schema": b"Obj\x01" + _zigzag(0) + b"S" * 16,
        "unknown_type": _make_ocf({"type": "record", "name": "r",
                                   "fields": [{"name": "a",
                                               "type": "nosuch"}]}, []),
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformed_inputs_raise_like_jax(case):
    got, err = _same(_malformed()[case])
    assert err is not None or case in ("truncated_sync",)


def test_empty_files_match_jax():
    _same(_make_ocf(FLAT_AVRO_SCHEMA, []))
    _same(_make_ocf(AVRO_SCHEMA, []))
    _same(_make_ocf(FLAT_AVRO_SCHEMA, [[]]))


def test_read_from_a_path_and_a_stream(tmp_path):
    data = _make_ocf(FLAT_AVRO_SCHEMA, [[_enc_flat(i) for i in range(33)]],
                     b"deflate")
    p = tmp_path / "x.avro"
    p.write_bytes(data)
    want = javro.read_avro(data)
    same_table(tavro.read_avro(str(p)), want)
    same_table(tavro.read_avro(io.BytesIO(data)), want)


# -- the port's zstd size discovery -----------------------------------------

ZSTD_INPUTS = {
    "text": b"avro block " * 5000,
    "random": np.random.default_rng(2).bytes(300000),
    "empty": b"",
    "ints": np.arange(100000, dtype=np.int64).tobytes(),
}


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("name", sorted(ZSTD_INPUTS))
def test_zstd_size_discovery(name, content_size):
    """A frame with the content size in its header decodes into exactly
    that; one without grows its buffer; both equal the input."""
    raw = ZSTD_INPUTS[name]
    frame = zstandard.ZstdCompressor(
        write_content_size=content_size).compress(raw)
    if raw:
        assert bool(frame[4] >> 6) == content_size
    streamed = zstandard.ZstdCompressor().compressobj()
    for frame in (frame, streamed.compress(raw) + streamed.flush()):
        # the header's flags say whether it carries the size (a single-
        # segment frame always does)
        has = frame[4] >> 6 or frame[4] & 0x20
        assert native.zstd_content_size(frame) == (len(raw) if has
                                                   else None)
        assert bytes(native.zstd_decompress(frame, None)) == raw


def test_zstd_size_discovery_limits():
    raw = b"x" * 100000
    known = zstandard.ZstdCompressor().compress(raw)
    unknown = zstandard.ZstdCompressor(write_content_size=False).compress(
        raw)
    for frame in (known, unknown):
        with pytest.raises(ArrowInvalid):
            native.zstd_decompress(frame, None, max_size=1000)
        assert bytes(native.zstd_decompress(frame, None,
                                            max_size=100000)) == raw
    two = known + native.zstd_compress(b"yz").tobytes()
    assert native.zstd_content_size(two) == 100002
    assert bytes(native.zstd_decompress(two, None)) == raw + b"yz"
    with pytest.raises(ArrowInvalid):
        native.zstd_content_size(known[:7])
    with pytest.raises(ArrowInvalid):
        native.zstd_decompress(known[:-3], None)


# -- chip_smoke.py's Avro files ----------------------------------------------

@pytest.mark.parametrize("codec", ["null", "deflate", "snappy",
                                   "zstandard"])
def test_chip_smoke_avro_files_match_jax(codec, monkeypatch):
    """chip_smoke.write_avro's Q6 file (its own zigzag-varint encoder) of
    each codec, read by both packages: the same columns, bit for bit
    against the numpy source."""
    import chip_smoke as cs
    monkeypatch.setattr(cs, "AVRO_BLOCK_ROWS", 700)
    li, _ = cs.make_data(2000, 500)
    cs.add_quantity(li)
    rec, ends = cs.avro_records(li, 0, 2000)
    data = cs.write_avro(rec, ends, codec)
    got, _ = _same(data)
    hb = tavro.read_avro(data)
    cs.check_read("avro", hb, li, list(cs.AVRO_TYPES), 0, 2000,
                  cs.AVRO_TYPES)


@pytest.mark.parametrize("codec", ["null", "deflate", "snappy",
                                   "zstandard"])
def test_avro_q6_path_matches_jax(codec):
    """Q6 from the Avro file of each codec at 200,000 rows through
    chip_smoke.py's own functions (avro_records, write_avro, avro_q6)
    against the JAX reader's table through the same composition of JAX
    functions, and against numpy."""
    import chip_smoke as cs
    from arrow_go_tpu.device.block import batch_to_device
    from test_torch_csv import _jax_q6
    li, _ = cs.make_data(200_000, 50_000)
    cs.add_quantity(li)
    rec, ends = cs.avro_records(li, 0, 200_000)
    data = cs.write_avro(rec, ends, codec)
    times = {}
    hb, _, q6 = cs.avro_q6(data, "cpu", times)
    assert {"read_s", "decompress_s", "decode_s", "h2d_s",
            "compute_s"} <= set(times)
    cs.check_read("avro_q6", hb, li, list(cs.AVRO_TYPES), 0, 200_000,
                  cs.AVRO_TYPES)
    cs.check_q6(q6, cs.q6_oracle(li))
    jt = javro.read_avro(data)
    same_table(hb, jt)
    want = _jax_q6(batch_to_device(jt.combine_chunks().to_batches()[0]
                                   if hasattr(jt, "combine_chunks") else
                                   _one_batch(jt)))
    assert q6["count"] == want["count"]
    np.testing.assert_allclose(q6["revenue"], want["revenue"], rtol=1e-9)


def _one_batch(t):
    """A JAX Table's rows as one RecordBatch."""
    from arrow_go_tpu.array.record import RecordBatch
    return RecordBatch(t.schema, [t.column(i).combine()
                                  for i in range(t.num_columns)], t.num_rows)


@pytest.mark.parametrize("length", [0, 1, 5, 11, 1000, 100_000])
@pytest.mark.parametrize("top", [256, 129, 127])
def test_varint_lanes_match_jax(length, top):
    """native.varint_lanes against the JAX package's _varint_lanes on
    random bytes (all bytes under `top`), the last ones continuation
    bytes that run past the end."""
    rng = np.random.default_rng(length + top)
    buf = rng.integers(0, top, length).astype(np.uint8)
    buf[-3:] = 200
    jv, jl = javro._varint_lanes(buf)
    tv, tl = native.varint_lanes(buf)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("length,count", [(0, 0), (0, 3), (7, 5),
                                          (500, 40), (3000, 400)])
def test_flat_walk_matches_the_jax_record_jump_map(length, count):
    """The port's array tier (its record walk in native.avro_flat_walk)
    against the JAX array tier (its record-jump map over every byte) on
    garbage bytes, whose positions run into the block's end and are
    clamped there: the same values and validity of every field, or the
    same exception class."""
    rng = np.random.default_rng(length + count)
    payload = rng.integers(0, 256, length).astype(np.uint8).tobytes()
    jplan = javro._flat_plan(FLAT_AVRO_SCHEMA, {})
    tplan = tavro._flat_plan(FLAT_AVRO_SCHEMA, {})
    jschema = javro.OCFReader(_make_ocf(FLAT_AVRO_SCHEMA, [])).schema
    want, jerr = _outcome(lambda: javro._decode_block_vec(
        payload, count, jplan, jschema))
    got, terr = _outcome(lambda: tavro._decode_block_vec(payload, count,
                                                          tplan))
    assert terr == jerr
    if jerr:
        return
    for (k, v, valid, *_), (tk, tv, tvalid, _) in zip(want[1], got[1]):
        assert tk == k
        for a, b in zip(v if isinstance(v, tuple) else [v],
                        tv if isinstance(tv, tuple) else [tv]):
            np.testing.assert_array_equal(np.asarray(b).view(np.uint8),
                                          np.asarray(a).view(np.uint8))
        assert (valid is None) == (tvalid is None)
        if valid is not None:
            np.testing.assert_array_equal(tvalid, valid)
