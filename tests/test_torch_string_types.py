"""The string-like, fixed_size_binary and dictionary arrays of the port
against the JAX package's on the same seeded inputs: their type and
class (a string column typed string, a dictionary column a
DictionaryArray whose `dictionary` is an Array), their values and Arrow
buffers, the builders, concat, the device boundary (`to_device` /
`from_device` / `batch_from_device` on the CPU), the class and type of
each compute result over strings for host input, the IPC, parquet and
pyarrow round trips of `string` beside `dictionary<int32, string>`, and
the parquet writer's defaults."""
import io

import numpy as np
import pytest

import arrow_go_tpu as jagt
import arrow_go_tpu.compute as jpc
import arrow_go_tpu.parquet as jpq
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import ipc as jipc
from arrow_go_tpu.device import block as jblock

import arrow_go_tpu_torch as agt
import arrow_go_tpu_torch.compute as pc
import arrow_go_tpu_torch.parquet as tpq
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import ipc as tipc
from arrow_go_tpu_torch.device import block
from arrow_go_tpu_torch.parquet import format as fmt
from test_torch_arrays_api import same_data
from torch_parity import jax_type, port_array, same_array, same_table

N = 300
WORDS = ["MAIL", "SHIP", "AIR", "", "été", "a-long-value-past-12-bytes"]
STRING_TYPES = ["string", "binary", "large_string", "large_binary",
                "string_view", "binary_view", "fixed_size_binary"]
INDEX_TYPES = ["int8", "int16", "int32", "int64"]


def _type(name: str):
    """(the port's type, the JAX one) of a name of STRING_TYPES."""
    if name == "fixed_size_binary":
        return dt.fixed_size_binary(3), jdt.fixed_size_binary(3)
    return getattr(dt, name), getattr(jdt, name)


def _values(name: str, n: int = N, seed: int = 0) -> list:
    """n seeded values of the type (a null now and then)."""
    rng = np.random.default_rng(seed)
    if name == "fixed_size_binary":
        pool = [bytes(rng.integers(0, 256, 3, dtype=np.uint8))
                for _ in range(5)]
    else:
        utf8 = name in ("string", "large_string", "string_view")
        pool = WORDS if utf8 else [w.encode() for w in WORDS]
    return [None if rng.random() < 0.15 else pool[rng.integers(len(pool))]
            for _ in range(n)]


def _same(got, want, what: str = "") -> None:
    """Same class name, type and Python values."""
    assert type(got).__name__ == type(want).__name__, (what, got, want)
    assert str(got.type) == str(want.type), (what, got.type, want.type)
    assert got.to_pylist() == want.to_pylist(), what


# ---------------------------------------------------------------------------
# array / builders: type, class, values, buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STRING_TYPES)
def test_array_of_each_string_like_type_is_the_jax_one(name):
    t, jt = _type(name)
    vals = _values(name)
    got, want = agt.array(vals, t), jagt.array(vals, jt)
    _same(got, want, name)
    assert got.type == t and got.null_count == want.null_count
    same_data(got.data, want.data, name)
    if name in ("string", "binary", "large_string", "large_binary"):
        np.testing.assert_array_equal(got.offsets, want.offsets)
    if name != "fixed_size_binary":
        np.testing.assert_array_equal(got.value_lengths(),
                                      want.value_lengths())
    sl, jsl = got.slice(7, 40), want.slice(7, 40)
    _same(sl, jsl, name + " slice")
    same_data(sl.data, jsl.data, name + " slice")


@pytest.mark.parametrize("values,name", [
    (["hello", None, "wörld"], "StringArray"),
    ([b"\x00\x01", None, b""], "BinaryArray")])
def test_inferred_string_and_binary_types(values, name):
    got, want = agt.array(values), jagt.array(values)
    _same(got, want)
    assert type(got).__name__ == name
    obj = np.empty(len(values), dtype=object)
    obj[:] = values
    _same(agt.array(obj), jagt.array(obj))


@pytest.mark.parametrize("name", STRING_TYPES)
def test_builders_give_the_jax_class_and_type(name):
    t, jt = _type(name)
    vals = _values(name, 50, seed=3)
    arrays = []
    for pkg, typ in ((agt, t), (jagt, jt)):
        b = pkg.make_builder(typ)
        for v in vals:
            if v is None:
                b.append_null()
            else:
                b.append(v)
        arrays.append(b.finish())
    _same(*arrays, what=name)
    same_data(arrays[0].data, arrays[1].data, name)


@pytest.mark.parametrize("index", INDEX_TYPES)
@pytest.mark.parametrize("value", ["string", "binary", "int64"])
def test_explicit_dictionaries_hold_an_array(index, value):
    rng = np.random.default_rng(5)
    if value == "int64":
        pool = [7, -3, 11, 0]
    else:
        pool = WORDS if value == "string" else [w.encode() for w in WORDS]
    vals = [None if rng.random() < 0.2 else pool[rng.integers(len(pool))]
            for _ in range(80)]
    t = dt.dictionary(getattr(dt, index), getattr(dt, value))
    jt = jdt.dictionary(getattr(jdt, index), getattr(jdt, value))
    got, want = agt.array(vals, t), jagt.array(vals, jt)
    _same(got, want, "array")
    assert type(got).__name__ == "DictionaryArray"
    _same(got.dictionary, want.dictionary, "dictionary")
    _same(got.indices, want.indices, "indices")
    _same(got.decode(), want.decode(), "decode")
    same_data(got.data, want.data, "data")


def test_concat_of_dictionaries_and_of_strings():
    t, jt = dt.dictionary(dt.int32, dt.string), jdt.dictionary(jdt.int32,
                                                              jdt.string)
    parts = [_values("string", 40, seed=s) for s in range(3)]
    got = agt.concat_arrays([agt.array(p, t) for p in parts])
    want = jagt.concat_arrays([jagt.array(p, jt) for p in parts])
    _same(got, want, "dictionary")
    _same(got.dictionary, want.dictionary, "unified dictionary")
    _same(got.indices, want.indices, "indices")
    got = agt.concat_arrays([agt.array(p) for p in parts])
    want = jagt.concat_arrays([jagt.array(p) for p in parts])
    _same(got, want, "string")
    with pytest.raises(ValueError):
        agt.concat_arrays([agt.array(parts[0]), agt.array(parts[1], t)])


def test_equals_tells_string_from_its_dictionary():
    vals = ["x", None, "y", "x"]
    s, d = agt.array(vals), agt.array(vals, dt.dictionary(dt.int32,
                                                          dt.string))
    js, jd = jagt.array(vals), jagt.array(vals, jdt.dictionary(jdt.int32,
                                                              jdt.string))
    assert s.equals(agt.array(vals)) and js.equals(jagt.array(vals))
    assert not s.equals(d) and not js.equals(jd)
    assert s.equals(d.decode()) and js.equals(jd.decode())


# ---------------------------------------------------------------------------
# the device boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STRING_TYPES)
def test_to_device_and_from_device_match_jax(name):
    t, jt = _type(name)
    vals = _values(name, seed=8)
    col = block.to_device(agt.array(vals, t), device="cpu")
    jcol = jblock.to_device(jagt.array(vals, jt))
    assert str(col.type) == str(jcol.type) == str(
        jdt.dictionary(jdt.int32, jt))
    assert col.values.dtype.itemsize == 4 and col.length == jcol.length
    back, jback = block.from_device(col), jblock.from_device(jcol)
    _same(back, jback, name)
    assert type(back.dictionary).__name__ == \
        type(jback.dictionary).__name__
    if name != "fixed_size_binary":     # first occurrence, as the JAX memo
        assert back.dictionary.to_pylist() == jback.dictionary.to_pylist()
        ok = back.validity_bools()           # a null row's code is free
        np.testing.assert_array_equal(
            col.values[:col.length].numpy()[ok],
            np.asarray(jcol.values)[:jcol.length][ok])


def test_an_explicit_dictionary_keeps_its_index_type_on_the_device():
    vals = _values("string", 60, seed=9)
    t, jt = dt.dictionary(dt.int16, dt.string), jdt.dictionary(jdt.int16,
                                                              jdt.string)
    col = block.to_device(agt.array(vals, t), device="cpu")
    jcol = jblock.to_device(jagt.array(vals, jt))
    assert str(col.type) == str(jcol.type)
    _same(block.from_device(col), jblock.from_device(jcol))


def test_batch_from_device_gives_each_field_its_class():
    vals = _values("string", 70, seed=4)
    rb = agt.record_batch({"s": agt.array(vals),
                           "d": agt.array(vals, dt.dictionary(dt.int32,
                                                              dt.string)),
                           "i": agt.array(list(range(70)))})
    jrb = jagt.record_batch({"s": jagt.array(vals),
                             "d": jagt.array(vals, jdt.dictionary(
                                 jdt.int32, jdt.string)),
                             "i": jagt.array(list(range(70)))})
    got = block.batch_from_device(block.batch_to_device(rb, "cpu"))
    want = jblock.batch_from_device(jblock.batch_to_device(jrb))
    assert type(got).__name__ == type(want).__name__ == "RecordBatch"
    assert [str(f.type) for f in got.schema.fields] == \
        [str(f.type) for f in want.schema.fields]
    for i in range(3):
        _same(got.column(i), want.column(i), rb.schema.field(i).name)


def test_an_empty_binary_column_stays_binary():
    db = block.batch_to_device({"b": np.array([], dtype="S1"),
                                "s": np.array([], dtype="U1")},
                               device="cpu")
    assert db.schema.field(0).type == dt.binary
    assert db.schema.field(1).type == dt.string
    coded = block.batch_to_device(
        {"b": (np.zeros(0, np.int32), np.array([], dtype="S1"))},
        device="cpu")
    assert coded.schema.field(0).type == dt.binary
    assert block.dictionary_type(np.array([b"x"], dtype=object)) == dt.binary
    assert block.batch_to_device({"b": np.array([b"ab", b"c"])},
                                 device="cpu").schema.field(0).type == \
        dt.binary


# ---------------------------------------------------------------------------
# compute results over strings, host input
# ---------------------------------------------------------------------------

def _pair(form: str, n: int = N):
    vals = _values("string", n, seed=12)
    if form == "chunked":
        cut = n // 3
        return (agt.ChunkedArray([agt.array(vals[:cut]),
                                  agt.array(vals[cut:])]),
                jagt.ChunkedArray([jagt.array(vals[:cut]),
                                   jagt.array(vals[cut:])]))
    return agt.array(vals), jagt.array(vals)


# each function as (module, dtypes module, array package, values,
# keywords): the keywords are the port's `device`, none for the JAX one
FUNCTIONS = {
    "unique": lambda m, d, p, a, kw: m.unique(a, **kw),
    "dictionary_encode": lambda m, d, p, a, kw: m.dictionary_encode(a, **kw),
    "sort_indices": lambda m, d, p, a, kw: m.sort_indices(a, **kw),
    "value_counts": lambda m, d, p, a, kw: m.value_counts(a, **kw),
    "is_in": lambda m, d, p, a, kw: m.is_in(a, m.SetLookupOptions(
        p.array(["MAIL", "AIR"])), **kw),
    "index_in": lambda m, d, p, a, kw: m.index_in(a, m.SetLookupOptions(
        p.array(["MAIL", "AIR"])), **kw),
    "cast": lambda m, d, p, a, kw: m.cast(a, d.large_string, **kw),
    "run_end_encode": lambda m, d, p, a, kw: m.run_end_encode(
        a.combine() if hasattr(a, "combine") else a, **kw),
}


@pytest.mark.parametrize("form", ["array", "chunked"])
@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
def test_compute_results_have_the_jax_class(fn, form):
    ta, ja = _pair(form)
    got = FUNCTIONS[fn](pc, dt, agt, ta, {"device": "cpu"})
    want = FUNCTIONS[fn](jpc, jdt, jagt, ja, {})
    assert type(got).__name__ == type(want).__name__, fn
    assert str(got.type) == str(want.type), fn
    if fn == "run_end_encode":
        _same(got.values, want.values, fn)
    elif fn == "value_counts":
        _same(got.field(0), want.field(0), fn)
        assert got.to_pylist() == want.to_pylist()
    else:
        assert got.to_pylist() == want.to_pylist(), fn
    if fn == "dictionary_encode":
        _same(got.dictionary, want.dictionary, fn)


@pytest.mark.parametrize("n", [100, 5000], ids=["small", "large"])
def test_filter_and_take_follow_the_jax_routes(n):
    ta, ja = _pair("array", n)
    rng = np.random.default_rng(2)
    keep = rng.random(n) < 0.5
    idx = rng.integers(0, n, 60)
    got = pc.filter(ta, agt.array(keep), device="cpu")
    want = jpc.filter(ja, jagt.array(keep))
    _same(got, want, "filter")
    got = pc.take(ta, agt.array(idx), device="cpu")
    want = jpc.take(ja, jagt.array(idx))
    _same(got, want, "take")
    rb = agt.record_batch({"s": ta, "i": agt.array(list(range(n)))})
    jrb = jagt.record_batch({"s": ja, "i": jagt.array(list(range(n)))})
    got = pc.filter(rb, agt.array(keep), device="cpu")
    want = jpc.filter(jrb, jagt.array(keep))
    assert type(got).__name__ == type(want).__name__
    _same(got.column(0), want.column(0), "batch filter")
    got = pc.take(rb, agt.array(idx), device="cpu")
    want = jpc.take(jrb, jagt.array(idx))
    _same(got.column(0), want.column(0), "batch take")


def test_group_by_keys_have_the_jax_class():
    ta, ja = _pair("array")
    rb = agt.record_batch({"s": ta, "i": agt.array(list(range(N)))})
    jrb = jagt.record_batch({"s": ja, "i": jagt.array(list(range(N)))})
    for got, want in (
            (pc.group_by(rb, "s", [("i", "sum")], device="cpu"),
             jpc.group_by(jrb, "s", [("i", "sum")])),
            (pc.group_by(block.batch_to_device(rb, "cpu"), "s",
                         [("i", "sum")]),
             jpc.group_by(jblock.batch_to_device(jrb), "s",
                          [("i", "sum")]))):
        assert type(got).__name__ == type(want).__name__ == "RecordBatch"
        assert [str(f.type) for f in got.schema.fields] == \
            [str(f.type) for f in want.schema.fields]
        _same(got.column(0), want.column(0), "key")
        assert got.column(1).to_pylist() == want.column(1).to_pylist()


@pytest.mark.parametrize("how", ["inner", "left outer", "left semi"])
def test_a_host_join_on_a_string_key_has_the_jax_classes(how):
    ta, ja = _pair("array")
    right = {"k": ["MAIL", "AIR", "été"], "y": [1, 2, 3]}
    got = pc.hash_join(
        agt.record_batch({"k": ta, "x": agt.array(list(range(N)))}),
        agt.record_batch(right), "k", join_type=how, device="cpu")
    want = jpc.hash_join(
        jagt.record_batch({"k": ja, "x": jagt.array(list(range(N)))}),
        jagt.record_batch(right), "k", join_type=how)
    assert type(got).__name__ == type(want).__name__ == "RecordBatch"
    assert [str(f.type) for f in got.schema.fields] == \
        [str(f.type) for f in want.schema.fields]
    assert sorted(map(str, got.to_pylist())) == \
        sorted(map(str, want.to_pylist()))
    assert type(got.column("k")).__name__ == \
        type(want.column("k")).__name__


# ---------------------------------------------------------------------------
# IPC, parquet and pyarrow: string beside dictionary<int32, string>
# ---------------------------------------------------------------------------

def _tables():
    vals = _values("string", 120, seed=21)
    dvals = _values("string", 120, seed=22)
    t = agt.table({"s": agt.array(vals),
                   "d": agt.array(dvals, dt.dictionary(dt.int32,
                                                       dt.string)),
                   "i": agt.array(list(range(120)))})
    jt = jagt.table({"s": jagt.array(vals),
                     "d": jagt.array(dvals, jdt.dictionary(jdt.int32,
                                                           jdt.string)),
                     "i": jagt.array(list(range(120)))})
    return t, jt


def _classes(t) -> list:
    return [type(t.column(i).combine()).__name__
            for i in range(t.num_columns)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ipc_round_trip_keeps_string_and_dictionary(writer):
    t, jt = _tables()
    sink = io.BytesIO()
    if writer == "port":
        with tipc.new_stream(sink, t.schema) as w:
            w.write_table(t)
    else:
        with jipc.new_stream(sink, jt.schema) as w:
            w.write_table(jt)
    got = tipc.open_stream(sink.getvalue()).read_all()
    want = jipc.open_stream(io.BytesIO(sink.getvalue())).read_all()
    assert type(got).__name__ == type(want).__name__ == "Table"
    same_table(got, want, writer)
    assert _classes(got) == _classes(want) == [
        "StringArray", "DictionaryArray", "NumericArray"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_parquet_round_trip_types_match_the_jax_reader(writer):
    t, jt = _tables()
    sink = io.BytesIO()
    if writer == "port":
        tpq.write_table(t, sink)
    else:
        jpq.write_table(jt, sink)
    blob = sink.getvalue()
    got = tpq.read_table(blob, device="cpu")
    want = jpq.read_table(io.BytesIO(blob))
    assert type(got).__name__ == type(want).__name__ == "Table"
    assert type(got.column("s")).__name__ == "ChunkedArray"
    same_table(got, want, writer)
    assert _classes(got) == _classes(want)
    rg = tpq.ParquetFile(blob).read_row_group(0, device="cpu")
    jrg = jpq.ParquetFile(io.BytesIO(blob)).read_row_group(0)
    assert type(rg).__name__ == type(jrg).__name__ == "RecordBatch"
    _same(rg.column("s"), jrg.column("s"), "row group")


def test_pyarrow_strings_and_dictionaries_import_typed():
    pa = pytest.importorskip("pyarrow")
    from arrow_go_tpu.interop import pyarrow_interop as jpx
    from arrow_go_tpu_torch.interop import pyarrow_interop as tpx
    vals = _values("string", 50, seed=30)
    for parr in (pa.array(vals, pa.string()),
                 pa.array(vals, pa.large_string()),
                 pa.array(vals, pa.string()).dictionary_encode(),
                 pa.array([None if v is None else v.encode() for v in vals],
                          pa.binary())):
        got, want = tpx.array_from_pyarrow(parr), jpx.array_from_pyarrow(
            parr)
        _same(got, want, str(parr.type))
        back = tpx.array_to_pyarrow(got)
        assert back.type == parr.type and back.to_pylist() == \
            parr.to_pylist()
    assert tpx.array_from_pyarrow(pa.array(vals, pa.string())).type == \
        dt.string


# ---------------------------------------------------------------------------
# the writer's defaults
# ---------------------------------------------------------------------------

def _chunks(blob: bytes) -> list:
    pf = tpq.ParquetFile(blob)
    return [(c.meta_data.codec, c.column_index_offset is not None,
             c.offset_index_offset is not None,
             sorted(fmt.Encoding(e).name for e in c.meta_data.encodings))
            for c in pf.metadata.row_groups[0].columns]


def test_write_table_defaults_are_the_jax_writers():
    t, jt = _tables()
    a, b = io.BytesIO(), io.BytesIO()
    tpq.write_table(t, a)
    jpq.write_table(jt, b)
    got, want = _chunks(a.getvalue()), _chunks(b.getvalue())
    for (codec, ci, oi, encs), (jcodec, jci, joi, jencs) in zip(got, want):
        assert codec == jcodec == fmt.Codec.SNAPPY
        assert ci and oi and jci and joi
        assert "RLE_DICTIONARY" not in encs + jencs
    for (*_, encs), (*_, jencs) in zip(got[:2], want[:2]):   # the strings
        assert "PLAIN_DICTIONARY" in encs and "PLAIN_DICTIONARY" in jencs
    pf = tpq.ParquetFile(a.getvalue())
    jf = jpq.ParquetFile(io.BytesIO(a.getvalue()))
    for col in range(3):
        assert str(pf.read_column_index(0, col)) == \
            str(jf.read_column_index(0, col))
    v2 = io.BytesIO()
    tpq.write_table(t, v2, properties=tpq.WriterProperties(
        data_page_version="2.0"))
    assert all("RLE_DICTIONARY" in encs and "PLAIN_DICTIONARY" not in encs
               for *_, encs in _chunks(v2.getvalue()))


def test_port_array_maps_a_jax_string_array_to_a_string_array():
    for name in STRING_TYPES:
        _, jt = _type(name)
        ja = jagt.array(_values(name, 40, seed=40), jt)
        got = port_array(ja)
        assert str(got.type) == str(jt)
        same_array(got, ja, name)
        assert str(jax_type(got.type)) == str(jt)
