"""The port's data-model API (array/arrays.py, array/record.py,
array/concat.py, array/layout.py, device/__init__.py) against the JAX
package's on the CPU.

Every case of tests/test_arrays.py runs through both packages with the
same Python or seeded numpy inputs, each JAX assertion held on both,
ints, bitmaps and offsets exactly. For each type of the IPC tests'
matrix (tests/test_torch_ipc.py), whole and sliced, a JAX array's
`data` buffers go through the port's `make_array` to the same values,
and the port's `Array.data` buffers equal the JAX ones byte for byte;
the differences are the deviations of ROADMAP §3, each asserted both
ways. The JAX `device` package's 13 names import from the port's, and a
port Table goes into each entry point that takes a HostBatch."""
import datetime
import decimal as pydec
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import arrow_go_tpu as jagt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.array.arrays import make_array as jmake_array

import arrow_go_tpu_torch as agt
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.array import arrays as A
from arrow_go_tpu_torch.device.block import HostArray, HostBatch
from arrow_go_tpu_torch.memory.buffer import Buffer
from test_torch_ipc import CASES, N, case
from torch_parity import port_type, same_array, same_table

BOTH = [(jagt, jdt), (agt, dt)]


# ---------------------------------------------------------------------------
# tests/test_arrays.py, case by case on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_numeric_roundtrip(pkg, d):
    a = pkg.array([1, 2, None, 4], d.int32)
    assert a.type == d.int32
    assert len(a) == 4 and a.null_count == 1
    assert a.to_pylist() == [1, 2, None, 4]
    assert a[0] == 1 and a[2] is None and a[-1] == 4
    assert type(a).__name__ == "NumericArray"


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_from_numpy_zero_copy(pkg, d):
    v = np.arange(10, dtype=np.float64)
    a = pkg.from_numpy(v)
    assert a.type == d.float64
    assert np.shares_memory(a.to_numpy(), v)


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_bool_array(pkg, d):
    a = pkg.array([True, False, None, True])
    assert a.type == d.bool_ and type(a).__name__ == "BooleanArray"
    assert a.to_pylist() == [True, False, None, True]
    np.testing.assert_array_equal(a.data.buffers[1].data,
                                  np.array([0b1001], np.uint8))


def test_string_binary():
    for pkg, d in BOTH:
        s = pkg.array(["hello", "", None, "wörld"])
        assert type(s).__name__ == "StringArray"
        assert s.to_pylist() == ["hello", "", None, "wörld"]
        b = pkg.array([b"\x00\x01", None, b""], d.binary)
        assert b.to_pylist() == [b"\x00\x01", None, b""]
        assert type(b).__name__ == "BinaryArray"
        np.testing.assert_array_equal(s.offsets, [0, 5, 5, 5, 11])
        np.testing.assert_array_equal(s.value_lengths(), [5, 0, 0, 6])
        assert s.value_bytes(3) == "wörld".encode() and \
            s.total_values_bytes() == 11
    # a port string column is coded (int32 codes into its values) and
    # typed utf8, as the JAX one
    s = agt.array(["hello", "", None, "wörld"])
    assert s.type == dt.string and s.data.type == dt.string
    assert jagt.array(["hello"]).type == jdt.string
    assert s.values.dtype == np.int32 and s.dict_values.tolist() == [
        "hello", "", "wörld"]


def test_large_string():
    for pkg, d in BOTH:
        s = pkg.array(["a", None, "bc"], d.large_string)
        assert s.to_pylist() == ["a", None, "bc"]
        assert s.offsets.dtype == np.int64
        assert type(s).__name__ == "LargeStringArray"
    assert jagt.array(["a"], jdt.large_string).type == jdt.large_string
    assert agt.array(["a"], dt.large_string).type == dt.large_string


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_slicing(pkg, d):
    a = pkg.array([1, 2, None, 4, 5])
    s = a.slice(1, 3)
    assert s.to_pylist() == [2, None, 4] and s.null_count == 1
    assert s.offset == 1 and s.data.offset == 1
    assert a[2:5].to_pylist() == [None, 4, 5]
    ss = s.slice(1, 2)
    assert ss.to_pylist() == [None, 4] and ss.offset == 2
    assert a.slice(3).to_pylist() == [4, 5]


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_list_array(pkg, d):
    a = pkg.array([[1, 2], [], None, [3, None, 5]])
    assert a.type == d.list_(d.int64)
    assert a.to_pylist() == [[1, 2], [], None, [3, None, 5]]
    np.testing.assert_array_equal(a.offsets, [0, 2, 2, 2, 5])
    assert type(a).__name__ == "ListArray"


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_fixed_size_list(pkg, d):
    a = pkg.array([[1, 2], None, [3, 4]], d.fixed_size_list(d.int32, 2))
    assert a.to_pylist() == [[1, 2], None, [3, 4]]
    assert type(a).__name__ == "FixedSizeListArray"


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_struct_array(pkg, d):
    a = pkg.array([{"x": 1, "y": "a"}, None, {"x": 3, "y": None}],
                  d.struct({"x": d.int64, "y": d.string}))
    assert a.to_pylist() == [{"x": 1, "y": "a"}, None, {"x": 3, "y": None}]
    assert a.field("x").to_pylist() == [1, None, 3]
    assert a.field(1).to_pylist() == ["a", None, None] and a.num_fields == 2


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_map_array(pkg, d):
    a = pkg.array([{"a": 1, "b": 2}, None, {}], d.map_(d.string, d.int64))
    assert a.to_pylist() == [[("a", 1), ("b", 2)], None, []]
    assert type(a).__name__ == "MapArray"


def test_dictionary_array():
    vals = ["x", "y", "x", None, "z", "y"]
    got = agt.array(vals, dt.dictionary(dt.int16, dt.string))
    want = jagt.array(vals, jdt.dictionary(jdt.int16, jdt.string))
    for a in (got, want):
        assert type(a).__name__ == "DictionaryArray"
        assert a.to_pylist() == vals
        assert a.indices.to_pylist()[:3] == [0, 1, 0]
        assert a.indices.type.name == "int16"
        assert a.decode().to_pylist() == vals
    # the dictionary is an Array of the value type in both packages
    for a in (got, want):
        assert a.dictionary.to_pylist() == ["x", "y", "z"]
        assert type(a.dictionary).__name__ == "StringArray"
        assert type(a.decode()).__name__ == "StringArray"


def test_decimal128():
    vals = [pydec.Decimal("12.34"), None, pydec.Decimal("-0.01")]
    for pkg, d in BOTH:
        a = pkg.array(vals, d.decimal128(20, 2))
        assert a.to_pylist() == vals
        assert a.unscaled(0) == 1234 and a.unscaled(2) == -1
        assert a.byte_width == 16 and type(a).__name__ == "DecimalArray"
    assert list(agt.array(vals, dt.decimal128(20, 2)).unscaled_array()) == \
        list(jagt.array(vals, jdt.decimal128(20, 2)).unscaled_array())


def test_decimal256_big():
    big = 10 ** 70 + 7
    for pkg, d in BOTH:
        a = pkg.array([pydec.Decimal(big), pydec.Decimal(-big)],
                      d.decimal256(76, 0))
        assert a.unscaled(0) == big and a.unscaled(1) == -big


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_fixed_size_binary(pkg, d):
    a = pkg.array([b"abc", None, b"xyz"], d.fixed_size_binary(3))
    assert a.to_pylist() == [b"abc", None, b"xyz"]
    assert a.value(2) == b"xyz" and type(a).__name__ == \
        "FixedSizeBinaryArray"


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_timestamp_date(pkg, d):
    ts = pkg.array([datetime.datetime(2020, 1, 1), None], d.timestamp("us"))
    assert ts.to_pylist()[0] == 1577836800 * 10 ** 6
    assert type(ts).__name__ == "TimestampArray"
    da = pkg.array([datetime.date(1970, 1, 2)], d.date32)
    assert da.to_pylist() == [1] and type(da).__name__ == "Date32Array"


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_run_end_encoded(pkg, d):
    vals = ["a", "a", "a", "b", None, None, "a"]
    a = pkg.array(vals, d.run_end_encoded(d.int32, d.string))
    assert a.to_pylist() == vals and len(a.run_ends) == 4
    assert a.decode().to_pylist() == vals
    assert a[4] is None and a[3] == "b" and a.slice(2, 3).to_pylist() == \
        ["a", "b", None]


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_null_array(pkg, d):
    a = pkg.array([None, None, None])
    assert a.type == d.null and a.null_count == 3
    assert a.to_pylist() == [None, None, None]
    assert a.data.buffers == []


def test_concat():
    for pkg, d in BOTH:
        c = pkg.concat_arrays([pkg.array([1, None, 3]),
                               pkg.array([4, 5], d.int64)])
        assert c.to_pylist() == [1, None, 3, 4, 5]
        s = pkg.concat_arrays([pkg.array(["a", None]), pkg.array(["bc"])])
        assert s.to_pylist() == ["a", None, "bc"]
        ll = pkg.concat_arrays([pkg.array([[1], [2, 3]]),
                                pkg.array([None, [4]], d.list_(d.int64))])
        assert ll.to_pylist() == [[1], [2, 3], None, [4]]
    same_array(agt.concat_arrays([agt.array(["a", None]),
                                  agt.array(["bc"])]),
               jagt.concat_arrays([jagt.array(["a", None]),
                                   jagt.array(["bc"])]), "strings")


def test_concat_dictionary_unifies():
    got = agt.concat_arrays([agt.array(["x", "y", None],
                                       dt.dictionary(dt.int32, dt.string)),
                             agt.array(["y", "z"],
                                       dt.dictionary(dt.int32, dt.string))])
    want = jagt.concat_arrays([jagt.array(["x", "y", None],
                                          jdt.dictionary(jdt.int32,
                                                         jdt.string)),
                               jagt.array(["y", "z"],
                                          jdt.dictionary(jdt.int32,
                                                         jdt.string))])
    assert type(got).__name__ == "DictionaryArray"
    assert got.to_pylist() == want.to_pylist() == ["x", "y", None, "y", "z"]
    assert got.dictionary.to_pylist() == want.dictionary.to_pylist() == \
        ["x", "y", "z"]
    assert got.indices.to_pylist() == want.indices.to_pylist()
    same_data(got.data, want.data, "unified")


def test_record_batch():
    data = {"a": [1, 2, 3], "b": ["x", None, "z"]}
    for pkg in (jagt, agt):
        rb = pkg.record_batch(data)
        assert type(rb).__name__ == "RecordBatch"
        assert rb.num_rows == 3 and rb.num_columns == 2
        assert rb.column("b").to_pylist() == ["x", None, "z"]
        assert rb.slice(1, 2).to_pydict() == {"a": [2, 3], "b": [None, "z"]}
        assert rb.select(["b"]).schema.names == ["b"]
        assert rb.to_pylist()[1] == {"a": 2, "b": None}
        assert rb.column_name(1) == "b" and rb["a"].to_pylist() == [1, 2, 3]
        assert rb.equals(pkg.record_batch(data))
        assert not rb.equals(pkg.record_batch({"a": [1, 2, 4],
                                               "b": ["x", None, "z"]}))
    rb = agt.record_batch(data)
    assert isinstance(rb, HostBatch) and isinstance(rb.slice(1, 2),
                                                    agt.RecordBatch)
    same_table(rb, jagt.record_batch(data), "record_batch")
    f = dt.Field("c", dt.float64)
    added = rb.add_column(1, f, agt.array([0.5, 1.5, None]))
    assert added.schema.names == ["a", "c", "b"]
    assert added.set_column(1, f, agt.array([1.0, 2.0, 3.0])).column(
        "c").to_pylist() == [1.0, 2.0, 3.0]
    with pytest.raises(ValueError):
        agt.RecordBatch(rb.schema, [rb.columns[0]])
    with pytest.raises(ValueError):
        agt.RecordBatch(rb.schema, rb.columns[::-1])


def test_table():
    for pkg in (jagt, agt):
        t = pkg.Table.from_batches([pkg.record_batch({"a": [1, 2]}),
                                    pkg.record_batch({"a": [3]})])
        assert t.num_rows == 3 and t.column("a").num_chunks == 2
        assert t.to_pydict() == {"a": [1, 2, 3]}
        assert t.combine_chunks().column("a").num_chunks == 1
        assert [b.num_rows for b in t.to_batches(max_chunksize=2)] == [2, 1]
        assert t.slice(1).to_pydict() == {"a": [2, 3]}
        assert t.select(["a"]).num_columns == 1
        assert t.equals(pkg.table({"a": [1, 2, 3]}))
    pt = agt.Table.from_batches([agt.record_batch({"a": [1, 2]}),
                                 agt.record_batch({"a": [3]})])
    assert isinstance(pt.column("a"), agt.ChunkedArray)
    same_table(pt, jagt.Table.from_batches([jagt.record_batch({"a": [1, 2]}),
                                            jagt.record_batch({"a": [3]})]),
               "from_batches")
    col = agt.Column(pt.schema.field(0), pt.column(0))
    assert (col.name, col.type, len(col)) == ("a", dt.int64, 3)


def test_chunked_array_ops():
    for pkg, d in BOTH:
        ca = pkg.ChunkedArray([pkg.array([1, 2]), pkg.array([None, 4])],
                              d.int64)
        assert len(ca) == 4 and ca.null_count == 1
        assert ca[2] is None and ca[3] == 4
        assert ca.slice(1, 2).to_pylist() == [2, None]
        assert ca.combine().to_pylist() == [1, 2, None, 4]


@pytest.mark.parametrize("pkg,d", BOTH, ids=["jax", "port"])
def test_builder_validity_optimized_away(pkg, d):
    a = pkg.array([1, 2, 3])
    assert a.data.validity is None and a.null_count == 0
    assert pkg.array([1, None]).data.validity is not None


def test_tracked_allocator():
    for pkg in (jagt, agt):
        alloc = pkg.TrackedAllocator()
        b = alloc.allocate(100)
        assert alloc.allocated_bytes == 100
        with pytest.raises(AssertionError):
            alloc.assert_size(0)
        alloc.free(b)
        alloc.assert_size(0)
        with pytest.raises(RuntimeError):
            alloc.free(b)


# ---------------------------------------------------------------------------
# the Array methods beyond test_arrays.py
# ---------------------------------------------------------------------------

def test_array_methods_match():
    rng = np.random.default_rng(5)
    v = rng.integers(-50, 50, 37)
    mask = rng.random(37) < 0.8
    got, want = agt.array(v, mask=mask), jagt.array(v, mask=mask)
    for i in range(37):
        assert got.is_valid(i) == want.is_valid(i)
        assert got.is_null(i) == want.is_null(i)
        assert got.value(i) == want.value(i)
        assert got[i] == want[i]
    assert list(got) == list(want) and got.null_count == want.null_count
    assert got.equals(agt.array(v, mask=mask)) and got == agt.array(
        v, mask=mask)
    assert not got.equals(agt.array(v))
    np.testing.assert_array_equal(got.validity_bools(),
                                  want.validity_bools())
    assert repr(agt.array([1, None])) == repr(jagt.array([1, None]))
    from arrow_go_tpu.array.arrays import take_host as jtake
    from arrow_go_tpu.array.arrays import with_validity as jwith
    assert A.with_validity(got, ~mask).to_pylist() == \
        jwith(want, ~mask).to_pylist()
    idx = np.array([3, -1, 0, 36])
    assert A.take_host(got, idx).to_pylist() == jtake(want, idx).to_pylist()
    s = agt.array(["a", None, "bc", "a"])
    js = jagt.array(["a", None, "bc", "a"])
    assert A.take_host(s, [2, -1, 0]).to_pylist() == \
        jtake(js, np.array([2, -1, 0])).to_pylist()


def test_union_and_list_view_accessors():
    ja, pa, _ = case("dense_union")
    assert type(pa).__name__ == "UnionArray"
    np.testing.assert_array_equal(pa.type_ids, ja.type_ids)
    for i in range(len(ja.type.fields())):
        assert pa.child(i).to_pylist() == ja.child(i).to_pylist()
    ja, pa, _ = case("large_list_view<utf8>")
    assert type(pa).__name__ == type(ja).__name__ == "LargeListViewArray"
    assert pa.slice(3, 5).to_pylist() == ja.slice(3, 5).to_pylist()


def test_nested_values_are_children():
    # a nested column's `values` is None in the port, its child
    # children[0]; the JAX ListArray's `values` is the child (ROADMAP §3)
    got = agt.array([[1, 2], None, [3]])
    want = jagt.array([[1, 2], None, [3]])
    assert got.values is None
    assert got.children[0].to_pylist() == want.values.to_pylist()


# ---------------------------------------------------------------------------
# ArrayData across the IPC matrix: make_array of the JAX buffers, and the
# port's buffers byte for byte
# ---------------------------------------------------------------------------

def port_data(jd):
    """A JAX ArrayData as the port's: the same bytes in port Buffers."""
    return A.ArrayData(
        port_type(jd.type), jd.length,
        [None if b is None else Buffer(np.asarray(b.data).copy())
         for b in jd.buffers],
        [port_data(c) for c in jd.children],
        None if jd.dictionary is None else port_data(jd.dictionary),
        jd._null_count, jd.offset)


UNIONS = ("sparse_union", "dense_union")


def same_data(pd, jd, what: str) -> None:
    """Two ArrayDatas alike: type, length, offset, null count (not a
    union's: ROADMAP §3), buffers byte for byte, children, dictionary."""
    assert str(pd.type) == str(jd.type), what
    assert (pd.length, pd.offset) == (jd.length, jd.offset), what
    if pd.type.name not in UNIONS:
        assert pd.null_count == jd.null_count, what
    assert len(pd.buffers) == len(jd.buffers), what
    for i, (pb, jb) in enumerate(zip(pd.buffers, jd.buffers)):
        assert (pb is None) == (jb is None), (what, i)
        if pb is not None:
            assert np.asarray(pb.data).tobytes() == \
                np.asarray(jb.data).tobytes(), (what, i)
    assert len(pd.children) == len(jd.children), what
    for i, (pc, jc) in enumerate(zip(pd.children, jd.children)):
        same_data(pc, jc, f"{what}.{i}")
    assert (pd.dictionary is None) == (jd.dictionary is None), what
    if pd.dictionary is not None:
        same_data(pd.dictionary, jd.dictionary, what + ".dictionary")


def _port_case(name):
    ja, pa, t = case(name)
    if name == "dictionary<utf8>":      # an explicit dictionary column
        pa = A.DictionaryArray(pa.values, pa.mask, pa.type, pa.dictionary)
    return ja, pa


SLICES = [(0, N), (3, 11)]


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", CASES)
def test_make_array_of_the_jax_buffers(name, lo, n):
    ja, _ = _port_case(name)
    ja = ja.slice(lo, n)
    pd = port_data(ja.data)
    got = A.make_array(pd)
    assert got.data is pd and got.offset == lo
    assert type(got).__name__ == type(ja).__name__ or name == "variant"
    same_array(got, ja, name)
    assert got.to_pylist() == ja.to_pylist()


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", CASES)
def test_the_ports_buffers_are_the_jax_bytes(name, lo, n):
    ja, pa = _port_case(name)
    ja, pa = ja.slice(lo, n), pa.slice(lo, n)
    assert pa.offset == ja.offset == lo
    same_data(pa.data, ja.data, name)
    back = A.make_array(pa.data)
    assert back.to_pylist() == pa.to_pylist()


@pytest.mark.parametrize("name", UNIONS)
def test_a_unions_null_count_is_its_rows(name):
    # the JAX ArrayData reads a union's type-code buffer as a validity
    # bitmap; the port counts the rows whose child row is null, and its
    # layout counts none, as the IPC field node does (ROADMAP §3)
    ja, pa, _ = case(name)
    want_rows = sum(not ja.is_valid(i) for i in range(len(ja)))
    assert pa.null_count == want_rows
    assert pa.data.null_count == 0
    jbits = np.unpackbits(np.asarray(ja.data.buffers[0].data),
                          bitorder="little")[:len(ja)]
    assert ja.null_count == len(ja) - int(jbits.sum())


def test_make_array_round_trips_the_jax_layout_of_a_jax_make_array():
    ja = jagt.array([[1, None], None, [2, 3, 4]])
    d = ja.data
    back = jmake_array(d)
    got = A.make_array(port_data(d))
    assert got.to_pylist() == back.to_pylist()
    same_data(got.data, back.data, "list")


# ---------------------------------------------------------------------------
# the device package's names
# ---------------------------------------------------------------------------

def test_the_device_package_exports_the_jax_names():
    import arrow_go_tpu.device as jdev
    from arrow_go_tpu_torch import device as tdev
    names = sorted(n for n in vars(jdev) if not n.startswith("_")
                   and n != "block")
    assert len(names) == 13
    from arrow_go_tpu_torch.device import (  # noqa: F401
        DeviceBatch, DeviceColumn, DeviceListColumn, HostColumn,
        batch_from_device, batch_to_device, from_device, list_from_device,
        list_take_device, list_to_device, pad_length, row_mask, to_device)
    assert [n for n in names if not hasattr(tdev, n)] == []


def test_to_device_from_device_and_the_batch_round_trip():
    rng = np.random.default_rng(11)
    v = rng.integers(-100, 100, 300)
    mask = rng.random(300) < 0.9
    for arr, jarr in [(agt.array(v, mask=mask), jagt.array(v, mask=mask)),
                      (agt.array(["a", None, "b"] * 7),
                       jagt.array(["a", None, "b"] * 7))]:
        col = agt.device.to_device(arr, device="cpu")
        from arrow_go_tpu.device import to_device as jto
        jcol = jto(jarr)
        assert col.padded == jcol.padded and col.length == jcol.length
        np.testing.assert_array_equal(
            col.validity.numpy().view(np.uint32) if col.validity is not None
            else [], np.asarray(jcol.validity) if jcol.validity is not None
            else [])
        assert agt.device.from_device(col).to_pylist() == arr.to_pylist()
        assert col.null_count == arr.null_count
    rb = agt.record_batch({"a": v, "s": [str(x % 7) for x in v],
                           "l": [[int(x)] for x in v]})
    db = agt.device.batch_to_device(rb, "cpu")
    assert type(db.columns[2]).__name__ == "HostColumn"
    back = agt.device.batch_from_device(db)
    assert isinstance(back, agt.RecordBatch) and back.equals(rb)
    table = agt.Table.from_batches([rb.slice(0, 100), rb.slice(100)])
    assert agt.device.batch_from_device(
        agt.device.batch_to_device(table, "cpu")).equals(rb)
    from arrow_go_tpu_torch.device.block import array_from_host
    got = array_from_host(np.asarray(v, np.int64), mask, dt.int64, None, 10)
    assert got.to_pylist() == agt.array(v[:10], mask=mask[:10]).to_pylist()


# ---------------------------------------------------------------------------
# a Table into each entry point that takes a HostBatch
# ---------------------------------------------------------------------------

def _table_and_batch():
    rng = np.random.default_rng(2)
    k = rng.integers(0, 5, 60)
    v = rng.standard_normal(60)
    data = {"k": k, "v": v, "s": [["p", "q", "r"][x % 3] for x in k]}
    rb = agt.record_batch(data)
    return agt.Table.from_batches([rb.slice(0, 25), rb.slice(25)]), rb, data


def test_a_table_writes_as_its_batch():
    from arrow_go_tpu_torch import formats, ipc, parquet
    t, rb, data = _table_and_batch()

    def parquet_bytes(x):
        buf = io.BytesIO()
        parquet.write_table(x, buf)
        return buf.getvalue()

    def ipc_bytes(x):
        buf = io.BytesIO()
        w = ipc.new_stream(buf, rb.schema)
        w.write(x)
        w.close()
        return buf.getvalue()

    def text(fn, x):
        buf = io.StringIO()
        fn(x, buf)
        return buf.getvalue()

    assert parquet_bytes(t) == parquet_bytes(rb)
    assert ipc_bytes(t) == ipc_bytes(rb)
    assert text(formats.write_csv, t) == text(formats.write_csv, rb)
    assert text(formats.write_json, t) == text(formats.write_json, rb)
    import arrow_go_tpu.parquet as jpq
    jt = jagt.Table.from_batches([jagt.record_batch(
        {"k": data["k"], "v": data["v"], "s": data["s"]})])
    assert jpq.read_table(io.BytesIO(parquet_bytes(t))).to_pydict() == \
        jt.to_pydict()


def test_a_table_goes_through_compute():
    from arrow_go_tpu_torch import compute as tpc
    t, rb, _ = _table_and_batch()
    g1 = tpc.group_by(t, "k", [("v", "sum")], device="cpu")
    g2 = tpc.group_by(rb, "k", [("v", "sum")], device="cpu")
    assert g1.equals(g2)
    m = agt.array(np.asarray(rb.column("v").values) > 0)
    assert tpc.filter_(t, m, device="cpu").equals(
        tpc.filter_(rb, m, device="cpu"))
    idx = agt.array(np.array([5, 0, 59], np.int64))
    assert tpc.take(t, idx, device="cpu").equals(
        tpc.take(rb, idx, device="cpu"))
    j1 = tpc.hash_join(t, t.select(["k", "v"]), "k", device="cpu")
    j2 = tpc.hash_join(rb, rb.select(["k", "v"]), "k", device="cpu")
    assert j1.equals(j2)


def test_a_table_goes_through_cdata_and_pyarrow():
    from arrow_go_tpu_torch import cdata
    t, rb, _ = _table_and_batch()
    ptrs = cdata.stream_handle()
    cdata.export_stream(t, ptrs)
    assert cdata.import_stream(ptrs).read_all().equals(rb)
    pa = pytest.importorskip("pyarrow")
    from arrow_go_tpu_torch.interop import pyarrow_interop as pi
    assert pi.record_batch_to_pyarrow(t).equals(
        pi.record_batch_to_pyarrow(rb))
    pt = pi.table_to_pyarrow(t)
    assert isinstance(pt, pa.Table) and pt.column(0).num_chunks == 2


def test_a_table_goes_through_flight():
    from arrow_go_tpu_torch import flight as tfl
    t, rb, _ = _table_and_batch()
    got = {}

    class Srv(tfl.FlightServerBase):
        def do_get(self, ctx, ticket):
            return t

        def do_put(self, ctx, descriptor, reader):
            got["put"] = reader.read_all()
            yield b"ok"

    with Srv("grpc://127.0.0.1:0") as srv:
        with tfl.FlightClient(f"grpc://127.0.0.1:{srv.port}") as c:
            assert c.do_get(tfl.Ticket(b"t")).read_all().equals(rb)
            assert c.do_put(tfl.FlightDescriptor.for_path("p"), t.schema,
                            [t]) == [b"ok"]
    assert got["put"].equals(rb)


def test_a_table_goes_through_the_distributed_tier():
    """parallel.api takes a Table (its chunks combined): a world-size-1
    gloo group in a child process, against the one-process group_by."""
    code = (
        "import numpy as np\n"
        "import arrow_go_tpu_torch as agt\n"
        "from arrow_go_tpu_torch import compute as pc, parallel\n"
        "rb = agt.record_batch({'k': np.arange(60) % 5,"
        " 'v': np.arange(60.0)})\n"
        "t = agt.Table.from_batches([rb.slice(0, 25), rb.slice(25)])\n"
        "mesh = parallel.make_mesh(device='cpu')\n"
        "got = parallel.distributed_group_by(t, 'k', [('v', 'sum')],"
        " mesh=mesh)\n"
        "want = pc.group_by(rb, 'k', [('v', 'sum')], device='cpu')\n"
        "g = dict(zip(got.column('k').to_pylist(),"
        " got.column('v_sum').to_pylist()))\n"
        "w = dict(zip(want.column('k').to_pylist(),"
        " want.column('v_sum').to_pylist()))\n"
        "assert g == w, (g, w)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_a_read_results_column_is_an_array():
    # the readers return a Table, as the JAX read does: its `column` is
    # a ChunkedArray, one chunk a row group, whose chunks are arrays
    import arrow_go_tpu.parquet as jpq
    from arrow_go_tpu_torch import parquet
    rb = agt.record_batch({"a": list(range(10)), "s": ["x", None] * 5})
    buf = io.BytesIO()
    parquet.write_table(rb, buf)
    got = parquet.read_table(io.BytesIO(buf.getvalue()), device="cpu")
    want = jpq.read_table(io.BytesIO(buf.getvalue()))
    assert isinstance(got, agt.Table) and not isinstance(got, HostBatch)
    for t in (got, want):
        assert type(t.column("a")).__name__ == "ChunkedArray"
        assert t.column("a").num_chunks == 1
    assert isinstance(got.column("a").chunk(0), HostArray)
    assert type(got.column("s").chunk(0)).__name__ == "StringArray"
    assert got.schema.field(1).type == dt.string
    assert [b.num_rows for b in got.to_batches(4)] == [4, 4, 2] == \
        [b.num_rows for b in want.to_batches(4)]
    assert got.to_pydict() == want.to_pydict()
    assert agt.Table.from_batches(got.to_batches(4)).equals(
        agt.Table.from_batches([got]))
