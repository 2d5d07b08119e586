"""The port's pyarrow interop (arrow_go_tpu_torch/interop/pyarrow_interop.py)
against the JAX module (arrow_go_tpu/interop/pyarrow_interop.py) on the
same inputs: every case of tests/test_interop.py's CASES and every type
of tests/test_torch_ipc.py's cases (the primitives, temporals, decimals,
binaries, views, large types, float16, nested types, intervals, unions,
run-end encoding, dictionary, extensions), whole and sliced, in both
directions, pyarrow's `validate(full=True)` on every array the port
builds; the JAX refusals and losses in both packages; schemas with
metadata; record batches and tables of several batches; and the module
with pyarrow blocked. Where the JAX module fails (a null column and a
union to pyarrow; a sliced struct with nulls or a sliced union from
pyarrow) the test holds that it still fails and that the port gives
pyarrow's own values (ROADMAP §3)."""
import decimal
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.array.record import Table as JTable
from arrow_go_tpu.interop import pyarrow_interop as jpx

from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.array.record import ChunkedArray
from arrow_go_tpu_torch.device.block import HostBatch
from arrow_go_tpu_torch.interop import pyarrow_interop as tpx
from test_interop import CASES as INTEROP_CASES
from test_torch_ipc import CASES as IPC_CASES
from test_torch_ipc import case
from torch_parity import (_exact, port_array, port_record_batch, port_type,
                          same_array, same_table)

pa = pytest.importorskip("pyarrow")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PUBLIC = ["type_to_pyarrow", "type_from_pyarrow", "schema_to_pyarrow",
          "schema_from_pyarrow", "array_to_pyarrow", "array_from_pyarrow",
          "record_batch_to_pyarrow", "record_batch_from_pyarrow",
          "table_to_pyarrow", "table_from_pyarrow"]
# type_to_pyarrow has no entry for these (arrow_go_tpu/interop/
# pyarrow_interop.py:98-99)
REFUSED = {"month_interval", "day_time_interval", "bool8", "uuid", "json",
           "variant"}
# the JAX array_to_pyarrow raises on these: from_buffers with no buffer
# for the null type, pa.array of Python values for a union
JAX_CANNOT_EXPORT = {"null": ValueError, "sparse_union": NotImplementedError,
                     "dense_union": NotImplementedError}
# the JAX array_from_pyarrow reads a struct's validity and a union's type
# codes (and dense offsets) without the slice's offset
JAX_MISREADS_SLICES = {"struct<a: int32, b: utf8>", "sparse_union",
                       "dense_union"}
SLICES = [(0, None), (3, 11)]
# the port keeps pyarrow's child and its offsets (a list view's child
# unsliced, a run-end array's offset) where the JAX module rebuilds the
# rows; only their values and type are compared
LAYOUT_MAY_DIFFER = {"list_view<int32>", "large_list_view<utf8>",
                     "run_end_encoded<int32, int64>", "sparse_union",
                     "dense_union"}


def _ids(v):
    return str(v)[:40]


def _pylist(values) -> list:
    """Python values with intervals' numpy ints as ints (the port's
    records and the JAX package's tuples alike)."""
    return [tuple(int(x) for x in v) if isinstance(v, tuple) else v
            for v in values]


def _comparable(parr):
    """pyarrow's values as the port and the JAX package give them: a
    temporal column's raw ints, an interval's tuples."""
    import pyarrow.types as pt
    t = parr.type
    if pt.is_temporal(t) and not pt.is_interval(t):
        return parr.cast(pa.int64() if t.bit_width == 64
                         else pa.int32()).to_pylist()
    return _pylist(parr.to_pylist())


def _cut(a, lo, n):
    return a if n is None else a.slice(lo, n)


def _port_type(jt):
    """torch_parity.port_type, run_end_encoded too."""
    if jt.id == jdt.TypeId.RUN_END_ENCODED:
        return dt.run_end_encoded(port_type(jt.run_ends_type),
                                  port_type(jt.values_type))
    return port_type(jt)


def test_the_jax_modules_public_functions_are_ported():
    import inspect
    jax_funcs = {n for n, f in vars(jpx).items() if not n.startswith("_")
                 and inspect.isfunction(f) and f.__module__ == jpx.__name__}
    assert jax_funcs == set(PUBLIC)
    for name in PUBLIC:
        assert callable(getattr(tpx, name)), name


# ---------------------------------------------------------------------------
# arrays to pyarrow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values,jt", INTEROP_CASES, ids=_ids)
def test_interop_cases_to_pyarrow_equal_the_jax_module(values, jt):
    ja = agt.array(values, jt)
    want = jpx.array_to_pyarrow(ja)
    got = tpx.array_to_pyarrow(port_array(ja), port_type(jt))
    got.validate(full=True)
    assert got.type == want.type
    assert got.equals(want)
    if jt.id != jdt.TypeId.DICTIONARY:
        # a column's own field type is the default (a dictionary-coded
        # string column is a string column)
        assert tpx.array_to_pyarrow(port_array(ja)).equals(want)


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", IPC_CASES)
def test_every_type_to_pyarrow_equals_the_jax_module(name, lo, n):
    ja, ha, t = case(name)
    ja, ha = _cut(ja, lo, n), _cut(ha, lo, n)
    if name in REFUSED:
        with pytest.raises(NotImplementedError):
            jpx.array_to_pyarrow(ja)
        with pytest.raises(NotImplementedError):
            tpx.array_to_pyarrow(ha, t)
        return
    got = tpx.array_to_pyarrow(ha, t)
    got.validate(full=True)
    assert got.type == jpx.type_to_pyarrow(ja.type)
    if name in JAX_CANNOT_EXPORT:
        with pytest.raises(JAX_CANNOT_EXPORT[name]):
            jpx.array_to_pyarrow(ja)
        assert _comparable(got) == _pylist(ja.to_pylist())
        # and the JAX module reads the port's array back as it was
        assert _pylist(jpx.array_from_pyarrow(got).to_pylist()) == \
            _pylist(ja.to_pylist())
        return
    want = jpx.array_to_pyarrow(ja)
    assert got.type == want.type
    assert got.equals(want)


def test_large_lists_lose_their_value_fields_name_in_both():
    jt = jdt.large_list(jdt.Field("x", jdt.int32))
    ja = agt.array([[1, 2], None, []], jt)
    want = jpx.array_to_pyarrow(ja)
    got = tpx.array_to_pyarrow(port_array(ja), port_type(jt))
    assert str(want.type) == str(got.type) == "large_list<item: int32>"
    assert got.equals(want)
    view = dt.large_list_view(dt.Field("x", dt.int64))
    jview = jdt.LargeListViewType(jdt.Field("x", jdt.int64))
    assert tpx.type_to_pyarrow(view) == jpx.type_to_pyarrow(jview) == \
        pa.large_list_view(pa.int64())


# ---------------------------------------------------------------------------
# arrays from pyarrow
# ---------------------------------------------------------------------------

def _source(values, jt):
    """The pyarrow array of a test_interop case, built as that test
    builds it (a temporal one through its raw ints)."""
    if jt.is_temporal:
        return pa.array(values, pa.int64() if jt.bit_width == 64
                        else pa.int32()).cast(jpx.type_to_pyarrow(jt))
    return pa.array(values, jpx.type_to_pyarrow(jt))


def _same_import(got, want, src, what, jax_misreads=False):
    """The port's import of `src` equal to the JAX module's: its type and
    values, pyarrow's own;
    with `jax_misreads`, the JAX module's values differ from pyarrow's
    (ROADMAP §3) and only the type is compared with them."""
    wt = _port_type(want.type)
    assert got.type == wt, (what, got.type, wt)
    assert _pylist(got.to_pylist()) == _comparable(src), what
    if jax_misreads:
        assert _pylist(want.to_pylist()) != _comparable(src), what
    else:
        assert _pylist(got.to_pylist()) == _pylist(want.to_pylist()), what


@pytest.mark.parametrize("lo,n", [(0, None), (1, 2)])
@pytest.mark.parametrize("values,jt", INTEROP_CASES, ids=_ids)
def test_interop_cases_from_pyarrow_equal_the_jax_module(values, jt, lo, n):
    src = _cut(_source(values, jt), lo, n)
    misread = n is not None and jt.id == jdt.TypeId.STRUCT
    _same_import(tpx.array_from_pyarrow(src), jpx.array_from_pyarrow(src),
                 src, str(jt), misread)


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", [c for c in IPC_CASES if c not in REFUSED])
def test_every_type_from_pyarrow_equals_the_jax_module(name, lo, n):
    ja, ha, t = case(name)
    src = _cut(tpx.array_to_pyarrow(ha, t), lo, n)
    got = tpx.array_from_pyarrow(src)
    want = jpx.array_from_pyarrow(src)
    misread = n is not None and name in JAX_MISREADS_SLICES
    _same_import(got, want, src, name, misread)
    if name not in LAYOUT_MAY_DIFFER and not misread:
        same_array(got, want, name)
    # and back: the port's array gives the same pyarrow array again
    back = tpx.array_to_pyarrow(got, t)
    back.validate(full=True)
    assert back.equals(src)


def test_unsigned_extremes_and_wide_decimals_cross_exactly():
    src = pa.array([0, 2**64 - 1, None, 2**63], pa.uint64())
    got = tpx.array_from_pyarrow(src)
    assert got.values.dtype == np.uint64
    assert got.to_pylist() == src.to_pylist()
    assert tpx.array_to_pyarrow(got).equals(src)
    big = [decimal.Decimal(2**120 + 7), None,
           decimal.Decimal(-(2**250)), decimal.Decimal(1)]
    for ptype in (pa.decimal128(38, 0), pa.decimal256(76, 0)):
        vals = [v if v is None or abs(v) < 10 ** ptype.precision else None
                for v in big]
        src = pa.array(vals, ptype)
        got = tpx.array_from_pyarrow(src)
        assert got.values.shape == (4, ptype.bit_width // 64)
        assert got.to_pylist() == vals
        back = tpx.array_to_pyarrow(got)
        back.validate(full=True)
        assert back.equals(src)
        # 16 / 32 little-endian bytes a value, the Arrow layout
        assert back.buffers()[1].to_pybytes() == src.buffers()[1].to_pybytes()


# ---------------------------------------------------------------------------
# types and schemas
# ---------------------------------------------------------------------------

def test_types_both_ways_equal_the_jax_module():
    from test_torch_ipc import FLAT, NESTED
    for jt in list(FLAT.values()) + list(NESTED.values()) + [
            jdt.null, jdt.large_string, jdt.large_binary, jdt.string_view,
            jdt.binary_view, jdt.month_day_nano_interval,
            jdt.ListViewType(jdt.int32), jdt.dictionary(jdt.int8, jdt.string),
            jdt.run_end_encoded(jdt.int16, jdt.float64),
            jdt.run_end_encoded(jdt.int64, jdt.string),
            jdt.sparse_union([jdt.Field("i", jdt.int64),
                              jdt.Field("s", jdt.string)], [3, 7]),
            jdt.dense_union([jdt.Field("i", jdt.int64)], [1])]:
        want = jpx.type_to_pyarrow(jt)
        assert tpx.type_to_pyarrow(_port_type(jt)) == want, jt
        assert tpx.type_from_pyarrow(want) == _port_type(
            jpx.type_from_pyarrow(want)), jt


def test_union_fields_come_back_nullable_in_both():
    ut = pa.sparse_union([pa.field("i", pa.int64(), nullable=False),
                          pa.field("s", pa.string(), nullable=False)], [0, 1])
    got, want = tpx.type_from_pyarrow(ut), jpx.type_from_pyarrow(ut)
    assert [f.nullable for f in got.fields()] == \
        [f.nullable for f in want.fields()] == [True, True]
    assert got == port_type(want)


def test_refusals_raise_not_implemented_in_both():
    from arrow_go_tpu_torch import extensions as ext
    from arrow_go_tpu import extensions as jext
    for t, jt in ((dt.month_interval, jdt.month_interval),
                  (dt.day_time_interval, jdt.day_time_interval),
                  (ext.uuid, jext.UuidType())):
        with pytest.raises(NotImplementedError):
            jpx.type_to_pyarrow(jt)
        with pytest.raises(NotImplementedError):
            tpx.type_to_pyarrow(t)
    for ptype in (pa.uuid(), pa.bool8(), pa.json_()):
        with pytest.raises(NotImplementedError):
            jpx.type_from_pyarrow(ptype)
        with pytest.raises(NotImplementedError):
            tpx.type_from_pyarrow(ptype)


def test_schema_metadata_round_trips_and_field_metadata_drops():
    fmd = {"unit": "cents"}
    js = jdt.Schema([jdt.Field("a", jdt.int64, False, jdt.Metadata(fmd)),
                     jdt.Field("b", jdt.string),
                     jdt.Field("c", jdt.list_(jdt.float32))],
                    jdt.Metadata({"k": "v"}))
    ts = dt.Schema([dt.Field("a", dt.int64, False, dt.Metadata(fmd)),
                    dt.Field("b", dt.string),
                    dt.Field("c", dt.list_(dt.float32))],
                   dt.Metadata({"k": "v"}))
    want = jpx.schema_to_pyarrow(js)
    got = tpx.schema_to_pyarrow(ts)
    assert got.equals(want, check_metadata=True)
    assert got.field("a").metadata == {b"unit": b"cents"}
    back, jback = tpx.schema_from_pyarrow(got), jpx.schema_from_pyarrow(want)
    assert back == ts
    assert back.metadata == dt.Metadata({"k": "v"})
    assert jback.metadata.get("k") == back.metadata.get("k") == "v"
    # field metadata is dropped by both
    assert len(jback.field(0).metadata) == len(back.field(0).metadata) == 0
    assert not back.field(0).nullable


# ---------------------------------------------------------------------------
# batches and tables
# ---------------------------------------------------------------------------

def _batch_data(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    words = ["east", "west", "north", None]
    return {"i": [None if x < 5 else int(x) for x in
                  rng.integers(0, 100, n)],
            "s": [words[x] for x in rng.integers(0, 4, n)],
            "f": [float(x) for x in rng.random(n)],
            "l": [None if x == 0 else list(range(int(x)))
                  for x in rng.integers(0, 4, n)]}


def test_record_batches_round_trip_as_the_jax_modules():
    jrb = agt.record_batch(_batch_data(1, 30))
    hb = port_record_batch(jrb)
    want = jpx.record_batch_to_pyarrow(jrb)
    got = tpx.record_batch_to_pyarrow(hb)
    got.validate(full=True)
    assert got.equals(want)
    assert got.schema.equals(want.schema, check_metadata=True)
    back = tpx.record_batch_from_pyarrow(got)
    same_table(back, jpx.record_batch_from_pyarrow(want), "batch")


BATCH_SCHEMA = jdt.Schema([jdt.Field("i", jdt.int64),
                           jdt.Field("s", jdt.string),
                           jdt.Field("f", jdt.float64),
                           jdt.Field("l", jdt.list_(jdt.int64))])


def test_a_table_of_several_batches_becomes_one_host_batch():
    jbs = [agt.record_batch(_batch_data(s, n), schema=BATCH_SCHEMA)
           for s, n in ((2, 17), (3, 0), (4, 25))]
    src = pa.Table.from_batches([jpx.record_batch_to_pyarrow(b)
                                 for b in jbs])
    assert src.column(0).num_chunks == 3
    got = tpx.table_from_pyarrow(src)
    want = jpx.table_from_pyarrow(src)
    assert isinstance(got, HostBatch) and got.num_rows == 42
    same_table(got, want, "table")
    # one pyarrow chunk a column back (the JAX module combines them too)
    out = tpx.table_to_pyarrow(got)
    assert out.equals(jpx.table_to_pyarrow(want))
    assert out.equals(src)
    assert out.column(0).num_chunks == 1


def test_chunked_columns_go_one_pyarrow_chunk_a_chunk():
    jt = JTable.from_batches([
        agt.record_batch({"x": [1, 2], "s": ["a", None]}),
        agt.record_batch({"x": [None, 4], "s": ["b", "a"]})])
    want = jpx.table_to_pyarrow(jt)
    hb = HostBatch(dt.Schema([dt.Field("x", dt.int64),
                              dt.Field("s", dt.string)]),
                   [ChunkedArray([port_array(c) for c in jt.column(i).chunks])
                    for i in range(2)], 4)
    got = tpx.table_to_pyarrow(hb)
    got.validate(full=True)
    assert got.equals(want)
    assert [got.column(i).num_chunks for i in range(2)] == [2, 2]
    assert tpx.table_from_pyarrow(got).to_pydict() == jt.to_pydict()


def test_a_union_column_of_several_batches_stays_chunked():
    _, ha, t = case("dense_union")
    chunk = tpx.array_to_pyarrow(ha, t)
    src = pa.Table.from_arrays([pa.chunked_array([chunk, chunk.slice(5)])],
                               names=["u"])
    got = tpx.table_from_pyarrow(src)
    col = got.column("u")
    assert isinstance(col, ChunkedArray) and col.num_chunks == 2
    assert _exact(col.to_pylist()) == _exact(src.column(0).to_pylist())
    assert tpx.table_to_pyarrow(got).equals(src)


def test_an_empty_table_keeps_its_schema():
    src = pa.table({"a": pa.array([], pa.int32()),
                    "s": pa.array([], pa.string())})
    got = tpx.table_from_pyarrow(src)
    assert got.num_rows == 0
    assert got.schema == dt.Schema([dt.Field("a", dt.int32),
                                    dt.Field("s", dt.string)])
    assert tpx.table_to_pyarrow(got).equals(src)


# ---------------------------------------------------------------------------
# without pyarrow
# ---------------------------------------------------------------------------

def test_the_module_imports_without_pyarrow_and_its_first_call_raises():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pyarrow', 'jax',\n"
        "                                  'arrow_go_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import arrow_go_tpu_torch as agt\n"
        "from arrow_go_tpu_torch.interop import pyarrow_interop as px\n"
        "for call in (lambda: px.type_to_pyarrow(agt.int64),\n"
        "             lambda: px.array_to_pyarrow(agt.array([1, 2])),\n"
        "             lambda: px.table_to_pyarrow(agt.table({'a': [1]}))):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        print(e)\n"
        "print('pyarrow' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[:4] == ["pyarrow not available"] * 3 + [
        "False"]
