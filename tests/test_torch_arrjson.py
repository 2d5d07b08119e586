"""The port's Arrow integration JSON (arrow_go_tpu_torch/interop/
arrjson.py) against the JAX package's: for tests/fixtures'
canonical_batches, the families of tests/test_arrjson.py and every type
case of tests/test_torch_ipc.py (with nulls, whole and sliced), the
port's text is the JAX writer's, byte for byte; the port reads the JAX
text into the same table (torch_parity.same_table / same_array) and the
JAX reader reads the port's text into the same values. Then several
batches, nested and integer dictionaries, the file sinks and sources,
and the malformed inputs by exception class."""
import io
import json

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.array.record import RecordBatch
from arrow_go_tpu.compute.errors import ArrowInvalid as JArrowInvalid
from arrow_go_tpu.compute.errors import \
    ArrowNotImplemented as JArrowNotImplemented
from arrow_go_tpu.interop import arrjson as jaj

from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute.errors import (ArrowInvalid,
                                               ArrowNotImplemented)
from arrow_go_tpu_torch.device.block import HostArray, HostBatch
from arrow_go_tpu_torch.interop import arrjson as taj
from fixtures import canonical_batches
from test_torch_ipc import CASES, SLICES, _both, _same
from torch_parity import port_record_batch, same_table

EXTENSIONS = {"bool8", "uuid", "json", "variant"}
# the JAX writer compacts a slice through its builders, which it lacks
# for unions (arrow_go_tpu/interop/arrjson.py:233-236)
JAX_CANNOT_WRITE_SLICED = {"sparse_union", "dense_union"}


def _jax_same(got: RecordBatch, want: RecordBatch, what: str) -> None:
    assert got.schema.names == want.schema.names, what
    assert got.num_rows == want.num_rows, what
    for i in range(want.num_columns):
        g, w = got.column(i), want.column(i)
        assert str(g.type) == str(w.type), (what, i)
        assert json.dumps(g.to_pylist(), default=repr) == \
            json.dumps(w.to_pylist(), default=repr), (what, i)


@pytest.mark.parametrize("family", ["primitives", "binary", "temporal",
                                    "decimal", "nested", "dictionary"])
def test_canonical_families_both_ways(family):
    rb = canonical_batches()[family]
    pb = port_record_batch(rb)
    jtext, ttext = jaj.write_arrjson([rb]), taj.write_arrjson([pb])
    assert ttext == jtext
    got = taj.read_arrjson(jtext)
    assert len(got) == 1
    same_table(got[0], rb, family)
    _jax_same(jaj.read_arrjson(ttext)[0], rb, family)


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", CASES)
def test_text_is_the_jax_writers(name, lo, n):
    jb, pb = _both(name, lo, n)
    if name in EXTENSIONS:
        # neither writer has an extension type in the JSON format
        with pytest.raises(ArrowNotImplemented):
            taj.write_arrjson([pb])
        with pytest.raises(JArrowNotImplemented):
            jaj.write_arrjson([jb])
        return
    ttext = taj.write_arrjson([pb])
    if lo and name in JAX_CANNOT_WRITE_SLICED:
        # a recorded deviation: the port writes such a slice, the JAX
        # writer raises; both readers read the port's text
        with pytest.raises(NotImplementedError):
            jaj.write_arrjson([jb])
        assert taj.read_arrjson(ttext)[0].columns[0].to_pylist() == \
            jb.column(0).to_pylist()
        _jax_same(jaj.read_arrjson(ttext)[0], jb, name)
        return
    assert ttext == jaj.write_arrjson([jb])


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", [c for c in CASES if c not in EXTENSIONS])
def test_each_package_reads_the_others_text(name, lo, n):
    jb, pb = _both(name, lo, n)
    ttext = taj.write_arrjson([pb])
    _jax_same(jaj.read_arrjson(ttext)[0], jb, name)
    if lo and name in JAX_CANNOT_WRITE_SLICED:
        return
    got = taj.read_arrjson(jaj.write_arrjson([jb]))[0]
    assert got.num_rows == n and got.schema == pb.schema
    _same(got.columns[0], jb.column(0), name)
    np.testing.assert_array_equal(got.columns[1].values, pb.columns[1].values)


def test_several_batches_and_a_dictionary_of_the_first():
    """The dictionaries section holds the first batch's values (as in
    the JAX writer); each batch keeps its rows."""
    jt = jdt.dictionary(jdt.int8, jdt.string)
    rbs = [agt.record_batch({
        "d": agt.array(v, jt), "x": agt.array(x, jdt.uint64)})
        for v, x in ((["a", "b", None, "a"], [0, 2 ** 64 - 1, None, 5]),
                     (["a", "b", "b", None], [1, 2, 3, 2 ** 63]))]
    pbs = [port_record_batch(rb) for rb in rbs]
    jtext, ttext = jaj.write_arrjson(rbs), taj.write_arrjson(pbs)
    assert ttext == jtext
    doc = json.loads(ttext)
    assert doc["batches"][0]["columns"][1]["DATA"][1] == str(2 ** 64 - 1)
    assert [d["id"] for d in doc["dictionaries"]] == [0]
    got = taj.read_arrjson(jtext)
    assert len(got) == 2
    for g, rb in zip(got, rbs):
        same_table(g, rb)


def test_integer_dictionary_and_dictionaries_section_shape():
    rb = canonical_batches()["dictionary"]
    doc = json.loads(taj.write_arrjson([port_record_batch(rb)]))
    assert [d["id"] for d in doc["dictionaries"]] == [0, 1]
    fj = doc["schema"]["fields"][1]
    assert fj["dictionary"] == {"id": 1, "indexType": {
        "name": "int", "bitWidth": 16, "isSigned": True}, "isOrdered": False}
    assert doc["dictionaries"][1]["data"]["columns"][0]["DATA"] == \
        ["7", "9"]
    assert all(isinstance(v, int)
               for v in doc["batches"][0]["columns"][0]["DATA"])


def test_nested_dictionary_from_pyarrow():
    """list<dictionary<string>>: the nested id resolves in both readers
    (tests/test_arrjson.py's case, its JAX array from pyarrow)."""
    pa = pytest.importorskip("pyarrow")
    from arrow_go_tpu.interop.pyarrow_interop import array_from_pyarrow
    pdict = pa.array(["a", "b", "a", None, "b"]).dictionary_encode()
    parr = pa.ListArray.from_arrays(pa.array([0, 2, 2, 5], pa.int32()),
                                    pdict)
    ours = array_from_pyarrow(parr)
    rb = RecordBatch(jdt.Schema([jdt.Field("ld", ours.type, True)]),
                     [ours], len(ours))
    jtext = jaj.write_arrjson([rb])
    got = taj.read_arrjson(jtext)[0]
    assert got.columns[0].to_pylist() == parr.to_pylist()
    assert taj.write_arrjson([got]) == jtext


def test_sinks_and_sources(tmp_path):
    rb = canonical_batches()["primitives"]
    pb = port_record_batch(rb)
    path = str(tmp_path / "p.json")
    text = taj.write_arrjson([pb], path)
    buf = io.StringIO()
    assert taj.write_arrjson([pb], buf) == text
    assert buf.getvalue() == text == open(path).read()
    for source in (text, text.encode(), path, open(path)):
        same_table(taj.read_arrjson(source)[0], rb)
    assert taj.read_arrjson(jaj.write_arrjson([])) == []
    assert taj.write_arrjson([]) == jaj.write_arrjson([])


def _doc(field_type: dict, column: dict, dictionaries=None) -> str:
    doc = {"schema": {"fields": [{"name": "c", "type": field_type,
                                  "nullable": True, "children": []}]},
           "batches": [{"count": column["count"], "columns": [column]}]}
    if dictionaries is not None:
        doc["schema"]["fields"][0]["dictionary"] = {
            "id": 3, "indexType": {"name": "int", "bitWidth": 32,
                                   "isSigned": True}, "isOrdered": False}
        doc["dictionaries"] = dictionaries
    return json.dumps(doc)


@pytest.mark.parametrize("text,port_exc,jax_exc", [
    (_doc({"name": "utf8"}, {"name": "c", "count": 1, "VALIDITY": [1],
                             "DATA": [3]}, dictionaries=[]),
     ArrowInvalid, JArrowInvalid),                   # no dictionary id 3
    (_doc({"name": "utf8"}, {"name": "c", "count": 0, "VALIDITY": [],
                             "DATA": []}, dictionaries=[
        {"id": 9, "data": {"count": 0, "columns": []}}]),
     ArrowInvalid, JArrowInvalid),                   # an unknown id
    (_doc({"name": "float8"}, {"name": "c", "count": 0}),
     ArrowNotImplemented, JArrowNotImplemented),     # an unknown type
], ids=["missing-dictionary", "unknown-dictionary-id", "unknown-type"])
def test_malformed_inputs_raise_the_same_classes(text, port_exc, jax_exc):
    with pytest.raises(port_exc):
        taj.read_arrjson(text)
    with pytest.raises(jax_exc):
        jaj.read_arrjson(text)


def test_a_coded_string_column_reads_back_as_the_ports():
    """A string column is written from the port's codes (any dictionary
    order) and read back as codes in first-occurrence order."""
    arr = HostArray(np.array([2, 0, 1, 2, 0], np.int32),
                    np.array([True, True, False, True, True]),
                    dt.dictionary(dt.int32, dt.string),
                    np.array(["z", "y", "x"], dtype=object))
    pb = HostBatch(dt.Schema([dt.Field("s", dt.string)]), [arr], 5)
    got = taj.read_arrjson(taj.write_arrjson([pb]))[0].columns[0]
    assert got.to_pylist() == ["x", "z", None, "x", "z"]
    assert list(got.dict_values) == ["x", "z"]
    assert got.values.tolist()[:2] == [0, 1]


# -- the slice as a whole: chip_smoke.py's arrjson_orders on the CPU ---------

def test_chip_smoke_arrjson_orders_matches_jax():
    """20,000 orders (o_opri a dictionary field) through chip_smoke.py's
    own functions (arrjson_orders_batch, write_arrjson, arrjson_orders):
    the text is the JAX writer's for the JAX reader's batch of it, the
    port's read equals the JAX read, and the filter and sum equal numpy
    and the JAX functions over the JAX read."""
    import chip_smoke as cs
    import arrow_go_tpu.compute as jpc
    from arrow_go_tpu.compute.functions import agg_sum as jax_agg_sum
    from arrow_go_tpu.device.block import batch_to_device as jax_to_device
    from test_torch_dataset import _jproject
    n = 20_000
    li, orders = cs.make_data(4 * n, n)
    cs.add_join_columns(li, orders)
    hb = cs.arrjson_orders_batch(orders, n)
    text = taj.write_arrjson([hb])
    jrb = jaj.read_arrjson(text)[0]
    assert jaj.write_arrjson([jrb]) == text
    times = {}
    got_hb, _, got = cs.arrjson_orders(text, "cpu", times)
    same_table(got_hb, jrb)
    keep = orders["o_odate"][:n] < cs.JSON_ODATE_MAX
    assert got == {"sum": int(orders["o_custkey"][:n][keep].sum()),
                   "count": int(keep.sum())}
    jdb = jax_to_device(jrb)
    kept = jpc.filter(_jproject(jdb, ["o_custkey"]), jpc.call_function(
        "less", [jdb.column("o_odate"), cs.JSON_ODATE_MAX]))
    assert got == {"sum": int(jax_agg_sum(kept.column("o_custkey"))),
                   "count": kept.length}
