"""Nested parquet columns of the port against the JAX package, on the
CPU: the `levels` functions' definition and repetition levels bit for
bit, files of list, large_list, fixed_size_list, struct, map and struct
of list columns (nulls at every level, depth up to 3) written by the
JAX writer and read by the port, the port's files read by the JAX
reader, and a dataset with one nested column. Offsets, validity and
ints exactly, floats at rtol 1e-9 (torch_parity.same_array).
"""
import io

import numpy as np
import pytest

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
import arrow_go_tpu.parquet as jpq
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.array.arrays import make_array
from arrow_go_tpu.dataset import dataset as jdataset
from arrow_go_tpu.parquet import levels as jlv
from arrow_go_tpu.parquet import schema as jsch

import arrow_go_tpu_torch.compute as pc
import arrow_go_tpu_torch.parquet as tpq
from arrow_go_tpu_torch import dataset as tds
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.device.block import (HostArray, HostColumn,
                                             device_batch_to_host)
from arrow_go_tpu_torch.parquet import levels as tlv
from arrow_go_tpu_torch.parquet import reader as treader
from arrow_go_tpu_torch.parquet import schema as tsch
from test_torch_nested import TYPES, pair
from torch_parity import port_array, port_type, same_array

# the nested columns the JAX writer writes (a map or fixed_size_list
# only at the top level)
FILE_TYPES = ["list<int64>", "large_list<double>",
              "fixed_size_list<int32>[3]", "struct<a: int32, b: utf8>",
              "map<utf8, int64>", "struct of list", "list of struct",
              "list<list<int32>>", "struct<s: struct<a: list>>",
              "large_list<list<utf8>>", "list<list<list<int16>>>",
              "list<uint32> not null"]


def _read_back_type(jt):
    """The type a nested column reads back as: a fixed_size_list or
    large_list as a list (the JAX reader's schema)."""
    if jt.id in (jdt.TypeId.FIXED_SIZE_LIST, jdt.TypeId.LARGE_LIST):
        vf = jt.value_field
        return jdt.list_(jdt.Field("element", _read_back_type(vf.type),
                                   vf.nullable))
    if jt.id == jdt.TypeId.LIST:
        vf = jt.value_field
        return jdt.list_(jdt.Field("element", _read_back_type(vf.type),
                                   vf.nullable))
    if jt.id == jdt.TypeId.STRUCT:
        return jdt.struct([jdt.Field(f.name, _read_back_type(f.type),
                                     f.nullable) for f in jt.fields()])
    return jt


def _jax_file(columns: dict, row_group_size=None, **kw) -> bytes:
    buf = io.BytesIO()
    jpq.write_table(agt.table(columns), buf, row_group_size=row_group_size,
                    **kw)
    return buf.getvalue()


def _port_file(columns: dict, **kw) -> bytes:
    buf = io.BytesIO()
    tpq.write_table(columns, buf, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", FILE_TYPES)
def test_levels_match_jax_bit_for_bit(name):
    ja, a = pair(name, n=60, seed=6)
    jf_ = jdt.Field("c", ja.type)
    tf = tdt.Field("c", a.type)
    jt = ja.type
    if jt.id == jdt.TypeId.MAP:
        jf_ = jlv.map_storage_field(jdt.Field("c", jt))
        ja = make_array(jlv.map_storage_data(ja.data))
        tf, a = tlv.map_storage_field(tf), tlv.map_storage_data(a)
    elif jt.id == jdt.TypeId.FIXED_SIZE_LIST:
        jf_ = jlv.fsl_storage_field(jdt.Field("c", jt))
        ja = make_array(jlv.fsl_storage_data(ja.data))
        tf, a = tlv.fsl_storage_field(tf), tlv.fsl_storage_data(a)
    jpaths, tpaths = jlv.leaf_paths(jf_.type), tlv.leaf_paths(tf.type)
    assert jpaths == tpaths
    for path in jpaths:
        jarr, jfield = jlv.prune_to_leaf(ja, jf_, path)
        tarr, tfield = tlv.prune_to_leaf(a, tf, path)
        assert str(tfield.type) == str(jfield.type)
        assert str(tlv.prune_field(tf, path).type) == str(
            jlv.prune_field(jf_, path).type)
        jd, jr, jleaf = jlv.generate_levels_nested(jarr, jfield)
        td, tr, tleaf = tlv.generate_levels_nested(tarr, tfield)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tr, jr)
        same_array(tleaf, jleaf)
        # and back: the port's rebuild of the JAX levels and values
        want = jlv.rebuild_nested(jfield, jd, jr, jleaf)
        same_array(tlv.rebuild_nested(tfield, td, tr, tleaf),
                   make_array(want))


def test_flat_levels_match_jax():
    v = np.arange(10, dtype=np.int64)
    m = np.arange(10) % 3 > 0
    jd, jr, _ = jlv.generate_levels(agt.from_numpy(v, m), True)
    td, tr, _ = tlv.generate_levels(HostArray(v, m, tdt.int64), True)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("name", FILE_TYPES)
def test_schemas_convert_like_jax(name):
    jt = TYPES[name]
    jschema = jdt.Schema([jdt.Field("id", jdt.int64), jdt.Field("c", jt)])
    tschema = tdt.Schema([tdt.Field("id", tdt.int64),
                          tdt.Field("c", port_type(jt))])
    jel, jleaves = jsch.schema_to_elements(jschema)
    tel, tleaves = tsch.schema_to_elements(tschema)
    assert [(e.name, e.type, e.repetition_type, e.num_children,
             e.converted_type) for e in tel] == [
        (e.name, e.type, e.repetition_type, e.num_children,
         e.converted_type) for e in jel]
    assert [(d.path, d.max_def_level, d.max_rep_level) for d in tleaves] \
        == [(d.path, d.max_def_level, d.max_rep_level) for d in jleaves]
    js, _ = jsch.elements_to_schema(jel)
    ts, _ = tsch.elements_to_schema(tel)
    assert [str(f.type) for f in ts.fields] == [str(f.type)
                                                for f in js.fields]


@pytest.mark.parametrize("name", FILE_TYPES)
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_jax_written_nested_files_read_by_the_port(name, compression):
    ja, _ = pair(name, n=150, seed=7)
    rng = np.random.default_rng(3)
    ids = np.arange(150, dtype=np.int64)
    f = rng.standard_normal(150)
    blob = _jax_file({"id": agt.from_numpy(ids), "c": ja,
                      "f": agt.from_numpy(f)}, row_group_size=64,
                     compression=compression)
    jt = jpq.read_table(io.BytesIO(blob))
    pf = tpq.ParquetFile(blob)
    assert [str(fl.type) for fl in pf.schema.fields] == [
        str(fl.type) for fl in jt.schema.fields]
    for rg in range(pf.num_row_groups):
        lo = rg * 64
        want = ja.slice(lo, min(64, 150 - lo))
        got = treader.read_field_host(pf, rg, "c")
        jc = jt.column(1).chunks[rg]
        same_array(got, jc)
        # the JAX writer's quirk: a fixed_size_list column cut by a row
        # group keeps its validity at the slice's offset, so its later row
        # groups read back shifted, in the JAX reader as in the port's
        if not (rg and name.startswith("fixed_size_list")):
            assert got.to_pylist() == want.to_pylist() or "double" in name
        db = tpq.read_batch_device(pf, rg, device="cpu")
        assert isinstance(db.columns[1], HostColumn)
        same_array(db.columns[1].array, jc)
        hb = device_batch_to_host(db)
        assert hb.column("id").to_pylist() == ids[lo:lo + 64].tolist()
        np.testing.assert_allclose(hb.column("f").values, f[lo:lo + 64])


@pytest.mark.parametrize("name", FILE_TYPES)
def test_port_written_nested_files_read_by_jax(name):
    ja, a = pair(name, n=130, seed=8)
    ids = np.arange(130, dtype=np.int32)
    blob = _port_file({"id": ids, "c": a}, row_group_size=50,
                      compression="snappy")
    jt = jpq.read_table(io.BytesIO(blob))
    assert str(jt.schema.field(1).type) == str(_read_back_type(ja.type))
    assert jt.column(1).combine().to_pylist() == ja.to_pylist() or \
        "double" in name
    pf = tpq.ParquetFile(blob)
    for rg in range(pf.num_row_groups):
        same_array(treader.read_field_host(pf, rg, "c"),
                   jt.column(1).chunks[rg])
    assert jt.column(0).combine().to_pylist() == ids.tolist()


def test_both_writers_files_read_the_same():
    """A list<struct> column written uncompressed by the JAX writer (no
    dictionary) and by the port's writer reads back the same in the port
    and in the JAX reader."""
    ja, a = pair("list of struct", n=70, seed=9)
    jb = _jax_file({"c": ja}, compression="none", use_dictionary=False)
    tb = _port_file({"c": a})
    want = jpq.read_table(io.BytesIO(jb)).column(0).chunks[0]
    assert want.to_pylist() == ja.to_pylist()
    for blob in (jb, tb):
        same_array(treader.read_field_host(tpq.ParquetFile(blob), 0, "c"),
                   want)
        same_array(port_array(jpq.read_table(io.BytesIO(blob)).column(
            0).chunks[0]), want)


def test_a_dataset_with_a_nested_column(tmp_path):
    rng = np.random.default_rng(4)
    parts = []
    for i in range(3):
        ja, a = pair("list<int64>", n=100, seed=20 + i)
        k = rng.integers(0, 10, 100).astype(np.int64)
        buf = _port_file({"k": k, "c": a}, row_group_size=40)
        (tmp_path / f"part-{i}.parquet").write_bytes(buf)
        parts.append((k, ja))
    ds = tds.dataset(str(tmp_path))
    assert str(ds.schema.field(1).type) == "list<element: int64>"
    table = ds.to_table(device="cpu")
    want = sum((ja.to_pylist() for _, ja in parts), [])
    assert table.column("c").to_pylist() == want
    expr = pc.call("less", [pc.field("k"), pc.literal(4)])
    got = ds.scanner(filter=expr, device="cpu").to_table()
    jds = jdataset(str(tmp_path))
    jexpr_ = jpc.call("less", [jpc.field("k"), jpc.literal(4)])
    jt = jds.to_table(filter=jexpr_)
    for i in range(2):
        same_array(got.column(i).combine(), jt.column(i).combine())
    keep = np.concatenate([k for k, _ in parts]) < 4
    assert got.column("c").to_pylist() == [
        v for v, kk in zip(want, keep) if kk]
    assert got.column("k").to_pylist() == [
        int(x) for x in np.concatenate([k for k, _ in parts])[keep]]
    assert ds.count_rows(filter=expr, device="cpu") == int(keep.sum())


def test_a_dataset_with_no_rows_keeps_the_nested_schema(tmp_path):
    ja, a = pair("struct of list", n=30)
    (tmp_path / "p.parquet").write_bytes(_port_file({
        "k": np.arange(30, dtype=np.int64), "c": a}))
    got = tds.dataset(str(tmp_path)).to_table(
        filter=pc.call("less", [pc.field("k"), pc.literal(0)]),
        device="cpu")
    assert got.num_rows == 0 and len(got.column("c")) == 0
    assert str(got.schema.field(1).type) == str(_read_back_type(ja.type))
