"""The port's dataset scan (arrow_go_tpu_torch/dataset.py) against the JAX
package's Dataset on the same directories: discovery, projection, the
residual filter, row-group pruning by statistics and bloom filters, the
device batches, the refusals (columns the device read cannot take,
fragments of other types), .arrow and .csv fragments beside parquet
ones, and TPC-H Q6 and Q10 over a small zstd dataset of many files and
row groups (Q6 also over its lz4 .arrow and its .csv twins) against the
same composition of JAX functions
(K3 as the JAX package runs it on the CPU: the Pallas kernel in
interpret mode). Every port call passes device="cpu"."""
import os

import numpy as np
import pytest

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.compute.functions import agg_sum as jax_agg_sum
from arrow_go_tpu.dataset import dataset as jdataset
from arrow_go_tpu.device.block import DeviceBatch as JaxDeviceBatch
from arrow_go_tpu.device.block import batch_to_device as jax_batch_to_device

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import ipc
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu.compute.errors import ArrowInvalid as jArrowInvalid
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.compute.errors import ArrowInvalid as tArrowInvalid
from arrow_go_tpu_torch.dataset import _simple_guards, dataset
from chip_smoke import (Q4_ODATE_HI, Q4_ODATE_LO, Q6_COLUMNS, Q6_DATE_HI,
                        Q6_DATE_LO, Q6_DISC_HI, Q6_DISC_LO, Q6_QTY, Q10_TOP,
                        add_join_columns, add_q1_columns, add_quantity,
                        check_q6, check_q10, check_string_pages,
                        customer_table, dataset_lookup, dataset_q6,
                        dataset_q10, dataset_tables, make_data,
                        q6_expression, q6_oracle, q10_oracle,
                        write_dataset, STRING_ENCODINGS)
from torch_parity import port_type

CPU = "cpu"


@pytest.fixture(scope="module")
def pq_dir(tmp_path_factory):
    """tests/test_dataset.py's directory: three JAX-written files of two
    row groups each, bloom filters on."""
    d = tmp_path_factory.mktemp("ds")
    for i in range(3):
        t = agt.table({"id": list(range(i * 100, (i + 1) * 100)),
                       "cat": [f"c{j % 4}" for j in range(100)],
                       "v": [float(j) for j in range(100)]})
        jpq.write_table(t, str(d / f"part{i}.parquet"), row_group_size=50,
                        write_bloom_filters=True)
    return str(d)


def _expr(m, op, col, value):
    return m.call(op, [m.field(col), m.literal(value)])


def _both(m_op, col, value):
    return _expr(jpc, m_op, col, value), _expr(pc, m_op, col, value)


def _same_table(got, want) -> None:
    """A port HostBatch and a JAX Table hold the same rows."""
    assert got.schema.names == want.schema.names
    assert got.num_rows == want.num_rows
    assert got.to_pydict() == want.to_pydict()


def test_dataset_discovery(pq_dir):
    ds, jds = dataset(pq_dir), jdataset(pq_dir)
    assert [f.path for f in ds.fragments] == [f.path for f in jds.fragments]
    assert ds.schema.names == jds.schema.names == ["id", "cat", "v"]
    _same_table(ds.to_table(device=CPU), jds.to_table())
    assert ds.count_rows(device=CPU) == 300


@pytest.mark.parametrize("op,value", [("greater_equal", 250), ("less", 50),
                                      ("equal", 142), ("greater", 10 ** 6),
                                      ("less_equal", -1)])
def test_dataset_filter_pushdown(pq_dir, op, value):
    jf, tf = _both(op, "id", value)
    _same_table(dataset(pq_dir).to_table(filter=tf, device=CPU),
                jdataset(pq_dir).to_table(filter=jf))


def test_dataset_projection_and_residual_filter(pq_dir):
    jf, tf = _both("equal", "id", 42)
    t = dataset(pq_dir).to_table(columns=["cat"], filter=tf, device=CPU)
    assert t.to_pydict() == {"cat": ["c2"]}
    _same_table(t, jdataset(pq_dir).to_table(columns=["cat"], filter=jf))


def test_dataset_string_filter(pq_dir):
    j = jpc.call("and", [_expr(jpc, "equal", "cat", "c1"),
                         _expr(jpc, "less", "id", 100)])
    t = pc.call("and", [_expr(pc, "equal", "cat", "c1"),
                        _expr(pc, "less", "id", 100)])
    assert dataset(pq_dir).count_rows(filter=t, device=CPU) == \
        jdataset(pq_dir).count_rows(filter=j) == 25


def test_dataset_empty_result(pq_dir):
    t = dataset(pq_dir).to_table(filter=_expr(pc, "greater", "id", 10 ** 6),
                                 device=CPU)
    assert t.num_rows == 0
    assert t.schema.names == ["id", "cat", "v"]
    t = dataset(pq_dir).to_table(columns=["v", "cat"], filter=_expr(
        pc, "greater", "id", 10 ** 6), device=CPU)
    assert t.schema.names == ["cat", "v"]       # schema order, as JAX's


def test_dataset_mixed_glob_arrow_and_csv_fragments(pq_dir, tmp_path):
    """A .parquet, an .arrow (an IPC file of the JAX writer) and a .csv
    fragment read as the JAX Dataset reads them, each alone and mixed;
    `format` reads any path as the format it names."""
    from arrow_go_tpu import ipc
    t = agt.table({"id": [999, 1000], "cat": ["x", "c1"], "v": [0.0, 2.5]})
    p = tmp_path / "extra.arrow"
    with open(p, "wb") as f:
        with ipc.new_file(f, t.schema) as w:
            w.write_table(t)
    q = tmp_path / "extra.csv"
    q.write_text("id,cat,v\n1,a,0.5\n7,c1,1.5\n")
    part0 = os.path.join(pq_dir, "part0.parquet")
    for paths, kinds, rows in (
            ([part0, str(p)], ["ParquetFragment", "IpcFragment"], 102),
            ([part0, str(p), str(q)], ["ParquetFragment", "IpcFragment",
                                       "CsvFragment"], 104),
            ([str(q), part0], ["CsvFragment", "ParquetFragment"], 102),
            ([str(q)], ["CsvFragment"], 2)):
        jds, ds = jdataset(paths), dataset(paths)
        assert [type(f).__name__ for f in ds.fragments] == \
            [type(f).__name__ for f in jds.fragments] == kinds
        assert ds.schema == tdt.Schema([tdt.Field(f.name, port_type(
            f.type)) for f in jds.schema.fields])
        assert jds.to_table().num_rows == rows
        _same_table(ds.to_table(device=CPU), jds.to_table())
        jf, tf = _both("greater_equal", "id", 7)
        _same_table(ds.to_table(filter=tf, device=CPU),
                    jds.to_table(filter=jf))
        jf, tf = _both("equal", "cat", "c1")
        _same_table(ds.to_table(columns=["v"], filter=tf, device=CPU),
                    jds.to_table(columns=["v"], filter=jf))
        assert ds.count_rows(device=CPU) == jds.count_rows() == rows
    assert dataset([part0, str(p)]).scanner().row_groups()[1] == (
        str(p), [0], 1)
    # format= reads any path as the format it names, as in the JAX package
    assert dataset([str(p)], format="feather").count_rows(device=CPU) == 2
    r = tmp_path / "extra.txt"
    r.write_bytes(q.read_bytes())
    _same_table(dataset([str(r)], format="csv").to_table(device=CPU),
                jdataset([str(r)], format="csv").to_table())
    _same_table(dataset(str(tmp_path / "*.csv")).to_table(device=CPU),
                jdataset(str(tmp_path / "*.csv")).to_table())
    with pytest.raises(tArrowInvalid):
        dataset([str(r)])
    with pytest.raises(jArrowInvalid):
        jdataset([str(r)])


def test_csv_directory_matches_jax(tmp_path):
    """A directory of .csv files written by the JAX writer (types inferred
    file by file, nulls, strings): discovery, projection, the filter,
    counts and the device batches with their parse / copy split."""
    from arrow_go_tpu.formats import write_csv as jwrite_csv
    for i in range(3):
        t = agt.table({"id": list(range(i * 10, i * 10 + 10)),
                       "cat": [f"c{j % 3}" for j in range(10)],
                       "v": [None if j == 4 else j * 0.5 for j in range(10)],
                       "d": [f"2020-01-{j + 1:02d}" for j in range(10)]})
        jwrite_csv(t, str(tmp_path / f"part{i}.csv"))
    ds, jds = dataset(str(tmp_path)), jdataset(str(tmp_path))
    assert [f.path for f in ds.fragments] == [f.path for f in jds.fragments]
    assert ds.schema.field(3).type == tdt.date32
    _same_table(ds.to_table(device=CPU), jds.to_table())
    for op, col, value in (("greater", "id", 14), ("equal", "cat", "c1"),
                           ("less", "v", 2.0)):
        jf, tf = _both(op, col, value)
        _same_table(ds.to_table(filter=tf, device=CPU),
                    jds.to_table(filter=jf))
        _same_table(ds.to_table(columns=["cat"], filter=tf, device=CPU),
                    jds.to_table(columns=["cat"], filter=jf))
        assert ds.count_rows(filter=tf, device=CPU) == \
            jds.count_rows(filter=jf)
    times = {}
    dbs = list(ds.scanner(columns=["id", "v"]).device_batches(
        device=CPU, times=times))
    jbs = list(jds.scanner(columns=["id", "v"]).device_batches())
    assert [d.length for d in dbs] == [j.length for j in jbs] == [10] * 3
    assert times["parse_s"] > 0 and times["h2d_s"] > 0
    assert ds.scanner().row_groups()[0] == (ds.fragments[0].path, [0], 1)


def test_csv_fragments_of_other_types_raise_like_jax(tmp_path):
    """Each csv fragment infers its own types and the dataset's schema is
    the first's; a fragment whose kept rows have other types makes the
    table refuse its batches in both packages, while the batches
    themselves come through with their own types."""
    (tmp_path / "a.csv").write_text("id,v,s\n1,5,a\n2,6,b\n")
    (tmp_path / "b.csv").write_text("id,v,s\n3,1.5,c\n4,,d\n")
    ds, jds = dataset(str(tmp_path)), jdataset(str(tmp_path))
    assert ds.schema.field(1).type == tdt.int64 == port_type(
        jds.schema.field(1).type)
    got = list(ds.scanner(device=CPU).batches())
    want = list(jds.scanner().batches())
    assert [b.schema.field(1).type for b in got] == [tdt.int64, tdt.float64]
    for g, w in zip(got, want):
        _same_table(g, w)
    with pytest.raises(ValueError):
        jds.to_table()
    with pytest.raises(tArrowInvalid):
        ds.to_table(device=CPU)
    with pytest.raises(ValueError):
        jds.count_rows()
    with pytest.raises(tArrowInvalid):
        ds.count_rows(device=CPU)
    # a filter that keeps rows of one fragment only reads as one table
    jf, tf = _both("less", "id", 3)
    _same_table(ds.to_table(filter=tf, device=CPU), jds.to_table(filter=jf))
    assert ds.count_rows(filter=tf, device=CPU) == jds.count_rows(
        filter=jf) == 2


def test_dataset_device_batches(pq_dir):
    from arrow_go_tpu.device.block import batch_from_device
    jbs = list(jdataset(pq_dir).scanner(columns=["id", "v"]
                                        ).device_batches())
    tbs = list(dataset(pq_dir).scanner(columns=["id", "v"]
                                       ).device_batches(device=CPU))
    assert len(tbs) == len(jbs) == 6
    for tb, jb in zip(tbs, jbs):
        assert tb.schema.names == ["id", "v"] and tb.length == jb.length
        rb = batch_from_device(jb)
        for name in ("id", "v"):
            assert tb.column(name).values[:tb.length].tolist() == \
                rb.column(name).to_pylist()
    got = []
    for db in dataset(pq_dir).scanner().device_batches(device=CPU):
        c = db.column("cat")
        got.extend(c.dict_values[c.values[:db.length].numpy()].tolist())
    assert got[:4] == ["c0", "c1", "c2", "c3"] and len(got) == 300


def test_nested_column_raises_where_jax_reads_on_the_host(tmp_path):
    t = agt.table({"id": agt.array(list(range(6)), jdt.int64),
                   "tags": agt.array([[1, 2], None, [], [3], [4, 5, 6], [7]],
                                     jdt.list_(jdt.int64))})
    p = tmp_path / "nested.parquet"
    jpq.write_table(t, str(p))
    assert sum(db.length for db in jdataset(str(p)).scanner(
        ).device_batches()) == 6
    # the port reads the nested column on the host too (a HostColumn), so
    # the dataset no longer raises
    got = dataset(str(p)).to_table(device=CPU)
    assert got.column("tags").to_pylist() == \
        jdataset(str(p)).to_table().column("tags").combine().to_pylist()
    assert got.column("id").to_pylist() == list(range(6))


GUARD_CASES = [
    ("and", [("greater_equal", "id", 120), ("less", "id", 180)]),
    ("and", [("equal", "cat", "c3"), ("greater", "v", 98.5)]),
    ("and", [("equal", "cat", "zz"), ("less_equal", "id", 299)]),
    ("and", [("less", "v", 0.0), ("equal", "id", 7)]),
]


@pytest.mark.parametrize("case", range(len(GUARD_CASES)))
def test_guards_and_kept_row_groups_match_jax(pq_dir, case):
    from arrow_go_tpu.dataset import _simple_guards as jax_guards
    how, parts = GUARD_CASES[case]
    jx = [_expr(jpc, *p) for p in parts]
    tx = [_expr(pc, *p) for p in parts]
    je, te = jpc.call(how, jx), pc.call(how, tx)
    # a literal on the left flips the operator
    te = pc.call(how, [te, pc.call("greater", [pc.literal(1000),
                                               pc.field("id")])])
    je = jpc.call(how, [je, jpc.call("greater", [jpc.literal(1000),
                                                 jpc.field("id")])])
    assert _simple_guards(te) == jax_guards(je)
    got = dataset(pq_dir).scanner(filter=te).row_groups()
    for (path, kept, total), frag in zip(got, jdataset(pq_dir).fragments):
        pf = jpq.ParquetFile(frag.path)
        assert path == frag.path and total == pf.num_row_groups
        assert kept == [i for i in range(total) if pf._row_group_may_match(
            i, jax_guards(je))]
    _same_table(dataset(pq_dir).to_table(filter=te, device=CPU),
                jdataset(pq_dir).to_table(filter=je))


# ---------------------------------------------------------------------------
# TPC-H Q6 and Q10 over a small zstd dataset
# ---------------------------------------------------------------------------

ROWS, ROWS_PER_GROUP = 200_000, 16_384


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    """chip_smoke.py's dataset at 200,000 lineitem rows in row groups of
    16,384, the customers' dictionary limit low enough that c_name falls
    back to PLAIN as it does at SF10."""
    li, orders = make_data(ROWS, ROWS // 4)
    add_quantity(li)
    add_q1_columns(li)
    add_join_columns(li, orders)
    lis, ords, cus = dataset_tables(li, orders,
                                    customer_table(len(orders["o_okey"])))
    root = str(tmp_path_factory.mktemp("tpch"))
    write_dataset(root, lis, ords, cus, rows_per_group=ROWS_PER_GROUP,
                  dict_limit=4096)
    return li, orders, cus, root


def _jax_q6_expression():
    f, lit, call = jpc.field, jpc.literal, jpc.call
    pred = None
    for c in (call("greater_equal", [f("l_sdate"), lit(Q6_DATE_LO)]),
              call("less", [f("l_sdate"), lit(Q6_DATE_HI)]),
              call("greater_equal", [f("l_disc"), lit(Q6_DISC_LO)]),
              call("less_equal", [f("l_disc"), lit(Q6_DISC_HI)]),
              call("less", [f("l_qty"), lit(Q6_QTY)])):
        pred = c if pred is None else call("and", [pred, c])
    return pred


def _jproject(db, names):
    return JaxDeviceBatch(jdt.Schema([db.schema.field(
        db.schema.field_index(n)) for n in names]),
        [db.column(n) for n in names], db.length)


def _jax_dataset_q6(root, pruned=True, table="lineitem"):
    """Q6 composed of the JAX package's Scanner and functions, as
    chip_smoke.dataset_q6 composes the port's."""
    pred = _jax_q6_expression()
    sc = jdataset(os.path.join(root, table)).scanner(
        columns=Q6_COLUMNS, filter=pred if pruned else None)
    revenue, count, batches = 0.0, 0, 0
    for db in sc.device_batches():
        batches += 1
        li_f = jpc.filter(_jproject(db, ["l_price", "l_disc"]),
                          jpc.execute_scalar_expression(pred, db))
        rev = jpc.execute_scalar_expression(jpc.call("multiply", [
            jpc.field("l_price"), jpc.field("l_disc")]), li_f)
        if li_f.length:
            revenue += jax_agg_sum(rev)
        count += li_f.length
    return {"revenue": revenue, "count": count}, batches


@pytest.mark.parametrize("pruned", [True, False])
def test_dataset_q6_matches_jax_and_oracle(tpch, pruned):
    li, _, _, root = tpch
    ds = dataset(os.path.join(root, "lineitem"))
    times = {}
    got = dataset_q6(ds, CPU, times, pruned=pruned)
    want, batches = _jax_dataset_q6(root, pruned)
    check_q6(got, q6_oracle(li))
    assert got["count"] == want["count"]
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-9)
    rgs = ds.scanner(filter=q6_expression() if pruned else None
                     ).row_groups()
    total = sum(n for *_, n in rgs)
    assert total == 16
    # the JAX scanner keeps the same row groups: one batch each
    assert sum(len(k) for _, k, _ in rgs) == batches
    assert (batches < total) == pruned
    assert times["decompress_s"] > 0 and times["parse_s"] > 0


@pytest.mark.parametrize("compression", ["lz4", None, "zstd"])
def test_ipc_dataset_q6_matches_jax_and_parquet(tpch, compression,
                                                monkeypatch):
    """Q6 over the sorted lineitem as .arrow fragments (chip_smoke's
    write_ipc_dataset: the parquet dataset's files, in record batches of
    its row-group size) against the JAX scanner over the same files (one
    batch a file in both), and against the port's Q6 over the parquet
    dataset."""
    import chip_smoke
    li, _, _, root = tpch
    monkeypatch.setattr(chip_smoke, "DATASET_ROWS_PER_GROUP", ROWS_PER_GROUP)
    order = np.argsort(li["l_sdate"], kind="stable")
    lis = {c: li[c][order] for c in Q6_COLUMNS + ["l_okey"]}
    sub = f"arrow_{compression}"
    paths = chip_smoke.write_ipc_dataset(os.path.join(root, sub), lis,
                                         compression)
    assert len(paths) == 8
    ds = dataset(os.path.join(root, sub))
    assert {type(f).__name__ for f in ds.fragments} == {"IpcFragment"}
    times = {}
    got = chip_smoke.ipc_dataset_q6(ds, CPU, times)
    check_q6(got, q6_oracle(li))
    want, batches = _jax_dataset_q6(root, True, sub)
    assert got["count"] == want["count"]
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-9)
    assert batches == 8 == sum(n for *_, n in ds.scanner().row_groups())
    assert sum(ipc.open_file(p).num_record_batches for p in paths) == 16
    pq = dataset_q6(dataset(os.path.join(root, "lineitem")), CPU)
    assert got["count"] == pq["count"]
    np.testing.assert_allclose(got["revenue"], pq["revenue"], rtol=1e-9)
    assert times["parse_s"] > 0 and times["h2d_s"] > 0


def test_csv_dataset_q6_matches_jax_and_parquet(tpch):
    """Q6 over the sorted lineitem's Q6 columns as 8 .csv fragments
    (chip_smoke's write_csv_dataset) through the port's scanner, as
    chip_smoke.formats_phases runs it, against the JAX scanner over the
    same files (one batch a file in both) and the parquet dataset."""
    import chip_smoke
    li, _, _, root = tpch
    order = np.argsort(li["l_sdate"], kind="stable")
    lis = {c: li[c][order] for c in Q6_COLUMNS}
    sub = "csv"
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    paths = chip_smoke.write_csv_dataset(os.path.join(root, sub), lis,
                                         Q6_COLUMNS)
    assert len(paths) == 8
    ds = dataset(os.path.join(root, sub))
    assert {type(f).__name__ for f in ds.fragments} == {"CsvFragment"}
    times = {}
    got = dataset_q6(ds, CPU, times)
    check_q6(got, q6_oracle(li))
    want, batches = _jax_dataset_q6(root, True, sub)
    assert got["count"] == want["count"] and batches == 8
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-9)
    pq = dataset_q6(dataset(os.path.join(root, "lineitem")), CPU)
    assert got["count"] == pq["count"]
    np.testing.assert_allclose(got["revenue"], pq["revenue"], rtol=1e-9)
    assert times["parse_s"] > 0 and times["h2d_s"] > 0


def _jax_dataset_q10(root):
    """Q10 composed of the JAX package's Scanner and functions, as
    chip_smoke.dataset_q10 composes the port's."""
    f, lit, call = jpc.field, jpc.literal, jpc.call
    window = call("and", [call("greater_equal", [f("o_odate"),
                                                 lit(Q4_ODATE_LO)]),
                          call("less", [f("o_odate"), lit(Q4_ODATE_HI)])])
    orders = jdataset(os.path.join(root, "orders")).to_table(
        columns=["o_okey", "o_custkey"], filter=window)
    ord_db = jax_batch_to_device(orders.combine_chunks().to_batches()[0]
                                 if hasattr(orders, "combine_chunks")
                                 else orders.to_batches()[0])
    returned = call("equal", [f("l_rflag"), lit("R")])
    keys, sums = [], []
    for db in jdataset(os.path.join(root, "lineitem")).scanner(
            columns=["l_okey", "l_price", "l_disc", "l_rflag"],
            filter=returned).device_batches():
        li_f = jpc.filter(_jproject(db, ["l_okey", "l_price", "l_disc"]),
                          jpc.execute_scalar_expression(returned, db))
        if not li_f.length:
            continue
        j = jpc.hash_join(li_f, ord_db, left_keys=["l_okey"],
                          right_keys=["o_okey"],
                          output_columns=["l_price", "l_disc", "o_custkey"])
        rev = jpc.execute_scalar_expression(call("multiply", [
            f("l_price"), call("subtract", [lit(1.0), f("l_disc")])]), j)
        g = jpc.group_by(JaxDeviceBatch(
            jdt.Schema([jdt.Field("o_custkey", jdt.int64),
                        jdt.Field("rev", jdt.float64)]),
            [j.column("o_custkey"), rev], j.length), "o_custkey",
            [("rev", "sum")])
        keys += g.column("o_custkey").to_pylist()
        sums += g.column("rev_sum").to_pylist()
    both = jax_batch_to_device(agt.record_batch({
        "o_custkey": agt.from_numpy(np.array(keys, np.int64)),
        "rev": agt.from_numpy(np.array(sums))}))
    g = jpc.group_by(both, "o_custkey", [("rev", "sum")])
    g = jpc.take(g, jpc.sort_indices(g, jpc.SortOptions(
        keys=[jpc.SortKey("rev_sum", "descending")])))
    top = g.column("o_custkey").to_pylist()[:Q10_TOP]
    names = jdataset(os.path.join(root, "customer_plain")).to_table(
        columns=["c_custkey", "c_name"],
        filter=call("is_in", [f("c_custkey")], {"value_set": top}))
    name_of = dict(zip(names.column("c_custkey").to_pylist(),
                       names.column("c_name").to_pylist()))
    return {"c_custkey": top, "c_name": [name_of[k] for k in top],
            "revenue": g.column("rev_sum").to_pylist()[:Q10_TOP]}


def test_dataset_q10_matches_jax_and_oracle(tpch):
    li, orders, _, root = tpch
    got = dataset_q10(dataset(os.path.join(root, "lineitem")),
                      dataset(os.path.join(root, "orders")),
                      dataset(os.path.join(root, "customer_plain")), CPU)
    check_q10(got, q10_oracle(li, orders))
    want = _jax_dataset_q10(root)
    out = got.to_pydict()
    assert out["c_custkey"] == want["c_custkey"]
    assert out["c_name"] == want["c_name"]
    np.testing.assert_allclose(out["revenue"], want["revenue"], rtol=1e-9)
    # the customers' c_name chunk is PLAIN (its dictionary passed the
    # limit); the window prunes the orders' row groups by statistics, and
    # l_rflag's statistics prune the lineitem groups shipped after the
    # last return
    pf = tpq.ParquetFile(os.path.join(root, "customer_plain",
                                      "part-0.parquet"))
    meta = pf.metadata.row_groups[0].columns[1].meta_data
    assert meta.dictionary_page_offset is None
    rgs = dataset(os.path.join(root, "orders")).scanner(filter=pc.call(
        "less", [pc.field("o_odate"), pc.literal(Q4_ODATE_HI)])).row_groups()
    assert 0 < sum(len(k) for _, k, _ in rgs) < sum(n for *_, n in rgs)
    rgs = dataset(os.path.join(root, "lineitem")).scanner(filter=pc.call(
        "equal", [pc.field("l_rflag"), pc.literal("R")])).row_groups()
    assert 0 < sum(len(k) for _, k, _ in rgs) < sum(n for *_, n in rgs)


def test_dataset_lookup_prunes_by_bloom_filter(tpch):
    _, orders, _, root = tpch
    ds = dataset(os.path.join(root, "orders"))
    ck = orders["o_custkey"]
    for k in [int(ck[0]), int(ck[-1]), 3, 3 * 500]:
        r = dataset_lookup(ds, k, CPU)
        want = np.sort(orders["o_okey"][ck == k])
        np.testing.assert_array_equal(r["o_okey"], want)
        assert r["rows"] == len(want)
        assert r["kept_by_bloom"] <= r["kept_by_stats"]
        if not len(want):
            assert r["kept_by_bloom"] < r["kept_by_stats"]
        jt = jdataset(os.path.join(root, "orders")).to_table(
            columns=["o_okey"], filter=jpc.call("equal", [
                jpc.field("o_custkey"), jpc.literal(k)]))
        assert sorted(jt.column("o_okey").to_pylist()) == want.tolist()


@pytest.mark.parametrize("encoding", sorted(STRING_ENCODINGS))
def test_string_pages_of_each_encoding(tpch, encoding):
    _, _, cus, root = tpch
    path = os.path.join(root, f"customer_{encoding}")
    times = {}
    assert check_string_pages(dataset(path), cus["c_name"][1], CPU,
                              times) == len(cus["c_name"][1])
    assert times["strings_s"] > 0
    jbs = list(jdataset(path).scanner(columns=["c_name"]).device_batches())
    tbs = list(dataset(path).scanner(columns=["c_name"]).device_batches(
        device=CPU))
    for jb, tb in zip(jbs, tbs):
        jc, tc = jb.column("c_name"), tb.column("c_name")
        assert list(tc.dict_values) == jc.dictionary.to_pylist()
        np.testing.assert_array_equal(tc.values[:tb.length].numpy(),
                                      np.asarray(jc.values)[:jb.length])


# ---------------------------------------------------------------------------
# use_threads in the JAX position (the JAX scanner's worker pool; the
# port's staging knob): the same rows either way, and a JAX call's
# positional arguments bind as in the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_threads", [True, False])
def test_dataset_parallel_scan_matches_serial_as_jax(pq_dir, use_threads):
    """tests/test_dataset.py::test_dataset_parallel_scan_matches_serial."""
    jf, tf = _both("less", "id", 250)
    want = jdataset(pq_dir).to_table(["id", "v"], jf, use_threads)
    got = dataset(pq_dir).to_table(["id", "v"], tf, use_threads, device=CPU)
    _same_table(got, want)
    assert got.num_rows == 250
    assert got.to_pydict() == dataset(pq_dir).to_table(
        columns=["id", "v"], filter=tf, use_threads=not use_threads,
        device=CPU).to_pydict()


def test_scanner_takes_use_threads_positionally_as_jax(pq_dir):
    from arrow_go_tpu.dataset import Scanner as JScanner
    from arrow_go_tpu_torch.dataset import Scanner
    jf, tf = _both("greater_equal", "id", 120)
    ds, jds = dataset(pq_dir), jdataset(pq_dir)
    for use_threads in (True, False):
        sc = ds.scanner(["id"], tf, use_threads, device=CPU)
        assert sc.use_threads is use_threads and sc.device == CPU
        _same_table(sc.to_table(), jds.scanner(["id"], jf,
                                               use_threads).to_table())
        _same_table(Scanner(ds, ["id", "cat"], tf, use_threads,
                            device=CPU).to_table(),
                    JScanner(jds, ["id", "cat"], jf, use_threads).to_table())


def test_a_device_passed_by_position_is_refused(pq_dir):
    """`device` is keyword-only after use_threads: a positional third
    argument is use_threads, as in the JAX package."""
    with pytest.raises(TypeError):
        dataset(pq_dir).to_table(None, None, True, CPU)
