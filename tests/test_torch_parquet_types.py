"""Parquet columns of the new types, both ways, and the slice as a whole.

The JAX writer writes date32, date64, timestamp(ms, UTC), time32, int8,
int16 and uint8-uint64 columns with nulls, plain and dictionary encoded,
in v1 and v2 pages; the port's device read (on the CPU) must give what
the JAX package's host read followed by `to_device` gives (its device
read raises on these types). The port's writer, told the types, must
round-trip through the JAX reader. Then TPC-H Q6 over a lineitem whose
l_sdate is a DATE column read from bytes, and the revenue by
floor_temporal(l_sdate, unit="year"), in both packages."""
import io

import numpy as np
import pytest

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.compute import temporal as jtemp
from arrow_go_tpu.compute.groupby import group_by as jgroup_by
from arrow_go_tpu.device.block import DeviceBatch as JaxBatch
from arrow_go_tpu.device.block import to_device

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.device.block import DeviceBatch
from test_torch_types import same_column, values_of
from torch_parity import jax_type

TYPES = {"d32": dt.date32, "d64": dt.date64,
         "ts": dt.timestamp("ms", "UTC"), "t32": dt.time32("ms"),
         "i8": dt.int8, "i16": dt.int16, "u8": dt.uint8, "u16": dt.uint16,
         "u32": dt.uint32, "u64": dt.uint64}
N = 3000


def _columns(rng):
    """(values, masks): low-cardinality columns (dictionary pages when
    the writer wants them) with the types' extremes, and nulls."""
    data, masks = {}, {}
    for name, t in TYPES.items():
        pool = values_of(t if t.is_integer else dt.int32, 40, rng)
        if t.is_temporal:
            pool = np.abs(pool.astype(np.int64)) % (86_400_000 if t.id ==
                                                    dt.TypeId.TIME32
                                                    else 10 ** 6)
        data[name] = pool[rng.integers(0, 40, N)].astype(t.np_dtype)
        masks[name] = rng.random(N) < 0.9
    return data, masks


def _jax_blob(data, masks, **props) -> bytes:
    table = agt.table({k: agt.from_numpy(v, masks.get(k),
                                         jax_type(TYPES[k]))
                       for k, v in data.items()})
    buf = io.BytesIO()
    jpq.write_table(table, buf, properties=jpq.WriterProperties(**props))
    return buf.getvalue()


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("use_dictionary", [True, False])
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_jax_file_reads_as_the_jax_host_read(compression, use_dictionary,
                                              version):
    data, masks = _columns(np.random.default_rng(31))
    blob = _jax_blob(data, masks, compression=compression,
                     use_dictionary=use_dictionary,
                     data_page_version=version, data_page_size=4096)
    jt = jpq.read_table(io.BytesIO(blob))
    tdb = tpq.read_batch_device(tpq.ParquetFile(blob), 0, device="cpu")
    for name in data:
        want = to_device(jt.column(name).combine())
        got = tdb.column(name)
        # (date64 is written unannotated, so both read it as int64)
        assert str(got.type) == str(want.type), name
        same_column(got, want)


def test_port_writer_round_trips_through_the_jax_reader():
    data, masks = _columns(np.random.default_rng(32))
    buf = io.BytesIO()
    tpq.write_table(data, buf, masks=masks, types=TYPES,
                    data_page_size=4096)
    jt = jpq.read_table(io.BytesIO(buf.getvalue()))
    jschema = {f.name: str(f.type) for f in jt.schema.fields}
    for name, t in TYPES.items():
        jcol = jt.column(name).combine()
        # the JAX writer and reader drop date64's type alike
        assert jschema[name] == (str(t) if t != dt.date64 else "int64")
        got = to_device(jcol)
        want_vals = np.where(masks[name], data[name], 0)
        np.testing.assert_array_equal(
            np.asarray(got.validity_mask())[:N], masks[name])
        np.testing.assert_array_equal(
            np.where(masks[name], np.asarray(got.values)[:N], 0).astype(
                t.np_dtype), want_vals)


@pytest.mark.parametrize("annotation", ["DECIMAL", "FLOAT16"])
def test_decimal_and_float16_columns_raise(annotation):
    """An INT32 leaf annotated DECIMAL(9, 2) reads as decimal32(9, 2), as
    the JAX package maps it (the decimal slice ported it); a FLOAT16
    annotation on INT32, which no writer gives (FLOAT16 annotates a
    2-byte FIXED_LEN_BYTE_ARRAY), still raises."""
    from arrow_go_tpu.parquet import format as jfmt
    from arrow_go_tpu.parquet import schema as jpsch
    from arrow_go_tpu_torch.parquet import format as fmt
    from arrow_go_tpu_torch.parquet import schema as psch
    lt = fmt.LogicalType(DECIMAL=fmt.DecimalLType(scale=2, precision=9)) \
        if annotation == "DECIMAL" else fmt.LogicalType(
            FLOAT16=fmt.Float16LType())
    el = fmt.SchemaElement(name="x", type=int(fmt.Type.INT32),
                           repetition_type=0, logicalType=lt)
    root = fmt.SchemaElement(name="schema", num_children=1)
    if annotation == "FLOAT16":
        with pytest.raises(pc.ArrowNotImplemented):
            psch.elements_to_schema([root, el])
        return
    jlt = jfmt.LogicalType(DECIMAL=jfmt.DecimalLType(scale=2, precision=9))
    jel = jfmt.SchemaElement(name="x", type=int(jfmt.Type.INT32),
                             repetition_type=0, logicalType=jlt)
    jschema, _ = jpsch.elements_to_schema(
        [jfmt.SchemaElement(name="schema", num_children=1), jel])
    schema, _ = psch.elements_to_schema([root, el])
    assert str(schema.field(0).type) == str(jschema.field(0).type) == \
        "decimal32(9, 2)"


# the slice as a whole: TPC-H Q6 on a DATE l_sdate, and the revenue by
# ship year (the shape of TPC-H Q7/Q9's extract(year from l_shipdate))

Q6_LO, Q6_HI = 8766, 9131       # 1994-01-01, 1995-01-01 as days


def _lineitem(n: int = 4000):
    rng = np.random.default_rng(33)
    data = {"l_price": np.round(rng.uniform(1.0, 1000.0, n), 2),
            "l_disc": np.round(rng.uniform(0.0, 0.1, n), 2),
            "l_sdate": rng.integers(8000, 10600, n).astype(np.int32),
            "l_qty": rng.integers(1, 51, n).astype(np.int32)}
    table = agt.table({
        "l_price": agt.from_numpy(data["l_price"]),
        "l_disc": agt.from_numpy(data["l_disc"]),
        "l_sdate": agt.from_numpy(data["l_sdate"], None,
                                  jax_type(dt.date32)),
        "l_qty": agt.from_numpy(data["l_qty"])})
    buf = io.BytesIO()
    jpq.write_table(table, buf, compression="snappy")
    return data, buf.getvalue()


def _q6_predicate(m):
    f, lit, call = m.field, m.literal, m.call
    pred = None
    for c in (call("greater_equal", [f("l_sdate"), lit(Q6_LO)]),
              call("less", [f("l_sdate"), lit(Q6_HI)]),
              call("greater_equal", [f("l_disc"), lit(0.05)]),
              call("less_equal", [f("l_disc"), lit(0.07)]),
              call("less", [f("l_qty"), lit(24)])):
        pred = c if pred is None else call("and", [pred, c])
    return pred


def _both_batches():
    data, blob = _lineitem()
    jt = jpq.read_table(io.BytesIO(blob))
    jcols = [to_device(jt.column(f.name).combine())
             for f in jt.schema.fields]
    jdb = JaxBatch(jt.schema, jcols, jt.num_rows)
    tdb = tpq.read_batch_device(tpq.ParquetFile(blob), 0, device="cpu")
    return data, jdb, tdb


def test_typed_q6_matches_jax_and_numpy():
    data, jdb, tdb = _both_batches()
    sdate = tdb.column("l_sdate")
    assert sdate.type == dt.date32 and str(jdb.column("l_sdate").type) == \
        "date32"
    # (an OPTIONAL column without nulls: the port's device read keeps its
    # validity words, the JAX host read drops them)
    np.testing.assert_array_equal(sdate.values.numpy(),
                                  np.asarray(jdb.column("l_sdate").values))
    results = []
    for m, db in ((jpc, jdb), (pc, tdb)):
        mask = m.execute_scalar_expression(_q6_predicate(m), db)
        kept = m.filter(db, mask)
        rev = m.execute_scalar_expression(
            m.call("multiply", [m.field("l_price"), m.field("l_disc")]),
            kept)
        results.append((m.call_function("sum", [rev]), kept.length))
    (jrev, jn), (trev, tn) = results
    sel = ((data["l_sdate"] >= Q6_LO) & (data["l_sdate"] < Q6_HI)
           & (data["l_disc"] >= 0.05) & (data["l_disc"] <= 0.07)
           & (data["l_qty"] < 24))
    assert tn == jn == int(sel.sum()) > 0
    np.testing.assert_allclose(trev, jrev, rtol=1e-9)
    np.testing.assert_allclose(
        trev, float(np.sum(data["l_price"][sel] * data["l_disc"][sel])),
        rtol=1e-9)


def test_revenue_by_ship_year_matches_jax():
    _, jdb, tdb = _both_batches()
    outs = []
    for m, db, floor, batch in (
            (jpc, jdb, jtemp.floor_temporal, JaxBatch),
            (pc, tdb, pc.floor_temporal, DeviceBatch)):
        year = floor(db.column("l_sdate"), unit="year")
        rev = m.execute_scalar_expression(m.call("multiply", [
            m.field("l_price"),
            m.call("subtract", [m.literal(1.0), m.field("l_disc")])]), db)
        mod = agt.dtypes if m is jpc else dt
        gb = batch(mod.Schema([mod.Field("year", year.type),
                               mod.Field("rev", mod.float64)]),
                   [year, rev], db.length)
        g = (jgroup_by if m is jpc else pc.group_by)(
            gb, "year", [("rev", "sum"), ("rev", "count")])
        outs.append(g.to_pydict())
    want, got = outs
    assert got["year"] == want["year"]
    # each key is the first day of a year
    assert all(str(np.datetime64(y, "D")).endswith("-01-01")
               for y in got["year"]) and len(got["year"]) >= 7
    assert got["rev_count"] == want["rev_count"]
    np.testing.assert_allclose(got["rev_sum"], want["rev_sum"], rtol=1e-9)
