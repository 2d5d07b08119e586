"""Parquet columns of this slice's types, both writers and both readers:
large_string (BYTE_ARRAY with the UTF8 annotation) and large_binary
(BYTE_ARRAY) columns, and extension columns, which both packages write
as their storage type and read back as it (uuid as
fixed_size_binary(16), bool8 as int8, json as utf8,
timestamp_with_offset as its struct). The JAX reader is its
`read_table`; the port's are `read_batch_device` (on the CPU) for a flat
column and `read_field_host` for a nested one. The types with no
parquet physical type (the views, the intervals, null, list views,
unions) raise ArrowNotImplemented in both writers."""
import io

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import extensions as jext
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.array.arrays import ArrayData, make_array
from arrow_go_tpu.compute.errors import \
    ArrowNotImplemented as JArrowNotImplemented

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.device.block import device_batch_to_host
from arrow_go_tpu_torch.parquet.reader import read_field_host
from test_torch_more_types import jax_case
from torch_parity import port_array, same_array

N = 300


def _extension(ext, storage):
    d = storage.data
    return make_array(ArrayData(ext, len(storage), d.buffers, d.children,
                                d.dictionary, None, d.offset))


def _columns():
    """JAX host Arrays of each writable type, with nulls."""
    rng = np.random.default_rng(41)
    ok = rng.random(N) < 0.85
    words = ["MAIL", "", "a-long-value-past-12-bytes", "été", "SHIP"]
    w = [words[i] if o else None
         for i, o in zip(rng.integers(0, len(words), N), ok)]
    cols = {
        "ls": agt.array(w, jdt.large_string),
        "lb": agt.array([None if x is None else x.encode() for x in w],
                        jdt.large_binary),
        "uuid": _extension(jext.UuidType(), agt.array(
            [rng.bytes(16) if o else None for o in ok],
            jdt.fixed_size_binary(16))),
        "bool8": _extension(jext.Bool8Type(), agt.array(
            [int(x) if o else None for x, o in zip(rng.integers(0, 2, N),
                                                   ok)], jdt.int8)),
        "json": _extension(jext.JsonType(), agt.array(
            [f'{{"k": {int(x)}}}' if o else None
             for x, o in zip(rng.integers(0, 99, N), ok)], jdt.string)),
    }
    return cols


STORAGE = {"ls": "utf8", "lb": "binary", "uuid": "fixed_size_binary[16]",
           "bool8": "int8", "json": "utf8"}


def _jax_blob(cols) -> bytes:
    buf = io.BytesIO()
    jpq.write_table(agt.table(cols), buf, compression="snappy")
    return buf.getvalue()


def _port_blob(cols) -> bytes:
    buf = io.BytesIO()
    tpq.write_table({k: port_array(v) for k, v in cols.items()}, buf,
                    compression="snappy")
    return buf.getvalue()


def _storage_of(a):
    """A JAX array as what a parquet read gives back: an extension's
    storage, a large string or binary as the plain type."""
    if a.type.id == jdt.TypeId.EXTENSION:
        return a.storage
    to = {jdt.TypeId.LARGE_STRING: jdt.string,
          jdt.TypeId.LARGE_BINARY: jdt.binary}.get(a.type.id)
    return agt.array(a.to_pylist(), to) if to is not None else a


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_readers_read_both_writers_files(writer):
    cols = _columns()
    blob = (_jax_blob if writer == "jax" else _port_blob)(cols)
    jt = jpq.read_table(io.BytesIO(blob))
    pf = tpq.ParquetFile(blob)
    db = tpq.read_batch_device(pf, 0, device="cpu")
    back = device_batch_to_host(db)       # each field's type, as JAX's
    for name, a in cols.items():
        want = _storage_of(a)
        assert str(jt.schema.field_by_name(name).type) == STORAGE[name]
        assert str(pf.schema.field(pf.schema.field_index(name)).type) == \
            STORAGE[name]
        same_array(port_array(jt.column(name).combine()), want, name)
        same_array(back.column(name), want, name)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_struct_storage_extension_reads_as_its_struct(writer):
    """timestamp_with_offset: struct<timestamp[ms, tz=UTC], int16>
    storage, read back by the JAX reader and the port's host read of a
    nested column as that struct."""
    rng = np.random.default_rng(42)
    ext = jext.TimestampWithOffsetType("ms")
    storage = agt.array([{"timestamp": int(t), "offset_minutes": int(o)}
                         for t, o in zip(rng.integers(0, 10**12, N),
                                         rng.integers(-600, 600, N))],
                        ext.storage_type)
    cols = {"two": _extension(ext, storage)}
    blob = (_jax_blob if writer == "jax" else _port_blob)(cols)
    got_j = jpq.read_table(io.BytesIO(blob)).column("two").combine()
    got_t = read_field_host(tpq.ParquetFile(blob), 0, "two")
    assert got_j.to_pylist() == storage.to_pylist()
    assert got_t.to_pylist() == storage.to_pylist()
    assert str(got_t.type) == str(got_j.type)


def test_the_port_writer_takes_typed_large_string_columns():
    """A str column with `types` naming large_string is written with the
    UTF8 annotation, as the JAX writer writes a large_string column."""
    rng = np.random.default_rng(43)
    vals = np.array(["x", "yy", "", "zzz"], dtype=object)[
        rng.integers(0, 4, N)]
    mask = rng.random(N) < 0.9
    buf = io.BytesIO()
    tpq.write_table({"s": vals, "b": vals.astype(bytes).astype(object)},
                    buf, masks={"s": mask},
                    types={"s": dt.large_string, "b": dt.large_binary})
    jt = jpq.read_table(io.BytesIO(buf.getvalue()))
    assert str(jt.schema.field_by_name("s").type) == "utf8"
    assert str(jt.schema.field_by_name("b").type) == "binary"
    assert jt.column("s").combine().to_pylist() == [
        v if m else None for v, m in zip(vals.tolist(), mask.tolist())]
    assert jt.column("b").combine().to_pylist() == [
        v.encode() for v in vals.tolist()]


REFUSED = ["string_view", "binary_view", "null", "month_interval",
           "day_time_interval", "month_day_nano_interval",
           "list_view<int32>", "large_list_view<utf8>", "sparse_union",
           "dense_union"]


@pytest.mark.parametrize("name", REFUSED)
def test_types_without_a_physical_type_refuse_in_both_writers(name):
    ja = jax_case(name, 20)
    with pytest.raises(JArrowNotImplemented, match="no parquet physical"):
        jpq.write_table(agt.table({"x": ja}), io.BytesIO())
    with pytest.raises(pc.ArrowNotImplemented, match="no parquet physical"):
        tpq.write_table({"x": port_array(ja)}, io.BytesIO())
