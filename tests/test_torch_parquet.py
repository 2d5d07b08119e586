"""The port's parquet (footer, schema, writer, device scan) against the
JAX package's.

Files written by the JAX writer are scanned by both packages'
read_batch_device; values over [0, n) and validity words match bit for
bit, and padded lengths are equal. Files written by the port's writer
are read back by the JAX package's host reader (and pyarrow's where it
is installed) and by the port's own scan.
"""
import io

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.parquet import device_read as jdr

from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.compute.errors import (ArrowInvalid,
                                               ArrowNotImplemented)
from arrow_go_tpu_torch.parquet import format as tfmt
from torch_parity import words_u32


def _table(rng, n: int):
    """(values, masks) of every flat type the port reads: low-cardinality
    columns (dictionary pages when the writer wants them) and a
    high-cardinality one (PLAIN past the dictionary limit)."""
    data = {
        "i32": rng.integers(-50, 50, n).astype(np.int32),
        "i64": rng.integers(-10 ** 12, 10 ** 12, n),
        "f32": np.round(rng.uniform(0, 10, n), 1).astype(np.float32),
        "f64": np.round(rng.uniform(1, 1000, n), 2),
        "b": rng.random(n) < 0.3,
    }
    masks = {"i32": rng.random(n) < 0.8, "f32": rng.random(n) < 0.9,
             "b": rng.random(n) < 0.7}
    return data, masks


def _jax_file(data, masks, **props):
    t = agt.table({k: agt.from_numpy(v, masks.get(k)) for k, v in
                   data.items()})
    buf = io.BytesIO()
    row_group_size = props.pop("row_group_size", None)
    jpq.write_table(t, buf, row_group_size=row_group_size,
                    properties=jpq.WriterProperties(**props))
    return buf.getvalue()


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(f"u{a.dtype.itemsize}") if a.dtype != np.bool_ else a


def _same_batch(tdb, jdb) -> None:
    assert tdb.schema.names == jdb.schema.names
    assert tdb.length == jdb.length
    for f, tc, jc in zip(tdb.schema.fields, tdb.columns, jdb.columns):
        assert tc.type.name == jc.type.name, f.name
        assert tc.padded == jc.padded == agt.device.pad_length(tdb.length)
        n = tc.length
        assert n == jc.length
        assert (tc.validity is None) == (jc.validity is None), f.name
        valid = np.ones(n, np.bool_)
        if tc.validity is not None:
            np.testing.assert_array_equal(words_u32(tc.validity),
                                          np.asarray(jc.validity))
            valid = np.unpackbits(words_u32(tc.validity).view(np.uint8),
                                  bitorder="little")[:n].astype(bool)
        # values bit for bit where rows are valid: a null slot's value is
        # unspecified (the port decodes page by page, the JAX package a
        # uniform chunk at once, and the two fill null slots differently)
        np.testing.assert_array_equal(_bits(tc.values[:n].numpy())[valid],
                                      _bits(np.asarray(jc.values)[:n])[valid])


def _check_against_source(tdb, data, masks, rows: slice) -> None:
    for name, v in data.items():
        c = tdb.column(name)
        got = c.values[:c.length].numpy()
        want = v[rows]
        m = masks.get(name)
        if m is None:
            np.testing.assert_array_equal(got, want)
            continue
        valid = np.unpackbits(words_u32(c.validity).view(np.uint8),
                              bitorder="little")[:c.length].astype(bool)
        np.testing.assert_array_equal(valid, m[rows])
        np.testing.assert_array_equal(got[valid], want[m[rows]])


@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("use_dictionary", [True, False])
@pytest.mark.parametrize("compression", ["none", "gzip"])
def test_scan_of_jax_written_files_matches_jax(rng, compression,
                                               use_dictionary, page_version):
    n = 7000
    data, masks = _table(rng, n)
    blob = _jax_file(data, masks, compression=compression,
                     use_dictionary=use_dictionary, data_page_size=2048,
                     data_page_version=page_version, row_group_size=4000)
    tpf, jpf = tpq.ParquetFile(blob), jpq.ParquetFile(blob)
    assert tpf.num_row_groups == jpf.num_row_groups == 2
    for rg in range(2):
        tdb = tpq.read_batch_device(tpf, rg, device="cpu")
        _same_batch(tdb, jdr.read_batch_device(jpf, rg))
        _check_against_source(tdb, data, masks,
                              slice(rg * 4000, min(rg * 4000 + 4000, n)))


def test_scan_byte_stream_split_matches_jax(rng):
    n = 4096
    data = {"f": rng.standard_normal(n).astype(np.float32),
            "d": rng.standard_normal(n)}
    masks = {"f": rng.random(n) < 0.85}
    blob = _jax_file(data, masks, compression="none", use_dictionary=False,
                     column_properties={
                         "f": {"encoding": "byte_stream_split"},
                         "d": {"encoding": "byte_stream_split"}})
    tpf = tpq.ParquetFile(blob)
    encs = {c.meta_data.path_in_schema[0]: c.meta_data.encodings
            for c in tpf.metadata.row_groups[0].columns}
    assert all(int(tfmt.Encoding.BYTE_STREAM_SPLIT) in e
               for e in encs.values())
    tdb = tpq.read_batch_device(tpf, 0, device="cpu")
    _same_batch(tdb, jdr.read_batch_device(jpq.ParquetFile(blob), 0))
    _check_against_source(tdb, data, masks, slice(0, n))


def test_scan_column_order_and_errors(rng):
    data, masks = _table(rng, 500)
    tpf = tpq.ParquetFile(_jax_file(data, masks, compression="none"))
    tdb = tpq.read_batch_device(tpf, 0, columns=["f64", "i32"], device="cpu")
    _same_batch(tdb, jdr.read_batch_device(jpq.ParquetFile(
        _jax_file(data, masks, compression="none")), 0,
        columns=["f64", "i32"]))
    with pytest.raises(ArrowInvalid):
        tpq.read_batch_device(tpf, 0, columns=["i32", "nope"], device="cpu")
    with pytest.raises(ArrowInvalid):
        tpq.read_batch_device(tpf, 0, columns=["i32", "i32"], device="cpu")


@pytest.mark.parametrize("codec", ["snappy", "zstd"])
def test_codecs_the_port_does_not_read_raise(rng, codec):
    data, masks = _table(rng, 300)
    tpf = tpq.ParquetFile(_jax_file(data, masks, compression=codec))
    with pytest.raises(ArrowNotImplemented):
        tpq.read_batch_device(tpf, 0, device="cpu")
    with pytest.raises(ArrowNotImplemented):
        tpq.write_table(data, io.BytesIO(), compression=codec)


@pytest.mark.parametrize("column", ["string", "list"])
def test_string_and_nested_columns_raise(column):
    arr = agt.array(["a", "b", None]) if column == "string" else \
        agt.array([[1], None, [2, 3]], agt.dtypes.list_(agt.dtypes.int64))
    buf = io.BytesIO()
    jpq.write_table(agt.table({"c": arr}), buf)
    with pytest.raises(ArrowNotImplemented):
        tpq.ParquetFile(buf.getvalue())


def _port_file(data, masks, **kw) -> bytes:
    buf = io.BytesIO()
    tpq.write_table(data, buf, masks=masks, **kw)
    return buf.getvalue()


WRITER_CASES = {
    "dictionary": dict(),
    "plain_gzip": dict(use_dictionary=False, compression="gzip"),
    "pages_row_groups": dict(data_page_size=1024, row_group_size=2500),
    "dictionary_limit": dict(dictionary_pagesize_limit=512,
                             data_page_size=4096),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_port_writer_read_by_jax_and_port(rng, case):
    n = 6000
    data, masks = _table(rng, n)
    blob = _port_file(data, masks, **WRITER_CASES[case])
    jt = jpq.read_table(io.BytesIO(blob))
    for name, v in data.items():
        m = masks.get(name)
        want = [x if m is None or m[i] else None
                for i, x in enumerate(v.tolist())]
        assert jt.column(name).to_pylist() == want, name
    tpf = tpq.ParquetFile(blob)
    rg_rows = WRITER_CASES[case].get("row_group_size", n)
    for rg in range(tpf.num_row_groups):
        tdb = tpq.read_batch_device(tpf, rg, device="cpu")
        _same_batch(tdb, jdr.read_batch_device(jpq.ParquetFile(blob), rg))
        _check_against_source(tdb, data, masks,
                              slice(rg * rg_rows, (rg + 1) * rg_rows))
    encodings = {c.meta_data.path_in_schema[0]: set(c.meta_data.encodings)
                 for c in tpf.metadata.row_groups[0].columns}
    dict_on = WRITER_CASES[case].get("use_dictionary", True)
    assert (int(tfmt.Encoding.RLE_DICTIONARY) in encodings["i32"]) == dict_on
    # 6000 distinct int64 keys pass a 512-byte dictionary limit: PLAIN
    i64_dict = dict_on and case != "dictionary_limit"
    assert (int(tfmt.Encoding.RLE_DICTIONARY) in encodings["i64"]) == i64_dict


def test_port_writer_read_by_pyarrow(rng):
    papq = pytest.importorskip("pyarrow.parquet")
    data, masks = _table(rng, 3000)
    pt = papq.read_table(io.BytesIO(_port_file(data, masks,
                                               data_page_size=2048)))
    for name, v in data.items():
        m = masks.get(name)
        got = pt.column(name).to_numpy(zero_copy_only=False)
        if m is None:
            np.testing.assert_array_equal(got, v)
        else:
            assert pt.column(name).null_count == int((~m).sum())


def test_port_writer_round_trip_keeps_float_bits():
    vals = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -0.0],
                    np.float64)
    for dictionary in (True, False):
        tpf = tpq.ParquetFile(_port_file({"x": vals}, None,
                                         use_dictionary=dictionary))
        got = tpq.read_batch_device(tpf, 0, device="cpu").column("x")
        np.testing.assert_array_equal(got.values[:7].numpy().view(np.uint64),
                                      vals.view(np.uint64))
