"""String and binary columns from other writers, and the statistics and
bloom filters that prune row groups, in the port against the JAX package.

Chunks of PLAIN, DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY pages (a
writer without dictionaries, a whole-chunk dictionary fallback, a chunk
that falls back part way, v1 and v2 pages, zstd) go through the port's
device read and the JAX package's Scanner.device_batches, which reads
such a chunk on the host and factorizes it in batch_to_device: values,
validity, codes and dictionary are the same, a null row counting as the
empty string in both (the JAX memo table's quirk). The port's files read
in the JAX package. Both packages' _row_group_may_match and bloom
filters decide alike on both packages' files, and the two writers'
statistics are the same bytes. Every port call passes device="cpu".
"""
import io
import os

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.dataset import dataset as jdataset
from arrow_go_tpu.parquet import encodings as jenc

from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch import native
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.compute.errors import ArrowInvalid
from arrow_go_tpu_torch.dataset import dataset as tdataset
from arrow_go_tpu_torch.parquet import bloom as tbloom
from arrow_go_tpu_torch.parquet import encodings as tenc
from arrow_go_tpu_torch.parquet import format as tfmt
from arrow_go_tpu_torch.parquet import schema as tsch
from arrow_go_tpu_torch.parquet.writer import _thrift_bytes
from torch_parity import words_u32

WORDS = ["", "a", "ab", "abc", "Customer#000000001", "Customer#000000002",
         "zzz", "é", "naïve", "€uro", "日本語", "a\x00b"]


def _values(rng, n: int, kind: str):
    """(python values with None for nulls, numpy values, mask) of a
    string or binary column: a pool of repeated words, empty strings,
    non-ASCII UTF-8, and unique values past the pool."""
    pool = WORDS + [f"w{i:05d}-{'x' * (i % 7)}" for i in range(n // 3)]
    idx = rng.integers(0, len(pool), n)
    vals = [pool[i] for i in idx]
    if kind == "binary":
        vals = [v.encode() + bytes([i % 256]) for i, v in zip(idx, vals)]
    mask = rng.random(n) < 0.85
    py = [v if m else None for v, m in zip(vals, mask)]
    arr = np.empty(n, dtype=object)
    arr[:] = vals
    return py, arr, mask


JAX_WRITERS = {
    "zstd_dictionary": dict(compression="zstd"),
    "plain": dict(use_dictionary=False),
    "fallback": dict(dictionary_pagesize_limit=200),
    "delta_length": dict(column_properties={
        "s": {"encoding": "delta_length_byte_array"}}),
    "delta": dict(column_properties={"s": {"encoding": "delta_byte_array"}},
                  compression="zstd"),
    "v2_plain": dict(use_dictionary=False, data_page_version="2.0",
                     compression="zstd"),
    "v2_delta": dict(column_properties={"s": {
        "encoding": "delta_byte_array"}}, data_page_version="2.0"),
}


def _jax_write(path, py, kind, row_group_size=None, **props):
    t = jdt.binary if kind == "binary" else jdt.string
    table = agt.table({"s": agt.array(py, t),
                       "i": agt.from_numpy(np.arange(len(py)))})
    jpq.write_table(table, str(path), row_group_size=row_group_size,
                    properties=jpq.WriterProperties(data_page_size=400,
                                                    **props))


def _same_batches(path, dictionary_chunks: bool) -> int:
    """The port's and the JAX Scanner's device batches of a file: the same
    values, validity and dictionary, and the same codes (at every row
    where a chunk is not all-dictionary: there the JAX memo table numbers
    a null row as the empty string, and so does the port)."""
    jbs = list(jdataset(str(path)).scanner().device_batches())
    tbs = list(tdataset(str(path)).scanner(device="cpu").device_batches())
    assert len(jbs) == len(tbs)
    rows = 0
    for jb, tb in zip(jbs, tbs):
        assert jb.length == tb.length and jb.schema.names == tb.schema.names
        jc, tc = jb.column("s"), tb.column("s")
        n = tc.length
        assert tc.padded == jc.padded
        np.testing.assert_array_equal(words_u32(tc.validity),
                                      np.asarray(jc.validity))
        valid = tc.validity_mask()[:n].numpy()
        jd, td = jc.dictionary.to_pylist(), list(tc.dict_values)
        assert td == jd
        jcodes = np.asarray(jc.values)[:n]
        tcodes = tc.values[:n].numpy()
        where = valid if dictionary_chunks else np.ones(n, np.bool_)
        np.testing.assert_array_equal(tcodes[where], jcodes[where])
        got = [td[c] if ok else None for c, ok in zip(tcodes, valid)]
        assert got == [jd[c] if ok else None for c, ok in zip(jcodes, valid)]
        np.testing.assert_array_equal(tb.column("i").values[:n].numpy(),
                                      np.asarray(jb.column("i").values)[:n])
        rows += n
    return rows


@pytest.mark.parametrize("kind", ["string", "binary"])
@pytest.mark.parametrize("writer", sorted(JAX_WRITERS))
def test_jax_written_chunks_read_as_the_jax_scanner_reads_them(
        rng, tmp_path, writer, kind):
    py, _, _ = _values(rng, 1500, kind)
    path = tmp_path / "s.parquet"
    _jax_write(path, py, kind, row_group_size=600, **JAX_WRITERS[writer])
    assert _same_batches(path, writer == "zstd_dictionary") == 1500


PORT_WRITERS = {
    "zstd_dictionary": dict(compression="zstd"),
    "plain": dict(use_dictionary={"s": False}, compression="zstd",
                  compression_level=9),
    "fallback": dict(dictionary_pagesize_limit=200),
    "delta_length": dict(column_encodings={"s": "delta_length_byte_array"},
                         compression="snappy"),
    "delta": dict(column_encodings={"s": "delta_byte_array"},
                  compression="zstd", compression_level=1),
}


@pytest.mark.parametrize("kind", ["string", "binary"])
@pytest.mark.parametrize("writer", sorted(PORT_WRITERS))
def test_port_written_chunks_read_in_both_packages(rng, tmp_path, writer,
                                                   kind):
    py, arr, mask = _values(rng, 1500, kind)
    path = tmp_path / "s.parquet"
    tpq.write_table({"s": arr, "i": np.arange(1500)}, str(path),
                    masks={"s": mask}, row_group_size=600,
                    data_page_size=400, **PORT_WRITERS[writer])
    assert jpq.ParquetFile(str(path)).read_table().to_pydict()["s"] == py
    assert _same_batches(path, writer == "zstd_dictionary") == 1500
    enc = {"plain": tfmt.Encoding.PLAIN, "fallback": tfmt.Encoding.PLAIN,
           "delta_length": tfmt.Encoding.DELTA_LENGTH_BYTE_ARRAY,
           "delta": tfmt.Encoding.DELTA_BYTE_ARRAY}.get(writer)
    meta = tpq.ParquetFile(str(path)).metadata.row_groups[0].columns[0]
    if enc is not None:
        assert int(enc) in meta.meta_data.encodings
        assert meta.meta_data.dictionary_page_offset is None


def _mixed_chunk_file(py, kind: str) -> bytes:
    """One column chunk that opens with a dictionary page and falls back
    part way, as parquet-mr and the Arrow writers do for strings: a
    dictionary page (the first page's distinct values), an
    RLE_DICTIONARY page, then a PLAIN, a DELTA_LENGTH_BYTE_ARRAY and a
    DELTA_BYTE_ARRAY page, each a quarter of the rows."""
    t = tdt.binary if kind == "binary" else tdt.string
    schema = tdt.Schema([tdt.Field("s", t, True)])
    elements, leaves = tsch.schema_to_elements(schema)
    n = len(py)
    cuts = np.linspace(0, n, 5).astype(int).tolist()
    as_bytes = [None if v is None else (v if isinstance(v, bytes)
                                        else v.encode()) for v in py]
    first = [v for v in as_bytes[:cuts[1]] if v is not None]
    dictionary = list(dict.fromkeys(first))
    out = io.BytesIO()
    out.write(b"PAR1")

    def page(hdr, body):
        out.write(_thrift_bytes(hdr))
        out.write(body)
    dict_body = tenc.plain_encode(tfmt.Type.BYTE_ARRAY, dictionary)
    dict_offset = out.tell()
    page(tfmt.PageHeader(
        type=int(tfmt.PageType.DICTIONARY_PAGE),
        uncompressed_page_size=len(dict_body),
        compressed_page_size=len(dict_body),
        dictionary_page_header=tfmt.DictionaryPageHeader(
            num_values=len(dictionary), encoding=int(tfmt.Encoding.PLAIN))),
        dict_body)
    data_offset = out.tell()
    encodings = [tfmt.Encoding.RLE_DICTIONARY, tfmt.Encoding.PLAIN,
                 tfmt.Encoding.DELTA_LENGTH_BYTE_ARRAY,
                 tfmt.Encoding.DELTA_BYTE_ARRAY]
    for p, e in enumerate(encodings):
        rows = as_bytes[cuts[p]:cuts[p + 1]]
        present = [v for v in rows if v is not None]
        levels = tenc.levels_encode_v1(np.array(
            [v is not None for v in rows], np.uint32), 1)
        if e == tfmt.Encoding.RLE_DICTIONARY:
            code = {v: i for i, v in enumerate(dictionary)}
            width = max(tenc.bit_width_for(len(dictionary) - 1), 1)
            data = bytes([width]) + tenc.rle_encode(
                np.array([code[v] for v in present], np.uint32), width)
        elif e == tfmt.Encoding.PLAIN:
            data = tenc.plain_encode(tfmt.Type.BYTE_ARRAY, present)
        elif e == tfmt.Encoding.DELTA_LENGTH_BYTE_ARRAY:
            data = tenc.delta_length_byte_array_encode(present)
        else:
            data = tenc.delta_byte_array_encode(present)
        body = levels + data
        page(tfmt.PageHeader(
            type=int(tfmt.PageType.DATA_PAGE),
            uncompressed_page_size=len(body), compressed_page_size=len(body),
            data_page_header=tfmt.DataPageHeader(
                num_values=len(rows), encoding=int(e),
                definition_level_encoding=int(tfmt.Encoding.RLE),
                repetition_level_encoding=int(tfmt.Encoding.RLE))), body)
    end = out.tell()
    meta = tfmt.ColumnMetaData(
        type=int(tfmt.Type.BYTE_ARRAY),
        encodings=sorted({int(e) for e in encodings}
                         | {int(tfmt.Encoding.RLE)}),
        path_in_schema=["s"], codec=0, num_values=n,
        total_uncompressed_size=end - dict_offset,
        total_compressed_size=end - dict_offset,
        data_page_offset=data_offset, dictionary_page_offset=dict_offset)
    footer = _thrift_bytes(tfmt.FileMetaData(
        version=2, schema=elements, num_rows=n, row_groups=[tfmt.RowGroup(
            columns=[tfmt.ColumnChunk(file_offset=dict_offset,
                                      meta_data=meta)],
            total_byte_size=end - dict_offset, num_rows=n)],
        created_by="test"))
    out.write(footer)
    out.write(len(footer).to_bytes(4, "little"))
    out.write(b"PAR1")
    return out.getvalue()


@pytest.mark.parametrize("kind", ["string", "binary"])
def test_chunk_that_falls_back_part_way_merges_one_dictionary(rng, tmp_path,
                                                              kind):
    py, _, _ = _values(rng, 2000, kind)
    path = tmp_path / "mixed.parquet"
    path.write_bytes(_mixed_chunk_file(py, kind))
    assert jpq.ParquetFile(str(path)).read_table().to_pydict()["s"] == py
    jbs = list(jdataset(str(path)).scanner().device_batches())
    tbs = list(tdataset(str(path)).scanner(device="cpu").device_batches())
    jc, tc = jbs[0].column("s"), tbs[0].column("s")
    assert list(tc.dict_values) == jc.dictionary.to_pylist()
    np.testing.assert_array_equal(tc.values[:2000].numpy(),
                                  np.asarray(jc.values)[:2000])
    valid = tc.validity_mask()[:2000].numpy()
    assert [tc.dict_values[c] if ok else None for c, ok in
            zip(tc.values[:2000].tolist(), valid)] == py


def test_byte_array_walks_match_the_jax_decoders(rng):
    py, arr, mask = _values(rng, 3000, "string")
    vals = [v.encode() for v in arr]
    for enc, jdec in (
            (tfmt.Encoding.DELTA_LENGTH_BYTE_ARRAY,
             jenc.delta_length_byte_array_decode),
            (tfmt.Encoding.DELTA_BYTE_ARRAY, jenc.delta_byte_array_decode),
            (tfmt.Encoding.PLAIN, None)):
        data = {tfmt.Encoding.PLAIN: tenc.plain_encode,
                tfmt.Encoding.DELTA_LENGTH_BYTE_ARRAY:
                    lambda _, v: tenc.delta_length_byte_array_encode(v),
                tfmt.Encoding.DELTA_BYTE_ARRAY:
                    lambda _, v: tenc.delta_byte_array_encode(v)}[enc](
            tfmt.Type.BYTE_ARRAY, vals)
        ends, body = tenc.byte_array_decode(enc, data, len(vals))
        raw = body.tobytes()
        assert [raw[a:b] for a, b in zip(np.r_[0, ends[:-1]].tolist(),
                                         ends.tolist())] == vals
        if jdec is not None:
            assert [bytes(v) for v in jdec(data, len(vals))] == vals
    codes, first = native.factorize(*tenc._ends_data(vals))
    uniq = list(dict.fromkeys(vals))
    assert first.tolist() == [vals.index(u) for u in uniq]
    assert codes.tolist() == [uniq.index(v) for v in vals]


@pytest.mark.parametrize("width", [1, 7, 31, 33, 63, 64])
def test_delta_lengths_decode_past_32_bits(width):
    """The host DELTA decode takes every miniblock width up to 64, as the
    device DELTA path does."""
    rng = np.random.default_rng(width)
    v = rng.integers(-(2 ** 62), 2 ** 62, 700) if width > 62 else \
        np.cumsum(rng.integers(0, 2 ** (width - 1), 700))
    data = jenc.delta_binary_packed_encode(v)
    got, used = native.delta_decode(data, 700)
    assert got.tolist() == v.tolist() and used == len(data)
    with pytest.raises(ArrowInvalid):
        native.delta_decode(data, 699)


@pytest.mark.parametrize("bad", ["truncated", "prefix"])
def test_corrupt_byte_array_pages_raise(bad):
    vals = [b"abc", b"abd", b"xyz"] * 50
    data = tenc.delta_byte_array_encode(vals)
    if bad == "truncated":
        data = data[:-5]
    else:
        # a first prefix length of 1 with no value before it
        data = tenc.delta_binary_packed_encode(
            np.r_[1, np.zeros(149, np.int64)]) + \
            tenc.delta_length_byte_array_encode(vals)
    with pytest.raises(ArrowInvalid):
        tenc.byte_array_decode(tfmt.Encoding.DELTA_BYTE_ARRAY, data,
                               len(vals))


# ---------------------------------------------------------------------------
# statistics and bloom filters
# ---------------------------------------------------------------------------

def _pruning_table(rng, n: int):
    data = {"i32": rng.integers(-500, 500, n).astype(np.int32),
            "i64": np.sort(rng.integers(0, 10 ** 12, n)),
            "f64": np.round(rng.uniform(0, 100, n), 2),
            "s": np.array([f"k{v:04d}" for v in rng.integers(0, 3000, n)],
                          dtype=object),
            "long": np.array(["L" * 70 + str(v) for v in
                              rng.integers(0, 9, n)], dtype=object)}
    masks = {"f64": rng.random(n) < 0.9}
    return data, masks


def _both_files(tmp_path, rng):
    data, masks = _pruning_table(rng, 4000)
    jpath, tpath = tmp_path / "jax.parquet", tmp_path / "port.parquet"
    cols = {k: agt.from_numpy(v, masks.get(k)) if v.dtype != object else
            agt.array(v.tolist()) for k, v in data.items()}
    jpq.write_table(agt.table(cols), str(jpath), row_group_size=500,
                    write_bloom_filters=True)
    tpq.write_table(data, str(tpath), masks=masks, row_group_size=500,
                    write_bloom_filters=True, compression="zstd")
    return data, masks, jpath, tpath


LITERALS = {"i32": [-501, -500, -3, 0, 17, 499, 500],
            "i64": [-1, 0, 5 * 10 ** 11, 10 ** 12],
            "f64": [-0.5, 0.0, 12.34, 50.0, 100.0, 100.5],
            "s": ["a", "k0000", "k1500", "k1500x", "k2999", "z"],
            "long": ["A", "L" * 70 + "3", "Z"]}


def test_row_group_pruning_matches_jax_on_both_writers(rng, tmp_path):
    data, _, jpath, tpath = _both_files(tmp_path, rng)
    for path in (jpath, tpath):
        jpf, tpf = jpq.ParquetFile(str(path)), tpq.ParquetFile(str(path))
        decided = 0
        for col, lits in LITERALS.items():
            for op in ("==", "<", "<=", ">", ">="):
                for lit in lits + [data[col][7]]:
                    f = [(col, op, lit)]
                    want = [jpf._row_group_may_match(i, f)
                            for i in range(jpf.num_row_groups)]
                    got = [tpf._row_group_may_match(i, f)
                           for i in range(tpf.num_row_groups)]
                    assert got == want, (path.name, col, op, lit)
                    decided += not all(got)
        assert decided > 50


def test_statistics_are_the_jax_writers_bytes(rng, tmp_path):
    """Statistics of the same rows from both writers: null counts and
    min/max bytes equal, a string's only while its first value is under
    64 bytes (none for `long`)."""
    _, _, jpath, tpath = _both_files(tmp_path, rng)
    jm, tm = jpq.ParquetFile(str(jpath)).metadata, \
        tpq.ParquetFile(str(tpath)).metadata
    for jrg, trg in zip(jm.row_groups, tm.row_groups):
        for jc, tc in zip(jrg.columns, trg.columns):
            js, ts = jc.meta_data.statistics, tc.meta_data.statistics
            assert (ts.null_count, ts.min_value, ts.max_value) == \
                (js.null_count, js.min_value, js.max_value)
    assert tm.row_groups[0].columns[4].meta_data.statistics.min_value is None


def test_fixed_length_statistics_are_the_jax_writers_bytes(rng, tmp_path):
    """FIXED_LEN_BYTE_ARRAY statistics compare the big-endian bytes (the
    JAX writer's min / max of its byte strings): a decimal's negative
    values sort above its positive ones."""
    from decimal import Decimal
    unscaled = rng.integers(-10 ** 12, 10 ** 12, 3000)
    mask = rng.random(3000) < 0.9
    jt = agt.table({"d": agt.array([Decimal(int(u)).scaleb(-2) if m
                                    else None for u, m in
                                    zip(unscaled, mask)],
                                   jdt.decimal128(15, 2))})
    jpath, tpath = tmp_path / "jax.parquet", tmp_path / "port.parquet"
    jpq.write_table(jt, str(jpath), row_group_size=700)
    tpq.write_table({"d": unscaled}, str(tpath), masks={"d": mask},
                    types={"d": tdt.decimal128(15, 2)}, row_group_size=700)
    jm = jpq.ParquetFile(str(jpath)).metadata
    tm = tpq.ParquetFile(str(tpath)).metadata
    for jrg, trg in zip(jm.row_groups, tm.row_groups):
        js = jrg.columns[0].meta_data.statistics
        ts = trg.columns[0].meta_data.statistics
        assert (ts.null_count, ts.min_value, ts.max_value) == \
            (js.null_count, js.min_value, js.max_value)
        assert ts.min_value[0] == 0 and ts.max_value[0] == 0xFF


def test_bloom_filters_check_alike(rng, tmp_path):
    data, masks, jpath, tpath = _both_files(tmp_path, rng)
    phys = {"i32": tfmt.Type.INT32, "i64": tfmt.Type.INT64,
            "f64": tfmt.Type.DOUBLE, "s": tfmt.Type.BYTE_ARRAY,
            "long": tfmt.Type.BYTE_ARRAY}
    for path in (jpath, tpath):
        jpf, tpf = jpq.ParquetFile(str(path)), tpq.ParquetFile(str(path))
        for li, col in enumerate(data):
            for rg in range(tpf.num_row_groups):
                jbf, tbf = jpf.read_bloom_filter(rg, li), \
                    tpf.read_bloom_filter(rg, li)
                np.testing.assert_array_equal(tbf.blocks, jbf.blocks)
                rows = data[col][rg * 500:(rg + 1) * 500]
                for v in list(rows[:20]) + LITERALS[col]:
                    v = v.item() if hasattr(v, "item") else v
                    assert tbf.check(v, phys[col]) == jbf.check(
                        v, phys[col])
                # every value of a valid row is in the filter
                valid = masks.get(col, np.ones(len(data[col]), np.bool_))[
                    rg * 500:(rg + 1) * 500]
                assert all(tbf.check(v.item() if hasattr(v, "item") else v,
                                     phys[col]) for v in rows[valid][:50])


def test_bloom_filter_round_trip_and_sizing():
    from arrow_go_tpu.parquet import bloom as jbloom
    for ndv in (0, 1, 100, 10_000, 1_000_000):
        for fpp in (0.01, 0.05):
            assert tbloom.optimal_num_blocks(ndv, fpp) == \
                jbloom.optimal_num_blocks(ndv, fpp)
    bf = tbloom.build_bloom_filter(range(1000), tfmt.Type.INT64)
    np.testing.assert_array_equal(
        bf.blocks, jbloom.build_bloom_filter(range(1000),
                                             jbloom.fmt.Type.INT64).blocks)
    back = tbloom.BloomFilter.deserialize(bf.serialize())
    np.testing.assert_array_equal(back.blocks, bf.blocks)
    assert bf.serialize() == jbloom.BloomFilter.deserialize(
        bf.serialize()).serialize()
    assert all(back.check(v, tfmt.Type.INT64) for v in range(1000))
    assert np.mean([back.check(v, tfmt.Type.INT64)
                    for v in range(10 ** 6, 10 ** 6 + 5000)]) < 0.03


def test_row_group_of_mixed_chunks_keeps_dictionary_order(rng, tmp_path):
    """A JAX quirk the port does not copy: when one column of a row group
    needs the host read, the JAX Scanner reads the whole row group on
    the host, so an all-dictionary string chunk beside it is renumbered
    by first occurrence too. The port renumbers only the chunk with
    PLAIN pages; the all-dictionary chunk keeps its dictionary page's
    order. The values agree."""
    n = 800
    flags = np.array(["N", "R", "A"], dtype=object)
    codes = rng.integers(0, 3, n).astype(np.int32)
    codes[0] = 2                       # "A" first: the orders differ
    names = np.array([f"name{i:05d}" for i in range(n)], dtype=object)
    path = tmp_path / "mixed_rg.parquet"
    tpq.write_table({"flag": (codes, flags), "name": names}, str(path),
                    use_dictionary={"name": False})
    jb = next(jdataset(str(path)).scanner().device_batches())
    tb = next(tdataset(str(path)).scanner(device="cpu").device_batches())
    tc, jc = tb.column("flag"), jb.column("flag")
    assert list(tc.dict_values) == ["N", "R", "A"]
    assert jc.dictionary.to_pylist() == list(dict.fromkeys(
        flags[codes].tolist()))
    assert tc.dict_values[tc.values[:n].numpy()].tolist() == \
        [jc.dictionary.to_pylist()[c] for c in np.asarray(jc.values)[:n]]
    assert list(tb.column("name").dict_values) == \
        jb.column("name").dictionary.to_pylist() == names.tolist()
