"""WriterProperties of the port's parquet writer (arrow_go_tpu_torch/
parquet/writer.py) against the JAX writer (arrow_go_tpu/parquet/
writer.py:401-485) and pyarrow: the counterpart of every test of
tests/test_parquet_properties.py, and footers compared field by field
(the format version, created_by, the page types, encodings and codecs
by column, the statistics, the bloom filters' sizes for an fpp, the
sorting columns and the key/value metadata) between the two writers'
files under the same properties. Values are compared exactly, in the
JAX reader, pyarrow and the port's reader. The keyword path keeps the
bytes it wrote before the properties existed."""
import decimal
import hashlib
import io

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.parquet import bloom as tbloom
from arrow_go_tpu_torch.parquet import format as fmt
from arrow_go_tpu_torch.parquet.device_read import _iter_pages

from torch_parity import port_record_batch

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as papq  # noqa: E402


def _sample_table():
    return agt.table({
        "i": agt.array([1, None, 3, 4, 5], jdt.int64),
        "s": agt.array(["aa", "bb", None, "aa", "cc"], jdt.string),
        "f": agt.array([0.5, 1.5, 2.5, None, 4.5], jdt.float64),
        "ls": agt.array([[1, 2], None, [3], [], [4, 5, 6]],
                        jdt.list_(jdt.int32)),
    })


def _port(table):
    hb = port_record_batch(table.to_batches()[0])
    if table.schema.metadata:
        hb.schema.metadata = tdt.Metadata(
            keys=table.schema.metadata.keys,
            values=table.schema.metadata.values)
    return hb


def _props(pkg, **kw):
    kw.setdefault("created_by", "test writer")   # the defaults name each
    sort = kw.pop("sorting_columns", None)
    if sort is not None:
        kw["sorting_columns"] = [pkg.SortingColumn(*s) for s in sort]
    return pkg.WriterProperties(**kw)


def _write_port(t, **kw):
    buf = io.BytesIO()
    tpq.write_table(_port(t), buf, properties=_props(tpq, **kw))
    return buf.getvalue()


def _write_jax(t, **kw):
    buf = io.BytesIO()
    jpq.write_table(t, buf, properties=_props(jpq, **kw))
    return buf.getvalue()


def _port_read(blob, **kw):
    return tpq.read_table(blob, device="cpu", **kw)


def footer(blob, normalize_v1=False) -> dict:
    """The footer's fields the tests compare, read by the port; with
    `normalize_v1` the recorded v1 deviations are mapped away (a v1
    dictionary data page's PLAIN_DICTIONARY as RLE_DICTIONARY; RLE
    listed for every chunk)."""
    pf = tpq.ParquetFile(blob)
    md = pf.metadata
    out = {"version": md.version, "created_by": md.created_by,
           "num_rows": md.num_rows,
           "kv": [(k.key, k.value) for k in md.key_value_metadata or []],
           "row_groups": []}
    for rg in md.row_groups:
        cols = []
        for ch in rg.columns:
            m = ch.meta_data
            pages = []
            for hdr, _ in _iter_pages(pf, ch):
                sub = hdr.data_page_header_v2 or hdr.data_page_header or \
                    hdr.dictionary_page_header
                pages.append((fmt.PageType(hdr.type).name,
                              fmt.Encoding(sub.encoding).name))
            # the writers cut pages at different rows (a recorded
            # deviation): the kinds of page are compared, not their count
            pages = sorted(set(pages))
            encs = set(m.encodings)
            if normalize_v1:
                encs = {int(fmt.Encoding.RLE_DICTIONARY)
                        if e == fmt.Encoding.PLAIN_DICTIONARY else e
                        for e in encs} | {int(fmt.Encoding.RLE)}
                pages = [(t, "RLE_DICTIONARY" if e == "PLAIN_DICTIONARY"
                          else e) for t, e in pages]
            st = m.statistics
            cols.append({
                "path": list(m.path_in_schema), "codec": m.codec,
                "encodings": sorted(encs), "pages": pages,
                "num_values": m.num_values,
                "stats": None if st is None else
                (st.null_count, st.min_value, st.max_value),
                "bloom_bytes": m.bloom_filter_length,
                "dictionary": m.dictionary_page_offset is not None})
        out["row_groups"].append({
            "num_rows": rg.num_rows, "columns": cols,
            "sorting": [(s.column_idx, s.descending, s.nulls_first)
                        for s in rg.sorting_columns or []]})
    return out


def _flat_table(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-1000, 1000, n)
    valid = rng.random(n) > 0.1
    words = np.array([f"w{k}" for k in range(50)])[rng.integers(0, 50, n)]
    t = agt.table({
        "id": agt.array(np.arange(n, dtype=np.int64), jdt.int64),
        "q": agt.array([int(v) if ok else None for v, ok in zip(ints, valid)],
                       jdt.int64),
        "price": agt.array(rng.random(n) * 100, jdt.float64),
        "name": agt.array([str(w) if ok else None
                           for w, ok in zip(words, valid[::-1])], jdt.string),
        "tag": agt.array([str(w) for w in words], jdt.string)})
    t.schema.metadata = jdt.Metadata({"source": "tests", "rows": str(n)})
    return t


V2_PROPS = dict(
    data_page_version="2.0", version="2.6", created_by="properties test",
    data_page_size=4096, write_page_index=False, write_bloom_filters=True,
    bloom_filter_fpp=0.05, sorting_columns=[(0, False, True)],
    column_properties={
        "id": {"encoding": "delta_binary_packed", "compression": "zstd",
               "bloom": False},
        "q": {"use_dictionary": False, "compression": "snappy",
              "bloom": False},
        "price": {"use_dictionary": False, "compression": "gzip",
                  "compression_level": 9, "write_statistics": False,
                  "bloom": False},
        "name": {"compression": "snappy", "bloom": True},
        "tag": {"encoding": "delta_length_byte_array",
                "compression": "none", "bloom": False}})


def test_v2_footer_matches_the_jax_writer_field_by_field():
    t = _flat_table()
    ours, theirs = _write_port(t, **V2_PROPS), _write_jax(t, **V2_PROPS)
    fo, fj = footer(ours), footer(theirs)
    assert fo["kv"] == [("source", "tests"), ("rows", "3000")]
    assert fo == fj
    pages = {p for c in fo["row_groups"][0]["columns"] for p, _ in c["pages"]}
    assert pages == {"DATA_PAGE_V2", "DICTIONARY_PAGE"}
    # the values, in the JAX reader, pyarrow and the port's reader
    want = t.to_pydict()
    assert jpq.read_table(ours).to_pydict() == want
    assert papq.read_table(io.BytesIO(ours)).to_pydict() == want
    assert _port_read(theirs).to_pydict() == want
    assert _port_read(ours).to_pydict() == want
    md = papq.ParquetFile(io.BytesIO(ours)).metadata
    assert md.created_by == "properties test"
    assert md.row_group(0).sorting_columns[0].nulls_first
    assert md.row_group(0).column(0).compression == "ZSTD"
    assert md.row_group(0).column(2).compression == "GZIP"
    assert not md.row_group(0).column(2).is_stats_set


def test_data_page_v2_roundtrip_and_pyarrow():
    t = _sample_table()
    blob = _write_port(t, data_page_version="2.0")
    assert _port_read(blob).to_pydict() == t.to_pydict()
    assert jpq.read_table(blob).to_pydict() == t.to_pydict()
    assert papq.read_table(io.BytesIO(blob)).to_pydict() == t.to_pydict()
    # the nested chunk is one v2 page, as the JAX writer writes it
    fo, fj = footer(blob), footer(_write_jax(t, data_page_version="2.0"))
    for a, b in zip(fo["row_groups"][0]["columns"],
                    fj["row_groups"][0]["columns"]):
        data_pages = {p for p, _ in a["pages"]} - {"DICTIONARY_PAGE"}
        assert data_pages == {"DATA_PAGE_V2"}
        assert (a["path"], a["codec"], a["num_values"]) == \
            (b["path"], b["codec"], b["num_values"])
    # pyarrow-written v2 pages read by the port
    pt = pa.table({"x": [1, None, 3], "s": ["a", "bb", None]})
    buf = io.BytesIO()
    papq.write_table(pt, buf, data_page_version="2.0")
    assert _port_read(buf.getvalue()).to_pydict() == pt.to_pydict()


def test_data_page_v2_multi_page():
    n = 5000
    t = agt.table({"x": agt.array(list(range(n)), jdt.int64)})
    kw = dict(data_page_version="2.0", data_page_size=4096,
              use_dictionary=False)
    blob = _write_port(t, **kw)
    assert _port_read(blob).column("x").to_pylist() == list(range(n))
    assert jpq.read_table(blob).column("x").to_pylist() == list(range(n))
    assert papq.read_table(
        io.BytesIO(blob)).column("x").to_pylist() == list(range(n))
    pf = tpq.ParquetFile(blob)
    assert len(list(_iter_pages(pf, pf.metadata.row_groups[0].columns[0]))) \
        > 1
    assert footer(blob) == footer(_write_jax(t, **kw))


def test_store_decimal_as_integer():
    vals = [decimal.Decimal("12345.67"), None, decimal.Decimal("-1.02")]
    t = agt.table({"d": agt.array(vals, jdt.decimal128(7, 2)),
                   "big": agt.array(vals, jdt.decimal128(15, 2))})
    blob = _write_port(t, store_decimal_as_integer=True,
                       use_dictionary=False)
    md = papq.ParquetFile(io.BytesIO(blob)).metadata
    assert md.row_group(0).column(0).physical_type == "INT32"
    assert md.row_group(0).column(1).physical_type == "INT64"
    theirs = papq.read_table(io.BytesIO(blob))
    assert theirs.column("d").to_pylist() == vals
    assert theirs.column("big").to_pylist() == vals
    assert jpq.read_table(blob).column("d").to_pylist() == vals
    assert _port_read(blob).column("d").to_pylist() == vals
    assert footer(blob, True) == footer(_write_jax(
        t, store_decimal_as_integer=True, use_dictionary=False), True)


def test_sorting_columns_metadata():
    t = agt.table({"a": [3, 1, 2], "b": ["x", "y", "z"]})
    blob = _write_port(t, sorting_columns=[(0, True, True)])
    scs = papq.ParquetFile(io.BytesIO(blob)).metadata.row_group(
        0).sorting_columns
    assert scs and scs[0].column_index == 0
    assert scs[0].descending and scs[0].nulls_first
    sc = jpq.ParquetFile(blob).metadata.row_groups[0].sorting_columns[0]
    assert (sc.column_idx, sc.descending, sc.nulls_first) == (0, True, True)
    sc = tpq.ParquetFile(blob).metadata.row_groups[0].sorting_columns[0]
    assert (sc.column_idx, sc.descending, sc.nulls_first) == (0, True, True)


def test_write_statistics_toggle():
    t = agt.table({"a": [3, 1, 2], "b": [1.0, 2.0, 3.0]})
    kw = dict(write_statistics=False, use_dictionary=False,
              column_properties={"b": {"write_statistics": True}})
    blob = _write_port(t, **kw)
    md = papq.ParquetFile(io.BytesIO(blob)).metadata
    assert not md.row_group(0).column(0).is_stats_set
    st = md.row_group(0).column(1).statistics
    assert st is not None and st.min == 1.0 and st.max == 3.0
    assert footer(blob, True) == footer(_write_jax(t, **kw), True)


def test_created_by_and_version():
    t = agt.table({"a": [1, 2]})
    kw = dict(created_by="unit-test writer", version="1.0")
    blob = _write_port(t, **kw)
    md = papq.ParquetFile(io.BytesIO(blob)).metadata
    assert md.created_by == "unit-test writer"
    assert md.format_version == "1.0"
    assert _port_read(blob).column("a").to_pylist() == [1, 2]
    assert jpq.read_table(blob).column("a").to_pylist() == [1, 2]
    fo, fj = footer(blob), footer(_write_jax(t, **kw))
    assert (fo["version"], fo["created_by"]) == (fj["version"],
                                                 fj["created_by"]) == \
        (1, "unit-test writer")


def test_compression_level():
    data = list(range(2000)) * 2
    t = agt.table({"x": agt.array(data, jdt.int64)})
    lo = _write_port(t, compression="gzip", compression_level=1,
                     use_dictionary=False)
    hi = _write_port(t, compression="gzip", compression_level=9,
                     use_dictionary=False)
    assert len(hi) <= len(lo)
    assert _port_read(hi).column("x").to_pylist() == data
    assert papq.read_table(io.BytesIO(hi)).column("x").to_pylist() == data
    assert footer(hi, True) == footer(_write_jax(
        t, compression="gzip", compression_level=9, use_dictionary=False),
        True)


def test_dictionary_pagesize_limit_fallback():
    vals = [f"string-{i}" for i in range(500)]
    t = agt.table({"s": agt.array(vals, jdt.string)})
    blob = _write_port(t, dictionary_pagesize_limit=64)
    meta = tpq.ParquetFile(blob).metadata.row_groups[0].columns[0].meta_data
    assert meta.dictionary_page_offset is None        # fell back to plain
    assert _port_read(blob).column("s").to_pylist() == vals
    assert jpq.read_table(blob).column("s").to_pylist() == vals
    assert papq.read_table(io.BytesIO(blob)).column("s").to_pylist() == vals
    assert footer(blob, True) == footer(_write_jax(
        t, dictionary_pagesize_limit=64), True)


def test_buffered_stream_reader():
    n = 3000
    t = agt.table({"x": agt.array(list(range(n)), jdt.int64),
                   "s": agt.array([f"v{i % 7}" for i in range(n)],
                                  jdt.string)})
    blob = _write_port(t, data_page_size=1024)
    props = tpq.ReaderProperties(buffer_size=37, buffered_stream=True)
    got = tpq.read_table(blob, properties=props, device="cpu")
    assert got.to_pydict() == _port_read(blob).to_pydict() == t.to_pydict()
    assert jpq.read_table(blob, properties=jpq.ReaderProperties(
        buffer_size=37, buffered_stream=True)).to_pydict() == t.to_pydict()


def test_v2_pages_with_encryption():
    key = b"0123456789012345"
    t = _sample_table()
    buf = io.BytesIO()
    tpq.write_table(_port(t), buf, properties=tpq.WriterProperties(
        data_page_version="2.0",
        encryption=tpq.FileEncryptionProperties(footer_key=key)))
    blob = buf.getvalue()
    got = tpq.read_table(blob, decryption=tpq.FileDecryptionProperties(
        footer_key=key), device="cpu")
    assert got.to_pydict() == t.to_pydict()
    assert jpq.read_table(blob, decryption=jpq.FileDecryptionProperties(
        footer_key=key)).to_pydict() == t.to_pydict()


@pytest.mark.parametrize("ndv", [100, 20000])
def test_bloom_sizes_for_an_fpp(ndv):
    """A dictionary-coded chunk's filter is sized for its distinct count
    at the fpp, as in the JAX writer, byte for byte in size."""
    vals = [f"k{i % ndv}" for i in range(max(ndv, 3000))]
    t = agt.table({"s": agt.array(vals, jdt.string)})
    for fpp in (0.01, 0.2):
        kw = dict(write_bloom_filters=True, bloom_filter_fpp=fpp,
                  dictionary_pagesize_limit=1 << 24)
        fo, fj = footer(_write_port(t, **kw)), footer(_write_jax(t, **kw))
        size = fo["row_groups"][0]["columns"][0]["bloom_bytes"]
        assert size == fj["row_groups"][0]["columns"][0]["bloom_bytes"]
        assert size > tbloom.optimal_num_blocks(ndv, fpp) * 32


def test_writer_dict_fallback_bloom_is_sized_by_distinct_count():
    """Recorded deviation: where the dictionary falls back, the JAX writer
    sizes the filter adaptively (AdaptiveBloomFilter) and the port by the
    chunk's exact distinct count; both files prune in both readers."""
    from arrow_go_tpu.parquet.bloom import optimal_num_bytes
    n = 3000
    vals = ["v" * 200 + str(i) for i in range(n)]
    t = agt.table({"s": agt.array(vals, jdt.string)})
    kw = dict(write_bloom_filters=True, dictionary_pagesize_limit=1024)
    ours, theirs = _write_port(t, **kw), _write_jax(t, **kw)
    fo, fj = footer(ours), footer(theirs)
    bo = fo["row_groups"][0]["columns"][0]["bloom_bytes"]
    bj = fj["row_groups"][0]["columns"][0]["bloom_bytes"]
    assert not fo["row_groups"][0]["columns"][0]["dictionary"]
    assert bo - 16 < optimal_num_bytes(n, 0.01) * 2 and bj < 2 * bo
    for blob in (ours, theirs):
        assert tpq.ParquetFile(blob).read_table(
            filters=[("s", "==", vals[5])], device="cpu").num_rows == n
        assert tpq.ParquetFile(blob).read_table(
            filters=[("s", "==", "absent-value")],
            device="cpu").num_rows == 0
        pf = jpq.ParquetFile(blob)
        assert pf.read_table(filters=[("s", "==", vals[5])]).num_rows == n
        assert pf.read_table(
            filters=[("s", "==", "absent-value")]).num_rows == 0


def test_numeric_dictionary_is_a_recorded_deviation():
    """The port dictionary-codes a numeric chunk under use_dictionary (as
    its keyword path always has); the JAX writer codes only binary-like
    ones.
    Everything else in the footer agrees."""
    t = agt.table({"x": agt.array([1, 2, 2, 1], jdt.int64)})
    fo = footer(_write_port(t, data_page_version="2.0"))
    fj = footer(_write_jax(t, data_page_version="2.0"))
    co, cj = fo["row_groups"][0]["columns"][0], \
        fj["row_groups"][0]["columns"][0]
    assert co["pages"] == [("DATA_PAGE_V2", "RLE_DICTIONARY"),
                           ("DICTIONARY_PAGE", "PLAIN")]
    assert cj["pages"] == [("DATA_PAGE_V2", "PLAIN")]
    for k in ("pages", "encodings", "dictionary"):
        co.pop(k), cj.pop(k)
    assert fo == fj


def test_v1_dictionary_encoding_is_a_recorded_deviation():
    """On v1 pages the dictionary data pages say PLAIN_DICTIONARY in both
    writers (v2 pages RLE_DICTIONARY); the port's chunks list RLE only
    with levels, the JAX writer's always."""
    t = agt.table({"s": agt.array(["a", "b", "a"], jdt.string)})
    fo, fj = footer(_write_port(t)), footer(_write_jax(t))
    co, cj = fo["row_groups"][0]["columns"][0], \
        fj["row_groups"][0]["columns"][0]
    assert co["pages"][0] == ("DATA_PAGE", "PLAIN_DICTIONARY")
    assert cj["pages"][0] == ("DATA_PAGE", "PLAIN_DICTIONARY")
    assert footer(_write_port(t), True) == footer(_write_jax(t), True)


def test_writer_properties_defaults_are_the_jax_ones():
    p, j = tpq.WriterProperties(), jpq.WriterProperties()
    for k in ("version", "data_page_version", "compression",
              "compression_level", "use_dictionary",
              "dictionary_pagesize_limit", "data_page_size",
              "max_row_group_length", "write_statistics", "page_index",
              "bloom", "bloom_filter_fpp", "sorting_columns",
              "store_decimal_as_integer", "per_column", "encryption"):
        assert getattr(p, k) == getattr(j, k), k
    assert p.created_by == "arrow_go_tpu_torch v0.1.0"   # names the port
    cp = {"a": {"compression": "zstd", "compression_level": 5,
                "use_dictionary": False, "encoding": "plain",
                "write_statistics": False, "bloom": True}}
    p = tpq.WriterProperties(column_properties=cp)
    j = jpq.WriterProperties(column_properties=cp)
    for name in ("a", "b"):
        for fn in ("codec_for", "level_for", "dict_for", "encoding_for",
                   "stats_for", "bloom_for"):
            assert getattr(p, fn)(name) == getattr(j, fn)(name), (name, fn)
    for bad in (dict(version="3.0"), dict(data_page_version="3.0")):
        with pytest.raises(tpq.writer.ArrowInvalid):
            tpq.WriterProperties(**bad)


def test_default_properties_write_what_the_jax_defaults_write():
    """properties=WriterProperties() against the JAX writer's defaults
    (snappy, statistics, page index, v1 pages): string and nested
    columns agree field by field, the recorded v1 deviations aside."""
    t = agt.table({"s": agt.array(["x", None, "y", "x"], jdt.string),
                   "ls": agt.array([[1], None, [], [2, 3]],
                                   jdt.list_(jdt.int32))})
    buf, jbuf = io.BytesIO(), io.BytesIO()
    tpq.write_table(_port(t), buf, properties=tpq.WriterProperties())
    jpq.write_table(t, jbuf)
    fo, fj = footer(buf.getvalue(), True), footer(jbuf.getvalue(), True)
    # the nested chunk's statistics: none from the port (a recorded
    # deviation of its nested writer)
    fj["row_groups"][0]["columns"][1]["stats"] = None
    assert fo["row_groups"][0]["columns"][0] == \
        fj["row_groups"][0]["columns"][0]
    assert {k: v for k, v in fo.items() if k != "row_groups"} == \
        {**{k: v for k, v in fj.items() if k != "row_groups"},
         "created_by": "arrow_go_tpu_torch v0.1.0"}
    pi = tpq.ParquetFile(buf.getvalue())
    assert pi.metadata.row_groups[0].columns[0].column_index_offset
    assert jpq.read_table(buf.getvalue()).to_pydict() == t.to_pydict()


def test_a_host_batch_with_metadata_and_row_groups():
    t = _flat_table(1000)
    hb = _port(t)
    hb.schema.metadata = tdt.Metadata({"k": "v", "other": "w"})
    buf = io.BytesIO()
    tpq.write_table(hb, buf, properties=tpq.WriterProperties(
        max_row_group_length=300, compression="zstd"))
    blob = buf.getvalue()
    assert [rg.num_rows for rg in tpq.ParquetFile(
        blob).metadata.row_groups] == [300, 300, 300, 100]
    assert papq.ParquetFile(io.BytesIO(blob)).schema_arrow.metadata == \
        {b"k": b"v", b"other": b"w"}
    assert jpq.read_table(blob).to_pydict() == t.to_pydict()
    assert _port_read(blob).schema.metadata.keys == ["k", "other"]


def test_properties_win_over_the_keywords():
    t = agt.table({"x": agt.array([1, 2, 3], jdt.int64)})
    buf = io.BytesIO()
    tpq.write_table(_port(t), buf, compression="gzip",
                    write_page_index=False,
                    properties=tpq.WriterProperties(compression="zstd"))
    ch = tpq.ParquetFile(buf.getvalue()).metadata.row_groups[0].columns[0]
    assert ch.meta_data.codec == fmt.Codec.ZSTD
    assert ch.column_index_offset is not None


# ---------------------------------------------------------------------------
# the keyword path keeps its bytes
# ---------------------------------------------------------------------------

def _keyword_cases():
    rng = np.random.default_rng(11)
    n = 2000
    base = {"a": np.arange(n, dtype=np.int64) % 37,
            "b": rng.random(n),
            "s": np.array([f"s{k % 13}" for k in range(n)], dtype=object)}
    masks = {"b": rng.random(n) > 0.2}
    return [
        ("snappy", base, masks, dict(compression="snappy",
                                     write_page_index=False)),
        ("zstd-delta-bloom", base, masks, dict(
            compression="zstd", data_page_size=4096,
            column_encodings={"a": "delta_binary_packed"},
            use_dictionary={"s": False}, write_bloom_filters=["s"],
            write_page_index=True, row_group_size=300)),
        ("date-plain", {"d": np.arange(n, dtype=np.int32),
                        "f": rng.random(n).astype(np.float32)}, {},
         dict(types={"d": tdt.date32}, use_dictionary=False,
              data_page_size=1000, compression="none",
              write_page_index=False)),
    ]


# sha256 of the files the writer wrote for _keyword_cases before
# WriterProperties existed (the writer's defaults of then named), but
# that v1 dictionary data pages say PLAIN_DICTIONARY, as the JAX
# writer's do: of the same length, each differing only in those enum
# bytes and the chunks' sorted encoding lists
KEYWORD_DIGESTS = {
    "snappy":
        "e31f4c4155c1cf4f084f385c80ddc9db17338c309559f251b6de55d720a5ccb0",
    "zstd-delta-bloom":
        "a1b689688bcfac881e68df8d14bbbbb274ce1410b4f9de6c1d591c205569f6d2",
    "date-plain":
        "698c39c352c7189c8a08102bb96d7e10c38838b5e1875409aa9b6e24ac765ac4",
}


@pytest.mark.parametrize("name", sorted(KEYWORD_DIGESTS))
def test_keyword_path_writes_its_old_bytes(name):
    (case,) = [c for c in _keyword_cases() if c[0] == name]
    _, data, masks, kw = case
    buf = io.BytesIO()
    tpq.write_table(data, buf, masks=masks, **kw)
    assert hashlib.sha256(buf.getvalue()).hexdigest() == \
        KEYWORD_DIGESTS[name]


# ---------------------------------------------------------------------------
# write_table's JAX parameters, by position and by name; read_row_group's
# row_range; a dictionary of numbers; the JAX bloom builder
# ---------------------------------------------------------------------------

# the JAX writer's parameters after (table, sink), in its order
JAX_ARGS = (300, "zstd", False, True, False, 4096,
            {"f": {"compression": "gzip"}, "s": {"use_dictionary": True}})
JAX_NAMES = ("row_group_size", "compression", "use_dictionary",
             "write_page_index", "write_bloom_filters", "data_page_size",
             "column_properties")


def _chunk_facts(blob) -> list:
    """Per row group: its rows and, per column, (codec, a dictionary page,
    a page index, a bloom filter)."""
    md = tpq.ParquetFile(blob).metadata
    return [(rg.num_rows, [(c.meta_data.codec,
                            c.meta_data.dictionary_page_offset is not None,
                            c.offset_index_offset is not None,
                            c.meta_data.bloom_filter_offset is not None)
                           for c in rg.columns])
            for rg in md.row_groups]


def test_write_table_binds_the_jax_arguments_positionally():
    t = _flat_table(1000)
    jbuf, pbuf, kbuf = io.BytesIO(), io.BytesIO(), io.BytesIO()
    t = agt.table({k: t.column(k) for k in ("id", "price", "name")})
    t = agt.table({"id": t.column("id"), "f": t.column("price"),
                   "s": t.column("name")})
    jpq.write_table(t, jbuf, *JAX_ARGS)
    tpq.write_table(_port(t), pbuf, *JAX_ARGS)
    tpq.write_table(_port(t), kbuf, **dict(zip(JAX_NAMES, JAX_ARGS)))
    assert pbuf.getvalue() == kbuf.getvalue()
    facts = _chunk_facts(pbuf.getvalue())
    assert facts == _chunk_facts(jbuf.getvalue())
    assert [rows for rows, _ in facts] == [300, 300, 300, 100]
    assert facts[0][1][1][0] == int(fmt.Codec.GZIP)
    assert facts[0][1][0][0] == int(fmt.Codec.ZSTD)
    want = jpq.read_table(jbuf.getvalue()).to_pydict()
    assert jpq.read_table(pbuf.getvalue()).to_pydict() == want
    assert _port_read(pbuf.getvalue()).to_pydict() == want


@pytest.mark.parametrize("props", [
    {"f": {"compression": "gzip", "compression_level": 9}},
    {"id": {"encoding": "delta_binary_packed"}, "s": {"compression": "zstd",
                                                      "use_dictionary": False}},
    {"id": {"write_statistics": False}, "f": {"use_dictionary": False}},
])
def test_column_properties_write_what_the_jax_writer_writes(props):
    """tests/test_parquet.py::test_multi_page_and_column_properties and
    the delta encoders' cases, with the JAX keyword."""
    t = _flat_table(2000)
    t = agt.table({"id": t.column("id"), "f": t.column("price"),
                   "s": t.column("name")})
    jbuf, pbuf = io.BytesIO(), io.BytesIO()
    jpq.write_table(t, jbuf, data_page_size=4096, write_page_index=False,
                    column_properties=props)
    tpq.write_table(_port(t), pbuf, compression="snappy",
                    data_page_size=4096, column_properties=props)
    fp, fj = footer(pbuf.getvalue(), True), footer(jbuf.getvalue(), True)
    for cp, cj in zip(fp["row_groups"][0]["columns"],
                      fj["row_groups"][0]["columns"]):
        assert (cp["codec"], cp["stats"] is None) == \
            (cj["codec"], cj["stats"] is None), cp["path"]
        named = props.get(cp["path"][0], {})
        # a numeric chunk the properties leave alone is dictionary-coded
        # by the port (test_numeric_dictionary_is_a_recorded_deviation)
        if "encoding" in named or named.get("use_dictionary") is False:
            assert (cp["pages"], cp["dictionary"]) == \
                (cj["pages"], cj["dictionary"]), cp["path"]
    want = jpq.read_table(jbuf.getvalue()).to_pydict()
    assert jpq.read_table(pbuf.getvalue()).to_pydict() == want
    assert _port_read(pbuf.getvalue()).to_pydict() == want
    assert pa.table(papq.read_table(io.BytesIO(pbuf.getvalue()))) \
        .to_pydict() == want


def test_the_by_name_keywords_win_over_column_properties():
    data = {"a": np.arange(100, dtype=np.int64),
            "b": np.arange(100, dtype=np.int64)}
    buf = io.BytesIO()
    tpq.write_table(data, buf, column_properties={
        "a": {"encoding": "plain", "compression": "zstd"},
        "b": {"use_dictionary": True}},
        column_encodings={"a": "delta_binary_packed"},
        use_dictionary={"b": False})
    pf = tpq.ParquetFile(buf.getvalue())
    a, b = (c.meta_data for c in pf.metadata.row_groups[0].columns)
    assert int(fmt.Encoding.DELTA_BINARY_PACKED) in a.encodings
    assert a.codec == int(fmt.Codec.ZSTD)
    assert b.dictionary_page_offset is None


@pytest.mark.parametrize("row_range", [(0, 10), (17, 283), (290, 10),
                                       (0, 300), (299, 1)])
@pytest.mark.parametrize("columns", [None, ["name", "id"]])
def test_read_row_group_row_range_matches_jax(row_range, columns):
    t = _flat_table(1000)
    buf = io.BytesIO()
    jpq.write_table(t, buf, row_group_size=300)
    blob = buf.getvalue()
    jf, tf = jpq.ParquetFile(blob), tpq.ParquetFile(blob)
    for i in (0, 2):
        want = jf.read_row_group(i, columns, row_range)
        got = tf.read_row_group(i, columns, row_range, device="cpu")
        assert got.num_rows == want.num_rows == row_range[1]
        assert got.to_pydict() == want.to_pydict()
        assert tf.read_row_group(i, columns=columns, row_range=row_range,
                                 use_threads=False, device="cpu"
                                 ).to_pydict() == want.to_pydict()


def test_read_rows_spans_row_groups_through_row_range():
    t = _flat_table(1000)
    buf = io.BytesIO()
    jpq.write_table(t, buf, row_group_size=300)
    tf = tpq.ParquetFile(buf.getvalue())
    got = tf.read_rows(250, 400, device="cpu").to_pydict()
    assert got == t.slice(250, 400).to_pydict()


@pytest.mark.parametrize("index", ["int16", "int8", "int32"])
@pytest.mark.parametrize("value", ["int64", "float64", "int32"])
def test_a_dictionary_of_numbers_round_trips_as_jax(index, value):
    """tests/test_fuzz_roundtrips.py::test_canonical_parquet_roundtrip
    [dictionary]: the JAX writer writes the value type."""
    import arrow_go_tpu_torch as tagt
    vals = [7, 9, 7, None, 9, 11] if value != "float64" else \
        [7.5, 9.0, 7.5, None, 9.0, -1.25]
    jt = agt.table({"d": agt.array(vals, jdt.dictionary(
        getattr(jdt, index), getattr(jdt, value)))})
    tt = tagt.table({"d": tagt.array(vals, tdt.dictionary(
        getattr(tdt, index), getattr(tdt, value)))})
    jbuf, pbuf = io.BytesIO(), io.BytesIO()
    jpq.write_table(jt, jbuf)
    tpq.write_table(tt, pbuf)
    want = jpq.read_table(jbuf.getvalue())
    assert want.to_pydict() == {"d": vals}
    for blob in (jbuf.getvalue(), pbuf.getvalue()):
        assert jpq.read_table(blob).to_pydict() == {"d": vals}
        got = _port_read(blob)
        assert got.to_pydict() == {"d": vals}
        assert str(got.schema.field(0).type) == str(want.schema.field(0).type)
    assert papq.read_table(io.BytesIO(pbuf.getvalue())).to_pydict() == \
        {"d": vals}


def test_a_nested_dictionary_of_numbers_round_trips_as_jax():
    import arrow_go_tpu_torch as tagt
    vals = [{"d": 7}, {"d": 9}, None, {"d": None}]
    jt = agt.table({"s": agt.array(vals, jdt.struct([jdt.Field(
        "d", jdt.dictionary(jdt.int16, jdt.int64))]))})
    tt = tagt.table({"s": tagt.array(vals, tdt.struct([tdt.Field(
        "d", tdt.dictionary(tdt.int16, tdt.int64))]))})
    jbuf, pbuf = io.BytesIO(), io.BytesIO()
    jpq.write_table(jt, jbuf)
    tpq.write_table(tt, pbuf)
    for blob in (jbuf.getvalue(), pbuf.getvalue()):
        assert jpq.read_table(blob).to_pydict() == {"s": vals}
        assert _port_read(blob).to_pydict() == {"s": vals}


@pytest.mark.parametrize("phys,values", [
    ("INT32", list(range(-50, 50))), ("INT64", [1 << 40, 3, 3, -7]),
    ("DOUBLE", [0.5, -1.25, 0.5, 1e300]), ("FLOAT", [0.5, 2.0]),
    ("BYTE_ARRAY", [b"a", b"", b"xyz", b"a"]),
    ("BYTE_ARRAY", ["text", "", "text", "ünï"]),
    ("FIXED_LEN_BYTE_ARRAY", [b"abcd", b"wxyz"])])
@pytest.mark.parametrize("fpp", [0.01, 0.1])
def test_build_bloom_filter_takes_values_as_jax(phys, values, fpp):
    from arrow_go_tpu.parquet import bloom as jbloom
    from arrow_go_tpu.parquet import format as jfmt
    got = tbloom.build_bloom_filter(values, getattr(fmt.Type, phys), fpp)
    want = jbloom.build_bloom_filter(values, getattr(jfmt.Type, phys), fpp)
    np.testing.assert_array_equal(got.blocks, want.blocks)
    assert all(got.check(v, getattr(fmt.Type, phys)) for v in values)


def test_the_encoding_helpers_take_the_jax_arguments():
    from arrow_go_tpu.parquet import encodings as je
    from arrow_go_tpu.parquet import format as jfmt
    from arrow_go_tpu_torch.parquet import encodings as te
    rows = [b"abcd", b"wxyz", b"0123"]
    blob = je.plain_encode(jfmt.Type.FIXED_LEN_BYTE_ARRAY, rows, 4)
    assert te.plain_encode(fmt.Type.FIXED_LEN_BYTE_ARRAY, rows,
                           type_length=4) == blob
    assert te.plain_decode(fmt.Type.FIXED_LEN_BYTE_ARRAY, blob, 3,
                           type_length=4) == \
        je.plain_decode(jfmt.Type.FIXED_LEN_BYTE_ARRAY, blob, 3, 4) == rows
    i96 = np.arange(24, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(
        te.plain_decode(fmt.Type.INT96, i96, 2),
        je.plain_decode(jfmt.Type.INT96, i96, 2))
    raw = np.arange(30, dtype=np.uint8).reshape(10, 3)
    enc = je.byte_stream_split_encode(raw)
    assert te.byte_stream_split_encode(raw=raw) == enc
    np.testing.assert_array_equal(
        te.byte_stream_split_decode(enc, 10, byte_width=3),
        je.byte_stream_split_decode(enc, 10, byte_width=3))
