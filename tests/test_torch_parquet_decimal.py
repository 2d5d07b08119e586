"""Decimal, FIXED_LEN_BYTE_ARRAY, FLOAT16 and INT96 parquet columns, both
ways, and decimal TPC-H Q6 and Q1 as a whole.

Files the JAX writer writes (decimal128 / decimal256 as FLBA, decimal32 /
decimal64 as INT32 / INT64, float16, fixed_size_binary; dictionary and
PLAIN-fallback chunks; v1 and v2 pages, snappy) read by the port's
`read_batch_device` on the CPU must give what the JAX package's host
read followed by `to_device` gives (its device read raises on these
types). Files the port's writer writes (with `types=`,
`store_decimal_as_integer`, INT96 timestamps, and FLBA chunks that fall
back from dictionary to PLAIN pages part way) must read back through the
JAX reader. A hand-built FLBA decimal of every byte length (pyarrow
writes 7 bytes for precision 15) reads as the JAX host reader reads it.
Then decimal Q6 over the FLBA bytes and decimal Q1 over INT64 bytes, in
both packages."""
import decimal
import io

import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.array.builders import DictionaryBuilder
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import kernels as jk
from arrow_go_tpu.compute.groupby import group_by as jgroup_by
from arrow_go_tpu.device.block import batch_to_device as jbatch_to_device
from arrow_go_tpu.device.block import from_device, to_device

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.device.block import column_to_host
from arrow_go_tpu_torch.ops import decimal as tdec
from arrow_go_tpu_torch.parquet import format as fmt
from arrow_go_tpu_torch.parquet import schema as psch
from arrow_go_tpu_torch.parquet import writer as pw
from test_torch_decimal import _same
from torch_parity import jax_type

D = decimal.Decimal
N = 3000


def _same_fixed(got, want) -> None:
    """A fixed_size_binary column: the same codes (valid rows), validity
    and dictionary of bytes."""
    assert str(got.type.value_type) == str(want.type.value_type)
    assert got.length == want.length and got.padded == want.padded
    n = want.length
    ok = np.asarray(want.validity_mask())[:n]
    np.testing.assert_array_equal(got.validity_mask()[:n].numpy(), ok)
    np.testing.assert_array_equal(got.values[:n].numpy()[ok],
                                  np.asarray(want.values)[:n][ok])
    assert list(got.dict_values) == want.dictionary.to_pylist()


def _same_read(got, want) -> None:
    """A column read from bytes against the JAX host read + to_device:
    the same type, padding, valid rows and their values, bit for bit (a
    nullable leaf without nulls keeps its validity words in the port's
    device read, where `to_device` drops them)."""
    if got.dict_values is not None:
        _same_fixed(got, want)
        return
    if want.validity is None and got.validity is not None:
        assert bool(got.validity_mask()[:got.length].all())
        got = type(got)(got.values, None, got.length, got.type)
    _same(got, want)


def _unscaled(rng, n, digits, pool=None):
    """n unscaled values of up to `digits` digits, as an int64 array (an
    object array of Python ints past 18 digits)."""
    if digits <= 18:
        v = rng.integers(-10**digits, 10**digits, n)
    else:
        v = np.zeros(n, object)
        for i in range(0, digits, 18):
            v = v + rng.integers(0, 10**18, n).astype(object) * 10**i
        v = v % 10**digits * rng.choice([-1, 1], n)
    v[:3] = [0, -1, 10**digits - 1]
    return v if pool is None else rng.choice(v[:pool], n)


def _jax_decimal(ints, mask, t):
    return agt.array([D(int(u)).scaleb(-t.scale) if ok else None
                      for u, ok in zip(ints, mask)], type=jax_type(t))


def _jax_table(rng, dictionary: bool):
    """The JAX arrays: every decimal width, float16, fixed_size_binary;
    with `dictionary`, dictionary<decimal128> and dictionary<fsb> arrays
    (the JAX writer codes only those)."""
    cols = {}
    specs = {"d128": (dt.decimal128(15, 2), 15), "d256": (dt.decimal256(45, 3),
                                                          40),
             "d32": (dt.decimal32(7, 2), 6), "d64": (dt.decimal64(15, 2), 14)}
    for name, (t, digits) in specs.items():
        mask = rng.random(N) < 0.9
        cols[name] = _jax_decimal(_unscaled(rng, N, digits, 60), mask, t)
    mask = rng.random(N) < 0.9
    h = rng.standard_normal(N).astype(np.float16)
    cols["f16"] = agt.from_numpy(h, mask)
    rows = rng.integers(0, 3, (N, 12)).astype(np.uint8)
    cols["fsb"] = agt.array([r.tobytes() if ok else None
                             for r, ok in zip(rows, mask)],
                            type=jdt.fixed_size_binary(12))
    if dictionary:
        for name, src in (("dd", "d128"), ("dfsb", "fsb")):
            b = DictionaryBuilder(jdt.dictionary(jdt.int32, cols[src].type))
            for v in cols[src].to_pylist():
                b.append_null() if v is None else b.append(v)
            cols[name] = b.finish()
    return cols


@pytest.mark.parametrize("dict_limit", [1 << 20, 256], ids=["dict", "fell"])
@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_jax_file_reads_as_the_jax_host_read(compression, version,
                                             dict_limit):
    cols = _jax_table(np.random.default_rng(41), True)
    buf = io.BytesIO()
    jpq.write_table(agt.table(cols), buf, properties=jpq.WriterProperties(
        compression=compression, data_page_version=version,
        data_page_size=4096, dictionary_pagesize_limit=dict_limit))
    blob = buf.getvalue()
    jt = jpq.read_table(io.BytesIO(blob))
    tdb = tpq.read_batch_device(tpq.ParquetFile(blob), 0, device="cpu")
    for name in cols:
        want = to_device(jt.column(name).combine())
        got = tdb.column(name)
        _same_read(got, want)
        assert column_to_host(got).to_pylist() == \
            jt.column(name).combine().to_pylist()


@pytest.mark.parametrize("store_as_integer", [False, True])
def test_jax_store_decimal_as_integer_reads_alike(store_as_integer):
    rng = np.random.default_rng(42)
    cols = {"a": _jax_decimal(_unscaled(rng, N, 15), rng.random(N) < 0.9,
                              dt.decimal128(15, 2)),
            "b": _jax_decimal(_unscaled(rng, N, 8), np.ones(N, bool),
                              dt.decimal128(9, 4))}
    buf = io.BytesIO()
    jpq.write_table(agt.table(cols), buf, properties=jpq.WriterProperties(
        store_decimal_as_integer=store_as_integer))
    blob = buf.getvalue()
    jt = jpq.read_table(io.BytesIO(blob))
    tdb = tpq.read_batch_device(tpq.ParquetFile(blob), 0, device="cpu")
    for name in cols:
        _same_read(tdb.column(name), to_device(jt.column(name).combine()))


def _port_columns(rng):
    """(data, masks, types) for the port's writer: unscaled ints, limbs
    of full width, float16, fixed_size_binary rows, an INT96 timestamp."""
    data = {"p": _unscaled(rng, N, 15, 200),
            "w": tdec.from_ints([int(x) * 10**55 + 7
                                 for x in _unscaled(rng, N, 15)], 4),
            "q": _unscaled(rng, N, 15),
            "s": (_unscaled(rng, N, 8) % 10**8).astype(np.int32),
            "h": rng.standard_normal(N).astype(np.float16),
            "f": rng.integers(0, 4, (N, 12)).astype(np.uint8),
            "t": rng.integers(-10**18, 10**18, N)}
    types = {"p": dt.decimal128(15, 2), "w": dt.decimal256(76, 4),
             "q": dt.decimal64(15, 2), "s": dt.decimal32(9, 3),
             "h": dt.float16, "f": dt.fixed_size_binary(12),
             "t": dt.timestamp("ns")}
    masks = {k: rng.random(N) < 0.9 for k in ("p", "w", "h", "f")}
    return data, masks, types


def _want_values(v, mask, t):
    if t.is_decimal:
        ints = tdec.to_ints(v).tolist() if v.ndim == 2 else v.tolist()
        vals = [D(int(u)).scaleb(-t.scale, decimal.Context(prec=80))
                for u in ints]
    elif v.ndim == 2:
        vals = [r.tobytes() for r in v]
    else:
        vals = v.tolist()
    return [x if mask is None or ok else None
            for x, ok in zip(vals, mask if mask is not None
                             else [True] * len(vals))]


@pytest.mark.parametrize("store_as_integer", [False, True])
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_port_file_reads_in_jax(compression, store_as_integer):
    data, masks, types = _port_columns(np.random.default_rng(43))
    buf = io.BytesIO()
    tpq.write_table(data, buf, masks=masks, types=types,
                    compression=compression, data_page_size=2048,
                    dictionary_pagesize_limit=1024, int96_timestamps=True,
                    store_decimal_as_integer=store_as_integer)
    blob = buf.getvalue()
    jt = jpq.read_table(io.BytesIO(blob))
    tdb = tpq.read_batch_device(tpq.ParquetFile(blob), 0, device="cpu")
    for name, t in types.items():
        want = _want_values(data[name], masks.get(name), t)
        got_j = jt.column(name).combine().to_pylist()
        got_t = column_to_host(tdb.column(name)).to_pylist()
        if name == "h":
            want = [None if x is None else float(x) for x in want]
        assert got_j == want, name
        assert got_t == want, name
        if store_as_integer and name == "p":
            assert str(tdb.column(name).type) == "decimal64(15, 2)"
        elif name != "f":
            assert str(tdb.column(name).type) == str(t)
        if name != "f":
            _same_read(tdb.column(name), to_device(jt.column(name).combine()))
        else:
            _same_fixed(tdb.column(name), to_device(jt.column(name).combine()))


def test_fixed_chunk_falls_back_to_plain_part_way():
    """The FLBA chunk of 200 distinct 16-byte decimals passes a 1 KiB
    dictionary in its first pages: those stay dictionary coded, the rest
    are PLAIN, and the column reads the same in both packages."""
    data, masks, types = _port_columns(np.random.default_rng(44))
    buf = io.BytesIO()
    tpq.write_table({"p": data["p"]}, buf, masks={"p": masks["p"]},
                    types={"p": types["p"]}, data_page_size=1024,
                    dictionary_pagesize_limit=1024)
    blob = buf.getvalue()
    pf = tpq.ParquetFile(blob)
    from arrow_go_tpu_torch.parquet.device_read import _iter_pages
    chunk = pf.metadata.row_groups[0].columns[0]
    kinds = []
    for hdr, _ in _iter_pages(pf, chunk):
        if hdr.data_page_header is not None:
            kinds.append(fmt.Encoding(hdr.data_page_header.encoding))
    assert kinds[0] == fmt.Encoding.PLAIN_DICTIONARY       # v1 pages
    assert kinds[-1] == fmt.Encoding.PLAIN
    assert set(kinds) == {fmt.Encoding.PLAIN_DICTIONARY, fmt.Encoding.PLAIN}
    jt = jpq.read_table(io.BytesIO(blob))
    got = tpq.read_batch_device(pf, 0, device="cpu").column("p")
    _same_read(got, to_device(jt.column("p").combine()))
    assert column_to_host(got).to_pylist() == _want_values(
        data["p"], masks["p"], types["p"])


@pytest.mark.parametrize("type_length,precision", [
    (1, 2), (5, 11), (7, 15), (8, 18), (9, 20), (16, 38), (20, 45),
    (32, 76)])
@pytest.mark.parametrize("use_dictionary", [False, True])
def test_hand_built_fixed_length_decimal(type_length, precision,
                                         use_dictionary):
    """A FLBA DECIMAL column of `type_length` big-endian bytes, as other
    writers size it (pyarrow: 7 bytes for precision 15), sign-extended
    to the limbs on the device."""
    rng = np.random.default_rng(45 + type_length)
    n = 700
    top = 1 << (8 * type_length - 1)
    ints = [int(x) for x in rng.integers(-2**62, 2**62, n)]
    ints = [x % (2 * top) - top for x in ints]
    ints[:4] = [0, -1, top - 1, -top]
    if use_dictionary:
        ints = [ints[i % 50] for i in range(n)]
    mask = rng.random(n) < 0.9
    rows = np.array([list(x.to_bytes(type_length, "big", signed=True))
                     for x in ints], np.uint8)
    t = psch._decimal_for(fmt.SchemaElement(
        name="d", type=int(fmt.Type.FIXED_LEN_BYTE_ARRAY)), precision, 2)
    el = fmt.SchemaElement(
        name="d", type=int(fmt.Type.FIXED_LEN_BYTE_ARRAY),
        type_length=type_length,
        repetition_type=int(fmt.Repetition.OPTIONAL),
        converted_type=int(fmt.ConvertedType.DECIMAL), scale=2,
        precision=precision)
    root = fmt.SchemaElement(name="schema", num_children=1)
    desc = psch.ColumnDescriptor(("d",), fmt.Type.FIXED_LEN_BYTE_ARRAY,
                                 type_length, 1, 0, t, [el])
    buf = io.BytesIO()
    opts = pw._Options(codec=0, level=None, use_dictionary=use_dictionary,
                       dict_limit=1 << 20, data_page_size=2048,
                       statistics=True, bloom=False)
    pw._write(buf, {"d": (rows, None)}, {"d": mask}, [root, el], [desc], n,
              {"d": opts}, None, {})
    blob = buf.getvalue()
    jt = jpq.read_table(io.BytesIO(blob))
    got = tpq.read_batch_device(tpq.ParquetFile(blob), 0, device="cpu")
    want = [D(x).scaleb(-2, decimal.Context(prec=80)) if ok else None
            for x, ok in zip(ints, mask)]
    assert jt.column("d").combine().to_pylist() == want
    assert column_to_host(got.column("d")).to_pylist() == want
    _same_read(got.column("d"), to_device(jt.column("d").combine()))


def test_int96_reads_as_the_jax_host_read():
    """INT96 (nanoseconds of the day, Julian day) becomes
    timestamp("ns"): (day - 2440588) * 86400e9 + nanos, as the JAX
    host reader computes it."""
    rng = np.random.default_rng(46)
    ts = rng.integers(-4 * 10**18, 4 * 10**18, N)
    ts[:3] = [0, -1, 86_400 * 10**9]
    mask = rng.random(N) < 0.9
    buf = io.BytesIO()
    tpq.write_table({"t": ts}, buf, masks={"t": mask},
                    types={"t": dt.timestamp("ns")}, int96_timestamps=True,
                    data_page_size=4096, compression="snappy")
    blob = buf.getvalue()
    pf = tpq.ParquetFile(blob)
    assert pf.leaves[0].physical_type == fmt.Type.INT96
    jt = jpq.read_table(io.BytesIO(blob))
    got = tpq.read_batch_device(pf, 0, device="cpu").column("t")
    assert str(got.type) == "timestamp[ns]"
    want = to_device(jt.column("t").combine())
    assert column_to_host(got).to_pylist() == [
        int(x) if ok else None for x, ok in zip(ts, mask)]
    n = want.length
    ok = np.asarray(want.validity_mask())[:n]
    np.testing.assert_array_equal(got.values[:n].numpy()[ok],
                                  np.asarray(want.values)[:n][ok])


# ---------------------------------------------------------------------------
# the slice as a whole: decimal Q6 and Q1
# ---------------------------------------------------------------------------

def _lineitem(rng, n=4000):
    """TPC-H-shaped lineitem columns as unscaled ints (cents)."""
    return {
        "l_sdate": rng.integers(8036, 10561, n).astype(np.int32),
        "l_qty": rng.integers(1, 51, n) * 100,
        "l_price": rng.integers(90_000, 10_500_000, n),
        "l_disc": rng.integers(0, 11, n),
        "l_tax": rng.integers(0, 9, n),
        "l_rflag": rng.choice(np.array(["A", "N", "R"], object), n),
        "l_lstatus": rng.choice(np.array(["F", "O"], object), n),
    }


def test_decimal_q6_matches_jax():
    li = _lineitem(np.random.default_rng(47))
    money = dt.decimal128(15, 2)
    buf = io.BytesIO()
    tpq.write_table({k: li[k] for k in ("l_sdate", "l_qty", "l_price",
                                        "l_disc")}, buf,
                    types={"l_sdate": dt.date32, "l_qty": money,
                           "l_price": money, "l_disc": money},
                    compression="snappy", data_page_size=8192,
                    dictionary_pagesize_limit=4096)
    blob = buf.getvalue()
    tdb = tpq.read_batch_device(tpq.ParquetFile(blob), 0, device="cpu")
    lo, hi = 8766, 9131                            # 1994-01-01, 1995-01-01

    def pred(k, col):
        m = k.boolean_binary("and", k.compare("greater_equal",
                                              col("l_sdate"), lo),
                             k.compare("less", col("l_sdate"), hi))
        m = k.boolean_binary("and", m, k.compare(
            "greater_equal", col("l_disc"), D("0.05")))
        m = k.boolean_binary("and", m, k.compare(
            "less_equal", col("l_disc"), D("0.07")))
        return k.boolean_binary("and", m, k.compare("less", col("l_qty"),
                                                     24))

    tmask = pred(pc, tdb.column)
    kept = pc.filter(tdb, tmask)
    trev = pc.arithmetic_binary("multiply", kept.column("l_price"),
                                kept.column("l_disc"))
    jt = jpq.read_table(io.BytesIO(blob))
    jcols = {k: to_device(jt.column(k).combine()) for k in jt.schema.names}
    jmask = pred(jk, jcols.get)
    jp, jd = (jf.filter_(from_device(jcols[k]), from_device(jmask))
              for k in ("l_price", "l_disc"))
    jrev = jk.arithmetic_binary("multiply", to_device(jp), to_device(jd))
    _same(trev, jrev)
    keep = ((li["l_sdate"] >= lo) & (li["l_sdate"] < hi) & (li["l_disc"] >= 5)
            & (li["l_disc"] <= 7) & (li["l_qty"] < 2400))
    assert kept.length == int(keep.sum())
    ints = tdec.to_ints(trev.values[:kept.length].numpy())
    assert ints.tolist() == (li["l_price"][keep] * li["l_disc"][keep]
                             ).tolist()
    assert str(trev.type) == "decimal128(31, 4)"


def test_decimal_q1_matches_jax():
    li = _lineitem(np.random.default_rng(48))
    money = dt.decimal64(15, 2)
    names = ("l_rflag", "l_lstatus", "l_qty", "l_price", "l_disc", "l_tax")
    buf = io.BytesIO()
    tpq.write_table({k: li[k] for k in names}, buf,
                    types={k: money for k in names[2:]},
                    compression="snappy", data_page_size=8192)
    blob = buf.getvalue()
    tdb = tpq.read_batch_device(tpq.ParquetFile(blob), 0, device="cpu")
    aggs = [(c, a) for c in names[2:] for a in ("sum", "min", "max",
                                                "count")]
    got = pc.group_by(tdb, ["l_rflag", "l_lstatus"], aggs)
    jt = jpq.read_table(io.BytesIO(blob))
    rb = agt.record_batch({k: jt.column(k).combine() for k in names})
    want = jgroup_by(jbatch_to_device(rb), ["l_rflag", "l_lstatus"], aggs)
    assert [str(getattr(f.type, "value_type", f.type))
            for f in got.schema.fields] == [
        str(getattr(f.type, "value_type", f.type))
        for f in want.schema.fields]
    assert got.to_pydict() == want.to_pydict()
    # and the sums against numpy's int64 sums of the unscaled values
    g = got.to_pydict()
    for r, (flag, status) in enumerate(zip(g["l_rflag"], g["l_lstatus"])):
        sel = (li["l_rflag"] == flag) & (li["l_lstatus"] == status)
        for c in names[2:]:
            assert g[f"{c}_sum"][r] == D(int(li[c][sel].sum())).scaleb(-2)
    assert pc.agg_sum(tdb.column("l_price")) == int(li["l_price"].sum())


@pytest.mark.parametrize("width", [1, 5, 8, 12, 16, 20])
def test_fixed_size_codes_match_the_jax_row_codes(width):
    """ops/decode.fixed_size_codes (a sort of each row's big-endian
    words) gives the codes and dictionary of the JAX package's
    np.unique over the rows, null rows as zero bytes."""
    from arrow_go_tpu_torch.ops import decode as dd
    rng = np.random.default_rng(49 + width)
    rows = rng.integers(0, 3, (2000, width)).astype(np.uint8)
    rows[:3] = np.array([255, 128, 127], np.uint8)[:, None]  # unsigned
    present = rng.random(2000) < 0.9
    jarr = agt.array([r.tobytes() if ok else None
                      for r, ok in zip(rows, present)],
                     type=jdt.fixed_size_binary(width))
    want = to_device(jarr)
    codes, dictionary = dd.fixed_size_codes(torch.from_numpy(rows),
                                            torch.from_numpy(present))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(want.values)[:2000])
    assert list(dictionary) == want.dictionary.to_pylist()


def test_fixed_length_page_of_another_encoding_raises():
    """A FLBA page in BYTE_STREAM_SPLIT decodes on the device to the JAX
    read_table's values; one in an encoding neither package reads for
    FLBA (RLE, rewritten into the page header) raises in both."""
    rng = np.random.default_rng(50)
    buf = io.BytesIO()
    tpq.write_table({"p": _unscaled(rng, 100, 10)}, buf,
                    types={"p": dt.decimal128(15, 2)}, use_dictionary=False,
                    column_encodings={"p": "byte_stream_split"})
    blob = bytearray(buf.getvalue())
    got = column_to_host(tpq.read_batch_device(
        tpq.ParquetFile(bytes(blob)), 0, device="cpu").column("p"))
    assert got.to_pylist() == jpq.read_table(bytes(blob)).column(
        0).to_pylist()
    pf = tpq.ParquetFile(bytes(blob))
    from arrow_go_tpu_torch.parquet.device_read import _iter_pages
    (hdr, _), = list(_iter_pages(pf, pf.metadata.row_groups[0].columns[0]))
    assert hdr.data_page_header.encoding == int(
        fmt.Encoding.BYTE_STREAM_SPLIT)
    # rewrite the one data page's encoding field (BYTE_STREAM_SPLIT, 9)
    # as RLE (3) in its thrift header
    from arrow_go_tpu_torch.parquet.thrift import CompactWriter
    old = CompactWriter()
    old.write_struct(hdr)
    hdr.data_page_header.encoding = int(fmt.Encoding.RLE)
    w = CompactWriter()
    w.write_struct(hdr)
    start = pf.metadata.row_groups[0].columns[0].meta_data.data_page_offset
    assert len(old.out) == len(w.out)
    blob[start:start + len(w.out)] = w.out
    with pytest.raises(pc.ArrowNotImplemented):
        tpq.read_batch_device(tpq.ParquetFile(bytes(blob)), 0, device="cpu")
    with pytest.raises(Exception, match="RLE"):
        jpq.read_table(bytes(blob))
