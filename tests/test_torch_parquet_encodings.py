"""The parquet encodings other writers use, through the port and the JAX
package on the CPU.

Files pyarrow writes (every physical type against every encoding it
writes for it, data page v1 and v2, with and without nulls, flat and
`list<...>`; a struct and a map with a FIXED_LEN_BYTE_ARRAY leaf; a
list of INT96 timestamps; DELTA_BINARY_PACKED at miniblock widths up to
64) read by the port's `read_table(..., device="cpu")` must give what
the JAX package's `read_table` gives (torch_parity.same_table). The
port's writer writes BYTE_STREAM_SPLIT and FIXED_LEN_BYTE_ARRAY
DELTA_BYTE_ARRAY pages with the JAX writer's value bytes, and nested
FIXED_LEN_BYTE_ARRAY, decimal and INT96 leaves that the JAX reader and
pyarrow read back. The ops-level decodes (DELTA past 32 bits, the
BYTE_STREAM_SPLIT rows of any width) are held against the JAX host
decodes, and a dataset of pyarrow v2 files scans.
"""
import decimal
import io
import zlib

import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.dataset import dataset as jdataset
from arrow_go_tpu.parquet import encodings as jenc

from arrow_go_tpu_torch import dataset as tds
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.compute.errors import (ArrowInvalid,
                                               ArrowNotImplemented)
from arrow_go_tpu_torch.ops import decode as tdd
from arrow_go_tpu_torch.parquet import device_read as tdr
from arrow_go_tpu_torch.parquet import encodings as tenc
from arrow_go_tpu_torch.parquet import format as fmt
from torch_parity import port_record_batch, same_table

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

N = 1500
D = decimal.Decimal

# (kind, the encodings pyarrow writes for its physical type)
MATRIX = [("bool", ["PLAIN", "RLE"]),
          ("int32", ["PLAIN", "DELTA_BINARY_PACKED", "BYTE_STREAM_SPLIT"]),
          ("int64", ["PLAIN", "DELTA_BINARY_PACKED", "BYTE_STREAM_SPLIT"]),
          ("float", ["PLAIN", "BYTE_STREAM_SPLIT"]),
          ("double", ["PLAIN", "BYTE_STREAM_SPLIT"])] + [
    (k, ["PLAIN", "BYTE_STREAM_SPLIT", "DELTA_BYTE_ARRAY"])
    for k in ("decimal128(20,2)", "decimal128(15,2)", "float16",
              "fixed_size_binary(6)")]
CASES = [(k, e) for k, encs in MATRIX for e in encs]


def _values(kind: str, n: int, rng) -> "pa.Array":
    """n seeded values of `kind` as a pyarrow array (no nulls)."""
    if kind == "bool":
        return pa.array(rng.random(n) < 0.3)
    if kind == "int32":
        return pa.array(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                        .astype(np.int32))
    if kind == "int64":
        return pa.array(np.cumsum(rng.integers(-2 ** 40, 2 ** 40, n)))
    if kind == "float":
        return pa.array(rng.standard_normal(n).astype(np.float32))
    if kind == "double":
        return pa.array(rng.standard_normal(n) * 1e6)
    if kind == "float16":
        return pa.array(rng.standard_normal(n).astype(np.float16))
    if kind.startswith("decimal128"):
        p = int(kind[11:13])
        lim = 10 ** (p - 1)
        ints = rng.integers(-lim, lim, n) if p <= 18 else [
            int(a) * 10 ** 9 + int(b) for a, b in zip(
                rng.integers(-10 ** 10, 10 ** 10, n),
                rng.integers(0, 10 ** 9, n))]
        return pa.array([D(int(v)).scaleb(-2) for v in ints],
                        pa.decimal128(p, 2))
    # fixed_size_binary(6): few distinct rows, so prefixes repeat
    rows = rng.integers(0, 3, (n, 6), dtype=np.uint8)
    return pa.array([r.tobytes() for r in rows], pa.binary(6))


def _column(kind: str, rng, nulls: bool, nested: bool) -> "pa.Array":
    a = _values(kind, N, rng)
    if nulls:
        a = pa.array(a.to_pylist(), a.type, mask=rng.random(N) < 0.15)
    if nested:
        cuts = np.sort(rng.integers(0, N, N // 4 - 1))
        off = np.concatenate([[0], cuts, [N]]).astype(np.int32)
        valid = rng.random(len(off) - 1) >= 0.1 if nulls else None
        a = pa.ListArray.from_arrays(
            pa.array(off, mask=None if valid is None else np.concatenate(
                [~valid, [False]])), a)
    return a


def _pyarrow_file(table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


def _encodings(blob: bytes) -> set:
    """The value encodings of the data pages of every chunk."""
    pf = tpq.ParquetFile(blob)
    out = set()
    for rg in range(pf.num_row_groups):
        for li, desc in enumerate(pf.leaves):
            chunk = pf.metadata.row_groups[rg].columns[li]
            for hdr, _ in tdr._iter_pages(pf, chunk):
                h = hdr.data_page_header or hdr.data_page_header_v2
                if h is not None:
                    out.add(fmt.Encoding(h.encoding or 0).name)
    return out


def _same_read(blob: bytes, what: str = "") -> None:
    same_table(tpq.read_table(blob, device="cpu"), jpq.read_table(blob),
               what)


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "list"])
@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("kind,encoding", CASES)
def test_pyarrow_files_read_as_jax(kind, encoding, version, nulls, nested):
    rng = np.random.default_rng(zlib.crc32(f"{kind} {encoding}".encode()))
    table = pa.table({"c": _column(kind, rng, nulls, nested)})
    blob = _pyarrow_file(table, data_page_version=version,
                         use_dictionary=False, data_page_size=4096,
                         column_encoding={
                             "c.list.element" if nested else "c": encoding})
    written = _encodings(blob)
    # pyarrow writes a list's v2 booleans RLE when asked for PLAIN
    assert written == {encoding} or (kind == "bool" and written == {"RLE"})
    _same_read(blob, f"{kind} {encoding} v{version}")


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_pyarrow_v2_default_booleans_are_rle(version):
    """pyarrow's default under data page v2 writes BOOLEAN in RLE."""
    rng = np.random.default_rng(3)
    for nested in (False, True):
        table = pa.table({"b": _column("bool", rng, True, nested)})
        blob = _pyarrow_file(table, data_page_version=version)
        assert _encodings(blob) == {"RLE" if version == "2.0" else "PLAIN"}
        _same_read(blob)


def _delta_values(width: int, n: int, rng) -> np.ndarray:
    """int64 values whose every DELTA miniblock (32 deltas, the default
    geometry) is `width` bits wide: deltas in [0, 2**width) with each
    miniblock holding a 0 and a 2**width - 1; width 64 wraps."""
    top = (1 << width) - 1
    d = rng.integers(0, 2 ** 62, n - 1, dtype=np.uint64).astype(np.uint64)
    d = (d & np.uint64(top)) if width < 64 else rng.integers(
        0, 2 ** 63, n - 1).astype(np.uint64) * np.uint64(2) + np.uint64(1)
    d[0::32] = 0
    d[1::32] = np.uint64(top)
    out = np.zeros(n, np.uint64)
    out[1:] = np.cumsum(d, dtype=np.uint64)
    return out.view(np.int64)


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("phys,width", [("int32", 1), ("int32", 31),
                                        ("int32", 32), ("int64", 1),
                                        ("int64", 31), ("int64", 32),
                                        ("int64", 33), ("int64", 48),
                                        ("int64", 63), ("int64", 64)])
def test_delta_widths_read_as_jax(phys, width, version):
    rng = np.random.default_rng(width)
    v = _delta_values(width, 4001, rng)
    if phys == "int32":
        v = v.astype(np.int32)
    mask = rng.random(len(v)) < 0.05
    off = np.arange(0, 4 * len(v) + 1, 4, dtype=np.int32)
    table = pa.table({"v": pa.array(v), "n": pa.array(v, mask=mask),
                      "l": pa.ListArray.from_arrays(
                          pa.array(off), pa.array(np.repeat(v, 4)))})
    blob = _pyarrow_file(table, data_page_version=version,
                         use_dictionary=False, column_encoding={
                             "v": "DELTA_BINARY_PACKED",
                             "n": "DELTA_BINARY_PACKED",
                             "l.list.element": "DELTA_BINARY_PACKED"})
    # the widest miniblock of v's pages, as pyarrow wrote them
    widths = [tdd.parse_delta_segments(page)[2].max()
              for e, page in _value_pages(blob)[:1]]
    assert _encodings(blob) == {"DELTA_BINARY_PACKED"}
    assert max(widths) == width
    _same_read(blob, f"{phys} width {width}")
    got = tpq.read_table(blob, device="cpu").column("v").combine().values
    np.testing.assert_array_equal(got, v)


def test_struct_and_map_with_fixed_leaves_and_int96_lists():
    rng = np.random.default_rng(11)
    dec = _values("decimal128(15,2)", N, rng)
    fsb = _values("fixed_size_binary(6)", N, rng)
    struct = pa.StructArray.from_arrays(
        [dec, pa.array(rng.integers(0, 9, N))], ["d", "i"],
        mask=pa.array(rng.random(N) < 0.1))
    off = pa.array(np.arange(N + 1, dtype=np.int32) // 5 * 5)
    keys = pa.array(np.arange(N, dtype=np.int32))
    mapped = pa.MapArray.from_arrays(off, keys, fsb)
    ts = pa.array(rng.integers(-2 ** 60, 2 ** 60, N), pa.timestamp("ns"),
                  mask=rng.random(N) < 0.1)
    ts_list = pa.ListArray.from_arrays(off, ts)
    table = pa.table({"s": struct, "m": mapped, "t": ts_list})
    for version in ("1.0", "2.0"):
        blob = _pyarrow_file(table, data_page_version=version,
                             use_deprecated_int96_timestamps=True)
        pf = tpq.ParquetFile(blob)
        assert fmt.Type.INT96 in [leaf.physical_type for leaf in pf.leaves]
        _same_read(blob, f"struct, map, INT96 v{version}")


# ---------------------------------------------------------------------------
# the writers: the port's pages against the JAX writer's
# ---------------------------------------------------------------------------

def _jax_column(kind: str, n: int, rng, nulls: bool):
    """A JAX Array of `kind` (the pyarrow values' Python values)."""
    vals = _values(kind, n, rng).to_pylist()
    if nulls:
        vals = [None if m else v for v, m in zip(vals, rng.random(n) < 0.2)]
    t = {"int32": jdt.int32, "int64": jdt.int64, "float": jdt.float32,
         "double": jdt.float64, "float16": jdt.float16,
         "decimal128(20,2)": jdt.decimal128(20, 2),
         "decimal128(15,2)": jdt.decimal128(15, 2),
         "fixed_size_binary(6)": jdt.fixed_size_binary(6)}[kind]
    if kind == "float16":
        vals = [None if v is None else float(v) for v in vals]
    return agt.array(vals, type=t)


def _value_pages(blob: bytes) -> list:
    """The value bytes of every data page of every chunk, in order."""
    pf = tpq.ParquetFile(blob)
    out = []
    for rg in range(pf.num_row_groups):
        for li, desc in enumerate(pf.leaves):
            chunk = pf.metadata.row_groups[rg].columns[li]
            clock = tdr._Clock(None, None)
            for hdr, body in tdr._iter_pages(pf, chunk):
                if hdr.data_page_header or hdr.data_page_header_v2:
                    nv, _, vals, e = tdr._split_page(
                        hdr, body, desc, chunk.meta_data.codec or 0, clock)
                    out.append((e.name, bytes(vals)))
    return out


WRITES = [(k, "byte_stream_split") for k in (
    "float", "double", "int32", "int64", "decimal128(20,2)", "float16",
    "fixed_size_binary(6)")] + [(k, "delta_byte_array") for k in (
        "decimal128(15,2)", "float16", "fixed_size_binary(6)")]


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
@pytest.mark.parametrize("kind,encoding", WRITES)
def test_port_writer_pages_equal_the_jax_writer(kind, encoding, nulls,
                                                version):
    rng = np.random.default_rng(len(kind) * 7 + len(encoding))
    rb = agt.record_batch({"c": _jax_column(kind, N, rng, nulls)})
    props = {"compression": "none", "data_page_version": version,
             "column_properties": {"c": {"encoding": encoding}}}
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jpq.write_table(rb, jbuf, properties=jpq.WriterProperties(**props))
    tpq.write_table(port_record_batch(rb), tbuf,
                    properties=tpq.WriterProperties(**props))
    jpages, tpages = _value_pages(jbuf.getvalue()), _value_pages(
        tbuf.getvalue())
    assert [e for e, _ in tpages] == [encoding.upper()] * len(tpages)
    assert tpages == jpages
    blob = tbuf.getvalue()
    want = jpq.read_table(jbuf.getvalue())
    same_table(tpq.read_table(blob, device="cpu"), want, "port")
    same_table(tpq.read_table(jbuf.getvalue(), device="cpu"), want, "JAX's")
    assert jpq.read_table(blob).column(0).to_pylist() == \
        want.column(0).to_pylist()
    assert pq.read_table(io.BytesIO(blob)).column("c").to_pylist() == \
        pq.read_table(jbuf).column("c").to_pylist()


@pytest.mark.parametrize("kind,encoding", [
    ("bool", "byte_stream_split"), ("bool", "delta_byte_array"),
    ("double", "delta_byte_array"), ("int64", "delta_length_byte_array"),
    ("fixed_size_binary(6)", "delta_binary_packed")])
def test_an_encoding_the_physical_type_does_not_take_raises(kind, encoding):
    rng = np.random.default_rng(5)
    col = agt.array((rng.random(40) < 0.5).tolist(), type=jdt.bool_) if \
        kind == "bool" else _jax_column(kind, 40, rng, False)
    rb = agt.record_batch({"c": col})
    with pytest.raises(ArrowInvalid):
        tpq.write_table(port_record_batch(rb), io.BytesIO(),
                        column_encodings={"c": encoding})


NESTED = {"list<fixed_size_binary(6)>": jdt.list_(jdt.fixed_size_binary(6)),
          "list<decimal128(15,2)>": jdt.list_(jdt.decimal128(15, 2)),
          "list<decimal128(40,3)>": jdt.list_(jdt.decimal256(40, 3)),
          "list<float16>": jdt.list_(jdt.float16),
          "list<timestamp[us]>": jdt.list_(jdt.timestamp("us")),
          "struct<d: decimal64(12,2), b: fixed_size_binary(4)>": jdt.struct(
              [jdt.Field("d", jdt.decimal64(12, 2)),
               jdt.Field("b", jdt.fixed_size_binary(4))])}


def _nested_rows(name: str, rng, n: int = 400) -> list:
    def leaf(t):
        if rng.random() < 0.15:
            return None
        if t.id == jdt.TypeId.FIXED_SIZE_BINARY:
            return bytes(rng.integers(0, 3, t.byte_width, dtype=np.uint8))
        if t.is_decimal:
            digits = min(t.precision, 30)
            return D(int(rng.integers(-10 ** 15, 10 ** 15)) *
                     10 ** (digits - 16) if digits > 16 else
                     int(rng.integers(-10 ** (digits - 1),
                                      10 ** (digits - 1)))).scaleb(-t.scale)
        if t.id == jdt.TypeId.FLOAT16:
            return float(np.float16(rng.standard_normal()))
        return int(rng.integers(-2 ** 50, 2 ** 50))
    t = NESTED[name]
    rows = []
    for _ in range(n):
        if rng.random() < 0.1:
            rows.append(None)
        elif t.id == jdt.TypeId.LIST:
            rows.append([leaf(t.value_type)
                         for _ in range(int(rng.integers(0, 5)))])
        else:
            rows.append({f.name: leaf(f.type) for f in t.fields()})
    return rows


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("name,int96", [(name, False) for name in NESTED]
                         + [("list<timestamp[us]>", True)])
def test_nested_fixed_leaves_round_trip(name, int96, version):
    rng = np.random.default_rng(len(name))
    ja = agt.array(_nested_rows(name, rng), type=NESTED[name])
    rb = agt.record_batch({"c": ja})
    buf = io.BytesIO()
    tpq.write_table(port_record_batch(rb), buf, int96_timestamps=int96,
                    properties=None if not version == "2.0" else
                    tpq.WriterProperties(data_page_version="2.0"))
    blob = buf.getvalue()
    pf = tpq.ParquetFile(blob)
    if int96:
        assert pf.leaves[0].physical_type == fmt.Type.INT96
    got = jpq.read_table(blob)
    jb = io.BytesIO()
    jpq.write_table(rb, jb, use_dictionary=False)
    want = jpq.read_table(jb.getvalue())
    if int96:    # an INT96 leaf reads back in ns, in both packages
        want = got
    else:
        assert got.column(0).to_pylist() == want.column(0).to_pylist()
    same_table(tpq.read_table(blob, device="cpu"), want, name)
    assert pq.read_table(io.BytesIO(blob)).num_rows == len(ja)


def test_list_of_fixed_size_binary_written_by_the_port_reads_both_ways():
    """A dictionary-coded fixed_size_binary leaf of a list column was a
    list of bytes handed to the PLAIN encoder, which raised ValueError:
    it is written as its rows."""
    rows = [[b"abc", None, b"abd"], None, [], [b"xyz"]] * 25
    ja = agt.array(rows, type=jdt.list_(jdt.fixed_size_binary(3)))
    buf = io.BytesIO()
    tpq.write_table(port_record_batch(agt.record_batch({"c": ja})), buf)
    blob = buf.getvalue()
    want = jpq.read_table(blob)
    assert want.column(0).to_pylist() == rows
    same_table(tpq.read_table(blob, device="cpu"), want)
    assert pq.read_table(io.BytesIO(blob)).column("c").to_pylist() == rows


# ---------------------------------------------------------------------------
# the ops-level decodes against the JAX host decodes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", list(range(33, 65)))
def test_delta_decode_device_past_32_bits_matches_jax_host(width):
    rng = np.random.default_rng(100 + width)
    v = _delta_values(width, 1000 + width, rng)
    stream = jenc.delta_binary_packed_encode(v)
    assert tenc.delta_binary_packed_encode(v) == stream
    st, b0, wd, mn, words, first, total = tdd.parse_delta_segments(stream)
    assert wd.max() == width
    got = tdd.delta_decode_device(
        torch.from_numpy(st), torch.from_numpy(b0), torch.from_numpy(wd),
        torch.from_numpy(mn), torch.from_numpy(words.view(np.int32).copy()),
        first, total).numpy()
    want, _ = jenc.delta_binary_packed_decode(stream)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, v)


def test_delta_width_over_64_raises():
    stream = bytearray(tenc.delta_binary_packed_encode(
        np.arange(0, 700, 3, dtype=np.int64)))
    # the header: block size (two bytes), miniblocks, count (two bytes)
    # and first value; then the block's min delta (one byte) and its
    # miniblocks' widths
    stream[7] = 65
    with pytest.raises(ArrowInvalid, match="65"):
        tdd.parse_delta_segments(bytes(stream))


@pytest.mark.parametrize("width", [2, 6, 9, 16, 32])
def test_byte_stream_split_rows_match_jax(width):
    rng = np.random.default_rng(width)
    n = 777
    rows = rng.integers(0, 256, (n, width), dtype=np.uint8)
    data = jenc.byte_stream_split_encode(rows)
    assert tenc.byte_stream_split_encode(rows) == data
    want = jenc.byte_stream_split_decode(data, n, width)
    got = tdd.byte_stream_split_rows_device(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()), width, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tenc.byte_stream_split_decode(
        data, n, width), want)
    with pytest.raises(ArrowInvalid):
        tenc.byte_stream_split_decode(data[:-1], n, width)


def test_fixed_delta_byte_array_value_of_another_length_raises():
    data = tenc.delta_byte_array_encode([b"abcdef", b"abcdeg", b"abc"])
    with pytest.raises(ArrowInvalid, match="6 bytes"):
        tenc.fixed_delta_byte_array_decode(data, 3, 6)
    data = tenc.delta_byte_array_encode([b"abcdef", b"abcdeg"])
    assert tenc.fixed_delta_byte_array_decode(data, 5, 6).tobytes() == \
        b"abcdefabcdeg"


def test_rle_boolean_page_decodes_on_the_device_plan():
    """A BOOLEAN RLE value stream (4-byte length, hybrid at width 1) with
    and without definition levels, through _plan_page on CPU tensors."""
    rng = np.random.default_rng(9)
    n = 5000
    bits = rng.random(n) < 0.4
    bits[1000:1400] = True
    present = rng.random(n) >= 0.05
    desc = tpq.ParquetFile(_pyarrow_file(pa.table(
        {"b": pa.array([True])}))).leaves[0]
    stager = tdr._Stager(torch.device("cpu"))
    for defs in (None, present):
        vals = bits if defs is None else bits[defs]
        body = tenc.rle_encode(vals.astype(np.uint32), 1)
        stream = len(body).to_bytes(4, "little") + body
        def_stream = None if defs is None else tenc.rle_encode(
            defs.astype(np.uint32), 1)
        host = {}
        decode = tdr._plan_page((n, def_stream, stream, fmt.Encoding.RLE),
                                desc, np.bool_, False, False, stager, host,
                                "p.")
        got, mask = decode(host)
        if defs is None:
            assert mask is None
            np.testing.assert_array_equal(got.numpy(), bits)
        else:
            np.testing.assert_array_equal(mask.numpy(), defs)
            np.testing.assert_array_equal(got.numpy()[defs], vals)


def test_fixed_page_in_another_encoding_raises():
    """Both readers refuse a FIXED_LEN_BYTE_ARRAY page in an encoding
    neither decodes (RLE)."""
    desc = tpq.ParquetFile(_pyarrow_file(pa.table(
        {"d": _values("decimal128(15,2)", 4, np.random.default_rng(1))})
    )).leaves[0]
    rows = tdr._fixed_rows(desc.arrow_type, desc.physical_type,
                           desc.type_length)
    with pytest.raises(ArrowNotImplemented):
        tdr._plan_page((4, None, b"\0" * 64, fmt.Encoding.RLE), desc, None,
                       False, False, tdr._Stager(torch.device("cpu")), {},
                       "p.", rows)


def test_dataset_of_pyarrow_v2_files(tmp_path):
    rng = np.random.default_rng(21)
    for i in range(3):
        table = pa.table({
            "k": pa.array(np.arange(i * 1000, i * 1000 + 1000)),
            "ts": pa.array(rng.integers(0, 2 ** 52, 1000),
                           pa.timestamp("us")),
            "b": pa.array(rng.random(1000) < 0.5,
                          mask=rng.random(1000) < 0.1),
            "x": pa.array(rng.standard_normal(1000)),
            "d": _values("decimal128(15,2)", 1000, rng)})
        pq.write_table(table, tmp_path / f"part{i}.parquet",
                       data_page_version="2.0", use_dictionary=["d"],
                       use_byte_stream_split=["x"],
                       column_encoding={"ts": "DELTA_BINARY_PACKED"})
    got = tds.dataset(str(tmp_path)).to_table(device="cpu")
    want = jdataset(str(tmp_path)).to_table()
    same_table(got, want, "dataset")
    import arrow_go_tpu.compute as jpc
    import arrow_go_tpu_torch.compute as tpc
    got = tds.dataset(str(tmp_path)).to_table(
        filter=tpc.call("greater_equal", [tpc.field("k"),
                                          tpc.literal(1500)]), device="cpu")
    want = jdataset(str(tmp_path)).to_table(
        filter=jpc.call("greater_equal", [jpc.field("k"),
                                          jpc.literal(1500)]))
    assert got.num_rows == want.num_rows == 1500
    assert got.to_pydict() == want.to_pydict()
