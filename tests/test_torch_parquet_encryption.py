"""Parquet modular encryption in the port (parquet/encryption.py,
keytools.py, the reader's footer and read front, the writer's frames)
against the JAX package's (tests/test_parquet_encryption.py, case for
case): files written by the JAX writer are read by the port, files
written by the port are read by the JAX reader, and each read is held
against the JAX package's read_table. Every mode is covered: uniform,
column keys beside plaintext columns, a plaintext (signed) footer,
AES_GCM_CTR_V1, stored and supplied AAD prefixes, a key retriever,
encrypted bloom filters and page indexes, several row groups with
read_rows, and the PKMT1 key tools against pyarrow's CryptoFactory in
both directions. Every port read passes device="cpu"."""
import base64
import io
import os

import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.compute.errors import ArrowInvalid as jArrowInvalid
from arrow_go_tpu.compute.errors import ArrowNotImplemented as jNotImpl
from arrow_go_tpu.parquet import device_read as jdr
from arrow_go_tpu.parquet import keytools as jkt

from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.compute.errors import ArrowInvalid as tArrowInvalid
from arrow_go_tpu_torch.parquet import keytools as tkt

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as papq  # noqa: E402
import pyarrow.parquet.encryption as pe  # noqa: E402
from cryptography.hazmat.primitives.ciphers.aead import AESGCM  # noqa: E402

KEY = b"0123456789012345"
COLKEY = b"abcdefghabcdefgh"
MASTER_KEYS = {"kf": KEY, "kc1": b"1234567890123450",
               "kc2": b"2345678901234501"}
N = 800
WRITERS = ["jax", "port"]


def _expected(n: int = N) -> dict:
    return {"a": list(range(n)), "s": [f"v{i % 37}" for i in range(n)],
            "f": [float(i) * 0.5 if i % 9 else None for i in range(n)]}


def _jax_table(n: int = N):
    return agt.table(_expected(n))


def _port_columns(n: int = N):
    data = {"a": np.arange(n, dtype=np.int64),
            "s": np.array([f"v{i % 37}" for i in range(n)], dtype=object),
            "f": np.arange(n) * 0.5}
    return data, {"f": np.arange(n) % 9 != 0}


def _props(pkg, kw: dict):
    """FileEncryptionProperties of package `pkg` ("jax" / "port") from
    keyword arguments whose column keys may be (key, metadata) pairs."""
    mod = jpq if pkg == "jax" else tpq
    kw = dict(kw)
    if "column_keys" in kw:
        kw["column_keys"] = {
            c: mod.ColumnEncryptionProperties(*k) if isinstance(k, tuple)
            else k for c, k in kw["column_keys"].items()}
    return mod.FileEncryptionProperties(**kw)


def _write(writer: str, enc_kw: dict, n: int = N, **opts) -> bytes:
    buf = io.BytesIO()
    if writer == "jax":
        jpq.write_table(_jax_table(n), buf, encryption=_props("jax", enc_kw),
                        **opts)
    else:
        data, masks = _port_columns(n)
        opts.setdefault("compression", "snappy")
        tpq.write_table(data, buf, masks=masks,
                        encryption=_props("port", enc_kw), **opts)
    return buf.getvalue()


def _dec(pkg: str, **kw):
    mod = jpq if pkg == "jax" else tpq
    return mod.FileDecryptionProperties(**kw)


def _read_both(data: bytes, columns=None, **dec_kw) -> dict:
    """The table as both readers give it (equal), as a dict."""
    want = jpq.read_table(data, columns=columns,
                          decryption=_dec("jax", **dec_kw)).to_pydict()
    got = tpq.read_table(data, columns=columns,
                         decryption=_dec("port", **dec_kw),
                         device="cpu").to_pydict()
    assert got == want
    return got


def _raises_both(data: bytes, columns=None, **dec_kw):
    dec = (lambda pkg: _dec(pkg, **dec_kw)) if dec_kw else (lambda pkg: None)
    with pytest.raises(jArrowInvalid):
        jpq.read_table(data, columns=columns, decryption=dec("jax"))
    with pytest.raises(tArrowInvalid):
        tpq.read_table(data, columns=columns, decryption=dec("port"),
                       device="cpu")


def _wrap(key_bytes, mid):
    nonce = os.urandom(12)
    ct = AESGCM(MASTER_KEYS[mid]).encrypt(nonce, bytes(key_bytes), b"")
    return base64.b64encode(nonce + ct).decode()


def _unwrap(wrapped, mid):
    raw = base64.b64decode(wrapped)
    return AESGCM(MASTER_KEYS[mid]).decrypt(raw[:12], raw[12:], b"")


class _PyKms(pe.KmsClient):
    def __init__(self, config):
        pe.KmsClient.__init__(self)

    def wrap_key(self, k, m):
        return _wrap(k, m)

    def unwrap_key(self, w, m):
        return _unwrap(w, m)


class _PortKms(tkt.KmsClient):
    def wrap_key(self, k, m):
        return _wrap(k, m)

    def unwrap_key(self, w, m):
        return _unwrap(w, m)


class _JaxKms(jkt.KmsClient):
    def wrap_key(self, k, m):
        return _wrap(k, m)

    def unwrap_key(self, w, m):
        return _unwrap(w, m)


# ---------------------------------------------------------------------------
# the JAX package's nine cases, each from both writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", WRITERS)
def test_uniform_encrypted_footer_roundtrip(writer):
    data = _write(writer, dict(footer_key=KEY, footer_key_metadata=b"kf"))
    assert data[:4] == b"PARE" and data[-4:] == b"PARE"
    assert _read_both(data, footer_key=KEY) == _expected()
    _raises_both(data)                                  # no keys
    _raises_both(data, footer_key=b"X" * 16)            # wrong key


@pytest.mark.parametrize("writer", WRITERS)
def test_column_keys_and_plaintext_column(writer):
    data = _write(writer, dict(footer_key=KEY,
                               column_keys={"s": COLKEY, "f": COLKEY}))
    assert _read_both(data, footer_key=KEY,
                      column_keys={"s": COLKEY, "f": COLKEY}) == _expected()
    # the plaintext column reads with the footer key alone; a column
    # whose key is missing or wrong raises when it is read
    assert _read_both(data, ["a"], footer_key=KEY) == \
        {"a": _expected()["a"]}
    _raises_both(data, ["s"], footer_key=KEY)
    _raises_both(data, ["f"], footer_key=KEY,
                 column_keys={"s": COLKEY, "f": KEY})


@pytest.mark.parametrize("writer", WRITERS)
def test_plaintext_footer_partial_access(writer):
    data = _write(writer, dict(footer_key=KEY, column_keys={"s": COLKEY},
                               plaintext_footer=True))
    assert data[:4] == b"PAR1" and data[-4:] == b"PAR1"
    # metadata and plaintext columns readable without any keys
    pf = tpq.ParquetFile(data)
    assert pf.num_rows == N == jpq.ParquetFile(data).num_rows
    assert pf.read_table(columns=["a"], device="cpu").column(
        "a").to_pylist() == list(range(N))
    with pytest.raises(tArrowInvalid):
        pf.read_table(columns=["s"], device="cpu")
    with pytest.raises(jArrowInvalid):
        jpq.ParquetFile(data).read_table(columns=["s"])
    assert _read_both(data, footer_key=KEY,
                      column_keys={"s": COLKEY}) == _expected()


@pytest.mark.parametrize("writer", WRITERS)
def test_tampered_plaintext_footer_raises(writer):
    data = _write(writer, dict(footer_key=KEY, plaintext_footer=True))
    at = data.rfind(b"v0.1.0")                    # in created_by
    bad = data[:at] + b"v0.1.1" + data[at + 6:]
    assert _read_both(data, footer_key=KEY) == _expected()
    for pkg, err in (("jax", jArrowInvalid), ("port", tArrowInvalid)):
        mod = jpq if pkg == "jax" else tpq
        with pytest.raises(err, match="signature verification failed"):
            mod.ParquetFile(bad, decryption=_dec(pkg, footer_key=KEY))
    # not checked when asked not to
    assert tpq.ParquetFile(bad, decryption=_dec(
        "port", footer_key=KEY, check_plaintext_footer_integrity=False)
    ).metadata.created_by.endswith("v0.1.1")


@pytest.mark.parametrize("writer", WRITERS)
def test_gcm_ctr_aad_prefix_and_retriever(writer):
    data = _write(writer, dict(
        footer_key=KEY, footer_key_metadata=b"kf",
        column_keys={"s": (COLKEY, b"ks")}, algorithm="AES_GCM_CTR_V1",
        aad_prefix=b"file-id-1"), data_page_size=1024)
    keys = {b"kf": KEY, b"ks": COLKEY}
    assert _read_both(data, key_retriever=lambda km: keys[bytes(km)]) == \
        _expected()
    _raises_both(data, key_retriever=lambda km: {b"kf": KEY,
                                                 b"ks": KEY}[bytes(km)])


@pytest.mark.parametrize("writer", WRITERS)
def test_supplied_aad_prefix(writer):
    data = _write(writer, dict(footer_key=KEY, aad_prefix=b"secret",
                               store_aad_prefix=False))
    _raises_both(data, footer_key=KEY)                   # no prefix
    _raises_both(data, footer_key=KEY, aad_prefix=b"secreT")
    assert _read_both(data, footer_key=KEY, aad_prefix=b"secret") == \
        _expected()


@pytest.mark.parametrize("writer", WRITERS)
def test_encrypted_bloom_and_page_index(writer):
    opts = {"write_bloom_filters": True}
    if writer == "port":
        opts["write_page_index"] = True
    data = _write(writer, dict(footer_key=KEY), data_page_size=1024, **opts)
    pf = tpq.ParquetFile(data, decryption=_dec("port", footer_key=KEY))
    jf = jpq.ParquetFile(data, decryption=_dec("jax", footer_key=KEY))
    bf = pf.read_bloom_filter(0, 1)
    assert bf is not None and bf.check(b"v5", tpq.format.Type.BYTE_ARRAY)
    assert not bf.check(b"v99", tpq.format.Type.BYTE_ARRAY)
    assert jf.read_bloom_filter(0, 1).check(b"v5", jpq.format.Type.BYTE_ARRAY)
    for col in range(3):
        ci, oi = pf.read_column_index(0, col), pf.read_offset_index(0, col)
        assert ci is not None and oi is not None
        assert str(ci) == str(jf.read_column_index(0, col))
        assert str(oi) == str(jf.read_offset_index(0, col))
        assert oi.page_locations[0].first_row_index == 0
    # the bloom filter and statistics prune in both readers
    for flt in ([("s", "==", "v99")], [("a", ">", 10_000)],
                [("s", "==", "v3")]):
        got = tpq.read_table(data, filters=flt, device="cpu",
                             decryption=_dec("port", footer_key=KEY))
        want = jpq.read_table(data, filters=flt,
                              decryption=_dec("jax", footer_key=KEY))
        assert got.num_rows == want.num_rows
        assert got.to_pydict() == want.to_pydict()


@pytest.mark.parametrize("plaintext_footer", [False, True])
@pytest.mark.parametrize("double_wrapping", [True, False])
def test_keytools_interop_with_pyarrow(double_wrapping, plaintext_footer):
    """PKMT1 envelope interop: pyarrow-encrypted files decrypt with the
    port's CryptoFactory and the port's files with pyarrow's."""
    table = pa.table(_expected())
    cf = pe.CryptoFactory(lambda c: _PyKms(c))
    kcfg = pe.KmsConnectionConfig()
    ours = tkt.CryptoFactory(lambda cfg: _PortKms())
    fep = cf.file_encryption_properties(kcfg, pe.EncryptionConfiguration(
        footer_key="kf", column_keys={"kc1": ["a"], "kc2": ["s"]},
        double_wrapping=double_wrapping, plaintext_footer=plaintext_footer))
    buf = io.BytesIO()
    with papq.ParquetWriter(buf, table.schema, encryption_properties=fep) as w:
        w.write_table(table)
    got = tpq.read_table(buf.getvalue(), device="cpu",
                         decryption=ours.file_decryption_properties(
                             tkt.KmsConnectionConfig()))
    assert got.to_pydict() == table.to_pydict()

    eprops = ours.file_encryption_properties(
        tkt.KmsConnectionConfig(),
        tkt.EncryptionConfiguration(footer_key="kf",
                                    column_keys={"kc1": ["a"], "kc2": ["s"]},
                                    double_wrapping=double_wrapping,
                                    plaintext_footer=plaintext_footer))
    data, masks = _port_columns()
    buf2 = io.BytesIO()
    tpq.write_table(data, buf2, masks=masks, data_page_size=4096,
                    compression="snappy", encryption=eprops)
    pt = papq.read_table(
        io.BytesIO(buf2.getvalue()),
        decryption_properties=cf.file_decryption_properties(
            kcfg, pe.DecryptionConfiguration()))
    assert pt.to_pydict() == table.to_pydict()
    # and the JAX package's key tools read the port's file
    jours = jkt.CryptoFactory(lambda cfg: _JaxKms())
    assert jpq.read_table(buf2.getvalue(),
                          decryption=jours.file_decryption_properties(
                              jkt.KmsConnectionConfig())).to_pydict() == \
        table.to_pydict()


def test_keytools_uniform_both_directions():
    table = pa.table(_expected())
    cf = pe.CryptoFactory(lambda c: _PyKms(c))
    kcfg = pe.KmsConnectionConfig()
    ours = tkt.CryptoFactory(lambda cfg: _PortKms())
    fep = cf.file_encryption_properties(kcfg, pe.EncryptionConfiguration(
        footer_key="kf", uniform_encryption=True))
    buf = io.BytesIO()
    with papq.ParquetWriter(buf, table.schema, encryption_properties=fep) as w:
        w.write_table(table)
    assert tpq.read_table(
        buf.getvalue(), device="cpu",
        decryption=ours.file_decryption_properties(
            tkt.KmsConnectionConfig())).to_pydict() == table.to_pydict()
    eprops = ours.file_encryption_properties(
        tkt.KmsConnectionConfig(),
        tkt.EncryptionConfiguration(footer_key="kf", uniform_encryption=True))
    data, masks = _port_columns()
    buf2 = io.BytesIO()
    tpq.write_table(data, buf2, masks=masks, encryption=eprops)
    assert papq.read_table(
        io.BytesIO(buf2.getvalue()),
        decryption_properties=cf.file_decryption_properties(
            kcfg, pe.DecryptionConfiguration())).to_pydict() \
        == table.to_pydict()


def test_keytools_key_material_matches_jax():
    """The PKMT1 JSON the port writes names the same fields the JAX
    package's does, and each package unwraps the other's."""
    import json
    for double in (True, False):
        cfg = dict(footer_key="kf", column_keys={"kc1": ["a"]},
                   double_wrapping=double)
        tp = tkt.CryptoFactory(lambda c: _PortKms()).file_encryption_properties(
            tkt.KmsConnectionConfig(), tkt.EncryptionConfiguration(**cfg))
        jp = jkt.CryptoFactory(lambda c: _JaxKms()).file_encryption_properties(
            jkt.KmsConnectionConfig(), jkt.EncryptionConfiguration(**cfg))
        for a, b in ((tp.footer_key_metadata, jp.footer_key_metadata),
                     (tp.column_keys["a"].key_metadata,
                      jp.column_keys["a"].key_metadata)):
            assert set(json.loads(a)) == set(json.loads(b))
        t_unwrap = tkt._KeyUnwrapper(_PortKms())
        j_unwrap = jkt._KeyUnwrapper(_JaxKms())
        assert t_unwrap(jp.footer_key_metadata) == jp.footer_key
        assert j_unwrap(tp.footer_key_metadata) == tp.footer_key
        assert t_unwrap(jp.column_keys["a"].key_metadata) == \
            jp.column_keys["a"].key
    with pytest.raises(tArrowInvalid, match="PKMT1"):
        tkt._KeyUnwrapper(_PortKms())(b"not json")
    with pytest.raises(tArrowInvalid, match="column_keys"):
        tkt.EncryptionConfiguration(footer_key="kf")


@pytest.mark.parametrize("writer", WRITERS)
def test_encrypted_multi_row_group_and_seek(writer):
    n = 5000
    if writer == "jax":
        buf = io.BytesIO()
        jpq.write_table(agt.table({"x": list(range(n))}), buf,
                        row_group_size=1500, data_page_size=2048,
                        encryption=_props("jax", dict(footer_key=KEY)))
    else:
        buf = io.BytesIO()
        tpq.write_table({"x": np.arange(n)}, buf, row_group_size=1500,
                        data_page_size=2048,
                        encryption=_props("port", dict(footer_key=KEY)))
    data = buf.getvalue()
    pf = tpq.ParquetFile(data, decryption=_dec("port", footer_key=KEY))
    jf = jpq.ParquetFile(data, decryption=_dec("jax", footer_key=KEY))
    assert pf.num_row_groups == jf.num_row_groups == 4
    assert pf.read_table(device="cpu").column("x").to_pylist() == \
        list(range(n))
    for off, cnt in ((2900, 300), (0, 1), (1499, 2), (4990, 100),
                     (n + 5, 3)):
        got = pf.read_rows(off, cnt, device="cpu").column("x").to_pylist()
        assert got == jf.read_rows(off, cnt).column("x").to_pylist() == \
            list(range(off, min(off + cnt, n)))
    assert pf.read_row_group(2, device="cpu").column("x").to_pylist() == \
        list(range(3000, 4500))


# ---------------------------------------------------------------------------
# the port's own read front and its recorded deviation
# ---------------------------------------------------------------------------

def test_read_column_device_decrypts_where_jax_refuses():
    """Recorded deviation: the JAX read_column_device refuses an encrypted
    column (its device route skips the host reader that decrypts); the
    port's device decode is its only flat reader, so it decrypts, and
    gives what JAX read_table(decryption=...) gives."""
    data = _write("jax", dict(footer_key=KEY))
    jf = jpq.ParquetFile(data, decryption=_dec("jax", footer_key=KEY))
    with pytest.raises(jNotImpl, match="encrypted"):
        jdr.read_column_device(jf, 0, "a")
    pf = tpq.ParquetFile(data, decryption=_dec("port", footer_key=KEY))
    want = jpq.read_table(data, decryption=_dec("jax", footer_key=KEY))
    for name in ("a", "f", "s"):
        col = tpq.read_column_device(pf, 0, name, device="cpu")
        from arrow_go_tpu_torch.device.block import column_to_host
        assert column_to_host(col).to_pylist() == \
            want.column(name).to_pylist()


def test_read_split_reports_decrypt_seconds():
    data = _write("port", dict(footer_key=KEY), data_page_size=1024)
    pf = tpq.ParquetFile(data, decryption=_dec("port", footer_key=KEY))
    times = {}
    db = tpq.read_batch_device(pf, 0, device="cpu", times=times)
    assert db.length == N
    assert {"parse_s", "decrypt_s", "decompress_s", "h2d_s",
            "decode_s"} <= set(times)
    assert 0 < times["decrypt_s"] <= times["parse_s"]


def test_reader_properties_and_nested_columns():
    """ReaderProperties' decryption is used when none is passed; a
    nested column's encrypted leaves decrypt in the host read."""
    t = agt.table({"k": list(range(50)),
                   "l": [[i, i + 1] if i % 4 else None for i in range(50)]})
    buf = io.BytesIO()
    jpq.write_table(t, buf, encryption=_props("jax", dict(footer_key=KEY)))
    props = tpq.ReaderProperties(decryption=_dec("port", footer_key=KEY),
                                 buffered_stream=True, buffer_size=64)
    got = tpq.read_table(buf.getvalue(), properties=props, device="cpu")
    assert got.to_pydict() == t.to_pydict()
    pf = tpq.ParquetFile(buf.getvalue(), properties=props)
    assert pf.read_table(["l"], device="cpu").to_pydict() == \
        {"l": t.column("l").to_pylist()}


def test_port_writes_unencrypted_files_as_before():
    """write_page_index defaults to on, as in the JAX writer: a file
    written with it off and no encryption has the bytes it had, and with
    the index the JAX reader finds the same entries the port's reader
    does."""
    data, masks = _port_columns()
    a, b = io.BytesIO(), io.BytesIO()
    tpq.write_table(data, a, masks=masks, compression="none",
                    write_page_index=False)
    tpq.write_table(data, b, masks=masks, compression="none",
                    write_page_index=False, encryption=None)
    assert a.getvalue() == b.getvalue()
    pf = tpq.ParquetFile(a.getvalue())
    assert pf.read_column_index(0, 0) is None
    d = io.BytesIO()
    tpq.write_table(data, d, masks=masks)
    assert tpq.ParquetFile(d.getvalue()).read_column_index(0, 0) is not None
    c = io.BytesIO()
    tpq.write_table(data, c, masks=masks, write_page_index=True,
                    data_page_size=512)
    pf, jf = tpq.ParquetFile(c.getvalue()), jpq.ParquetFile(c.getvalue())
    for col in range(3):
        assert str(pf.read_offset_index(0, col)) == \
            str(jf.read_offset_index(0, col))
        assert str(pf.read_column_index(0, col)) == \
            str(jf.read_column_index(0, col))
    assert len(pf.read_offset_index(0, 0).page_locations) > 1


def test_read_table_runs_on_the_card_unless_asked(monkeypatch):
    data = _write("port", dict(footer_key=KEY))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpq.read_table(data, decryption=_dec("port", footer_key=KEY))


def test_read_table_columns_follow_the_jax_selection():
    """columns picks fields in schema order and passes over a name the
    schema lacks, as the JAX reader does; no row group gives an empty
    table of the selected fields."""
    data = _write("jax", dict(footer_key=KEY))
    dec = dict(footer_key=KEY)
    assert list(_read_both(data, ["s", "a", "zz"], **dec)) == ["a", "s"]
    for flt in ([("a", "<", 0)],):
        got = tpq.read_table(data, filters=flt, device="cpu",
                             decryption=_dec("port", **dec))
        want = jpq.read_table(data, filters=flt,
                              decryption=_dec("jax", **dec))
        assert got.num_rows == want.num_rows == 0
        assert [f.name for f in got.schema.fields] == \
            [f.name for f in want.schema.fields]


def test_schema_keeps_the_files_key_value_metadata():
    """Repair: the port's ParquetFile dropped the footer's key/value
    metadata, which the JAX reader attaches to its schema and to every
    table it reads."""
    from arrow_go_tpu.array.record import RecordBatch, Table
    sch = jdt.Schema([jdt.Field("a", jdt.int64)],
                     jdt.Metadata({"origin": "tpch", "sf": "10"}))
    t = Table.from_batches([RecordBatch(
        sch, [agt.array([1, 2, 3], jdt.int64)], 3)])
    for enc in (None, dict(footer_key=KEY)):
        buf = io.BytesIO()
        jpq.write_table(t, buf, encryption=None if enc is None
                        else _props("jax", enc))
        dec = None if enc is None else _dec("port", footer_key=KEY)
        jdec = None if enc is None else _dec("jax", footer_key=KEY)
        pf = tpq.ParquetFile(buf.getvalue(), decryption=dec)
        want = jpq.ParquetFile(buf.getvalue(), decryption=jdec).schema
        assert pf.schema.metadata.to_dict() == want.metadata.to_dict() == \
            {"origin": "tpch", "sf": "10"}
        got = tpq.read_table(buf.getvalue(), decryption=dec, device="cpu")
        assert got.schema.metadata.to_dict() == want.metadata.to_dict()
        assert got.to_pydict() == {"a": [1, 2, 3]}
