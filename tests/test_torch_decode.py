"""Parquet page decoding of the port (ops/decode.py) and its host
encoders (parquet/encodings.py) against the JAX package's, on the same
bytes, bit for bit; mirrors tests/test_device_decode.py."""
import numpy as np
import pytest
import torch

from arrow_go_tpu.jaxenv import jnp
from arrow_go_tpu.ops import decode as jdd
from arrow_go_tpu.parquet import encodings as jenc
from arrow_go_tpu.parquet import format as jfmt

from arrow_go_tpu_torch.ops import decode as tdd
from arrow_go_tpu_torch.parquet import encodings as tenc
from arrow_go_tpu_torch.parquet import format as tfmt


def _vals(rng, n: int, bw: int) -> np.ndarray:
    return rng.integers(0, 2 ** bw, n, dtype=np.uint64).astype(np.uint32)


def _rle_decode(stream, n: int, bw: int) -> np.ndarray:
    """The port's RLE/bit-packed decode as the scan runs it: the host
    parse, then the segment tables decoded as CPU tensors."""
    st, ir, pay, words = tdd.parse_rle_segments(stream, n, bw)
    return tdd.rle_hybrid_decode_device(
        torch.from_numpy(st.astype(np.int64)),
        torch.from_numpy(ir.astype(np.bool_)), torch.from_numpy(pay),
        torch.from_numpy(words.view(np.int32).copy()), bw, n).numpy()


def _runs(rng, n: int, bw: int) -> np.ndarray:
    """Long constant runs (RLE) mixed with noise (bit-packed groups)."""
    vals = np.empty(n, np.uint32)
    pos = 0
    while pos < n:
        run = min(int(rng.integers(1, 400)), n - pos)
        vals[pos:pos + run] = rng.integers(0, 2 ** bw) if rng.random() < 0.5 \
            else rng.integers(0, 2 ** bw, run)
        pos += run
    return vals


@pytest.mark.parametrize("bw", range(1, 33))
def test_bitunpack_device_every_width(rng, bw):
    n = 1000
    vals = _vals(rng, n, bw)
    packed = jenc._pack_bits(vals, bw)
    assert tenc.pack_bits(vals, bw) == packed
    words = tdd.words_from_bytes(packed)
    np.testing.assert_array_equal(words, jdd.words_from_bytes(packed))
    got = tdd.bitunpack_device(
        torch.from_numpy(words.view(np.int32).copy()), bw, n).numpy()
    want = np.asarray(jdd.bitunpack_device(jnp.asarray(words), bw, n))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("encoder", ["jax", "port"])
@pytest.mark.parametrize("bw", [1, 3, 8, 12, 20, 32])
def test_rle_hybrid_decode_device(rng, bw, encoder):
    n = 5000
    vals = _runs(rng, n, bw)
    stream = (jenc if encoder == "jax" else tenc).rle_encode(vals, bw)
    tables = tdd.parse_rle_segments(stream, n, bw)
    for got, want in zip(tables, jdd.parse_rle_segments(stream, n, bw)):
        np.testing.assert_array_equal(got, want)
    got = _rle_decode(stream, n, bw)
    np.testing.assert_array_equal(
        got, np.asarray(jdd.rle_decode_device(stream, n, bw)))
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(jenc.rle_decode(stream, n, bw), vals)


def test_rle_encoder_writes_runs_of_at_most_512_values(rng):
    vals = _vals(rng, 5000, 7)
    vals[1000:1100] = 3
    stream = tenc.rle_encode(vals, 7)
    st, is_run, _, _ = tdd.parse_rle_segments(stream, 5000, 7)
    lengths = np.diff(np.append(st, 5000))
    assert lengths.max() <= 512
    assert is_run.sum() == 1 and lengths[is_run == 1][0] >= 92
    np.testing.assert_array_equal(jenc.rle_decode(stream, 5000, 7), vals)


@pytest.mark.parametrize("cut", ["whole", "n_mid_run", "n_at_run_end",
                                 "bytes_mid_run"])
def test_parse_rle_segments_takes_equal_runs_together(rng, cut):
    """Streams of many equal full runs (the port's writer's) parse to
    the JAX package's tables, however n or the bytes end."""
    vals = _vals(rng, 6000, 9)
    vals[2000:2300] = 5                       # one RLE run in the middle
    stream = tenc.rle_encode(vals, 9)
    n = {"n_mid_run": 4100, "n_at_run_end": 5120}.get(cut, 6000)
    if cut == "bytes_mid_run":
        stream = stream[:len(stream) - 700]
    got = tdd.parse_rle_segments(stream, n, 9)
    for g, w in zip(got, jdd.parse_rle_segments(stream, n, 9)):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 5
    if cut != "bytes_mid_run":
        np.testing.assert_array_equal(_rle_decode(stream, n, 9), vals[:n])


def test_rle_decode_device_zero_width():
    assert _rle_decode(b"", 7, 0).tolist() == [0] * 7


def test_levels_stream_decode_device(rng):
    """def-levels as the port's writer writes them (v1: 4-byte length +
    hybrid), read by both packages."""
    levels = (rng.random(4096) < 0.9).astype(np.uint32)
    stream = tenc.levels_encode_v1(levels, 1)
    oracle, used = jenc.levels_decode_v1(stream, len(levels), 1)
    got = _rle_decode(stream[4:used], len(levels), 1)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("npdt", [np.int32, np.int64, np.float32,
                                  np.float64])
def test_plain_decode_device(rng, npdt):
    n = 777
    vals = rng.standard_normal(n).astype(npdt) if np.dtype(npdt).kind == "f" \
        else rng.integers(np.iinfo(npdt).min, np.iinfo(npdt).max, n,
                          dtype=npdt)
    raw = vals.tobytes()
    phys = {np.int32: "INT32", np.int64: "INT64", np.float32: "FLOAT",
            np.float64: "DOUBLE"}[npdt]
    assert tenc.plain_encode(tfmt.Type[phys], vals) == \
        jenc.plain_encode(jfmt.Type[phys], vals)
    # a slice at an odd offset takes the copy before the view
    buf = torch.from_numpy(np.frombuffer(b"\0" + raw, np.uint8).copy())
    for t in (buf[1:].clone(), buf[1:]):
        got = tdd.plain_decode_device(t, npdt, n).numpy()
        want = np.asarray(jdd.plain_decode_device(
            jnp.asarray(np.frombuffer(raw, np.uint8)), npdt, n))
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("npdt", [np.float32, np.float64])
def test_byte_stream_split_decode_device(rng, npdt):
    n = 513
    k = np.dtype(npdt).itemsize
    vals = rng.standard_normal(n).astype(npdt)
    raw = jenc.byte_stream_split_encode(vals.view(np.uint8).reshape(n, k))
    got = tdd.byte_stream_split_decode_device(
        torch.from_numpy(np.frombuffer(raw, np.uint8).copy()), npdt,
        n).numpy()
    want = np.asarray(jdd.byte_stream_split_decode_device(
        jnp.asarray(np.frombuffer(raw, np.uint8)), npdt, n))
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_dict_decode_device(rng, dtype):
    dictionary = rng.standard_normal(37).astype(dtype) * 100
    codes = rng.integers(0, 37, 999).astype(np.uint32)
    got = tdd.dict_decode_device(torch.from_numpy(codes.astype(np.int64)),
                                 torch.from_numpy(dictionary)).numpy()
    want = np.asarray(jdd.dict_decode_device(jnp.asarray(codes),
                                             jnp.asarray(dictionary)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dictionary[codes])


@pytest.mark.parametrize("phys", ["INT32", "INT64", "FLOAT", "DOUBLE",
                                  "BOOLEAN"])
def test_plain_decode_host_dictionary_page(rng, phys):
    """The host PLAIN decode of dictionary pages, against the JAX one."""
    n = 300
    dtype = {"INT32": np.int32, "INT64": np.int64, "FLOAT": np.float32,
             "DOUBLE": np.float64, "BOOLEAN": np.bool_}[phys]
    vals = rng.random(n) < 0.5 if phys == "BOOLEAN" else \
        (rng.standard_normal(n) * 1000).astype(dtype)
    data = jenc.plain_encode(jfmt.Type[phys], vals)
    assert tenc.plain_encode(tfmt.Type[phys], vals) == data
    got = tenc.plain_decode(tfmt.Type[phys], data, n)
    np.testing.assert_array_equal(got, jenc.plain_decode(jfmt.Type[phys],
                                                         data, n))
    np.testing.assert_array_equal(got, vals)
