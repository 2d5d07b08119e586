"""The port's host codec library (csrc/codecs.cc through
arrow_go_tpu_torch/native.py) against the JAX package's native codecs:
snappy and LZ4 raw bytes made by either package decompress in the other
to the same bytes. The library is built with g++ here, as on the card's
machine."""
import numpy as np
import pytest

from arrow_go_tpu import native as jnative

from arrow_go_tpu_torch import native as tnative
from arrow_go_tpu_torch.compute.errors import ArrowNotImplemented
from arrow_go_tpu_torch.parquet import compress as tcomp
from arrow_go_tpu_torch.parquet import format as tfmt


def _inputs():
    rng = np.random.default_rng(11)
    text = b"".join(b"row %d: l_returnflag=%s;" % (i, b"NRA"[i % 3:i % 3 + 1])
                    for i in range(40_000))
    return {
        "empty": b"",
        "one_byte": b"\x07",
        "incompressible": rng.integers(0, 256, 100_003, np.uint8).tobytes(),
        "text": text,
        "runs": np.repeat(rng.integers(0, 4, 70_000), 9).astype(
            np.uint8).tobytes(),
        "8MiB": np.tile(rng.integers(0, 1 << 20, 1 << 16, np.int64),
                        16).tobytes(),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_snappy_both_ways(name):
    data = INPUTS[name]
    ours = bytes(tnative.snappy_compress(data))
    assert jnative.snappy_decompress(ours) == data
    assert bytes(tnative.snappy_decompress(ours)) == data
    assert bytes(tnative.snappy_decompress(
        jnative.snappy_compress(data))) == data
    if name != "incompressible":
        assert len(ours) < len(data) or len(data) < 2


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_lz4_raw_both_ways(name):
    data = INPUTS[name]
    ours = bytes(tnative.lz4_compress(data))
    assert jnative.lz4_decompress(ours, len(data)) == data
    assert bytes(tnative.lz4_decompress(ours, len(data))) == data
    assert bytes(tnative.lz4_decompress(jnative.lz4_compress(data),
                                        len(data))) == data


@pytest.mark.parametrize("codec", ["snappy", "lz4_raw", "gzip", "none"])
def test_page_codec_round_trip(codec):
    c = tcomp.codec_for_name(codec)
    data = INPUTS["text"]
    assert bytes(tcomp.decompress(c, tcomp.compress(c, data),
                                  len(data))) == data


@pytest.mark.parametrize("codec", ["zstd", "brotli", "lzo"])
def test_codecs_not_ported_raise(codec):
    """brotli and lzo are not ported; of zstd, frames that name a
    dictionary are not."""
    if codec == "zstd":
        frame = bytes(tnative.zstd_compress(INPUTS["text"]))
        named = frame[:4] + bytes([frame[4] | 2, 1, 0]) + frame[5:]
        with pytest.raises(ArrowNotImplemented):
            tcomp.decompress(tfmt.Codec.ZSTD, named, len(INPUTS["text"]))
        return
    with pytest.raises(ArrowNotImplemented):
        tcomp.codec_for_name(codec)
    c = {"brotli": tfmt.Codec.BROTLI, "lzo": tfmt.Codec.LZO}[codec]
    with pytest.raises(ArrowNotImplemented):
        tcomp.decompress(c, b"\0", 1)


@pytest.mark.parametrize("stream", [b"\x05\x00", b"\xff\xff\xff\xff\xff\xff",
                                    b"\x04\x0eab"])
def test_malformed_snappy_raises(stream):
    with pytest.raises(ValueError):
        tnative.snappy_decompress(stream)


def test_lz4_past_its_stated_size_raises():
    data = INPUTS["text"]
    with pytest.raises(ValueError):
        tnative.lz4_decompress(tnative.lz4_compress(data), len(data) - 1)


def test_library_is_built_once_per_source(tmp_path, monkeypatch):
    src = tmp_path / "codecs.cc"
    src.write_bytes(tnative.SOURCE.read_bytes())
    monkeypatch.setattr(tnative, "SOURCE", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    first = tnative.build()
    stamp = first.stat().st_mtime_ns
    assert tnative.build() == first and first.stat().st_mtime_ns == stamp
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    assert tnative.build() != first


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "codecs.cc"
    src.write_text("int agt_snappy_compress( {\n")
    monkeypatch.setattr(tnative, "SOURCE", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host codec build failed") as e:
        tnative.build()
    assert "error" in str(e.value)
