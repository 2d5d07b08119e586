"""The port's zstd codec and XXH64 (csrc/codecs.cc) against the zstandard
and xxhash packages, which only the tests import: frames that zstandard
writes at levels -5 to 19, with and without the content checksum and the
content size, decode byte for byte; concatenated and skippable frames
decode; truncated and bit-flipped frames raise ArrowInvalid; frames the
port's encoder writes decode in zstandard."""
import numpy as np
import pytest
import xxhash
import zstandard
from hypothesis import given, settings, strategies as st

from arrow_go_tpu_torch import native
from arrow_go_tpu_torch.compute.errors import ArrowInvalid


def _inputs():
    rng = np.random.default_rng(21)
    text = b"".join(b"%d|Customer#%09d|the quick brown fox %d\n"
                    % (i, i * 7919 % 100000, i % 13) for i in range(9000))
    return {
        "empty": b"",
        "one": b"\x07",
        "random": rng.bytes(200_000),
        "zeros": bytes(300_000),
        "text": text,
        # parquet-page-like: int32 keys and rounded f64 prices, > 128 KiB
        # so that a frame has several blocks
        "int_page": rng.integers(0, 60_000, 90_000).astype("<i4").tobytes(),
        "f64_page": np.round(rng.uniform(1, 1000, 40_000), 2).astype(
            "<f8").tobytes(),
        # literals Huffman-coded as one stream
        "short_text": text[:300],
        # a small alphabet: Huffman weights stored directly, not FSE-coded
        "small_alphabet": rng.integers(0, 6, 3000).astype(np.uint8
                                                          ).tobytes(),
        # a pattern with "Z" inserted: blocks whose literals are one byte
        # repeated (RLE literals)
        "z_inserts": b"".join(
            np.insert(np.tile(np.arange(256, dtype=np.uint8), 16),
                      np.sort(rng.integers(0, 4096, 200)), ord("Z")
                      ).tobytes() for _ in range(60)),
    }


INPUTS = _inputs()
LEVELS = (-5, 1, 3, 9, 19)


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decoder_matches_zstandard(name, level, checksum, content_size):
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)
    assert bytes(native.zstd_decompress(frame, len(data))) == data


@pytest.mark.parametrize("level", LEVELS)
def test_streamed_frames_of_several_blocks(level):
    """A frame written in pieces (flushed blocks, no content size in its
    header, a window descriptor) holds matches that reach back across
    block boundaries."""
    data = INPUTS["text"] + INPUTS["int_page"]
    co = zstandard.ZstdCompressor(level=level, write_checksum=True
                                  ).compressobj()
    frame = b"".join([co.compress(data[:70_000]),
                      co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK),
                      co.compress(data[70_000:]), co.flush()])
    assert bytes(native.zstd_decompress(frame, len(data))) == data


def test_concatenated_and_skippable_frames():
    a, b = INPUTS["text"][:5000], INPUTS["f64_page"]
    skippable = (0x184D2A53).to_bytes(4, "little") + (6).to_bytes(
        4, "little") + b"ignore"
    stream = (zstandard.ZstdCompressor(level=3).compress(a) + skippable
              + zstandard.ZstdCompressor(level=19, write_checksum=True
                                         ).compress(b)
              + bytes(native.zstd_compress(a, 1)))
    assert bytes(native.zstd_decompress(stream, 2 * len(a) + len(b))) == \
        a + b + a
    assert len(native.zstd_decompress(skippable, 0)) == 0


@pytest.mark.parametrize("name", ["text", "int_page", "f64_page"])
def test_truncated_frames_raise(name):
    data = INPUTS[name]
    for checksum in (True, False):
        frame = zstandard.ZstdCompressor(level=3, write_checksum=checksum
                                         ).compress(data)
        for cut in np.linspace(0, len(frame) - 1, 40).astype(int).tolist():
            with pytest.raises(ArrowInvalid):
                native.zstd_decompress(frame[:cut], len(data))


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", ["text", "int_page", "f64_page"])
def test_bit_flipped_frames_raise(name, level):
    """With the checksum on, a bit flipped anywhere past the frame header
    (blocks or checksum) raises: as a malformed stream or as a checksum
    that fails."""
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=True
                                     ).compress(data)
    rng = np.random.default_rng(level)
    for pos in rng.integers(14, len(frame), 60).tolist():
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        with pytest.raises(ArrowInvalid):
            native.zstd_decompress(bytes(bad), len(data))


def test_output_of_another_size_raises():
    data = INPUTS["text"]
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    for size in (len(data) - 1, len(data) + 1, 0):
        with pytest.raises(ArrowInvalid):
            native.zstd_decompress(frame, size)


@pytest.mark.parametrize("level", [-1, 1, 3, 6, 9, 12, 19])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_encoder_output_reads_in_zstandard(name, level):
    data = INPUTS[name]
    frame = bytes(native.zstd_compress(data, level))
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert bytes(native.zstd_decompress(frame, len(data))) == data
    assert zstandard.get_frame_parameters(frame).content_size == len(data)


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_encoder_ratio_is_below_zstandards(level):
    """The port's frames keep their literals raw, so on page-like inputs
    they are larger than the zstandard package's at the same level (the
    sizes print with `pytest -s`)."""
    sizes = {}
    for name in ("int_page", "f64_page", "text"):
        data = INPUTS[name]
        ours = len(native.zstd_compress(data, level))
        theirs = len(zstandard.ZstdCompressor(level=level).compress(data))
        assert ours >= theirs, name
        sizes[name] = (len(data), ours, theirs)
    print(f"zstd level {level} (input, port, zstandard bytes): {sizes}")


def test_encoder_searches_deeper_at_higher_levels():
    data = INPUTS["text"]
    sizes = [len(native.zstd_compress(data, lv)) for lv in (1, 3, 9, 19)]
    assert sizes == sorted(sizes, reverse=True) and sizes[-1] < sizes[0]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.binary(min_size=0, max_size=40),
                          st.integers(1, 60)), max_size=40),
       st.integers(-3, 12))
def test_round_trip(pieces, level):
    data = b"".join(p * k for p, k in pieces)
    frame = bytes(native.zstd_compress(data, level))
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert bytes(native.zstd_decompress(frame, len(data))) == data


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 15, 31, 32, 33, 63, 64,
                               100, 1000, 65_537])
def test_xxh64_matches_xxhash(n):
    data = np.random.default_rng(n).bytes(n)
    assert native.xxh64(data) == xxhash.xxh64_intdigest(data)
    ends = np.cumsum(np.random.default_rng(n + 1).integers(0, 9, 50))
    ends = np.minimum(ends, n)
    want = [xxhash.xxh64_intdigest(data[a:b]) for a, b in
            zip(np.concatenate(([0], ends[:-1])).tolist(), ends.tolist())]
    assert native.xxh64_rows(ends, np.frombuffer(data, np.uint8)).tolist() \
        == want
