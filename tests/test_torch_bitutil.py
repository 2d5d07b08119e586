"""The port's memory/bitutil.py against the JAX package's on the same
seeded bitmaps: every case of tests/test_bitutil.py on both modules,
bytes, bools, counts and indices bit for bit, and the functions that
file does not cover (set_bits_to, bitmap_xor, the byte helpers)."""
import numpy as np
import pytest

from arrow_go_tpu.memory import bitutil as jb

from arrow_go_tpu_torch.memory import bitutil as tb

BOTH = [jb, tb]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 65, 1000])
def test_pack_unpack_roundtrip(rng, n):
    bools = rng.random(n) < 0.5
    packed = tb.pack_bits(bools)
    np.testing.assert_array_equal(packed, jb.pack_bits(bools))
    np.testing.assert_array_equal(tb.unpack_bits(packed, n), bools)
    np.testing.assert_array_equal(tb.pack_bits(bools, n // 2),
                                  jb.pack_bits(bools, n // 2))


@pytest.mark.parametrize("off", [0, 1, 7, 8, 13, 64])
def test_unpack_with_offset(rng, off):
    bools = rng.random(100) < 0.5
    packed = jb.pack_bits(bools)
    for m in BOTH:
        np.testing.assert_array_equal(m.unpack_bits(packed, 100 - off, off),
                                      bools[off:])
    np.testing.assert_array_equal(tb.unpack_bits(packed.tobytes(), 50, off),
                                  jb.unpack_bits(packed.tobytes(), 50, off))


def test_count_set_bits(rng):
    bools = rng.random(1000) < 0.3
    packed = jb.pack_bits(bools)
    for off, ln in [(0, 1000), (3, 900), (8, 992), (17, 100), (995, 5),
                    (0, 0), (5, 3), (9, 6), (16, 16)]:
        want = int(bools[off:off + ln].sum())
        assert tb.count_set_bits(packed, off, ln) == want == \
            jb.count_set_bits(packed, off, ln)
    assert tb.count_set_bits(packed) == jb.count_set_bits(packed)
    assert tb.count_set_bits(packed.tobytes(), 3) == \
        jb.count_set_bits(packed.tobytes(), 3)


def test_get_set_clear():
    for m in BOTH:
        buf = np.zeros(4, dtype=np.uint8)
        m.set_bit(buf, 10)
        assert m.get_bit(buf, 10) and not m.get_bit(buf, 11)
        m.clear_bit(buf, 10)
        assert not m.get_bit(buf, 10)
        m.set_bit_to(buf, 31, True)
        assert m.get_bit(bytes(buf), 31)
        m.set_bit_to(buf, 31, False)
        assert not buf.any()


def test_bitmap_ops(rng):
    a = rng.random(200) < 0.5
    b = rng.random(200) < 0.5
    pa_, pb = jb.pack_bits(a), jb.pack_bits(b)
    for op, want in [("bitmap_and", a & b), ("bitmap_or", a | b)]:
        got = getattr(tb, op)(pa_, pb, 200)
        np.testing.assert_array_equal(got, getattr(jb, op)(pa_, pb, 200))
        np.testing.assert_array_equal(tb.unpack_bits(got, 200), want)
    np.testing.assert_array_equal(tb.bitmap_not(pa_, 197),
                                  jb.bitmap_not(pa_, 197))
    np.testing.assert_array_equal(tb.unpack_bits(tb.bitmap_not(pa_, 200),
                                                 200), ~a)
    np.testing.assert_array_equal(tb.bitmap_xor(pa_, pb, 200),
                                  jb.bitmap_xor(pa_, pb, 200))


def test_bitmap_and_offset(rng):
    a = rng.random(64) < 0.5
    b = rng.random(64) < 0.5
    pa_, pb = jb.pack_bits(a), jb.pack_bits(b)
    for op, f in [("bitmap_and", np.logical_and), ("bitmap_or", np.logical_or)]:
        got = getattr(tb, op)(pa_, pb, 50, 3, 9)
        np.testing.assert_array_equal(got, getattr(jb, op)(pa_, pb, 50, 3, 9))
        np.testing.assert_array_equal(tb.unpack_bits(got, 50),
                                      f(a[3:53], b[9:59]))


def test_bits_to_indices(rng):
    bools = rng.random(300) < 0.2
    packed = jb.pack_bits(bools)
    got = tb.bits_to_indices(packed, 300)
    np.testing.assert_array_equal(got, np.nonzero(bools)[0])
    np.testing.assert_array_equal(tb.bits_to_indices(packed, 200, 50),
                                  jb.bits_to_indices(packed, 200, 50))
    assert got.dtype == np.int64


def test_bit_runs(rng):
    bools = np.array([1, 1, 0, 0, 0, 1, 0, 1, 1, 1], dtype=bool)
    for m in BOTH:
        runs = list(m.bit_runs(m.pack_bits(bools), 10))
        assert [(r.value, r.length) for r in runs] == [
            (True, 2), (False, 3), (True, 1), (False, 1), (True, 3)]
    many = rng.random(500) < 0.7
    packed = jb.pack_bits(many)
    assert [(r.value, r.length) for r in tb.bit_runs(packed, 480, 7)] == \
        [(r.value, r.length) for r in jb.bit_runs(packed, 480, 7)]
    assert list(tb.bit_runs(packed, 0)) == []
    assert repr(tb.BitRun(True, 3)) == repr(jb.BitRun(True, 3))


def test_set_bits_to_and_the_byte_helpers(rng):
    bools = rng.random(70) < 0.5
    for off, ln, v in [(3, 20, True), (0, 70, False), (60, 10, True),
                       (5, 0, True)]:
        x, y = jb.pack_bits(bools), jb.pack_bits(bools)
        jb.set_bits_to(x, off, ln, v)
        tb.set_bits_to(y, off, ln, v)
        np.testing.assert_array_equal(x, y)
    for n in [0, 1, 7, 8, 9, 64, 65]:
        assert tb.bytes_for_bits(n) == jb.bytes_for_bits(n)
        assert tb.ceil_byte(n) == jb.ceil_byte(n)


def test_the_memory_package_exports_bitutil():
    import arrow_go_tpu.memory as jm
    import arrow_go_tpu_torch.memory as tm
    assert tm.bitutil is tb and jm.bitutil is jb
