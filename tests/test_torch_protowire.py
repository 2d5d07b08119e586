"""The port's protobuf wire format (arrow_go_tpu_torch/interop/
protowire.py) against the JAX package's: the same varints, tags, fixed
and length-delimited fields, byte for byte, on values made from a seed;
each package reads the other's messages field by field; zigzag both
ways."""
import numpy as np
import pytest

from arrow_go_tpu.interop import protowire as jpw

from arrow_go_tpu_torch.interop import protowire as pw

EDGES = [0, 1, 127, 128, 255, 256, 16383, 16384, 2 ** 31 - 1, 2 ** 31,
         2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 64 - 1, -1, -2, -(2 ** 31),
         -(2 ** 63)]


def _values(seed: int, n: int = 200) -> list:
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 64, n)
    out = [int(rng.integers(0, 2 ** int(b), dtype=np.uint64)) for b in bits]
    return out + [-v for v in out[::3]] + EDGES


@pytest.mark.parametrize("seed", range(4))
def test_varints_are_the_jax_bytes_and_read_back(seed):
    for v in _values(seed):
        mine, theirs = bytearray(), bytearray()
        pw.put_varint(mine, v)
        jpw.put_varint(theirs, v)
        assert mine == theirs, v
        got, p = pw.get_varint(bytes(mine), 0)
        assert p == len(mine)
        assert got == v % (1 << 64)
        assert jpw.get_varint(bytes(mine), 0) == (got, p)


@pytest.mark.parametrize("v", EDGES[:13])
def test_zigzag_matches_both_ways(v):
    for x in (v, -v):
        if not -(2 ** 63) <= x < 2 ** 63:
            continue
        z = pw.zigzag_encode(x)
        assert z == jpw.zigzag_encode(x)
        assert pw.zigzag_decode(z) == x == jpw.zigzag_decode(z)


def _message(m, rng) -> bytearray:
    """One message of every field kind, in package `m`, from `rng`."""
    out = bytearray()
    m.put_field_varint(out, 1, int(rng.integers(0, 2 ** 40)))
    m.put_field_str(out, 2, "héllo-" + str(int(rng.integers(0, 10 ** 6))))
    m.put_field_bytes(out, 3, rng.bytes(int(rng.integers(0, 300))))
    m.put_field_double(out, 4, float(rng.standard_normal()))
    m.put_field_float(out, 5, float(np.float32(rng.standard_normal())))
    inner = bytearray()
    m.put_field_varint(inner, 7, -int(rng.integers(1, 1000)))
    m.tag(inner, 9, m.WT_VARINT)
    m.put_varint(inner, 5)
    m.put_field_msg(out, 6, inner)
    m.put_field_varint(out, 2 ** 20, 3)          # a multi-byte tag
    m.put_field_str(out, 2, "again")
    return out


@pytest.mark.parametrize("seed", range(6))
def test_messages_are_the_jax_bytes_and_read_across(seed):
    mine = _message(pw, np.random.default_rng(seed))
    theirs = _message(jpw, np.random.default_rng(seed))
    assert mine == theirs
    got = list(pw.fields(bytes(theirs)))
    want = list(jpw.fields(bytes(mine)))
    assert [(f, w) for f, w, _ in got] == [(f, w) for f, w, _ in want]
    assert [bytes(v) if isinstance(v, (bytes, memoryview)) else v
            for *_, v in got] == [bytes(v) if isinstance(
                v, (bytes, memoryview)) else v for *_, v in want]
    d, jd = pw.to_dict(bytes(mine)), jpw.to_dict(bytes(mine))
    assert d == jd
    assert [v.decode() for v in d[2]][1] == "again"
    assert pw.first(d, 2) == jpw.first(jd, 2)
    assert pw.first(d, 99, "none") == "none"
    inner = pw.to_dict(d[6][0])
    assert inner[7][0] >= 2 ** 63         # a negative varint: 64-bit
    assert inner[9] == [5]


def test_unsupported_wire_type_raises_in_both():
    bad = bytes([(1 << 3) | 3])           # wire type 3, a start group
    with pytest.raises(ValueError):
        list(pw.fields(bad))
    with pytest.raises(ValueError):
        list(jpw.fields(bad))


def test_wire_type_constants_match():
    for n in ("WT_VARINT", "WT_FIXED64", "WT_BYTES", "WT_FIXED32"):
        assert getattr(pw, n) == getattr(jpw, n)
