"""ops/hashing.py of the port against the JAX package, on the CPU:
`hash32` bit for bit for every fixed-width dtype (NaN payloads, +-0.0,
infinities and denormals included) and for uint16 / uint32 columns in
the port's signed storage, `hash_combine`, the
first-occurrence `encode_codes` (codes, distinct count, null tracking,
first_index) and `value_counts_from_codes`."""
import numpy as np
import pytest
import torch

from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.jaxenv import jnp
from arrow_go_tpu.ops import hashing as jhashing

from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.ops import hashing

INT_DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64"]


def _values(rng, dtype: str, n: int = 2000) -> np.ndarray:
    d = np.dtype(dtype)
    if d.kind == "b":
        return rng.random(n) < 0.5
    if d.kind in "iu":
        info = np.iinfo(d)
        v = rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
        v[:4] = [info.min, info.max, 0, 1]
        return v
    v = (rng.standard_normal(n) * 1e3).astype(d)
    bits = v.view(f"u{d.itemsize}")
    special = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
               np.finfo(d).tiny / 4, -np.finfo(d).tiny / 8, np.finfo(d).max]
    v[:len(special)] = np.array(special, d)
    # NaNs with other payloads (signalling, negative) hash as one NaN
    top = np.array(((1 << (d.itemsize * 8 - 1)) - 1), bits.dtype)
    bits[20:24] = top - np.arange(4, dtype=bits.dtype)
    return v


@pytest.mark.parametrize("dtype", ["bool"] + INT_DTYPES
                         + ["float16", "float32", "float64"])
def test_hash32_bit_identical_to_jax(rng, dtype):
    v = _values(rng, dtype)
    want = np.asarray(jhashing.hash32(jnp.asarray(v)))
    got = hashing.hash32(torch.from_numpy(v))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if v.dtype.kind == "f":
        # canonical NaN and zero: every NaN alike, -0.0 as 0.0
        nan = np.isnan(v)
        assert len(set(got.numpy()[nan].tolist())) == 1
        assert got[4] == got[5]


@pytest.mark.parametrize("name", ["uint16", "uint32"])
def test_hash32_of_unsigned_storage_matches_jax(rng, name):
    """A uint16 or uint32 column lives in int16 or int32 storage; its
    hash zero-extends the bits, as the JAX package's uint32 cast does
    (65535 hashes as 0x0000ffff, not as a sign-extended -1)."""
    t = tdt.type_for_name(name)
    edges = [0, 1, 2**15, 2**16 - 1, 2**31, 2**32 - 1]
    v = np.array([e for e in edges if e < 1 << t.bit_width]
                 + rng.integers(0, 1 << t.bit_width, 500).tolist(),
                 t.np_dtype)
    want = np.asarray(jhashing.hash32(jnp.asarray(v))).astype(np.int64)
    stored = torch.from_numpy(v.view(f"i{v.itemsize}"))
    np.testing.assert_array_equal(hashing.hash32(stored, t).numpy(), want)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float64"])
def test_hash_combine_bit_identical_to_jax(rng, dtype):
    a, b = _values(rng, dtype), _values(rng, dtype)[::-1].copy()
    ja, jb = jhashing.hash32(jnp.asarray(a)), jhashing.hash32(jnp.asarray(b))
    ta, tb = hashing.hash32(torch.from_numpy(a)), hashing.hash32(
        torch.from_numpy(b))
    want = np.asarray(jhashing.hash_combine(ja, jb)).astype(np.int64)
    np.testing.assert_array_equal(hashing.hash_combine(ta, tb).numpy(),
                                  want)


def _column(rng, kind: str, n: int, P: int):
    """(values[P], jax type, port type, validity words or None)."""
    if kind == "int64":
        v = np.zeros(P, np.int64)
        v[:n] = rng.integers(-30, 30, n)
        t = (jdt.int64, tdt.int64)
    elif kind == "int32":
        v = np.zeros(P, np.int32)
        v[:n] = rng.integers(0, 500, n)
        t = (jdt.int32, tdt.int32)
    else:
        v = np.zeros(P, np.float64)
        v[:n] = np.round(rng.standard_normal(n), 1)
        v[rng.integers(0, max(n, 1), 9)] = np.nan
        v[rng.integers(0, max(n, 1), 9)] = -0.0
        t = (jdt.float64, tdt.float64)
    return v, t


@pytest.mark.parametrize("kind", ["int64", "int32", "float64"])
@pytest.mark.parametrize("nulls", ["none", "some", "all"])
@pytest.mark.parametrize("n,P", [(1000, 1024), (1024, 1024), (0, 128)])
def test_first_occurrence_encode_matches_jax(rng, kind, nulls, n, P):
    v, (jt, tt) = _column(rng, kind, n, P)
    valid = np.zeros(P, np.bool_)
    valid[:n] = True if nulls == "none" else (
        rng.random(n) > 0.2 if nulls == "some" else False)
    words = None if nulls == "none" else np.packbits(
        valid, bitorder="little").view(np.uint32)
    jr = jhashing.encode_codes(jnp.asarray(v), jt,
                               None if words is None else jnp.asarray(words),
                               n)
    tr = hashing.encode_codes(
        torch.from_numpy(v), tt,
        None if words is None else torch.from_numpy(words.view(np.int32)),
        n)
    k = int(jr.n_unique)
    assert int(tr.n_unique) == k
    assert bool(tr.has_null) == bool(jr.has_null)
    assert int(tr.null_first_row) == int(jr.null_first_row)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.first_index.numpy()[:k],
                                  np.asarray(jr.first_index)[:k])
    # first occurrence: code c's first row precedes code c+1's
    assert np.all(np.diff(tr.first_index.numpy()[:k]) > 0)
    jc = jhashing.value_counts_from_codes(jr, P, n)
    tc = hashing.value_counts_from_codes(tr, P, n)
    np.testing.assert_array_equal(tc.numpy()[:k], np.asarray(jc)[:k])
    assert int(tc[P]) == int(np.asarray(jc)[P])


def test_encode_codes_rejects_an_unknown_order():
    with pytest.raises(ValueError):
        hashing.encode_codes(torch.zeros(128, dtype=torch.int64), tdt.int64,
                             None, 128, order="sorted")
