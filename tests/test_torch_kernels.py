"""Parity of the port's kernel modules with the JAX package, on the CPU.

The port runs its plain PyTorch versions here (CPU tensors); the JAX
package runs its CPU fallbacks (ops/compaction.py:203, ops/scan.py:49),
as its own tests do. K1 (compact_flagged) and K2 (cummax_u64_lanes)
must agree bit for bit, as must bitmaps and sort permutations.
"""
import numpy as np
import pytest
import torch

import jax
from arrow_go_tpu.jaxenv import jnp
from arrow_go_tpu.ops import bitmap as jbitmap
from arrow_go_tpu.ops import compaction as jcompaction
from arrow_go_tpu.ops import scan as jscan
from arrow_go_tpu.ops import sort as jsort

from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.ops import bitmap, compaction, scan, sort
from torch_parity import words_u32

DTYPES = ["bool", "int8", "uint16", "int32", "uint32", "int64", "uint64",
          "float16", "float32", "float64"]


def _rand(rng, d, n):
    if d == "bool":
        return rng.random(n) > 0.4
    if d.startswith("float"):
        return rng.standard_normal(n).astype(d)
    info = np.iinfo(d)
    return rng.integers(info.min, int(info.max) + 1, n, dtype=np.dtype(d))


def _bits(a):
    """Bit patterns, so float NaNs and -0.0 compare exactly."""
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.itemsize}") if a.dtype != np.bool_ else a


# ---------------------------------------------------------------- K1

@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("d", DTYPES)
def test_compact_flagged_matches_jax(d, density):
    rng = np.random.default_rng(7)
    n = 3001
    keep = rng.random(n) < density
    a = _rand(rng, d, n)
    (got,) = compaction.compact_flagged(torch.from_numpy(keep),
                                        (torch.from_numpy(a),))
    (want,) = jcompaction.compact_flagged(jnp.asarray(keep),
                                          (jnp.asarray(a),))
    got = got.numpy()
    assert got.dtype == a.dtype and got.shape == a.shape
    c = int(keep.sum())
    np.testing.assert_array_equal(_bits(got[:c]), _bits(np.asarray(want)[:c]))
    # the whole length is the stable partition, as _sort_compact gives it
    (whole,) = jcompaction._sort_compact(jnp.asarray(keep), (jnp.asarray(a),))
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(whole)))


def test_compact_flagged_stability_and_multi_payload():
    rng = np.random.default_rng(3)
    n = 4096
    keep = rng.random(n) > 0.7
    ids = np.arange(n, dtype=np.int32)
    vals = rng.standard_normal(n)
    flags = rng.random(n) > 0.5
    got = compaction.compact_flagged(
        torch.from_numpy(keep),
        (torch.from_numpy(ids), torch.from_numpy(vals),
         torch.from_numpy(flags)))
    want = jcompaction._sort_compact(
        jnp.asarray(keep), (jnp.asarray(ids), jnp.asarray(vals),
                            jnp.asarray(flags)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c = int(keep.sum())
    assert np.all(np.diff(got[0].numpy()[:c]) > 0)
    assert np.all(np.diff(got[0].numpy()[c:]) > 0)


TILE = compaction._TILE
MIXED = ["bool", "int8", "int16", "float16", "int32", "float32", "int64",
         "float64"] * 2                  # 16 payloads of 1, 2, 4, 8 bytes


def _k1_both(keep, pays):
    """The port's compact_flagged against the JAX compact_flagged over the
    [0, count) prefix and against the plain version over the whole
    length, payload by payload, bit for bit."""
    got = compaction.compact_flagged(torch.from_numpy(keep),
                                     tuple(torch.from_numpy(p) for p in pays))
    want = jcompaction.compact_flagged(jnp.asarray(keep),
                                       tuple(jnp.asarray(p) for p in pays))
    whole = compaction.compact_flagged_plain(
        torch.from_numpy(keep), tuple(torch.from_numpy(p) for p in pays))
    c = int(keep.sum())
    assert len(got) == len(pays)
    for g, w, h, p in zip(got, want, whole, pays):
        g = g.numpy()
        assert g.dtype == p.dtype and g.shape == p.shape
        np.testing.assert_array_equal(_bits(g[:c]), _bits(np.asarray(w)[:c]))
        np.testing.assert_array_equal(_bits(g), _bits(h.numpy()))


@pytest.mark.parametrize("off", [1, 3, 5])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 2 * TILE + 3])
def test_compact_flagged_offset_views_match_jax(n, off):
    """keep and the payloads as views that start `off` elements into a
    larger array (not 16-byte aligned)."""
    rng = np.random.default_rng(n + off)
    keep = (rng.random(n + off) < 0.5)[off:]
    pays = tuple(_rand(rng, d, n + off)[off:] for d in
                 ("int64", "float64", "int32", "uint16", "bool"))
    assert not keep.flags.owndata and keep.ctypes.data % 16
    _k1_both(keep, pays)


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n", [TILE - 1, TILE + 1, 3 * TILE])
def test_compact_flagged_sixteen_mixed_payloads_match_jax(n, density):
    rng = np.random.default_rng(n)
    keep = rng.random(n) < density
    _k1_both(keep, tuple(_rand(rng, d, n) for d in MIXED))


def test_compact_flagged_wrapper_raises_on_what_k1_does_not_take():
    """The CUDA wrapper's checks, which run before any launch."""
    keep = torch.ones(8, dtype=torch.bool)
    x = torch.arange(8)
    bad = [
        (keep.to(torch.uint8), (x,)),                     # keep not bool
        (torch.ones(16, dtype=torch.bool)[::2], (x,)),    # keep strided
        (keep, ()),                                       # no payload
        (keep, (x,) * 17),                                # too many
        (keep, (torch.arange(9),)),                       # length
        (keep, (torch.arange(16)[::2],)),                 # strided payload
        (keep, (x.reshape(2, 4),)),                       # not 1-D
        (keep, (torch.zeros(8, dtype=torch.complex128),)),  # 16-byte rows
    ]
    for k, pays in bad:
        with pytest.raises(ValueError, match="compact_flagged"):
            compaction._compact_cuda(k, pays)


# ---------------------------------------------------------------- K2

@pytest.mark.parametrize("n", [1, 777, 8192 * 4 + 5])
def test_cummax_u64_lanes_matches_jax(n):
    rng = np.random.default_rng(11)
    # sparse set slots over zero (unset) slots, as the join scatters
    # them: a monotone hi with ties against the zero slots, lo lanes
    # with bit 31 set
    setp = rng.random(n) < 0.1
    hi = np.where(setp, np.cumsum(setp).astype(np.uint32) * 3, 0)
    hi = hi.astype(np.uint32)
    hi[rng.random(n) < 0.02] = np.uint32(0xFFFFFFF0)
    los = [np.where(setp, rng.integers(0, 2 ** 32, n), 0).astype(np.uint32)
           for _ in range(2)]
    want = jscan.cummax_u64_lanes(jnp.asarray(hi),
                                  [jnp.asarray(x) for x in los])
    got = scan.cummax_u64_lanes(
        torch.from_numpy(hi.astype(np.int64)),
        [torch.from_numpy(x.astype(np.int64)) for x in los])
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int64))


def _fill_lane(kind, n, rng):
    """One u32 lane as the join state hands K2's hi-only mode: run-start
    marks that grow along the rows, zero elsewhere (R_before, L_before);
    grp_L_end's reversed imax - end-of-run marks; or random u32 values,
    bit 31 set in about half."""
    marks = np.cumsum(rng.integers(0, 3, n))
    at = rng.random(n) < 0.3
    imax = (1 << 31) - 1
    if kind == "marks":
        return np.where(at, marks, 0).astype(np.uint32)
    if kind == "reversed":
        return (imax - np.where(at, marks, imax))[::-1].astype(np.uint32)
    return rng.integers(0, 2 ** 32, n).astype(np.uint32)


@pytest.mark.parametrize("kind", ["marks", "reversed", "random"])
@pytest.mark.parametrize("n", [1, 31, 8191, 8192, 65_537])
def test_cummax_u32_matches_jax_hi_lane(n, kind):
    """cummax_u32 (K2's hi-only mode) against the JAX package's hi lane
    of cummax_u64_lanes(x, [zeros]), bit for bit."""
    x = _fill_lane(kind, n, np.random.default_rng(n))
    want = jscan.cummax_u64_lanes(jnp.asarray(x),
                                  [jnp.zeros(n, jnp.uint32)])[0]
    t = torch.from_numpy(x.astype(np.int64))
    got = scan.cummax_u32(t)
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    # the plain version of the mode, and the pack call with no lo lane
    np.testing.assert_array_equal(scan.cummax_u32_plain(t).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(scan.cummax_u64_lanes(t, [])[0].numpy(),
                                  got.numpy())


def test_cummax_wrapper_raises_on_what_k2_does_not_take():
    """The CUDA wrapper's checks, which run before any launch."""
    x = torch.arange(8)
    bad = [
        (x, [x] * 5),                                  # too many lo lanes
        (x.to(torch.int32), []),                       # not int64
        (torch.arange(16)[::2], []),                   # strided
        (x.reshape(2, 4), []),                         # not 1-D
        (x, [torch.arange(9)]),                        # length
        (x, [x.to(torch.int32)]),                      # lo not int64
    ]
    for hi, los in bad:
        with pytest.raises(ValueError, match="cummax_u64_lanes"):
            scan._cummax_cuda(hi, los)


# ---------------------------------------------------------------- bitmaps

@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
def test_bitmap_words_match_jax(n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) > 0.3
    mask[-1] = True                  # bit 31 of a word set where it exists
    tw = bitmap.pack_mask(torch.from_numpy(mask))
    jw = np.asarray(jbitmap.pack_mask(jnp.asarray(mask)))
    np.testing.assert_array_equal(words_u32(tw), jw)
    padded = (n + 31) // 32 * 32
    np.testing.assert_array_equal(
        bitmap.expand_words(tw, padded).numpy(),
        np.asarray(jbitmap.expand_words(jnp.asarray(jw), padded)))
    assert int(bitmap.popcount_words(tw)) == int(
        jbitmap.popcount_words(jnp.asarray(jw)))
    np.testing.assert_array_equal(
        words_u32(bitmap.words_not(tw, n)),
        np.asarray(jbitmap.words_not(jnp.asarray(jw), n)))
    other = rng.random(n) > 0.5
    other[-1] = True
    tw2 = bitmap.pack_mask(torch.from_numpy(other))
    jw2 = jnp.asarray(words_u32(tw2))
    for name in ("words_and", "words_or", "words_xor"):
        np.testing.assert_array_equal(
            words_u32(getattr(bitmap, name)(tw, tw2)),
            np.asarray(getattr(jbitmap, name)(jnp.asarray(jw), jw2)))
    for length in (0, n // 2, n):
        np.testing.assert_array_equal(
            words_u32(bitmap.length_words(padded, length, "cpu")),
            np.asarray(jbitmap.length_words(padded, length)))


# ---------------------------------------------------------------- sorts

def test_lexsort_stable_matches_lax_sort():
    rng = np.random.default_rng(5)
    n = 2000
    flag = rng.integers(0, 3, n).astype(np.int32)
    k64 = rng.integers(-5, 5, n).astype(np.int64) * (1 << 40)
    hi = rng.integers(0, 4, n).astype(np.uint32) | np.uint32(1 << 31)
    lo = rng.integers(0, 3, n).astype(np.uint32)
    iota = np.arange(n, dtype=np.int32)
    want = jax.lax.sort(tuple(jnp.asarray(x) for x in (flag, k64, hi, lo,
                                                       iota)),
                        num_keys=4, is_stable=True)[-1]
    got = sort.lexsort_stable([torch.from_numpy(flag),
                               torch.from_numpy(k64),
                               torch.from_numpy(hi.astype(np.int64)),
                               torch.from_numpy(lo.astype(np.int64))])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", ["bool", "int32", "int64", "float32",
                               "float64"])
def test_orderable_bits_match_jax(d):
    rng = np.random.default_rng(9)
    a = _rand(rng, d, 500)
    if d.startswith("float"):
        a[:6] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0]
    got = sort._orderable_bits(torch.from_numpy(a)).numpy().view(np.uint64)
    want = np.asarray(jsort._orderable_bits(jnp.asarray(a), None)
                      ).astype(np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_first", [False, True])
def test_argsort_single_matches_jax(descending, nulls_first):
    rng = np.random.default_rng(13)
    n, P = 300, 384
    vals = np.zeros(P)
    vals[:n] = np.round(rng.standard_normal(n), 1)
    vals[:3] = np.nan
    valid = rng.random(P) > 0.2
    words = np.packbits(valid, bitorder="little").view(np.uint32)
    jop = jsort.sort_key(jnp.asarray(vals), None, jnp.asarray(words), n,
                         descending=descending, nulls_first=nulls_first)
    top = sort.sort_key(torch.from_numpy(vals), tdt.float64,
                        torch.from_numpy(words.view(np.int32)), n,
                        descending=descending, nulls_first=nulls_first)
    np.testing.assert_array_equal(top.flag.numpy(), np.asarray(jop.flag))
    np.testing.assert_array_equal(sort.argsort_single(top).numpy(),
                                  np.asarray(jsort.argsort_single(jop)))
