"""The port's run-end encoding and `sort` against the JAX package's.

The same seeded columns (runs of repeated values, nulls and null runs,
NaN and both zeros) go to the JAX `run_end_encode` and to the port's,
through the functions and through both `call_function`s, as host arrays
and as device columns, whole and sliced: the types, the run ends, the
run values and the decoded rows must agree, ints and strings exactly,
floats by their bits (NaN and -0.0 included). The port's run starts
come from K1's plain version here (the CPU), the JAX package's from its
host np.nonzero."""
import decimal

import numpy as np
import pytest

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.compute.run_ends import run_end_decode as jdecode
from arrow_go_tpu.compute.run_ends import run_end_encode as jencode
from arrow_go_tpu.device.block import to_device

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute.run_ends import run_starts
from arrow_go_tpu_torch.device.block import (HostArray, HostBatch,
                                             RunEndEncodedArray,
                                             batch_to_device,
                                             device_batch_to_host,
                                             host_array_to_device)
from arrow_go_tpu_torch.ops import compaction
from arrow_go_tpu_torch.ops.decimal import from_ints
from torch_parity import (jax_array, jax_type, port_array,
                          same_array)

TYPES = [dt.bool_, dt.int8, dt.int16, dt.int32, dt.int64, dt.uint8,
         dt.uint16, dt.uint32, dt.uint64, dt.float16, dt.float32,
         dt.float64, dt.date32, dt.date64, dt.timestamp("ms"),
         dt.timestamp("us", "UTC"), dt.time32("s"), dt.time64("us"),
         dt.duration("ms"), dt.string, dt.decimal32(7, 2),
         dt.decimal64(15, 2)]
RUN_END_TYPES = [dt.int16, dt.int32, dt.int64]
N = 120


def _pool(t, rng) -> list:
    """A few distinct Python values of t (runs repeat them)."""
    if t == dt.bool_:
        return [True, False]
    if t == dt.string:
        return ["a", "bb", "", "ccc", "d"]
    if t.is_decimal:
        return [decimal.Decimal(f"{x}.{y:02d}") for x, y in
                zip(rng.integers(-99, 99, 4), rng.integers(0, 99, 4))]
    if t.is_floating:
        return [0.0, -0.0, 1.5, -2.25, float("nan"), float("inf")]
    if t.is_unsigned_integer:
        top = 2 ** t.bit_width - 1
        return [0, 1, top, top - 1, 2 ** (t.bit_width - 1)]
    return [int(x) for x in rng.integers(-100 if t.is_signed_integer
                                         else 0, 100, 5)]


def runs_of(t, n: int = N, seed: int = 0, null_p: float = 0.15) -> HostArray:
    """n rows of t in runs of 1 to 6 rows, a null run now and then: the
    port's HostArray (its JAX twin is jax_array of it)."""
    rng = np.random.default_rng(seed)
    pool = _pool(t, rng)
    rows = []
    while len(rows) < n:
        v = None if rng.random() < null_p else pool[rng.integers(len(pool))]
        rows.extend([v] * int(rng.integers(1, 7)))
    return port_array(agt.array(rows[:n], jax_type(t)))


def same_ree(got, want, what: str = "") -> None:
    """A port RunEndEncodedArray equal to a JAX one: type, length, run
    ends (dtype too), run values (floats by their bits) and rows. The
    runs of a string device column are of its dictionary type in both
    packages, as from_device gives the column."""
    assert isinstance(got, RunEndEncodedArray), what
    wt = want.type
    assert str(got.type) == str(wt), (what, got.type, wt)
    assert len(got) == len(want), what
    ends = np.asarray(want.run_ends.to_numpy())
    assert got.run_ends.values.dtype == ends.dtype, what
    np.testing.assert_array_equal(got.run_ends.values, ends, err_msg=what)
    same_array(got.values, want.values, what + ".values")
    same_bits(got.values, want.values, what + ".values")
    same_array(got.decode(), want.decode(), what + ".decode")
    same_bits(got.decode(), want.decode(), what + ".decode")


def same_bits(got: HostArray, want, what: str) -> None:
    """Float values bit for bit on the valid rows (NaN, -0.0)."""
    if got.type.is_floating:
        ok = got.validity_bools()
        w = np.asarray(want.to_numpy())
        np.testing.assert_array_equal(
            got.values[ok].view(f"u{got.values.itemsize}"),
            w[ok].view(f"u{w.itemsize}"), err_msg=what)


@pytest.mark.parametrize("ret", RUN_END_TYPES, ids=str)
@pytest.mark.parametrize("t", TYPES, ids=str)
def test_run_end_encode_matches_jax(t, ret):
    arr = runs_of(t, seed=TYPES.index(t))
    jarr = jax_array(arr)
    want = jencode(jarr, jax_type(ret))
    same_ree(pc.run_end_encode(arr, ret, device="cpu"), want, "host")
    # a device column, and the registry's name in both packages
    col = host_array_to_device(arr, "cpu")
    same_ree(pc.run_end_encode(col, ret), jencode(to_device(jarr),
                                                  jax_type(ret)), "column")
    opts = {"run_end_type": jax_type(ret)}
    same_ree(pc.call_function("run_end_encode", [arr], {"run_end_type": ret},
                              device="cpu"),
             jpc.call_function("run_end_encode", [jarr], opts), "registry")


@pytest.mark.parametrize("t", [dt.int32, dt.float64, dt.string,
                               dt.decimal64(15, 2)], ids=str)
@pytest.mark.parametrize("cut", [(0, 7), (5, 60), (17, 103), (119, 1),
                                 (40, 0)])
def test_slices_encode_and_decode_like_jax(t, cut):
    arr = runs_of(t, seed=3)
    jarr = jax_array(arr)
    off, n = cut
    same_ree(pc.run_end_encode(arr.slice(off, n), device="cpu"),
             jencode(jarr.slice(off, n)), "sliced input")
    # a slice of the encoded array keeps its offset into the runs
    got = pc.run_end_encode(arr, device="cpu").slice(off, n)
    want = jencode(jarr).slice(off, n)
    assert len(got) == len(want) and got.offset == want.offset
    same_array(pc.run_end_decode(got), jdecode(want), "decode of a slice")
    same_array(pc.call_function("run_end_decode", [got], device="cpu"),
               jpc.call_function("run_end_decode", [want]), "registry")
    for i in range(len(want)):
        assert got.is_valid(i) == want.is_valid(i)
        g, w = got[i], want[i]
        assert (g is None and w is None) or g == w or (g != g and w != w)


def test_zeros_nan_and_nulls_follow_the_jax_quirk():
    """0.0 and -0.0 share a run whose value is the first; each NaN is a
    run of its own; neighbouring nulls are one run."""
    rows = [0.0, -0.0, float("nan"), float("nan"), None, None, 1.0]
    jarr = agt.array(rows, jdt.float64)
    want = jencode(jarr)
    got = pc.run_end_encode(port_array(jarr), device="cpu")
    same_ree(got, want)
    assert got.run_ends.values.tolist() == [2, 3, 4, 6, 7]
    assert np.signbit(got.values.values[0]) == np.False_
    got = pc.run_end_encode(port_array(agt.array(rows[1:], jdt.float64)),
                            device="cpu")
    assert np.signbit(got.values.values[0])   # -0.0 first: its run's value


@pytest.mark.parametrize("rows", [[], [7], [3, 3, 3, 3], [None, None],
                                  [None], [1, None, None, 1, 1]],
                         ids=["empty", "one", "one_run", "all_null",
                              "one_null", "null_run"])
@pytest.mark.parametrize("ret", RUN_END_TYPES, ids=str)
def test_small_and_degenerate_inputs_match_jax(rows, ret):
    jarr = agt.array(rows, jdt.int32)
    want = jencode(jarr, jax_type(ret))
    got = pc.run_end_encode(port_array(jarr), ret, device="cpu")
    same_ree(got, want)


def test_dictionary_codes_compare_and_keep_the_dictionary():
    """A string column's runs are runs of codes: the run values keep the
    column's dictionary and decode to the JAX strings."""
    arr = runs_of(dt.string, seed=9)
    got = pc.run_end_encode(arr, device="cpu")
    assert got.values.dict_values is arr.dict_values
    same_ree(got, jencode(jax_array(arr)))


def test_run_starts_go_through_k1():
    """The starts are compacted by compact_flagged, the row index as the
    payload; on the CPU that is K1's plain version."""
    arr = runs_of(dt.int64, seed=4)
    col = host_array_to_device(arr, "cpu")
    start = run_starts(col)
    want = np.flatnonzero(np.asarray(start))
    calls = []
    orig = compaction.compact_flagged
    import arrow_go_tpu_torch.compute.run_ends as ree
    try:
        ree.compact_flagged = lambda k, p: calls.append(1) or orig(k, p)
        got = pc.run_end_encode(col)
    finally:
        ree.compact_flagged = orig
    assert calls == [1]
    np.testing.assert_array_equal(
        np.append(want[1:], len(arr)), got.run_ends.values)


@pytest.mark.parametrize("t", [dt.decimal128(20, 2), dt.decimal256(50, 2),
                               dt.list_(dt.int32)], ids=str)
def test_refusals_where_jax_fails(t):
    if t.is_decimal:
        rows = [decimal.Decimal("1.25")] * 2
        arr = HostArray(from_ints([125, 125], t.limbs), None, t)
    else:
        rows = [[1], [1]]
        arr = port_array(agt.array(rows, jax_type(t)))
    with pytest.raises(Exception):
        jencode(agt.array(rows, jax_type(t)))
    with pytest.raises(pc.ArrowNotImplemented):
        pc.run_end_encode(arr, device="cpu")
    if t.is_decimal:
        with pytest.raises(pc.ArrowNotImplemented):
            pc.run_end_encode(host_array_to_device(arr, "cpu"))


def test_decode_of_a_plain_array_raises_like_jax():
    with pytest.raises(jpc.ArrowInvalid):
        jdecode(agt.array([1, 2]))
    with pytest.raises(pc.ArrowInvalid):
        pc.run_end_decode(HostArray(np.arange(2), None, dt.int64))
    with pytest.raises(pc.ArrowInvalid):
        pc.call_function("run_end_decode",
                         [HostArray(np.arange(2), None, dt.int64)],
                         device="cpu")


def test_take_of_an_encoded_array_matches_jax():
    arr = runs_of(dt.int32, seed=5)
    jarr = jax_array(arr)
    idx = np.random.default_rng(6).integers(0, N, 50)
    idx[[3, 4, 5]] = idx[2]
    got = pc.take(pc.run_end_encode(arr, device="cpu"),
                  HostArray(idx, None, dt.int64))
    want = jpc.take(jencode(jarr), agt.array(idx.tolist(), jdt.int64))
    same_ree(got, want)


SORTS = [({}, "asc"), ({"order": "descending"}, "desc"),
         ({"null_placement": "at_start"}, "nulls_first")]


@pytest.mark.parametrize("kw", [k for k, _ in SORTS],
                         ids=[i for _, i in SORTS])
@pytest.mark.parametrize("t", [dt.int64, dt.float64, dt.string, dt.uint32,
                               dt.date32], ids=str)
def test_sort_of_arrays_and_columns_matches_jax(t, kw):
    arr = runs_of(t, seed=7)
    jarr = jax_array(arr)
    same_array(pc.sort(arr, **kw, device="cpu"), jpc.sort(jarr, **kw))
    col = pc.sort(host_array_to_device(arr, "cpu"), **kw)
    jcol = jpc.sort(to_device(jarr), **kw)
    np.testing.assert_array_equal(col.validity_mask().numpy()[:N],
                                  np.asarray(jcol.validity_mask())[:N])
    ok = col.validity_mask().numpy()[:N]
    np.testing.assert_array_equal(col.values.numpy()[:N][ok].view(np.uint8),
                                  np.asarray(jcol.values)[:N][ok].view(
                                      np.uint8))


def test_sort_of_batches_matches_jax():
    a, b = runs_of(dt.int32, seed=8), runs_of(dt.float64, seed=9)
    jb = agt.record_batch({"a": jax_array(a), "b": jax_array(b)})
    hb = HostBatch.from_arrays({"a": a, "b": b})
    keys = [("a", "descending"), ("b", "ascending")]
    want = jpc.sort(jb, jpc.SortOptions([jpc.SortKey(*k) for k in keys]))
    opts = pc.SortOptions([pc.SortKey(*k) for k in keys])
    got = pc.sort(hb, opts, device="cpu")
    for i, name in enumerate(["a", "b"]):
        same_array(got.column(i), want.column(i), name)
    db = pc.sort(batch_to_device({"a": a, "b": b}, device="cpu"), opts)
    got = device_batch_to_host(db)
    for i, name in enumerate(["a", "b"]):
        same_array(got.column(i), want.column(i), name)
    same_array(pc.call_function("sort", [hb], opts, device="cpu").column(0),
               jpc.call_function("sort", [jb], jpc.SortOptions(
                   [jpc.SortKey(*k) for k in keys])).column(0))
