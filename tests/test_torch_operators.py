"""Parity of the port's operators with the JAX package, on the CPU:
encode, segment aggregation, the join core, the DeviceBatch filter,
hash_join with output_columns, group_by and take/sort_indices.

Ints, bitmaps, indices and counts must match bit for bit; float sums
agree to rtol=1e-9 (cumsum association differs); padded outputs are
compared over their [0, count) prefix.
"""
import numpy as np
import pytest
import torch

import arrow_go_tpu.compute as jpc
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.jaxenv import jnp
from arrow_go_tpu.ops import groupagg as jgroupagg
from arrow_go_tpu.ops import hashing as jhashing
from arrow_go_tpu.parallel import join as jjoin

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.device.block import HostArray
from arrow_go_tpu_torch.ops import groupagg, hashing
from arrow_go_tpu_torch.parallel import join as tjoin
from torch_parity import jax_batch, port_batch, words_u32


def _keys_with_nulls(rng, n, P, hi):
    vals = np.zeros(P, np.int64)
    vals[:n] = rng.integers(-hi, hi, n)
    valid = np.zeros(P, np.bool_)
    valid[:n] = rng.random(n) > 0.1
    words = np.packbits(valid, bitorder="little").view(np.uint32)
    return vals, words


@pytest.mark.parametrize("with_nulls", [False, True])
def test_encode_codes_key_order_matches_jax(with_nulls):
    rng = np.random.default_rng(1)
    n, P = 900, 1024
    vals, words = _keys_with_nulls(rng, n, P, 40)
    if not with_nulls:
        words = None
    jr = jhashing.encode_codes(jnp.asarray(vals), jdt.int64,
                               None if words is None else jnp.asarray(words),
                               n, order="key")
    tr = hashing.encode_codes(
        torch.from_numpy(vals), tdt.int64,
        None if words is None else torch.from_numpy(words.view(np.int32)),
        n, order="key")
    k = int(jr.n_unique)
    assert int(tr.n_unique) == k
    assert bool(tr.has_null) == bool(jr.has_null)
    assert int(tr.null_first_row) == int(jr.null_first_row)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.first_index.numpy()[:k],
                                  np.asarray(jr.first_index)[:k])


def test_segment_sum_count_matches_jax():
    rng = np.random.default_rng(2)
    n, P = 1500, 1536
    keys = np.zeros(P, np.int64)
    keys[:n] = rng.integers(0, 37, n)
    vals = rng.standard_normal(P) * 1e3
    ivals = rng.integers(-10 ** 12, 10 ** 12, P)
    vmask = rng.random(P) > 0.2
    jenc, jsp = jhashing.encode_sorted_with(
        jnp.asarray(keys), jdt.int64, None, n,
        (jnp.asarray(vals), jnp.asarray(ivals), jnp.asarray(vmask)))
    tenc, tsp = hashing.encode_sorted_with(
        torch.from_numpy(keys), tdt.int64, None, n,
        (torch.from_numpy(vals), torch.from_numpy(ivals),
         torch.from_numpy(vmask)))
    k = int(jenc.n_unique)
    assert int(tenc.n_unique) == k
    for name in ("sidx", "start", "svalid", "run_id"):
        np.testing.assert_array_equal(getattr(tenc, name).numpy(),
                                      np.asarray(getattr(jenc, name)))
    js, jc = jgroupagg.segment_sum_count(jenc, jnp.asarray(vals), None,
                                         values_sorted=jsp[0],
                                         valid_sorted=jsp[2])
    ts, tc = groupagg.segment_sum_count(tenc, torch.from_numpy(vals), None,
                                        values_sorted=tsp[0],
                                        valid_sorted=tsp[2])
    np.testing.assert_array_equal(tc.numpy()[:k], np.asarray(jc)[:k])
    np.testing.assert_allclose(ts.numpy()[:k], np.asarray(js)[:k],
                               rtol=1e-9, atol=1e-9)
    jsi, _ = jgroupagg.segment_sum_count(jenc, jnp.asarray(ivals), None,
                                         values_sorted=jsp[1],
                                         valid_sorted=jsp[2])
    tsi, _ = groupagg.segment_sum_count(tenc, torch.from_numpy(ivals), None,
                                        values_sorted=tsp[1],
                                        valid_sorted=tsp[2])
    np.testing.assert_array_equal(tsi.numpy()[:k], np.asarray(jsi)[:k])


def test_local_join_inner_matches_jax():
    rng = np.random.default_rng(4)
    PL, PR = 1024, 512
    lk, lw = _keys_with_nulls(rng, 1000, PL, 60)
    rk, rw = _keys_with_nulls(rng, 400, PR, 60)
    lvalid = np.unpackbits(lw.view(np.uint8), bitorder="little").astype(bool)
    rvalid = np.unpackbits(rw.view(np.uint8), bitorder="little").astype(bool)
    cap = 8192
    jli, jri, jrperm, jtot, jov = jjoin.local_join_inner(
        jnp.asarray(lk), jnp.asarray(lvalid), jnp.asarray(rk),
        jnp.asarray(rvalid), cap)
    tli, tri, trperm, ttot, tov = tjoin.local_join_inner(
        torch.from_numpy(lk), torch.from_numpy(lvalid), torch.from_numpy(rk),
        torch.from_numpy(rvalid), cap)
    total = int(jtot)
    assert int(ttot) == total and not bool(tov) and not bool(jov)
    assert 0 < total < cap
    np.testing.assert_array_equal(tli.numpy(), np.asarray(jli))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jri))
    nr = int(rvalid.sum())
    np.testing.assert_array_equal(trperm.numpy()[:nr],
                                  np.asarray(jrperm)[:nr])
    # the pairs are exactly the key matches
    rrow = trperm.numpy()[tri.numpy()[:total]]
    pairs = set(zip(tli.numpy()[:total].tolist(), rrow.tolist()))
    want = {(i, j) for i in np.flatnonzero(lvalid)
            for j in np.flatnonzero(rvalid) if lk[i] == rk[j]}
    assert pairs == want


def _assert_batches_equal(tdb, jdb, rtol=None):
    assert tdb.schema.names == jdb.schema.names
    assert tdb.length == jdb.length
    n = jdb.length
    for tc, jc in zip(tdb.columns, jdb.columns):
        assert tc.type.name == jc.type.name
        assert tc.padded == jc.padded
        tv, jv = tc.values.numpy()[:n], np.asarray(jc.values)[:n]
        if rtol is None:
            np.testing.assert_array_equal(tv, jv)
        else:
            np.testing.assert_allclose(tv, jv, rtol=rtol)
        assert (tc.validity is None) == (jc.validity is None)
        if jc.validity is not None:
            np.testing.assert_array_equal(words_u32(tc.validity),
                                          np.asarray(jc.validity))


def _sample(rng, n):
    return {"k": rng.integers(0, 50, n).astype(np.int64),
            "v": rng.standard_normal(n),
            "d": rng.integers(0, 30, n).astype(np.int32)}


def test_device_batch_filter_matches_jax():
    rng = np.random.default_rng(6)
    jdb = jax_batch(_sample(rng, 3000))
    tdb = port_batch(jdb)
    jm = jpc.execute_scalar_expression(
        jpc.call("greater", [jpc.field("d"), jpc.literal(10)]), jdb)
    tm = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("d"), pc.literal(10)]), tdb)
    np.testing.assert_array_equal(tm.values.numpy(), np.asarray(jm.values))
    _assert_batches_equal(pc.filter(tdb, tm), jpc.filter(jdb, jm))


def test_hash_join_output_columns_matches_jax():
    rng = np.random.default_rng(8)
    left = _sample(rng, 2000)
    right = {"k": np.arange(50, dtype=np.int64),
             "w": rng.integers(0, 9, 50).astype(np.int64),
             "v": rng.standard_normal(50)}
    jl, jr = jax_batch(left), jax_batch(right)
    tl, tr = port_batch(jl), port_batch(jr)
    for cols in (None, ["v", "w", "v_right"]):
        jj = jpc.hash_join(jl, jr, "k", output_columns=cols)
        tj = pc.hash_join(tl, tr, "k", output_columns=cols)
        _assert_batches_equal(tj, jj)


def test_group_by_matches_jax():
    rng = np.random.default_rng(10)
    n = 3000
    data = {"g": rng.integers(0, 25, n).astype(np.int32),
            "x": rng.standard_normal(n) * 100,
            "i": rng.integers(-1000, 1000, n).astype(np.int64)}
    jdb = jax_batch(data)
    tdb = port_batch(jdb)
    aggs = [("x", "sum"), ("x", "count"), ("i", "sum")]
    jg = jpc.group_by(jdb, "g", aggs)
    tg = pc.group_by(tdb, "g", aggs)
    assert tg.schema.names == jg.schema.names
    assert tg.num_rows == jg.num_rows
    for name in ("g", "x_count", "i_sum"):
        assert tg.column(name).to_pylist() == jg.column(name).to_pylist()
    np.testing.assert_allclose(tg.column("x_sum").to_pylist(),
                               jg.column("x_sum").to_pylist(), rtol=1e-9)


@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_sort_indices_and_take_match_jax(order):
    import arrow_go_tpu as agt
    rng = np.random.default_rng(12)
    vals = np.round(rng.standard_normal(5000), 1)
    mask = rng.random(5000) > 0.1
    jarr = agt.from_numpy(vals, mask)
    tarr = HostArray(vals, mask, tdt.float64)
    for n in (40, 5000):           # the host path and the device path
        jidx = jpc.sort_indices(jarr.slice(0, n), order=order)
        tidx = pc.sort_indices(HostArray(vals[:n], mask[:n], tdt.float64),
                               order=order, device="cpu")
        assert tidx.to_pylist() == jidx.to_pylist()
    assert pc.take(tarr, tidx).to_pylist() == jpc.take(jarr, jidx).to_pylist()


@pytest.mark.parametrize("a", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("b", ["int32", "int64", "float32", "float64"])
def test_common_numeric_type_matches_jax(a, b):
    """Implicit casts of the binary kernels, float32 included."""
    from arrow_go_tpu.compute.kernels import common_numeric_type
    want = common_numeric_type(getattr(jdt, a), getattr(jdt, b))
    got = tdt.common_numeric_type(tdt.type_for_name(a), tdt.type_for_name(b))
    assert got.name == want.name and got.np_dtype == want.np_dtype
