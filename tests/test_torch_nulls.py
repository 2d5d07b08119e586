"""Parity of the port's operators with the JAX package on inputs with
nulls, on the CPU: filter indices and the DeviceBatch filter in both
null-selection modes, joins on null
and multi-column keys, group-by on null keys and null values, and the
checked arithmetic's overflow error.

Ints, bitmaps and counts must match bit for bit; float sums agree to
rtol=1e-9; padded outputs are compared over their [0, count) prefix.
"""
import numpy as np
import pytest
import torch

import arrow_go_tpu.compute as jpc
from arrow_go_tpu.jaxenv import jnp
from arrow_go_tpu.ops import selection as jselection

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch.compute import kernels
from arrow_go_tpu_torch.ops import selection
from torch_parity import jax_batch, port_batch, words_u32


def _data(rng, n, key_hi=40):
    data = {"k": rng.integers(0, key_hi, n).astype(np.int64),
            "k2": rng.integers(0, 3, n).astype(np.int32),
            "v": np.round(rng.standard_normal(n) * 100, 2),
            "d": rng.integers(0, 30, n).astype(np.int32)}
    masks = {name: rng.random(n) > 0.15 for name in ("k", "v", "d")}
    return data, masks


def _assert_columns_equal(tdb, jdb):
    assert tdb.schema.names == jdb.schema.names
    assert tdb.length == jdb.length
    n = jdb.length
    for tc, jc in zip(tdb.columns, jdb.columns):
        assert tc.padded == jc.padded
        jv = np.asarray(jc.validity) if jc.validity is not None else None
        tv = words_u32(tc.validity) if tc.validity is not None else None
        valid = np.ones(n, np.bool_)
        if jv is not None:
            assert tv is not None
            np.testing.assert_array_equal(tv[:(n + 31) // 32],
                                          jv[:(n + 31) // 32])
            valid = np.unpackbits(jv.view(np.uint8),
                                  bitorder="little")[:n].astype(bool)
        else:
            assert tv is None
        # values are compared where they are valid: a null slot's value
        # is unspecified
        np.testing.assert_array_equal(tc.values.numpy()[:n][valid],
                                      np.asarray(jc.values)[:n][valid])


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_filter_indices_matches_jax(null_selection):
    rng = np.random.default_rng(24)
    P, n = 1024, 1000
    mask = rng.random(P) > 0.5
    words = np.packbits(rng.random(P) > 0.2, bitorder="little").view(
        np.uint32)
    ji, jc = jselection.filter_indices(jnp.asarray(mask), jnp.asarray(words),
                                       n, null_selection)
    ti, tc = selection.filter_indices(torch.from_numpy(mask),
                                      torch.from_numpy(words.view(np.int32)),
                                      n, null_selection)
    assert int(tc) == int(jc)
    assert (ti.numpy()[:int(tc)] == -1).any() == (
        null_selection == "emit_null")
    # the whole length: the JAX CPU path is the full stable partition too
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_filter_with_nulls_matches_jax(null_selection):
    rng = np.random.default_rng(21)
    data, masks = _data(rng, 2500)
    jdb = jax_batch(data, masks)
    tdb = port_batch(jdb)
    expr = ("greater", "d", 10)
    jm = jpc.execute_scalar_expression(
        jpc.call(expr[0], [jpc.field(expr[1]), jpc.literal(expr[2])]), jdb)
    tm = pc.execute_scalar_expression(
        pc.call(expr[0], [pc.field(expr[1]), pc.literal(expr[2])]), tdb)
    np.testing.assert_array_equal(words_u32(tm.validity),
                                  np.asarray(jm.validity))
    jf = jpc.filter(jdb, jm, jpc.FilterOptions(null_selection))
    tf = pc.filter(tdb, tm, pc.FilterOptions(null_selection))
    _assert_columns_equal(tf, jf)


@pytest.mark.parametrize("keys", [["k"], ["k", "k2"]])
def test_hash_join_null_and_multi_keys_matches_jax(keys):
    rng = np.random.default_rng(22)
    ldata, lmasks = _data(rng, 1500)
    rdata = {"k": np.arange(45, dtype=np.int64) % 40,
             "k2": (np.arange(45) % 3).astype(np.int32),
             "w": rng.integers(0, 9, 45).astype(np.int64)}
    rmasks = {"k": rng.random(45) > 0.1, "w": rng.random(45) > 0.2}
    jl, jr = jax_batch(ldata, lmasks), jax_batch(rdata, rmasks)
    tl, tr = port_batch(jl), port_batch(jr)
    jj = jpc.hash_join(jl, jr, keys)
    tj = pc.hash_join(tl, tr, keys)
    assert tj.length > 0
    _assert_columns_equal(tj, jj)


@pytest.mark.parametrize("keys", [["k"], ["k", "k2"]])
def test_group_by_null_keys_and_values_matches_jax(keys):
    rng = np.random.default_rng(23)
    data, masks = _data(rng, 3000, key_hi=12)
    jdb = jax_batch(data, masks)
    tdb = port_batch(jdb)
    aggs = [("v", "sum"), ("v", "count"), ("d", "sum")]
    jg = jpc.group_by(jdb, keys, aggs)
    tg = pc.group_by(tdb, keys, aggs)
    assert tg.schema.names == jg.schema.names
    assert tg.num_rows == jg.num_rows
    assert None in tg.column("k").to_pylist()
    for name in keys + ["v_count", "d_sum"]:
        assert tg.column(name).to_pylist() == jg.column(name).to_pylist()
    tv, jv = tg.column("v_sum").to_pylist(), jg.column("v_sum").to_pylist()
    assert [x is None for x in tv] == [x is None for x in jv]
    np.testing.assert_allclose([x for x in tv if x is not None],
                               [x for x in jv if x is not None], rtol=1e-9)


@pytest.mark.parametrize("op", ["add", "subtract", "multiply"])
def test_checked_integer_overflow_raises_like_jax(op):
    big = np.array([2 ** 62, -(2 ** 62), 5, 7], np.int64)
    other = np.array([2 ** 62, 2 ** 62, 3, 1], np.int64)
    data = {"a": big, "b": other if op != "subtract" else -other}
    jdb = jax_batch(data)
    tdb = port_batch(jdb)
    with pytest.raises(jpc.ArrowInvalid):
        jpc.call_function(op, [jdb.column("a"), jdb.column("b")])
    with pytest.raises(pc.ArrowInvalid, match="overflow"):
        kernels.arithmetic_binary(op, tdb.column("a"), tdb.column("b"))
    # the same rows without the overflowing ones pass in both
    ok = {"a": big[2:], "b": data["b"][2:]}
    jok, tok = jax_batch(ok), port_batch(jax_batch(ok))
    want = jpc.call_function(op, [jok.column("a"), jok.column("b")])
    got = kernels.arithmetic_binary(op, tok.column("a"), tok.column("b"))
    np.testing.assert_array_equal(got.values.numpy()[:2],
                                  np.asarray(want.values)[:2])
