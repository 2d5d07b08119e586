"""The port's type set against the JAX package's: every type's id, name,
numpy dtype and bit width; columns of each type through both packages'
host-to-device-to-host paths, bit for bit with nulls (unsigned values of
2**31, 2**32 - 1, 2**63 and 2**64 - 1 included); and the operations
whose result depends on signedness, on unsigned columns."""
import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import kernels as jk
from arrow_go_tpu.device.block import from_device, to_device

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute import kernels
from arrow_go_tpu_torch.device.block import (HostArray, column_to_host,
                                             host_array_to_device)
from torch_parity import jax_type, port_type, words_u32

NUMERIC = [dt.int8, dt.int16, dt.int32, dt.int64, dt.uint8, dt.uint16,
           dt.uint32, dt.uint64, dt.float16, dt.float32, dt.float64]
TEMPORAL = [dt.date32, dt.date64, dt.timestamp("s"), dt.timestamp("ms"),
            dt.timestamp("us", "UTC"), dt.timestamp("ns", "+05:30"),
            dt.time32("s"), dt.time32("ms"), dt.time64("us"),
            dt.time64("ns"), dt.duration("s"), dt.duration("ns")]
TYPES = [dt.bool_] + NUMERIC + TEMPORAL
UNSIGNED = [dt.uint8, dt.uint16, dt.uint32, dt.uint64]


def values_of(t, n: int, rng) -> np.ndarray:
    """n values of type t (its numpy dtype) from rng, the type's extremes
    first: for unsigned types 2**31, 2**32 - 1, 2**63 and 2**64 - 1 where
    they fit; floats with NaN, infinities and -0.0."""
    if t == dt.bool_:
        return rng.random(n) < 0.5
    d = t.np_dtype
    if t.is_floating:
        v = (rng.standard_normal(n) * 1000).astype(d)
        v[:5] = [np.nan, np.inf, -np.inf, -0.0, 0.5]
        return v
    info = np.iinfo(d)
    v = rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    extremes = [info.min, info.max, 0, 1]
    if t.is_unsigned_integer:
        extremes += [x for x in (2 ** 31, 2 ** 32 - 1, 2 ** 63, 2 ** 64 - 1,
                                 2 ** 15, 2 ** 7) if x <= info.max]
    v[:len(extremes)] = extremes
    return v


def jax_column(v, mask, t):
    return to_device(agt.from_numpy(v, mask, jax_type(t)))


def port_column(v, mask, t):
    return host_array_to_device(HostArray(v, mask, t), "cpu")


def same_column(tc, jc) -> None:
    """Type, length and padding, validity words and the values of the
    valid rows of [0, n), bit for bit."""
    assert str(tc.type) == str(jc.type)
    assert (tc.length, tc.padded) == (jc.length, jc.padded)
    n = jc.length
    valid = np.ones(n, np.bool_)
    assert (tc.validity is None) == (jc.validity is None)
    if jc.validity is not None:
        np.testing.assert_array_equal(words_u32(tc.validity),
                                      np.asarray(jc.validity))
        valid = np.unpackbits(np.asarray(jc.validity).view(np.uint8),
                              bitorder="little")[:n].astype(bool)
    got = column_to_host(tc).values
    want = np.asarray(jc.values)[:n]
    assert got.dtype == want.dtype
    if got.dtype != np.bool_:
        got = got.view(f"u{got.itemsize}")
        want = want.view(f"u{want.itemsize}")
    np.testing.assert_array_equal(got[valid], want[valid])


@pytest.mark.parametrize("t", TYPES, ids=str)
def test_type_matches_jax(t):
    jt = jax_type(t)
    # (the JAX package's bool has no np_dtype, only a device dtype)
    assert (int(t.id), t.name, str(t), t.np_dtype, t.bit_width) == (
        int(jt.id), jt.name, str(jt), jt.device_dtype, jt.bit_width)
    assert port_type(jt) == t and dt.type_for_name(str(t)) == t
    for pred in ("is_integer", "is_signed_integer", "is_unsigned_integer",
                 "is_floating", "is_numeric", "is_temporal"):
        assert getattr(t, pred) == getattr(jt, pred), pred
    # the storage keeps every bit of the numpy dtype
    assert torch.empty(0, dtype=t.torch_dtype).element_size() * 8 == max(
        t.bit_width, 8)


@pytest.mark.parametrize("d", ["int8", "uint16", "uint64", "float16",
                               "M8[D]", "M8[ms]", "m8[ns]"])
def test_from_numpy_dtype_matches_jax(d):
    assert str(dt.from_numpy_dtype(d)) == str(jdt.from_numpy_dtype(d))


@pytest.mark.parametrize("t", TYPES, ids=str)
def test_column_round_trip_matches_jax(t):
    rng = np.random.default_rng(int(t.id) * 7 + t.bit_width)
    v = values_of(t, 300, rng)
    mask = rng.random(300) < 0.85
    mask[:8] = True
    jc = jax_column(v, mask, t)
    tc = port_column(v, mask, t)
    same_column(tc, jc)
    back = column_to_host(tc)
    assert back.values.dtype == t.np_dtype
    np.testing.assert_array_equal(back.mask, mask)
    jback = from_device(jc)
    np.testing.assert_array_equal(
        np.where(mask, back.values, 0),
        np.where(mask, jback.to_numpy(zero_copy_only=False)
                 if t == dt.bool_ else np.asarray(jback.to_numpy()), 0))


def test_unsigned_extremes_survive_bit_for_bit():
    v = np.array([2 ** 64 - 1, 2 ** 63, 2 ** 32 - 1, 2 ** 31, 0],
                 np.uint64)
    tc = port_column(v, None, dt.uint64)
    assert tc.values.dtype == torch.int64
    assert column_to_host(tc).values.tolist() == v.tolist()
    w = np.array([2 ** 32 - 1, 2 ** 31, 7], np.uint32)
    assert column_to_host(port_column(w, None, dt.uint32)).values.tolist() \
        == w.tolist()


BINARY_OPS = ["add", "subtract", "multiply", "divide", "mod", "shift_right",
              "shift_left", "max_element_wise", "min_element_wise",
              "bit_wise_and", "bit_wise_xor"]


@pytest.mark.parametrize("op", BINARY_OPS)
@pytest.mark.parametrize("t", UNSIGNED, ids=str)
def test_unsigned_arithmetic_matches_jax(t, op):
    rng = np.random.default_rng(3)
    a, b = values_of(t, 200, rng), values_of(t, 200, rng)[::-1].copy()
    if op.startswith("shift"):
        b = (b % t.bit_width).astype(t.np_dtype)
    b[5] = 0                          # x / 0 and x mod 0
    mask = rng.random(200) < 0.9
    got = kernels.arithmetic_binary(op, port_column(a, mask, t),
                                    port_column(b, None, t), checked=False)
    want = jk.arithmetic_binary(op, jax_column(a, mask, t),
                                jax_column(b, None, t), checked=False)
    same_column(got, want)


@pytest.mark.parametrize("op", ["equal", "less", "less_equal", "greater",
                                "greater_equal"])
@pytest.mark.parametrize("t", UNSIGNED, ids=str)
def test_unsigned_compare_matches_jax(t, op):
    rng = np.random.default_rng(4)
    a, b = values_of(t, 200, rng), values_of(t, 200, rng)[::-1].copy()
    same_column(kernels.compare(op, port_column(a, None, t),
                                port_column(b, None, t)),
                jk.compare(op, jax_column(a, None, t),
                           jax_column(b, None, t)))
    # a Python int beside the column broadcasts to its type
    big = int(np.iinfo(t.np_dtype).max // 2 + 1)
    same_column(kernels.compare(op, port_column(a, None, t), big),
                jk.compare(op, jax_column(a, None, t), big))


@pytest.mark.parametrize("op", ["add", "subtract", "multiply"])
@pytest.mark.parametrize("t", UNSIGNED, ids=str)
def test_unsigned_overflow_check_matches_jax(t, op):
    top = np.iinfo(t.np_dtype).max
    cases = {"add": ([top - 1, 3], [1, 4]), "subtract": ([5, 3], [5, 4]),
             "multiply": ([top // 2, 3], [2, 4])}
    a, b = (np.array(x, t.np_dtype) for x in cases[op])
    # no overflow on the first row alone
    same_column(
        kernels.arithmetic_binary(op, port_column(a[:1], None, t),
                                  port_column(b[:1], None, t)),
        jk.arithmetic_binary(op, jax_column(a[:1], None, t),
                             jax_column(b[:1], None, t)))
    a[1], b[1] = (top, 1) if op == "add" else (3, 4) if op == \
        "subtract" else (top, 2)
    with pytest.raises(jk.ArrowInvalid):
        jk.arithmetic_binary(op, jax_column(a, None, t),
                             jax_column(b, None, t))
    with pytest.raises(pc.ArrowInvalid, match="overflow"):
        kernels.arithmetic_binary(op, port_column(a, None, t),
                                  port_column(b, None, t))


@pytest.mark.parametrize("op", ["abs", "sign", "negate", "bit_wise_not"])
@pytest.mark.parametrize("t", UNSIGNED, ids=str)
def test_unsigned_unary_matches_jax(t, op):
    v = values_of(t, 100, np.random.default_rng(5))
    same_column(kernels.arithmetic_unary(op, port_column(v, None, t),
                                         checked=False),
                jk.arithmetic_unary(op, jax_column(v, None, t),
                                    checked=False))


@pytest.mark.parametrize("t", NUMERIC + TEMPORAL[:4], ids=str)
def test_sort_indices_match_jax(t):
    """Unsigned values of 2**31 or 2**63 and more sort above the small
    ones; nulls at the end, stable."""
    rng = np.random.default_rng(6)
    v = values_of(t, 500, rng)
    v[200:260] = v[:60]                  # ties
    mask = rng.random(500) < 0.9
    for order in ("ascending", "descending"):
        got = pc.sort_indices(port_column(v, mask, t), order=order)
        want = jf.sort_indices(jax_column(v, mask, t), order=order)
        np.testing.assert_array_equal(got.values[:500].numpy(),
                                      np.asarray(want.values)[:500])


@pytest.mark.parametrize("t", [dt.int8, dt.uint16, dt.uint32, dt.uint64,
                               dt.float16, dt.date32, dt.timestamp("ms")],
                         ids=str)
def test_group_by_new_key_types_matches_jax(t):
    from arrow_go_tpu.compute.groupby import group_by as jgroup_by
    from torch_parity import jax_batch, port_batch
    rng = np.random.default_rng(8)
    keys = values_of(t, 400, rng)[rng.integers(0, 12, 400)]
    jdb = jax_batch({"k": keys, "x": np.arange(400, dtype=np.int64)})
    jdb.columns[0] = jax_column(keys, None, t)
    jdb.schema = agt.schema([agt.field("k", jax_type(t)),
                             jdb.schema.field(1)])
    tdb = port_batch(jdb)
    aggs = [("x", "sum"), ("k", "min"), ("k", "max"), ("x", "count")]
    got = pc.group_by(tdb, "k", aggs).to_pydict()
    want = jgroup_by(jdb, "k", aggs).to_pydict()
    assert list(got) == list(want)
    for name in got:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(g.view(f"u{g.itemsize}"),
                                          w.astype(g.dtype).view(
                                              f"u{g.itemsize}"))
        else:
            assert got[name] == [int(x) if not isinstance(x, bool) else x
                                 for x in np.asarray(want[name]).astype(
                                     g.dtype).tolist()], name


# F11: dictionary_encode keeps unsigned dictionary values

@pytest.mark.parametrize("t", UNSIGNED)
def test_dictionary_encode_of_unsigned_matches_jax(t, rng):
    v = values_of(t, 300, rng)
    v[10:20] = v[:10]
    mask = rng.random(300) > 0.1
    want = from_device(jf.dictionary_encode(jax_column(v, mask, t)))
    got = column_to_host(pc.dictionary_encode(port_column(v, mask, t)))
    assert got.dict_values.dtype == t.np_dtype
    assert got.dictionary.to_pylist() == want.dictionary.to_pylist()
    assert got.to_pylist() == want.decode().to_pylist()


def test_dictionary_encode_of_uint32_example_from_the_fault():
    v = np.array([2 ** 32 - 1, 2 ** 31 + 3, 2 ** 32 - 1], np.uint32)
    got = pc.dictionary_encode(port_column(v, None, dt.uint32))
    assert got.dict_values.tolist() == [4294967295, 2147483651]


# F12: unsigned scalars in fill_null and if_else fill as their bits

@pytest.mark.parametrize("t,scalar", [
    (dt.uint16, 2 ** 15), (dt.uint16, 2 ** 16 - 1), (dt.uint32, 2 ** 31),
    (dt.uint32, 2 ** 32 - 1), (dt.uint64, 2 ** 63), (dt.uint64, 2 ** 64 - 1),
    (dt.uint8, 255)])
def test_unsigned_scalar_fill_matches_jax(t, scalar, rng):
    v = values_of(t, 200, rng)
    mask = rng.random(200) > 0.3
    cond = rng.random(200) < 0.5
    want = from_device(jf.fill_null(jax_column(v, mask, t), scalar))
    got = column_to_host(pc.fill_null(port_column(v, mask, t), scalar))
    assert got.to_pylist() == want.to_pylist()
    jcond = jax_column(cond, None, dt.bool_)
    tcond = port_column(cond, None, dt.bool_)
    for args in ((scalar, "col"), ("col", scalar)):
        jargs = [jax_column(v, mask, t) if a == "col" else a for a in args]
        targs = [port_column(v, mask, t) if a == "col" else a for a in args]
        want = from_device(jf.if_else(jcond, *jargs))
        got = column_to_host(pc.if_else(tcond, *targs))
        assert got.to_pylist() == want.to_pylist()
