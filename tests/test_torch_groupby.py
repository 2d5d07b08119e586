"""The port's group_by against the JAX package's, for every aggregation
(sum, count, count_all, min, max, mean, product, any, all, first, last)
over int32 / int64 / float64 / bool values, with and without nulls in
keys and values, on one and two keys, dictionary (string) keys
included. Ints, bools and counts must match exactly, floats at rtol
1e-9 (sums and products add and multiply in another order), and NaN
lands where the JAX result has it."""
import numpy as np
import pytest

import arrow_go_tpu.compute as jpc

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch.compute.errors import ArrowNotImplemented
from torch_parity import jax_batch, port_batch

AGGS = ("sum", "count", "count_all", "min", "max", "mean", "product", "any",
        "all", "first", "last")
KEYS = {"one": ["k1"], "two": ["k1", "k2"], "dict": ["s"],
        "dict_two": ["s", "k2"]}
STRINGS = np.array(["R", "A", "N", "O", "F"], dtype=object)


def _data(rng, dtype: str, nulls: bool, n: int = 300):
    """Keys k1 (int32), k2 (int64), s (strings) and one value column v;
    values small enough that products stay exact in int64."""
    if dtype == "bool":
        v = rng.random(n) < 0.5
    elif dtype == "float64":
        v = rng.uniform(-2.0, 2.0, n)
        v[rng.integers(0, n, 4)] = np.nan
    else:
        v = rng.integers(-2, 3, n).astype(dtype)
    data = {"k1": rng.integers(0, 6, n).astype(np.int32),
            "k2": rng.integers(0, 3, n),
            "s": STRINGS[rng.integers(0, 4, n)], "v": v}
    masks = {}
    if nulls:
        masks = {c: rng.random(n) < p for c, p in
                 (("k1", 0.9), ("k2", 0.85), ("s", 0.9), ("v", 0.75))}
        # a group whose values are all null
        masks["v"][data["k1"] == 5] = False
    return data, masks


def _same_column(name, got: list, want: list, floating: bool) -> None:
    assert len(got) == len(want), name
    if not floating:
        assert got == want, name
        return
    assert [g is None for g in got] == [w is None for w in want], name
    g = np.array([np.nan if x is None else x for x in got], np.float64)
    w = np.array([np.nan if x is None else x for x in want], np.float64)
    np.testing.assert_allclose(g, w, rtol=1e-9, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("keys", sorted(KEYS))
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64", "bool"])
def test_every_aggregation_matches_jax(rng, dtype, keys, nulls):
    data, masks = _data(rng, dtype, nulls)
    jdb = jax_batch(data, masks)
    aggs = [("v", a) for a in AGGS]
    jout = jpc.group_by(jdb, KEYS[keys], aggs)
    tout = pc.group_by(port_batch(jdb), KEYS[keys], aggs)
    assert tout.schema.names == jout.schema.names
    assert tout.num_rows == jout.num_rows
    for name in tout.schema.names:
        tc = tout.column(name)
        floating = tc.type.is_floating
        _same_column(name, tc.to_pylist(), jout.column(name).to_pylist(),
                     floating)
    if keys.startswith("dict"):
        assert tout.column("s").dictionary is not None
        assert set(tout.column("s").to_pylist()) - {None} <= set(STRINGS)


def test_string_value_columns_take_counts_only(rng):
    data, masks = _data(rng, "int32", True)
    tdb = port_batch(jax_batch(data, masks))
    out = pc.group_by(tdb, "k1", [("s", "count"), ("s", "count_all")])
    jout = jpc.group_by(jax_batch(data, masks), "k1",
                        [("s", "count"), ("s", "count_all")])
    assert out.to_pydict() == {n: jout.column(n).to_pylist()
                               for n in jout.schema.names}
    for agg in ("min", "sum", "first"):
        with pytest.raises(ArrowNotImplemented):
            pc.group_by(tdb, "k1", [("s", agg)])
    with pytest.raises(ArrowNotImplemented):
        pc.group_by(tdb, "k1", [("v", "median")])


# F10: unsigned sums are uint64 and a uint64 group reads unsigned

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64])
def test_unsigned_sums_and_means_match_jax(dtype):
    rng = np.random.default_rng(11)
    n = 200
    info = np.iinfo(dtype)
    v = rng.integers(0, info.max, n, dtype=dtype, endpoint=True)
    if dtype == np.uint64:
        v[:4] = [2 ** 63 + 1, 7, 2 ** 64 - 1, 2 ** 63]
    data = {"k": rng.integers(0, 5, n).astype(np.int32), "v": v}
    masks = {"v": rng.random(n) > 0.1}
    aggs = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max")]
    want = jpc.group_by(jax_batch(data, masks), ["k"], aggs)
    got = pc.group_by(port_batch(jax_batch(data, masks)), ["k"], aggs)
    for name in ("v_sum", "v_mean", "v_min", "v_max"):
        jc, tc = want.column(name), got.column(name)
        assert str(tc.type) == str(jc.type), name
        np.testing.assert_array_equal(tc.validity_bools(),
                                      jc.validity_bools())
        if name == "v_mean":
            np.testing.assert_allclose(tc.to_pylist(), jc.to_pylist(),
                                       rtol=1e-12)
        else:
            assert tc.to_pylist() == jc.to_pylist(), name
    assert str(got.column("v_sum").type) == "uint64"


def test_uint64_group_sum_example_from_the_fault():
    data = {"k": np.zeros(2, np.int32),
            "v": np.array([2 ** 63 + 1, 7], np.uint64)}
    got = pc.group_by(port_batch(jax_batch(data)), ["k"],
                      [("v", "sum"), ("v", "mean")])
    assert got.column("v_sum").to_pylist() == [9223372036854775816]
    assert got.column("v_mean").to_pylist()[0] > 4.6e18


@pytest.mark.parametrize("agg", ["sum", "mean", "product"])
def test_float16_group_accumulation_is_a_recorded_deviation(agg):
    """Decided on purpose: the port sums (and multiplies) float16 groups
    in float32 and rounds once, as the scalar aggregates do; the JAX
    package accumulates in float16. Both keep the JAX result types; the
    port's sum is the float16 rounding of the exact sum of its rows,
    the JAX package's only within float16's accumulated error."""
    rng = np.random.default_rng(4)
    n = 36 if agg == "product" else 400
    v = (rng.standard_normal(n) * (0.5 if agg == "product" else 1.0)
         + (1.0 if agg == "product" else 0.0)).astype(np.float16)
    data = {"k": rng.integers(0, 3, n).astype(np.int32), "v": v}
    want = jpc.group_by(jax_batch(data), ["k"], [("v", agg)])
    got = pc.group_by(port_batch(jax_batch(data)), ["k"], [("v", agg)])
    name = f"v_{agg}"
    assert str(got.column(name).type) == str(want.column(name).type)
    keys = got.column("k").to_pylist()
    exact = {k: v[data["k"] == k].astype(np.float64) for k in keys}
    for k, g, w in zip(keys, got.column(name).to_pylist(),
                       want.column(name).to_pylist()):
        x = exact[k]
        ref = {"sum": x.sum(), "mean": x.mean(), "product": x.prod()}[agg]
        if agg == "mean":
            assert g == pytest.approx(ref, rel=1e-6)
        else:
            # float32 accumulation, one float16 rounding: within half a
            # float16 ulp of the exact result (plus float32's error)
            assert abs(g - ref) <= abs(float(np.spacing(np.float16(ref))))
        assert w == pytest.approx(ref, rel=0.05, abs=0.5)
