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
