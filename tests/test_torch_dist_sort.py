"""The distributed sorts of the port against the JAX package, on the
CPU: the sort cases of tests/test_parallel.py and
tests/test_dist_generalized.py (the narrow range-partitioned sort, the
multi-key sort with float keys, descending keys, null keys, overflow,
and the table-level API with null payloads), each at D = 1, 2 and 4,
compared as in test_torch_dist_groupby.py: rank d's outputs against the
JAX output's d-th block over its [0, count) prefix, bit for bit.
"""
import numpy as np
import pytest

import arrow_go_tpu.parallel as jpar
from arrow_go_tpu.parallel import dist as jdist
from arrow_go_tpu.parallel import sort as jsort

from torch_dist_parity import run_both
from torch_dist_worker import SIZES, check_blocks, pool  # noqa: F401
from torch_parity import host_tables, same_batch

Ds = pytest.mark.parametrize("D", SIZES)


@Ds
@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int16])
def test_narrow_distributed_sort(pool, D, dtype):
    """Concatenating the ranks' outputs is the global order; the payload
    rides the permutation; null rows are dropped."""
    n = 8 * 64
    rng = np.random.default_rng(7)
    keys = rng.integers(-1000, 1000, n).astype(dtype)
    if dtype == np.float64:
        keys[rng.random(n) < 0.05] = -0.0
    valid = rng.random(n) < 0.9
    payload = np.arange(n, dtype=np.int64)
    kw = {"cap": n, "n_payload": 1, "n_samples": 16}
    jout, touts = run_both(pool, D, "sort", "make_distributed_sort", kw,
                           [keys, valid, payload],
                           lambda m: jsort.make_distributed_sort(m, **kw))
    check_blocks(tuple(jout), touts, [(0, 2, 2)])
    got_k = np.concatenate([t[0][:int(t[2][0])] for t in touts])
    got_p = np.concatenate([t[1][0][:int(t[2][0])] for t in touts])
    np.testing.assert_array_equal(got_k, np.sort(keys[valid], kind="stable"))
    np.testing.assert_array_equal(keys[got_p], got_k)
    assert valid[got_p].all() and len(got_p) == valid.sum()


@Ds
def test_narrow_sort_overflow_flag(pool, D, rng):
    n = 512
    keys = np.full(n, 3, np.int64)              # one range takes it all
    kw = {"cap": n // 8, "n_payload": 0, "n_samples": 16}
    jout, touts = run_both(pool, D, "sort", "make_distributed_sort", kw,
                           [keys, np.ones(n, np.bool_)],
                           lambda m: jsort.make_distributed_sort(m, **kw))
    assert bool(jout[-1]) and all(bool(t[-1]) for t in touts)


def _sort_multi(pool, D, inputs, **kw):
    jout, touts = run_both(pool, D, "dist", "make_distributed_sort_multi",
                           kw, inputs,
                           lambda m: jdist.make_distributed_sort_multi(
                               m, **kw))
    n_out = kw["n_keys"] + kw.get("n_payload", 0)
    check_blocks(jout, touts, [(0, n_out, n_out)])
    return touts


@Ds
def test_sort_multikey_distributed(pool, D, rng):
    N = 2048
    k1 = rng.integers(0, 20, N).astype(np.int64)
    k2 = rng.standard_normal(N)
    pay = np.arange(N, dtype=np.int64)
    touts = _sort_multi(pool, D, [k1, k2, np.ones(N, np.bool_), pay],
                        cap=N, n_keys=2, n_payload=1)
    rows = [(int(a), float(b), int(c)) for t in touts
            for a, b, c in zip(*(x[:int(t[2][0])] for x in
                                 (t[0][0], t[0][1], t[1][0])))]
    assert rows == sorted(zip(k1.tolist(), k2.tolist(), pay.tolist()))


@Ds
def test_sort_multi_descending_nulls_and_mostly_padding(pool, D, rng):
    """A descending second key of int32, a float32 key with NaN, null
    rows dropped, and a table that fills a few ranks only (the splitters
    sample the valid prefix)."""
    N = 1024
    k1 = rng.integers(0, 6, N).astype(np.int32)
    k2 = rng.standard_normal(N).astype(np.float32)
    k2[rng.random(N) < 0.03] = np.nan
    k3 = rng.integers(-5, 5, N).astype(np.int64)
    valid = np.zeros(N, np.bool_)
    valid[:N // 3] = rng.random(N // 3) < 0.9
    pay = np.arange(N, dtype=np.int64)
    _sort_multi(pool, D, [k1, k2, k3, valid, pay, k2], cap=N, n_keys=3,
                n_payload=2, descending=(False, True))


@Ds
def test_sort_multi_overflow_flag(pool, D):
    N = 512
    touts = _sort_multi(pool, D, [np.zeros(N, np.int64), np.ones(N, bool)],
                        cap=N // 8, n_keys=1)
    assert all(bool(t[-1]) for t in touts)


@Ds
def test_table_level_distributed_sort(pool, D, rng):
    n = 1500
    data = {"k": rng.integers(0, 30, n).astype(np.int64),
            "s": rng.standard_normal(n),
            "p": np.arange(n, dtype=np.int64),
            "t": np.array([f"t{x}" for x in rng.integers(0, 9, n)],
                          dtype=object)}
    masks = {"k": rng.random(n) < 0.95, "p": rng.random(n) < 0.9}
    jrb, hb = host_tables(data, masks)
    mesh = jpar.make_mesh(D)
    for keys, desc in ((["k", "s"], ()), (["t", "k"], (True,))):
        want = jpar.distributed_sort(jrb, keys, mesh=mesh, descending=desc)
        for got in pool.run(D, "api", "distributed_sort", (hb, keys),
                            {"descending": desc}):
            same_batch(got, want)


@Ds
def test_sort_null_payloads_distributed(pool, D):
    jrb, hb = host_tables({"k": np.array([1, 2, 3], np.int64),
                           "p": np.array([0, 20, 30], np.int64)},
                          {"p": np.array([0, 1, 1], bool)})
    want = jpar.distributed_sort(jrb, "k", mesh=jpar.make_mesh(D))
    for got in pool.run(D, "api", "distributed_sort", (hb, "k"), {}):
        same_batch(got, want)
        assert got.column("p").to_pylist() == [None, 20, 30]
