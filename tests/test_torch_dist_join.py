"""The distributed joins of the port against the JAX package, on the
CPU: the join cases of tests/test_parallel.py and
tests/test_dist_generalized.py (the narrow inner join, multi-key and
multi-payload joins of all six types, semi/anti with null keys, the
Zipf hot-key paths A and B for each type they take, overflow flags and
the table-level API with nulls), each at D = 1, 2 and 4.

The port runs D spawned gloo ranks (torch_dist_worker.Pool); the JAX
package runs the same builder on make_mesh(D) of the suite's 8-device
CPU mesh. Rank d's outputs compare with the JAX output's d-th block over
its [0, n_out) prefix, bit for bit (floats are only moved, so they
compare exactly too); semi/anti verdicts over the whole block.
"""
import collections

import numpy as np
import pytest

import arrow_go_tpu.parallel as jpar
from arrow_go_tpu.parallel import join as jjoin

from torch_dist_parity import (HOWS, dist_join, inner_oracle, ones,
                               run_both)
from torch_dist_worker import SIZES, check_blocks, pool  # noqa: F401
from torch_parity import host_tables as _tables, same_batch

Ds = pytest.mark.parametrize("D", SIZES)


@Ds
def test_narrow_distributed_join(pool, D, rng):
    NL, NR = 1024, 512
    lk = rng.integers(0, 100, NL).astype(np.int64)
    lv = np.arange(NL, dtype=np.int64)
    rk = rng.integers(50, 150, NR).astype(np.int64)
    rv = np.arange(NR, dtype=np.int64)
    lvalid = rng.random(NL) < 0.9
    kw = {"cap_shuffle": NL, "cap_out": NL * 4}
    jout, touts = run_both(pool, D, "join", "make_distributed_join", kw,
                           [lk, lv, lvalid, rk, rv, ones(NR)],
                           lambda m: jjoin.make_distributed_join(m, **kw))
    check_blocks(jout, touts, [(0, 3, 3)])
    got = sorted((int(k), int(a), int(b)) for t in touts
                 for k, a, b in zip(*(x[:int(t[3][0])] for x in t[:3])))
    assert got == inner_oracle(lk[lvalid].tolist(), rk.tolist(),
                               lv[lvalid].tolist(), rv.tolist())


@Ds
def test_narrow_join_overflow_flag(pool, D):
    N = 256
    keys = np.zeros(N, np.int64)
    vals = np.arange(N, dtype=np.int64)
    kw = {"cap_shuffle": N, "cap_out": 4}
    jout, touts = run_both(pool, D, "join", "make_distributed_join", kw,
                           [keys, vals, ones(N), keys, vals, ones(N)],
                           lambda m: jjoin.make_distributed_join(m, **kw))
    assert bool(jout[-1]) and all(bool(t[-1]) for t in touts)


@Ds
def test_join_multikey_multipayload(pool, D, rng):
    NL, NR = 1024, 768
    lk1 = rng.integers(0, 40, NL).astype(np.int64)
    lk2 = rng.integers(0, 4, NL).astype(np.int32)
    rk1 = rng.integers(0, 40, NR).astype(np.int64)
    rk2 = rng.integers(0, 4, NR).astype(np.int32)
    lv = rng.standard_normal(NL)
    lw = rng.integers(0, 10**6, NL).astype(np.int64)
    rv = rng.standard_normal(NR)
    dist_join(pool, D, [lk1, lk2, lv, lw, ones(NL), rk1, rk2, rv, ones(NR)],
              cap_shuffle=NL, cap_out=NL * 4, n_keys=2, n_lpay=2, n_rpay=1)


@Ds
@pytest.mark.parametrize("how", HOWS)
def test_every_join_type_with_null_keys(pool, D, how, rng):
    """Unmatched rows both ways, null keys on both sides (invalid rows),
    float and bool payloads; semi/anti with the lnull input."""
    NL, NR = 512, 384
    lk = rng.integers(0, 80, NL).astype(np.int64)
    rk = rng.integers(40, 120, NR).astype(np.int64)
    lnull = rng.random(NL) < 0.1
    rvalid = rng.random(NR) < 0.9
    lv = rng.standard_normal(NL)
    rv = rng.random(NR) < 0.5
    inputs = [lk, lv, ~lnull, rk, rv, rvalid]
    if how in ("left semi", "left anti"):
        inputs.append(lnull)
    jout, touts = dist_join(pool, D, inputs, cap_shuffle=NL,
                            cap_out=NL * 8, how=how)
    if how in ("left semi", "left anti"):
        verdict = np.concatenate([t[0] for t in touts])
        has = np.isin(lk, rk[rvalid]) & ~lnull
        want = has if how == "left semi" else (~has & ~lnull) | lnull
        np.testing.assert_array_equal(verdict, want)


@Ds
def test_right_outer_unmatched_rows_carry_their_keys(pool, D, rng):
    NL, NR = 256, 128
    lk = rng.integers(0, 64, NL).astype(np.int64)
    rk = rng.integers(32, 96, NR).astype(np.int64)
    lv = np.arange(NL, dtype=np.int64)
    rv = np.arange(NR, dtype=np.int64)
    _, touts = dist_join(pool, D, [lk, lv, ones(NL), rk, rv, ones(NR)],
                         cap_shuffle=NL, cap_out=NL * 8, how="right outer")
    got = collections.defaultdict(set)
    for t in touts:
        n = int(t[4][0])
        for k, r in zip(t[0][0][:n], t[2][0][:n]):
            got[int(r)].add(int(k))
    for j in range(NR):
        assert int(rk[j]) in got[int(rv[j])]


# ---------------------------------------------------------------------------
# the table-level API
# ---------------------------------------------------------------------------

@Ds
def test_table_level_join_matches_jax(pool, D, rng):
    lt = {"k": rng.integers(0, 40, 800).astype(np.int64),
          "lv": np.arange(800, dtype=np.int64),
          "s": np.array([f"s{x}" for x in rng.integers(0, 5, 800)],
                        dtype=object)}
    rt = {"k": rng.integers(0, 40, 500).astype(np.int64),
          "rv": np.arange(500, dtype=np.int64),
          "lv": rng.standard_normal(500)}
    lmask = {"k": rng.random(800) < 0.95, "lv": rng.random(800) < 0.9}
    jl, hl = _tables(lt, lmask)
    jr, hr = _tables(rt)
    mesh = jpar.make_mesh(D)
    # pair capacity for every pair on one rank (the JAX defaults assume
    # 8 shards)
    for kw in ({}, {"hot_k": 2, "hot_thresh": 8}, {"left_suffix": "_l"}):
        kw["cap_out"] = 16384
        want = jpar.distributed_hash_join(jl, jr, "k", mesh=mesh, **kw)
        for got in pool.run(D, "api", "distributed_hash_join",
                            (hl, hr, "k"), kw):
            same_batch(got, want)
    cl = collections.Counter(lt["k"][lmask["k"]].tolist())
    cr = collections.Counter(rt["k"].tolist())
    assert want.num_rows == sum(c * cr[k] for k, c in cl.items())


@Ds
def test_table_level_string_keys_and_null_payloads(pool, D):
    """Payload nulls survive the exchange; string keys join on one code
    space; differing dictionaries raise, as in the JAX package."""
    left = {"k": np.array(["x", "y", "z"], dtype=object),
            "p": np.array([0, 20, 30], dtype=np.int64)}
    right = {"k": np.array(["x", "y", "z"], dtype=object),
             "q": np.array([9, 0, 7], dtype=np.int64)}
    jl, hl = _tables(left, {"p": np.array([0, 1, 1], bool)})
    jr, hr = _tables(right, {"q": np.array([1, 0, 1], bool)})
    want = jpar.distributed_hash_join(jl, jr, "k", mesh=jpar.make_mesh(D))
    for got in pool.run(D, "api", "distributed_hash_join", (hl, hr, "k"),
                        {}):
        same_batch(got, want)
        assert sorted(zip(*(got.column(i).to_pylist() for i in range(3)))) \
            == [("x", None, 9), ("y", 20, None), ("z", 30, 7)]
    other = {"k": np.array(["z", "y", "x"], dtype=object),
             "q": np.array([1, 2, 3], dtype=np.int64)}
    _, ho = _tables(other)
    with pytest.raises(RuntimeError, match="code spaces differ"):
        pool.run(D, "api", "distributed_hash_join", (hl, ho, "k"), {})
