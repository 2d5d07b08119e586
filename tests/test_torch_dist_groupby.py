"""The distributed tier's mesh, shuffle and group-by of the port against
the JAX package, on the CPU: the cases of tests/test_parallel.py and
tests/test_dist_generalized.py that aggregate (pre-aggregating multi-key
group-by, skew, value nulls, overflow, the streamed hash-table form, the
table-level API), each at D = 1, 2 and 4.

The port runs D spawned gloo ranks (torch_dist_worker.Pool); the JAX
package runs the same builder on make_mesh(D) of the suite's 8-device
CPU mesh. Rank d's outputs compare with the JAX output's d-th block
over its [0, count) prefix: ints, keys, order and flags bit for bit,
floats at rtol 1e-9; API results equal the JAX API's RecordBatch.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import arrow_go_tpu.parallel as jpar
from arrow_go_tpu.ops import hashtable as jht
from arrow_go_tpu.parallel import aggregate as jagg
from arrow_go_tpu.parallel import dist as jdist
from arrow_go_tpu.parallel import overlap as joverlap
from arrow_go_tpu.parallel import shuffle as jshuf

import torch

from arrow_go_tpu_torch.ops import hashtable as tht
from arrow_go_tpu_torch.parallel import mesh as tmesh
from torch_dist_parity import run_both
from torch_dist_worker import SIZES, check_blocks, pool  # noqa: F401
from torch_parity import host_tables as _tables, same_batch

Ds = pytest.mark.parametrize("D", SIZES)


@Ds
def test_mesh_blocks_and_row_ranges(pool, D):
    infos = pool.run(D, "mesh_info", 1000)
    data = np.arange(8 * D)
    ranges = []
    for d, (rank, size, rows, block, whole) in enumerate(infos):
        assert (rank, size) == (d, D)
        np.testing.assert_array_equal(block, data[d * 8:(d + 1) * 8])
        np.testing.assert_array_equal(whole, data)
        ranges.append(rows)
    # the ranks' row ranges tile the table, as the JAX package's
    # local_row_range cuts it per process
    per = -(-1000 // D)
    assert ranges == [(d * per, min(1000, (d + 1) * per)) for d in range(D)]


def test_make_mesh_starts_a_world_of_one():
    """With no process group, make_mesh starts a world-size-1 gloo group
    for the CPU, and the collectives run through it."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        m = tmesh.make_mesh(device="cpu")
        assert (m.rank, m.world_size, m.device.type) == (0, 1, "cpu")
        assert dist.get_backend() == "gloo"
        x = torch.arange(6, dtype=torch.int16)
        assert torch.equal(tmesh.all_to_all(m, x), x)
        assert torch.equal(tmesh.all_gather(m, x), x)
        assert bool(tmesh.all_max(m, torch.tensor(True)))
        assert tmesh.local_row_range(m, 1000) == (0, 1000)
        # a second call keeps the group (idempotent)
        assert tmesh.initialize_multihost("tcp://127.0.0.1:1", 1, 0,
                                          "cpu") == m
    finally:
        dist.destroy_process_group()


def test_entry_points_resolve_the_card():
    """Without device=, the tier runs on the card: none here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


@Ds
def test_shuffle_matches_jax(pool, D, rng):
    N, cap = 512, 512 // D
    keys = rng.integers(0, 37, N).astype(np.int64)
    vals = rng.standard_normal(N)
    valid = rng.random(N) < 0.8
    dest = (keys % D).astype(np.int32)
    jout, touts = run_both(pool, D, "shuffle", "make_shuffle",
                       {"n_cols": 2, "cap": cap}, [dest, valid, keys, vals],
                       lambda m: jshuf.make_shuffle(m, 2, cap))
    check_blocks(jout, touts)


@Ds
def test_distributed_group_by_sum(pool, D, rng):
    N, cap = 2048, 2048 // D
    keys = rng.integers(0, 57, N).astype(np.int64)
    vals = rng.integers(-50, 100, N).astype(np.int64)
    valid = rng.random(N) < 0.85
    jout, touts = run_both(pool, D, "aggregate", "make_group_by_sum",
                       {"cap": cap}, [keys, vals, valid],
                       lambda m: jagg.make_group_by_sum(m, cap))
    check_blocks(jout, touts, [(0, 3, 3)])
    assert not any(bool(t[-1]) for t in touts)


@Ds
def test_shuffle_overflow_detected(pool, D):
    # one key, one destination, capacity 2: every rank sees the flag
    N = 256
    inputs = [np.zeros(N, np.int64), np.ones(N, np.int64),
              np.ones(N, np.bool_)]
    jout, touts = run_both(pool, D, "aggregate", "make_group_by_sum",
                       {"cap": 2}, inputs,
                       lambda m: jagg.make_group_by_sum(m, 2))
    assert bool(jout[-1]) and all(bool(t[-1]) for t in touts)
    check_blocks(jout, touts, [(0, 3, 3)])


def _group_by(pool, D, inputs, cap, n_keys, specs, n_vals):
    kw = {"cap": cap, "n_keys": n_keys, "agg_specs": specs,
          "n_vals": n_vals}
    jout, touts = run_both(pool, D, "dist", "make_distributed_group_by", kw,
                       inputs, lambda m: jdist.make_distributed_group_by(
                           m, **kw))
    n_out = n_keys + 2 * len(specs)
    check_blocks(jout, touts, [(0, n_out, n_out)])
    return jout, touts


@Ds
def test_group_by_multikey_preagg(pool, D, rng):
    N = 2048
    k1 = rng.integers(0, 13, N).astype(np.int64)
    k2 = rng.integers(0, 3, N).astype(np.int32)
    v = rng.standard_normal(N)
    w = rng.integers(0, 100, N).astype(np.int64)
    ones = np.ones(N, np.bool_)
    _group_by(pool, D, [k1, k2, v, w, ones, ones, ones], 512, 2,
              ((0, "sum"), (1, "min"), (0, "mean"), (1, "count")), 2)


@Ds
def test_group_by_preagg_skew_no_overflow(pool, D, rng):
    """A 90%-hot key ships one partial row per rank: cap 64 holds."""
    N = 4096
    keys = np.where(rng.random(N) < 0.9, 7,
                    rng.integers(0, 50, N)).astype(np.int64)
    ones = np.ones(N, np.bool_)
    _, touts = _group_by(pool, D, [keys, np.ones(N), ones, ones], 64, 1,
                         ((0, "sum"),), 1)
    assert not any(bool(t[-1]) for t in touts)


@Ds
def test_group_by_null_values_keys_and_every_agg(pool, D, rng):
    """Value nulls (excluded), key-row nulls (dropped), an all-null
    group, a float key with -0.0, every aggregation over float64, uint8
    and bool values, and min/max over float32 with NaN."""
    N = 1536
    k1 = rng.integers(0, 9, N).astype(np.int32)
    k2 = rng.standard_normal(N).round(0)
    k2[rng.random(N) < 0.05] = -0.0
    v = rng.standard_normal(N)
    w = rng.integers(0, 255, N).astype(np.uint8)
    b = rng.random(N) < 0.5
    f = rng.standard_normal(N).astype(np.float32)
    f[rng.random(N) < 0.02] = np.nan
    valid = rng.random(N) < 0.9
    vm = rng.random(N) < 0.8
    vm[k1 == 4] = False                       # an all-null value group
    wm = rng.random(N) < 0.7
    fm = rng.random(N) < 0.9
    every = ("sum", "count", "min", "max", "mean")
    specs = tuple((0, a) for a in every) + tuple((1, a) for a in every) + \
        ((2, "sum"), (2, "count"), (3, "min"), (3, "max"), (3, "count"))
    _group_by(pool, D, [k1, k2, v, w, b, f, valid, vm, wm,
                        np.ones(N, bool), fm], N // D, 2, specs, 4)


@Ds
def test_group_by_overflow_flag(pool, D, rng):
    N = 1024
    keys = rng.integers(0, 500, N).astype(np.int64)
    ones = np.ones(N, np.bool_)
    jout, touts = _group_by(pool, D, [keys, np.ones(N), ones, ones], 8, 1,
                            ((0, "sum"),), 1)
    assert bool(jout[-1]) and all(bool(t[-1]) for t in touts)


@Ds
def test_streamed_group_by_matches_jax(pool, D, rng):
    """The chunk pipeline's table, slot for slot, and the barrier form."""
    N = 2048
    keys = rng.integers(0, 40, N).astype(np.int64)
    vals = rng.integers(0, 100, N).astype(np.int64)
    valid = rng.random(N) < 0.9
    # a chunk's rows all fit one bucket: no overflow at any D
    kw = {"cap": N // (4 * D), "n_chunks": 4, "table_size": 256}
    jout, touts = run_both(pool, D, "overlap", "make_group_by_sum_streamed",
                           kw, [keys, vals, valid],
                           lambda m: joverlap.make_group_by_sum_streamed(
                               m, **kw))
    check_blocks(jout, touts)
    assert not any(bool(t[-1]) for t in touts)
    got = {}
    for tk, sums, counts, occ, _, _ in touts:
        for i in np.flatnonzero(occ):
            got[int(tk[i])] = (int(sums[i]), int(counts[i]))
    want = {}
    for k in set(keys[valid].tolist()):
        m = (keys == k) & valid
        want[k] = (int(vals[m].sum()), int(m.sum()))
    assert got == want


@Ds
def test_streamed_overflow_and_full_table(pool, D, rng):
    """A capacity too small for a chunk raises the flag; a table with
    more keys than slots fills every slot."""
    N = 1024
    keys = rng.integers(0, 300, N).astype(np.int64)
    inputs = [keys, np.ones(N, np.int64), np.ones(N, np.bool_)]
    kw = {"cap": 4, "n_chunks": 2, "table_size": 64}
    jout, touts = run_both(pool, D, "overlap", "make_group_by_sum_streamed",
                           kw, inputs,
                           lambda m: joverlap.make_group_by_sum_streamed(
                               m, **kw))
    check_blocks(jout, touts)
    assert all(bool(t[-1]) for t in touts)
    kw = {"cap": N, "n_chunks": 2, "table_size": 64}
    jout, touts = run_both(pool, D, "overlap", "make_group_by_sum_streamed",
                           kw, inputs,
                           lambda m: joverlap.make_group_by_sum_streamed(
                               m, **kw))
    check_blocks(jout, touts)


@pytest.mark.parametrize("D", [2])
def test_bench_overlap_runs(pool, D):
    outs = pool.run(D, "bench_overlap", n_rows_per_shard=4096, n_keys=64,
                    n_chunks=4, repeats=2)
    assert all(b > 0 and s > 0 for b, s in outs)
    assert outs[0] == outs[1]          # the slowest rank's, on every rank


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hashtable_ops_match_jax(seed):
    """build (with resume), group_sum and probe slot for slot."""
    rng = np.random.default_rng(seed)
    n, T = 700, 256
    keys = rng.integers(-90, 90, n).astype(np.int64)
    vals = rng.integers(0, 50, n).astype(np.int64)
    valid = rng.random(n) < 0.9
    jk, jv, jm = jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid)
    tk, tv, tm = (torch.from_numpy(keys), torch.from_numpy(vals),
                  torch.from_numpy(valid))
    for jo, to in zip(jht.group_sum(jk, jv, jm, T),
                      tht.group_sum(tk, tv, tm, T)):
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    half = n // 2
    j1 = jht.build(jk[:half], jm[:half], T)
    t1 = tht.build(tk[:half], tm[:half], T)
    j2 = jht.build(jk[half:], jm[half:], T, init_keys=j1.keys,
                   init_occupied=j1.occupied)
    t2 = tht.build(tk[half:], tm[half:], T, init_keys=t1.keys,
                   init_occupied=t1.occupied)
    for jo, to in zip(j2, t2):
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    q = rng.integers(-120, 120, 300).astype(np.int64)
    qv = rng.random(300) < 0.9
    for jo, to in zip(jht.probe(j2.keys, j2.occupied, jnp.asarray(q),
                                jnp.asarray(qv)),
                      tht.probe(t2.keys, t2.occupied, torch.from_numpy(q),
                                torch.from_numpy(qv))):
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


# ---------------------------------------------------------------------------
# the table-level API
# ---------------------------------------------------------------------------

@Ds
def test_table_level_group_by_matches_jax(pool, D, rng):
    """String keys ride dictionary codes and come back decoded."""
    n = 1200
    data = {"cat": np.array([f"c{int(x)}" for x in rng.integers(0, 7, n)],
                            dtype=object),
            "region": rng.integers(0, 3, n).astype(np.int64),
            "v": rng.standard_normal(n)}
    jrb, hb = _tables(data)
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
            ("v", "mean"), ("region", "sum")]
    want = jpar.distributed_group_by(jrb, ["cat", "region"], aggs,
                                     mesh=jpar.make_mesh(D))
    for got in pool.run(D, "api", "distributed_group_by",
                        (hb, ["cat", "region"], aggs), {}):
        same_batch(got, want)


@Ds
def test_group_by_null_values_distributed(pool, D):
    """v=[10,None,5,7,None] on keys [a,a,b,b,c]: counts [1,2,0], min
    [10,5,null]; an all-null group gives null sum, min and mean."""
    data = {"k": np.array(["a", "a", "b", "b", "c"], dtype=object),
            "v": np.array([10, 0, 5, 7, 0], dtype=np.int64)}
    jrb, hb = _tables(data, {"v": np.array([1, 0, 1, 1, 0], bool)})
    aggs = [("v", "count"), ("v", "min"), ("v", "sum"), ("v", "mean")]
    want = jpar.distributed_group_by(jrb, "k", aggs, mesh=jpar.make_mesh(D))
    for got in pool.run(D, "api", "distributed_group_by", (hb, "k", aggs),
                        {}):
        same_batch(got, want)
        rows = {k: (c, mn, s, me) for k, c, mn, s, me in zip(
            *(got.column(i).to_pylist() for i in range(5)))}
        assert rows == {"a": (1, 10, 10, 10.0), "b": (2, 5, 12, 6.0),
                        "c": (0, None, None, None)}


@Ds
def test_group_by_unsigned_and_null_keys_match_jax(pool, D, rng):
    """uint16 / uint32 keys ride widened to int64 and come back in their
    type; null-key rows are dropped; unsigned sums come back uint64."""
    n = 900
    data = {"a": rng.integers(60000, 65536, n).astype(np.uint16),
            "b": rng.integers(0, 5, n).astype(np.uint32) + 4_000_000_000,
            "v": rng.integers(0, 2**31, n).astype(np.uint32)}
    masks = {"a": rng.random(n) < 0.9, "v": rng.random(n) < 0.9}
    jrb, hb = _tables(data, masks)
    aggs = [("v", "sum"), ("v", "min"), ("v", "max"), ("v", "count")]
    want = jpar.distributed_group_by(jrb, ["a", "b"], aggs,
                                     mesh=jpar.make_mesh(D))
    for got in pool.run(D, "api", "distributed_group_by",
                        (hb, ["a", "b"], aggs), {}):
        same_batch(got, want)
        assert got.column("a").values.dtype == np.uint16
        assert got.column("v_sum").values.dtype == np.uint64


def test_table_level_refusals():
    """Limb (decimal128) columns and uint64 keys raise; the JAX package
    refuses the former too."""
    from arrow_go_tpu_torch import dtypes as dt
    from arrow_go_tpu_torch.compute.errors import ArrowNotImplemented
    from arrow_go_tpu_torch.device.block import HostArray, HostBatch
    from arrow_go_tpu_torch.parallel import api
    m = tmesh.Mesh(None, 0, 1, torch.device("cpu"))
    u = HostBatch(dt.Schema([dt.Field("k", dt.uint64),
                             dt.Field("v", dt.float64)]),
                  [HostArray(np.arange(4, dtype=np.uint64), None, dt.uint64),
                   HostArray(np.ones(4), None, dt.float64)], 4)
    with pytest.raises(ArrowNotImplemented, match="uint64 key"):
        api._shard_columns(u, ["k"], m, key=True)
    api._shard_columns(u, ["k"], m)             # a uint64 payload rides
    d = HostBatch(dt.Schema([dt.Field("d", dt.decimal128(20, 2))]),
                  [HostArray(np.zeros((4, 2), np.int64), None,
                             dt.decimal128(20, 2))], 4)
    with pytest.raises(ArrowNotImplemented, match="flat columns"):
        api._shard_columns(d, ["d"], m)
    with pytest.raises(TypeError):
        api.distributed_group_by({"k": [1]}, "k", [("k", "count")], mesh=m)
