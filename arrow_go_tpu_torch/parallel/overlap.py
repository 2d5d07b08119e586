"""Compute/communication-overlapped distributed aggregation.

Port of arrow_go_tpu/parallel/overlap.py. The barrier form
(parallel/aggregate.py) runs ONE all_to_all of everything, then
aggregates. The streamed form here splits the local rows into C chunks
and pipelines them: chunk c+1's exchange is issued (async_op=True)
before chunk c is merged, and each merge waits on its own chunk's work
first, so the collective runs beside the merge. The received rows of
every chunk go into one open-addressing hash table (ops/hashtable.build
with resume), so group identities are exact across chunks and no final
re-merge is needed.

bench_overlap() times barrier vs streamed on the current mesh.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import hashing, hashtable
from . import shuffle as shuf
from .mesh import Mesh, all_max, all_to_all


def make_group_by_sum_streamed(mesh: Mesh, cap: int, n_chunks: int,
                               table_size: int):
    """Chunk-pipelined distributed GROUP BY key -> sum(value), count(*).

    Per-rank inputs: keys[L] int64, values[L], valid[L] bool (rows past
    n_chunks * (L // n_chunks) are not read, as in the JAX package).
    Per-rank outputs: table_keys[T], sums[T], counts[T] int32,
    occupied[T], n_groups[1], overflow. Groups live in hash-slot order."""
    D = mesh.world_size
    T = table_size

    def step(keys, values, valid):
        L = keys.shape[0]
        chunk = L // n_chunks
        dev = keys.device
        dest = shuf.partition_of(hashing.hash32(keys), D)

        def send(c):
            """Pack chunk c and issue its exchange: (buffers, works,
            overflow of its pack)."""
            sl = slice(c * chunk, (c + 1) * chunk)
            packed, pcnt, ovf = shuf._pack_for_send(
                dest[sl], valid[sl], D, cap, (keys[sl], values[sl]))
            outs, works = zip(*(all_to_all(mesh, b, async_op=True)
                                for b in packed + [pcnt]))
            return outs, works, ovf

        table_keys = torch.zeros(T, dtype=keys.dtype, device=dev)
        occupied = torch.zeros(T, dtype=torch.bool, device=dev)
        sums = torch.zeros(T, dtype=values.dtype, device=dev)
        counts = torch.zeros(T, dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        pending = send(0) if n_chunks else None
        for c in range(n_chunks):
            # the next chunk's exchange runs while this one merges
            nxt = send(c + 1) if c + 1 < n_chunks else None
            (rk, rv, rcnt), works, ovf = pending
            for w in works:
                w.wait()
            rvalid = shuf.row_validity_mask(rk, rcnt, cap)
            ht = hashtable.build(rk, rvalid, T, init_keys=table_keys,
                                 init_occupied=occupied)
            table_keys, occupied = ht.keys, ht.occupied
            hit = rvalid & (ht.slots >= 0)
            slot = ht.slots.clamp(0, T - 1)
            sums.index_add_(0, slot, torch.where(hit, rv, 0).to(rv.dtype))
            counts.index_add_(0, slot, hit.to(torch.int32))
            overflow = overflow | ovf
            pending = nxt
        return (table_keys, sums, counts, occupied,
                occupied.sum().to(torch.int32).reshape(1),
                all_max(mesh, overflow))

    return step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_overlap(mesh: Mesh, n_rows_per_shard: int = 1 << 16,
                  n_keys: int = 512, n_chunks: int = 4, repeats: int = 5):
    """Wall clock of the barrier all_to_all + aggregate vs the chunk
    pipeline, each the slowest rank's median of `repeats` runs after one
    warm run. Returns (barrier_s, streamed_s)."""
    from . import aggregate
    from .mesh import row_sharding

    D = mesh.world_size
    N = n_rows_per_shard * D
    rng = np.random.default_rng(0)
    sh = row_sharding(mesh)
    keys = sh.put(rng.integers(0, n_keys, N).astype(np.int64))
    vals = sh.put(rng.integers(0, 100, N).astype(np.int64))
    valid = sh.put(np.ones(N, np.bool_))

    cap = n_rows_per_shard          # worst case: all rows to one rank
    barrier = aggregate.make_group_by_sum(mesh, cap)
    streamed = make_group_by_sum_streamed(
        mesh, cap // n_chunks + n_keys, n_chunks, table_size=4 * n_keys)

    def timeit(fn):
        fn(keys, vals, valid)
        _sync(mesh.device)
        ts = []
        for _ in range(repeats):
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            fn(keys, vals, valid)
            _sync(mesh.device)
            ts.append(time.perf_counter() - t0)
        med = torch.tensor([sorted(ts)[len(ts) // 2]], dtype=torch.float64,
                           device=mesh.device)
        dist.all_reduce(med, op=dist.ReduceOp.MAX, group=mesh.group)
        return float(med)

    return timeit(barrier), timeit(streamed)
