"""Distributed query on the PyTorch/CUDA port: shuffle -> group-by -> join
-> sort, then Zipf-skewed keys, a hot-key join and string keys (the
port's counterpart of examples/distributed_query.py).

The port runs one process per shard, joined by torch.distributed (NCCL
between cards, gloo on the CPU; arrow_go_tpu_torch/parallel). Tables
live row-sharded over the ranks; repartitioning is an all_to_all of
capacity-bounded blocks; group-by, join and sort then run rank-locally
on their hash or range partition.

    python examples/torch_distributed_query.py      (one rank on the card)
    python examples/torch_distributed_query.py --device cpu --processes 4
"""
import argparse
import os
import sys

import numpy as np

if __package__ in (None, ""):     # run as a script: the repo importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def query_data(D: int) -> dict:
    """main()'s tables for D shards: a fact table (customer_key, amount,
    valid) and a near-unique order id, from np.random.default_rng(0)."""
    N = 4096 * D
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 97, N).astype(np.int64)
    amounts = rng.integers(1, 1000, N).astype(np.int64)
    valid = rng.random(N) < 0.98
    oid = rng.permutation(N).astype(np.int64)
    return {"keys": keys, "amounts": amounts, "valid": valid, "oid": oid}


def skew_data(D: int) -> dict:
    """skew_and_strings()'s columns for D shards, from
    np.random.default_rng(1): an 80%-hot key, values, a build side's
    keys and two string keys' codes."""
    N = 2048 * D
    rng = np.random.default_rng(1)
    zkeys = np.where(rng.random(N) < 0.8, 7,
                     rng.integers(0, 50, N)).astype(np.int64)
    vals = rng.integers(0, 100, N).astype(np.int64)
    rk = rng.integers(0, 50, N).astype(np.int64)
    s1 = rng.integers(0, 25, N).astype(np.int32)     # codes of 25 strings
    s2 = rng.integers(0, 3, N).astype(np.int64)
    return {"zkeys": zkeys, "vals": vals, "rk": rk, "s1": s1, "s2": s2}


def _say(mesh, line: str) -> None:
    if mesh.rank == 0:
        print(line, flush=True)


def main(mesh) -> dict:
    """Group-by, join and sort over `mesh`; returns what rank 0 prints."""
    from arrow_go_tpu_torch.parallel import aggregate, join, sort
    from arrow_go_tpu_torch.parallel.multiproc import collect, global_put

    D = mesh.world_size
    _say(mesh, f"mesh: {D} ranks ({mesh.device.type}, "
               f"{'nccl' if mesh.device.type == 'cuda' else 'gloo'})")
    data = query_data(D)
    N = len(data["keys"])
    cap = 4096 * 4
    keys, amounts, valid, oid = (global_put(mesh, data[k]) for k in
                                 ("keys", "amounts", "valid", "oid"))
    out = {}

    # 1. distributed GROUP BY customer_key SUM(amount)
    agg = aggregate.make_group_by_sum(mesh, cap)
    gk, sums, cnts, ngroups, overflow = agg(keys, amounts, valid)
    assert not bool(overflow)
    out["groups"] = int(collect(mesh, ngroups).sum())
    _say(mesh, f"group-by: {out['groups']} groups across {D} shards")

    # 2. distributed hash join on a (near-unique) order id: each row of the
    # left matches at most one row of the right
    jfn = join.make_distributed_join(mesh, cap_shuffle=cap, cap_out=cap * D)
    jk, jl, jr, nout, jov = jfn(oid, amounts, valid, oid, amounts, valid)
    assert not bool(jov)
    out["pairs"] = int(collect(mesh, nout).sum())
    _say(mesh, f"join: {out['pairs']} matched pairs")

    # 3. distributed ORDER BY amount (range partition + local sort)
    sfn = sort.make_distributed_sort(mesh, cap=N, n_payload=1)
    res = sfn(amounts, valid, keys)
    assert not bool(res.overflow)
    counts = collect(mesh, res.counts)
    ks = collect(mesh, res.keys).reshape(D, -1)
    merged = np.concatenate([ks[d, :counts[d]] for d in range(D)])
    assert (np.diff(merged) >= 0).all()
    out.update(sorted_rows=len(merged), sorted_min=int(merged[0]),
               sorted_max=int(merged[-1]))
    _say(mesh, f"sort: {len(merged)} rows globally ordered "
               f"(min={merged[0]}, max={merged[-1]})")
    return out


def skew_and_strings(mesh) -> dict:
    """Zipf-skewed keys and multi-column string-keyed queries
    (parallel/dist.py) over `mesh`; returns what rank 0 prints."""
    import torch
    from arrow_go_tpu_torch.parallel import dist
    from arrow_go_tpu_torch.parallel.multiproc import collect, global_put

    D = mesh.world_size
    data = skew_data(D)
    N = len(data["zkeys"])
    zkeys, vals, rk, s1, s2 = (global_put(mesh, data[k]) for k in
                               ("zkeys", "vals", "rk", "s1", "s2"))
    ones = global_put(mesh, np.ones(N, np.bool_))
    out = {}

    # 80%-hot key: the pre-aggregating group-by finishes at a capacity far
    # below the hot key's row count (one partial row per rank per group)
    gfn = dist.make_distributed_group_by(
        mesh, cap=128, n_keys=1,
        agg_specs=((0, "sum"), (0, "mean"), (0, "max")), n_vals=1)
    keys_out, aggs, _valids, ngroups, ov = gfn(zkeys, vals, ones, ones)
    assert not bool(ov)
    out.update(skew_groups=int(collect(mesh, ngroups).sum()),
               hot_rows=int((data["zkeys"] == 7).sum()))
    _say(mesh, f"skewed group-by: {out['skew_groups']} groups, no overflow "
               f"at cap 128 (hot key has ~{out['hot_rows']} rows)")

    # hot-key broadcast join: the hot probe rows never move; the hot build
    # rows broadcast to every rank. The shuffle holds a rank's N / D rows
    # (the JAX script's 1024 overflows on a single device, its own run on
    # one device too; the pairs are the same at any capacity that holds)
    jfn = dist.make_distributed_join(
        mesh, cap_shuffle=N // D, cap_out=1 << 18, n_keys=1, n_lpay=1,
        n_rpay=1, hot_k=4, hot_thresh=64, cap_hot=128, cap_hot_out=1 << 20)
    res = jfn(zkeys, vals, ones, rk, vals, ones)
    assert not bool(res[-1])
    out["hot_pairs"] = int(sum(collect(mesh, res[i]).sum()
                               for i in (4, 9, 14)))
    _say(mesh, f"hot-key broadcast join: {out['hot_pairs']} pairs, "
               f"overflow-free")

    # multi-column string keys ride as shared dictionary codes
    mfn = dist.make_distributed_group_by(
        mesh, cap=128, n_keys=2, agg_specs=((0, "count"),), n_vals=1)
    mout = mfn(s1, s2, vals, ones, ones)
    out["string_groups"] = int(collect(mesh, mout[3]).sum())
    _say(mesh, f"string 2-key group-by: {out['string_groups']} groups")
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return out


def run(device=None) -> dict:
    """Both parts on a world-size-1 mesh in this process (`device`: the
    card unless named); a process group this call starts is destroyed
    after it."""
    import torch.distributed as tdist
    from arrow_go_tpu_torch.parallel import make_mesh
    started = not tdist.is_initialized()
    mesh = make_mesh(device)
    try:
        return {**main(mesh), **skew_and_strings(mesh)}
    finally:
        if started:
            tdist.destroy_process_group()


def _worker(args) -> int:
    import torch.distributed as tdist
    from arrow_go_tpu_torch.parallel import multiproc
    mesh = multiproc.init_worker(args.process_id, args.num_processes,
                                 args.port, device=args.device)
    main(mesh)
    skew_and_strings(mesh)
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--processes", type=int, default=1,
                    help="ranks, one process each (gloo on the CPU)")
    ap.add_argument("--process-id", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.process_id is not None:
        sys.exit(_worker(args))
    if args.processes == 1:
        run(args.device)
    else:
        from arrow_go_tpu_torch.parallel import multiproc
        extra = [] if args.device is None else ["--device", args.device]
        multiproc.launch("examples.torch_distributed_query", args.processes,
                         extra)
