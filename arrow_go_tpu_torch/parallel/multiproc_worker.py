"""Worker of the multi-process distributed tier.

    python -m arrow_go_tpu_torch.parallel.multiproc_worker \\
        --process-id I --num-processes N --port P [--rows R] [--device cpu]

(started N times by `multiproc.launch`). Each process joins the process
group, then the tier of parallel/dist.py and parallel/overlap.py runs
across the process boundary: the pre-aggregating group-by with value
nulls, a multi-key join, the hot-key join under Zipf skew, a multi-key
sort and the chunk-pipelined streamed shuffle. Every process checks
each result against a numpy oracle made from the same seed; process 0
prints the result JSON line ({"multiproc": ...}). Without --device the
workers run on the card.
"""
import argparse
import collections
import json

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rows", type=int, default=1 << 14)
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default: the card)")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from arrow_go_tpu_torch.parallel import dist as pdist
    from arrow_go_tpu_torch.parallel import multiproc, overlap

    mesh = multiproc.init_worker(args.process_id, args.num_processes,
                                 args.port, device=args.device)
    D = mesh.world_size
    N = args.rows
    rng = np.random.default_rng(12345)     # identical data on every rank
    results = {"processes": args.num_processes, "device": str(mesh.device),
               "backend": dist.get_backend(), "rows": N, "checks": {}}

    def put(*arrays):
        return [multiproc.global_put(mesh, np.asarray(a)) for a in arrays]

    def collect(t):
        return multiproc.collect(mesh, t)

    # ---- 1. pre-aggregating group-by with value nulls ------------------
    keys = rng.integers(0, 200, N).astype(np.int64)
    vals = rng.integers(0, 100, N).astype(np.int64)
    vmask = rng.random(N) < 0.9
    gfn = pdist.make_distributed_group_by(
        mesh, cap=max(512, N // D), n_keys=1,
        agg_specs=((0, "sum"), (0, "count"), (0, "min")), n_vals=1)
    keys_out, aggs, valids, ng, ov = gfn(*put(keys, vals, np.ones(N, np.bool_),
                                             vmask))
    if bool(ov):
        raise AssertionError("group-by overflow")
    ko = collect(keys_out[0])
    so, co, mo = (collect(a) for a in aggs)
    vmin = collect(valids[2])
    ngs = collect(ng)
    L = ko.shape[0] // D
    got = {}
    for d in range(D):
        for g in range(int(ngs[d])):
            i = d * L + g
            got[int(ko[i])] = (int(so[i]), int(co[i]),
                               int(mo[i]) if vmin[i] else None)
    want = {}
    for k in np.unique(keys):
        m = (keys == k) & vmask
        want[int(k)] = ((int(vals[m].sum()), int(m.sum()), int(vals[m].min()))
                        if m.any() else (0, 0, None))
    if got != want:
        raise AssertionError("group-by mismatch across processes")
    results["checks"]["group_by"] = {"groups": len(got), "ok": True}

    # ---- 2. multi-key inner join --------------------------------------
    NL, NR = N, N // 2
    KL = max(50, N // 256)
    lk1 = rng.integers(0, KL, NL).astype(np.int64)
    lk2 = rng.integers(0, 4, NL).astype(np.int64)
    rk1 = rng.integers(0, KL, NR).astype(np.int64)
    rk2 = rng.integers(0, 4, NR).astype(np.int64)
    lv = np.arange(NL, dtype=np.int64)
    rv = np.arange(NR, dtype=np.int64)
    cl = collections.Counter(zip(lk1.tolist(), lk2.tolist()))
    cr = collections.Counter(zip(rk1.tolist(), rk2.tolist()))
    want_pairs = sum(c * cr.get(k, 0) for k, c in cl.items())
    # pair capacity: every pair on one rank (the worst case at any N)
    jfn = pdist.make_distributed_join(
        mesh, cap_shuffle=NL, cap_out=want_pairs, n_keys=2, n_lpay=1,
        n_rpay=1)
    *_, n_out, jov = jfn(*put(lk1, lk2, lv, np.ones(NL, np.bool_),
                              rk1, rk2, rv, np.ones(NR, np.bool_)))
    if bool(jov):
        raise AssertionError("join overflow")
    n_pairs = int(collect(n_out).sum())
    if n_pairs != want_pairs:
        raise AssertionError(f"join pairs {n_pairs}, numpy {want_pairs}")
    results["checks"]["join_multikey"] = {"pairs": n_pairs, "ok": True}

    # ---- 3. Zipf hot-key join -----------------------------------------
    R = max(64, NR // 128)   # ~128 build rows per key at any N
    zlk = np.where(rng.random(NL) < 0.8, 7,
                   rng.integers(0, R, NL)).astype(np.int64)
    zrk = rng.integers(0, R, NR).astype(np.int64)
    czl = collections.Counter(zlk.tolist())
    czr = collections.Counter(zrk.tolist())
    want_z = sum(c * czr.get(k, 0) for k, c in czl.items())
    cap_shuffle = max(256, NL // (2 * D))   # << the hot key's rows
    zfn = pdist.make_distributed_join(
        mesh, cap_shuffle=cap_shuffle, cap_out=want_z,
        n_keys=1, n_lpay=1, n_rpay=1, hot_k=4,
        hot_thresh=cap_shuffle // 2, cap_hot=256, cap_hot_out=want_z)
    zout = zfn(*put(zlk, lv, np.ones(NL, np.bool_),
                    zrk, rv, np.ones(NR, np.bool_)))
    if bool(zout[-1]):
        raise AssertionError("hot-key join overflow")
    zpairs = int(sum(collect(zout[i]).sum() for i in (4, 9, 14)))
    if zpairs != want_z:
        raise AssertionError(f"hot-key join pairs {zpairs}, numpy {want_z}")
    results["checks"]["join_zipf_hotkey"] = {
        "pairs": zpairs, "cap_shuffle": cap_shuffle,
        "hot_rows": int((zlk == 7).sum()), "ok": True}

    # ---- 4. multi-key distributed sort --------------------------------
    sk1 = rng.integers(0, 30, N).astype(np.int64)
    sk2 = rng.standard_normal(N)
    pay = np.arange(N, dtype=np.int64)
    sfn = pdist.make_distributed_sort_multi(mesh, cap=N, n_keys=2,
                                            n_payload=1)
    keys_s, pay_s, counts_s, sov = sfn(*put(sk1, sk2, np.ones(N, np.bool_),
                                            pay))
    if bool(sov):
        raise AssertionError("sort overflow")
    k1o, k2o, po = collect(keys_s[0]), collect(keys_s[1]), collect(pay_s[0])
    cn = collect(counts_s)
    Ls = k1o.shape[0] // D
    rows = [(int(k1o[d * Ls + j]), float(k2o[d * Ls + j]),
             int(po[d * Ls + j]))
            for d in range(D) for j in range(int(cn[d]))]
    if rows != sorted(zip(sk1.tolist(), sk2.tolist(), pay.tolist())):
        raise AssertionError("sort mismatch")
    results["checks"]["sort_multikey"] = {"rows": len(rows), "ok": True}

    # ---- 5. chunk-pipelined streamed shuffle --------------------------
    okeys = rng.integers(0, 64, N).astype(np.int64)
    ovals = rng.integers(0, 100, N).astype(np.int64)
    ovalid = rng.random(N) < 0.9
    ofn = overlap.make_group_by_sum_streamed(
        mesh, cap=max(256, N // D), n_chunks=4, table_size=256)
    tk, sums, counts, occ, _ng, oov = ofn(*put(okeys, ovals, ovalid))
    if bool(oov):
        raise AssertionError("streamed shuffle overflow")
    tkh, sh_, ch_, oh = (collect(t) for t in (tk, sums, counts, occ))
    got_o = {int(tkh[i]): (int(sh_[i]), int(ch_[i]))
             for i in np.flatnonzero(oh)}
    want_o = {}
    for k in set(okeys[ovalid].tolist()):
        m = (okeys == k) & ovalid
        want_o[int(k)] = (int(ovals[m].sum()), int(m.sum()))
    if got_o != want_o:
        raise AssertionError("streamed shuffle mismatch")
    results["checks"]["streamed_shuffle"] = {"groups": len(got_o),
                                             "ok": True}

    results["ok"] = all(c["ok"] for c in results["checks"].values())
    if args.process_id == 0:
        print(json.dumps({"multiproc": results}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
