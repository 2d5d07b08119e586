"""The JAX side of the distributed tier's parity tests: each builder
run on make_mesh(D) of the suite's 8-device CPU mesh beside the port's
on D spawned ranks (torch_dist_worker.Pool), and the join checks the
join test files share."""
import collections

import numpy as np

import jax
import jax.numpy as jnp

import arrow_go_tpu.parallel as jpar
from arrow_go_tpu.parallel import dist as jdist

from torch_dist_worker import check_blocks

HOWS = ["inner", "left outer", "right outer", "full outer", "left semi",
        "left anti"]

_JAX_FNS = {}


def run_both(pool, D, module, name, kwargs, inputs, jax_make):
    """The JAX builder (kept per module, name, D and kwargs, so a shape
    seen before is not compiled again) and the port's on D ranks."""
    key = (module, name, D, tuple(sorted(kwargs.items())))
    mesh = jpar.make_mesh(D)
    if key not in _JAX_FNS:
        _JAX_FNS[key] = jax_make(mesh)
    sh = jpar.row_sharding(mesh)
    jout = _JAX_FNS[key](*[jax.device_put(jnp.asarray(a), sh)
                           for a in inputs])
    return jout, pool.run(D, "builder", module, name, kwargs, inputs)


def dist_join(pool, D, inputs, **kw):
    """make_distributed_join on both packages; checks every rank's
    blocks (each output group over its own count) and returns both."""
    jout, touts = run_both(pool, D, "dist", "make_distributed_join", kw,
                           inputs,
                           lambda m: jdist.make_distributed_join(m, **kw))
    if kw.get("how", "inner") in ("left semi", "left anti"):
        check_blocks(jout, touts)
        return jout, touts
    g = kw.get("n_keys", 1) + kw.get("n_lpay", 1) + kw.get("n_rpay", 1) + 1
    groups = 3 if kw.get("hot_k") else 1
    check_blocks(jout, touts, [(i * (g + 1), i * (g + 1) + g,
                                i * (g + 1) + g) for i in range(groups)])
    return jout, touts


def pairs_of(touts, groups=1):
    """(key, lpay, rpay) of every emitted pair over all ranks."""
    out = []
    for t in touts:
        for i in range(groups):
            keys, lp, rp, _, n = t[i * 5: i * 5 + 5]
            n = int(n[0])
            out += list(zip(keys[0][:n].tolist(), lp[0][:n].tolist(),
                            rp[0][:n].tolist()))
    return sorted(out)


def inner_oracle(lk, rk, lv, rv):
    right_by_key = collections.defaultdict(list)
    for j, k in enumerate(rk):
        right_by_key[k].append(j)
    return sorted((k, lv[i], rv[j]) for i, k in enumerate(lk)
                  for j in right_by_key.get(k, []))


def ones(n):
    return np.ones(n, np.bool_)
