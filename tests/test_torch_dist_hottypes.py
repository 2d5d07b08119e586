"""hot_k on every join type of the port's distributed join against the
JAX package, on the CPU, at D = 1, 2 and 4 (compared as in
test_torch_dist_join.py): the probe side has one hot key (path A: its
build rows broadcast) and the build side another (path B: its build
rows salt over the ranks, for the types that salt), with keys unmatched
both ways and null probe keys. This holds the outer types' once-only
emission of unmatched broadcast rows and the semi/anti verdicts of hot
rows (tests/test_dist_generalized.py has right outer only).
"""
import numpy as np
import pytest

from torch_dist_parity import HOWS, dist_join, ones
from torch_dist_worker import SIZES, pool  # noqa: F401

Ds = pytest.mark.parametrize("D", SIZES)


def _skewed(rng, n, hot, lo):
    """n keys, 80% of them `hot`, the rest uniform over [lo, lo + 64)."""
    return np.where(rng.random(n) < 0.8, hot,
                    rng.integers(lo, lo + 64, n)).astype(np.int64)


@Ds
@pytest.mark.parametrize("how", HOWS)
def test_hot_k_every_join_type(pool, D, how, rng):
    N = 2048
    lk = _skewed(rng, N, 40, 0)        # probe-hot 40; 0..63
    rk = _skewed(rng, N, 50, 32)       # build-hot 50; 32..95
    lnull = rng.random(N) < 0.05
    lv = np.arange(N, dtype=np.int64)
    rv = rng.standard_normal(N)
    inputs = [lk, lv, ~lnull, rk, rv, ones(N)]
    if how in ("left semi", "left anti"):
        inputs.append(lnull)
    cap = 4 * N
    _, touts = dist_join(pool, D, inputs, cap_shuffle=cap, cap_out=cap * 8,
                         how=how, hot_k=4, hot_thresh=64, cap_hot=512,
                         cap_hot_out=cap * 8)
    assert not any(bool(t[-1]) for t in touts)
    if how in ("left semi", "left anti"):
        verdict = np.concatenate([t[0] for t in touts])
        has = np.isin(lk, rk) & ~lnull
        want = has if how == "left semi" else (~has & ~lnull) | lnull
        np.testing.assert_array_equal(verdict, want)
        return
    total = sum(int(t[i][0]) for t in touts for i in (4, 9, 14))
    lok = lk[~lnull]
    inner = sum(int((rk == k).sum()) * int(c)
                for k, c in zip(*np.unique(lok, return_counts=True)))
    un_l = int((~np.isin(lok, rk)).sum())
    un_r = int((~np.isin(rk, lok)).sum())
    want = inner + (un_l if how in ("left outer", "full outer") else 0) + \
        (un_r if how in ("right outer", "full outer") else 0)
    assert total == want
