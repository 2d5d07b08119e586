"""The hot-key paths of the port's distributed join against the JAX
package, on the CPU: the Zipf cases of tests/test_dist_generalized.py
(path A: probe-hot keys broadcast their build rows; path B: build-hot
keys salt their build rows over the ranks) and the hot-path overflow
flags, each at D = 1, 2 and 4, compared as in test_torch_dist_join.py.
hot_k on every join type is in test_torch_dist_hottypes.py.
"""
import numpy as np
import pytest

from torch_dist_parity import dist_join, inner_oracle, ones, pairs_of
from torch_dist_worker import SIZES, pool  # noqa: F401

Ds = pytest.mark.parametrize("D", SIZES)


def _zipf_sides(rng, NL, NR, hot, hot_left):
    """One key owns 80% of one side's rows."""
    big, small = (NL, NR) if hot_left else (NR, NL)
    skew = np.where(rng.random(big) < 0.8, hot,
                    rng.integers(0, 64, big)).astype(np.int64)
    flat = rng.integers(0, 64, small).astype(np.int64)
    lk, rk = (skew, flat) if hot_left else (flat, skew)
    return lk, rk


@Ds
def test_zipf_probe_hot_key_broadcast(pool, D, rng):
    """Path A: without hot_k the hot key overflows one rank's capacity;
    with it the join completes with every pair of the oracle."""
    NL, NR = 4096, 512
    lk, rk = _zipf_sides(rng, NL, NR, 3, True)
    lv = np.arange(NL, dtype=np.int64)
    rv = np.arange(NR, dtype=np.int64)
    inputs = [lk, lv, ones(NL), rk, rv, ones(NR)]
    cap = 256 * 8 // D               # the JAX case's capacity over 8 shards
    jout, _ = dist_join(pool, D, inputs, cap_shuffle=cap, cap_out=NL * 4)
    assert bool(jout[-1])
    _, touts = dist_join(pool, D, inputs, cap_shuffle=cap, cap_out=NL * 2,
                         n_keys=1, n_lpay=1, n_rpay=1, hot_k=4,
                         hot_thresh=64, cap_hot=64, cap_hot_out=NL * 8)
    assert not any(bool(t[-1]) for t in touts)
    assert pairs_of(touts, 3) == inner_oracle(lk.tolist(), rk.tolist(),
                                              lv.tolist(), rv.tolist())


@Ds
def test_zipf_build_hot_key_salted(pool, D, rng):
    """Path B: build-side skew salts the hot build rows over the ranks
    and broadcasts their probe rows. At D > 1 the hot key overflows one
    rank's capacity without hot_k (at D = 1 salting spreads nothing)."""
    NL, NR = 512, 4096
    lk, rk = _zipf_sides(rng, NL, NR, 11, False)
    lv = np.arange(NL, dtype=np.int64)
    rv = np.arange(NR, dtype=np.int64)
    inputs = [lk, lv, ones(NL), rk, rv, ones(NR)]
    cap = NR if D == 1 else 3 * NR // (2 * D * D)
    if D > 1:
        jout, _ = dist_join(pool, D, inputs, cap_shuffle=cap,
                            cap_out=NL * 64)
        assert bool(jout[-1])
    _, touts = dist_join(pool, D, inputs, cap_shuffle=cap, cap_out=NL * 64,
                         n_keys=1, n_lpay=1, n_rpay=1, hot_k=4,
                         hot_thresh=64, cap_hot=128, cap_hot_out=NL * 64)
    assert not any(bool(t[-1]) for t in touts)
    assert pairs_of(touts, 3) == inner_oracle(lk.tolist(), rk.tolist(),
                                              lv.tolist(), rv.tolist())


@Ds
def test_hot_k_overflow_flags(pool, D, rng):
    """More hot rows than cap_hot, and more hot pairs than cap_hot_out,
    raise the flag on every rank."""
    NL, NR = 2048, 256
    lk, rk = _zipf_sides(rng, NL, NR, 3, True)
    inputs = [lk, np.arange(NL), ones(NL), rk, np.arange(NR), ones(NR)]
    for cap_hot, cap_hot_out in ((1, NL * 8), (256, 16)):
        jout, touts = dist_join(pool, D, inputs, cap_shuffle=NL + NR,
                                cap_out=NL * 8, hot_k=4, hot_thresh=32,
                                cap_hot=cap_hot, cap_hot_out=cap_hot_out)
        assert bool(jout[-1]) and all(bool(t[-1]) for t in touts)
