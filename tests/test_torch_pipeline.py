"""The port's device pipeline as a whole, against the JAX package.

Q3 (benchmarks/engine_e2e.py:compute_ours) runs in both packages on the
same make_data inputs; the port's composition is the one chip_smoke.py
drives on the card. Groups and their order must be the same and counts
exact; revenues agree to rtol=1e-9 (engine_e2e.py:185's tolerance).
"""
import collections

import numpy as np

from benchmarks.engine_e2e import compute_ours, make_data

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.device.block import DeviceBatch
from chip_smoke import CUTOFF, check_q3, compute_q3, q3_oracle
from torch_parity import jax_batch, port_batch


def test_q3_matches_jax_and_oracle():
    li, orders = make_data(20_000, 5_000)
    jli, jord = jax_batch(li), jax_batch(orders)
    _, jout = compute_ours(jli, jord, CUTOFF)
    tout = compute_q3(port_batch(jli), port_batch(jord), CUTOFF)
    assert tout.schema.names == jout.schema.names
    assert tout.num_rows == jout.num_rows == 40
    for name in ("o_odate", "rev_count"):
        assert tout.column(name).to_pylist() == jout.column(name).to_pylist()
    np.testing.assert_allclose(tout.column("rev_sum").to_pylist(),
                               jout.column("rev_sum").to_pylist(),
                               rtol=1e-9)
    check_q3(tout, q3_oracle(li, orders, CUTOFF))


def test_device_resident_filter_join_group_by(rng):
    """tests/test_device_pipeline.py's composition, in the port."""
    n = 5000
    left = {"k": rng.integers(0, 50, n), "v": rng.standard_normal(n),
            "d": rng.integers(0, 30, n)}
    right = {"k": np.arange(50), "w": rng.integers(0, 9, 50)}
    ldb, rdb = port_batch(jax_batch(left)), port_batch(jax_batch(right))
    mask = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("d"), pc.literal(10)]), ldb)
    f = pc.filter(ldb, mask)
    assert isinstance(f, DeviceBatch)
    j = pc.hash_join(f, rdb, "k")
    assert isinstance(j, DeviceBatch)
    rev = pc.execute_scalar_expression(
        pc.call("multiply", [pc.field("v"), pc.literal(2.0)]), j)
    jb = DeviceBatch(tdt.Schema([tdt.Field("w", tdt.int64),
                                 tdt.Field("rev", tdt.float64)]),
                     [j.column("w"), rev], j.length)
    g = pc.group_by(jb, "w", [("rev", "sum"), ("rev", "count")])

    w_of = dict(zip(range(50), right["w"]))
    sel = left["d"] > 10
    sums = collections.defaultdict(float)
    cnts = collections.Counter()
    for ki, vi in zip(left["k"][sel], left["v"][sel]):
        sums[int(w_of[ki])] += 2.0 * vi
        cnts[int(w_of[ki])] += 1
    got = dict(zip(g.column("w").to_pylist(),
                   zip(g.column("rev_sum").to_pylist(),
                       g.column("rev_count").to_pylist())))
    assert set(got) == set(sums)
    for wk in sums:
        np.testing.assert_allclose(got[wk][0], sums[wk], rtol=1e-9)
        assert got[wk][1] == cnts[wk]
