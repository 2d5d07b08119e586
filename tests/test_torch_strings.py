"""String (dictionary) columns in the port against the JAX package: the
int32 codes and host dictionary a string column becomes on the device,
filter and take carrying the dictionary, and sort_indices in its record
form over sort keys (dictionary codes sort by their strings), on host
and device batches."""
import numpy as np
import pytest

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
from arrow_go_tpu.device.block import batch_to_device as jax_batch_to_device

import arrow_go_tpu_torch as agt_torch
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.device.block import HostArray, HostBatch
from torch_parity import jax_batch, port_batch

WORDS = np.array(["pear", "apple", "fig", "Zebra", "äpfel", ""],
                 dtype=object)


def test_batch_to_device_codes_and_dictionary_match_jax(rng):
    s = WORDS[rng.integers(0, 6, 500)]
    tdb = agt_torch.batch_to_device({"s": s}, device="cpu")
    jdb = jax_batch_to_device(agt.record_batch({"s": agt.array(s.tolist())}))
    tc, jc = tdb.column("s"), jdb.column("s")
    assert tc.type == tdt.dictionary(tdt.int32, tdt.string)
    assert tdb.schema.field(0).type == tdt.string
    assert list(tc.dict_values) == jc.dictionary.to_pylist()
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    # (codes, values) pairs are taken as they stand
    pair = agt_torch.batch_to_device(
        {"s": (np.array([2, 0, 2], np.int32), WORDS)}, device="cpu")
    assert list(pair.column("s").dict_values) == list(WORDS)
    assert pair.column("s").values[:3].tolist() == [2, 0, 2]


def test_filter_and_take_carry_the_dictionary(rng):
    n = 400
    data = {"s": WORDS[rng.integers(0, 6, n)], "x": rng.integers(0, 9, n)}
    masks = {"s": rng.random(n) < 0.8}
    jdb = jax_batch(data, masks)
    tdb = port_batch(jdb)
    mask = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("x"), pc.literal(4)]), tdb)
    f = pc.filter(tdb, mask)
    jmask = jpc.execute_scalar_expression(
        jpc.call("greater", [jpc.field("x"), jpc.literal(4)]), jdb)
    jf = jpc.filter(jdb, jmask)
    assert f.length == jf.length
    sel = data["x"] > 4
    want = [w if ok else None for w, ok in zip(data["s"][sel],
                                                masks["s"][sel])]
    col = f.column("s")
    assert list(col.dict_values) == jf.column("s").dictionary.to_pylist()
    got = HostArray(col.values[:f.length].numpy(),
                    np.unpackbits(col.validity.numpy().view(np.uint8),
                                  bitorder="little")[:f.length].astype(bool),
                    col.type, col.dict_values)
    assert got.to_pylist() == want
    idx = agt_torch.batch_to_device({"i": np.array([3, 0, 3])},
                                    device="cpu").column(0)
    t = pc.take(col, idx)
    assert t.dict_values is col.dict_values
    hidx = HostArray(np.array([2, 0, 1]), None, tdt.int64)
    assert pc.take(got, hidx).to_pylist() == [want[2], want[0], want[1]]


def _host_batch(data, masks):
    """A HostBatch of the columns; a string column's dictionary is in
    reverse string order, so its codes do not sort as its strings."""
    cols = {}
    for k, v in data.items():
        m = masks.get(k)
        if v.dtype == object:
            d = np.array(sorted(set(v.tolist()), reverse=True), dtype=object)
            code_of = {x: i for i, x in enumerate(d.tolist())}
            cols[k] = HostArray(np.array([code_of[x] for x in v], np.int32),
                                m, tdt.dictionary(tdt.int32, tdt.string), d)
        else:
            cols[k] = HostArray(v, m, tdt.from_numpy_dtype(v.dtype))
    return HostBatch.from_arrays(cols)


KEY_ORDERS = [("ascending", "ascending"), ("descending", "ascending"),
              ("ascending", "descending")]


@pytest.mark.parametrize("placement", ["at_end", "at_start"])
@pytest.mark.parametrize("orders", KEY_ORDERS)
@pytest.mark.parametrize("where", ["host", "device", "host_large"])
def test_record_sort_indices_matches_jax(rng, where, orders, placement):
    n = 5000 if where == "host_large" else 300
    data = {"s": WORDS[rng.integers(0, 6, n)],
            "f": np.round(rng.standard_normal(n), 1)}
    data["f"][rng.integers(0, n, 5)] = np.nan
    masks = {"s": rng.random(n) < 0.85, "f": rng.random(n) < 0.9}
    # a null string's slot holds "" (the JAX package's null code): keys
    # under a null still order the rows that tie before them, in both
    data["s"][~masks["s"]] = ""
    rb = agt.record_batch({
        "s": agt.array([x if ok else None
                        for x, ok in zip(data["s"].tolist(), masks["s"])]),
        "f": agt.from_numpy(data["f"], masks["f"])})
    keys = [("s", orders[0]), ("f", orders[1])]
    jperm = jpc.sort_indices(rb, jpc.SortOptions(
        keys=[jpc.SortKey(k, o) for k, o in keys],
        null_placement=placement)).to_pylist()
    opts = pc.SortOptions([pc.SortKey(k, o) for k, o in keys], placement)
    if where == "device":
        perm = pc.sort_indices(port_batch(jax_batch(data, masks)), opts)
        got = perm.values[:perm.length].tolist()
    else:
        perm = pc.sort_indices(_host_batch(data, masks), opts, device="cpu")
        got = perm.to_pylist()
    assert got == jperm


def test_record_sort_needs_keys():
    hb = HostBatch.from_arrays({"x": HostArray(np.arange(3), None,
                                               tdt.int64)})
    with pytest.raises(pc.ArrowInvalid):
        pc.sort_indices(hb)
