"""hash_join of the port against the JAX package, on the CPU: all eight
join types over DeviceBatch inputs (inner and the outer types) and
HostBatch inputs (all eight; the port's stand-in for the JAX package's
RecordBatch path), with null keys, multi-column keys, string keys whose
dictionaries differ in order and membership, string payload columns,
suffix collisions, output_columns, empty sides and a chunked probe.

Output rows compare one for one and in order, string columns through
`to_pylist`; a DeviceBatch result also by its padded length and its
validity words bit for bit. Gathered floats are copied, so they compare
exactly too.
"""
import numpy as np
import pytest

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
from arrow_go_tpu.device.block import batch_from_device

import arrow_go_tpu_torch as agt_torch
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch.device.block import (HostArray, HostBatch,
                                             concat_host_arrays,
                                             device_batch_to_host)
from torch_parity import jax_batch, port_batch, words_u32

DEVICE_HOWS = ["inner", "left outer", "right outer", "full outer"]
ALL_HOWS = DEVICE_HOWS + ["left semi", "left anti", "right semi",
                          "right anti"]
# the two sides' key dictionaries differ in order and in membership
LEFT_WORDS = np.array(["pear", "fig", "apple", "kiwi", "plum", "äpfel"],
                      dtype=object)
RIGHT_WORDS = np.array(["kiwi", "apple", "date", "pear", "lime"],
                       dtype=object)


def _sides(rng, nl, nr, nulls=True):
    """Left and right tables: a string key `k`, an int key `i`, a float
    `v` and a string payload on each side (`s` left, `t` right), with
    null masks when `nulls`."""
    left = {"k": LEFT_WORDS[rng.integers(0, 6, nl)],
            "i": rng.integers(0, 4, nl).astype(np.int64),
            "v": rng.standard_normal(nl),
            "s": np.array([f"L{x}" for x in rng.integers(0, 9, nl)],
                          dtype=object)}
    right = {"k": RIGHT_WORDS[rng.integers(0, 5, nr)],
             "i": rng.integers(0, 4, nr).astype(np.int64),
             "v": rng.standard_normal(nr),
             "t": np.array([f"R{x}" for x in rng.integers(0, 7, nr)],
                           dtype=object)}
    if not nulls:
        return left, right, {}, {}
    lm = {c: rng.random(nl) > 0.15 for c in ("k", "i", "v", "s")}
    rm = {c: rng.random(nr) > 0.15 for c in ("k", "i", "t")}
    return left, right, lm, rm


def _rows(rb) -> dict:
    return {n: rb.column(i).to_pylist()
            for i, n in enumerate(rb.schema.names)}


def _same_device(tdb, jdb) -> None:
    """A port DeviceBatch against a JAX DeviceBatch: names, length,
    padding, validity words bit for bit, and every row's value."""
    assert tdb.schema.names == jdb.schema.names
    assert tdb.length == jdb.length
    for tc, jc in zip(tdb.columns, jdb.columns):
        assert tc.padded == jc.padded
        assert (tc.validity is None) == (jc.validity is None)
        if jc.validity is not None:
            np.testing.assert_array_equal(words_u32(tc.validity),
                                          np.asarray(jc.validity))
    assert device_batch_to_host(tdb).to_pydict() == _rows(
        batch_from_device(jdb))


def _both(rng, nl=300, nr=120, nulls=True):
    left, right, lm, rm = _sides(rng, nl, nr, nulls)
    jl, jr = jax_batch(left, lm), jax_batch(right, rm)
    return jl, jr, port_batch(jl), port_batch(jr)


def test_string_keys_with_differing_dictionaries_pair_the_right_rows():
    """The two faults: left "b" paired with right "a" (raw codes joined
    across dictionaries) and string columns losing their values."""
    left = {"k": np.array(["b", "a", "c"], dtype=object),
            "x": np.arange(3, dtype=np.int64)}
    right = {"k": np.array(["a", "b"], dtype=object),
             "y": np.array([10, 20], dtype=np.int64)}
    tl = agt_torch.batch_to_device(left, device="cpu")
    tr = agt_torch.batch_to_device(right, device="cpu")
    out = device_batch_to_host(pc.hash_join(tl, tr, "k"))
    assert out.to_pydict() == {"k": ["b", "a"], "x": [0, 1], "y": [20, 10]}
    assert out.column("k").dict_values is not None
    jl, jr = jax_batch(left), jax_batch(right)
    _same_device(pc.hash_join(port_batch(jl), port_batch(jr), "k"),
                 jpc.hash_join(jl, jr, "k"))


@pytest.mark.parametrize("how", DEVICE_HOWS)
@pytest.mark.parametrize("keys", [["k"], ["i"], ["k", "i"], ["i", "k"]])
def test_device_batch_join_matches_jax(rng, how, keys):
    jl, jr, tl, tr = _both(rng)
    _same_device(pc.hash_join(tl, tr, keys, join_type=how),
                 jpc.hash_join(jl, jr, keys, join_type=how))


@pytest.mark.parametrize("how", DEVICE_HOWS)
def test_device_batch_join_without_nulls_matches_jax(rng, how):
    jl, jr, tl, tr = _both(rng, 500, 200, nulls=False)
    _same_device(pc.hash_join(tl, tr, "k", join_type=how),
                 jpc.hash_join(jl, jr, "k", join_type=how))


def _host(jdb) -> HostBatch:
    """The port's HostBatch holding a JAX DeviceBatch's rows."""
    return device_batch_to_host(port_batch(jdb))


def _jax_record(jdb):
    return batch_from_device(jdb)


@pytest.mark.parametrize("how", ALL_HOWS)
@pytest.mark.parametrize("keys", [["k"], ["k", "i"]])
def test_host_batch_join_matches_jax(rng, how, keys):
    jl, jr, _, _ = _both(rng)
    got = pc.hash_join(_host(jl), _host(jr), keys, join_type=how,
                       device="cpu")
    want = jpc.hash_join(_jax_record(jl), _jax_record(jr), keys,
                         join_type=how)
    assert got.schema.names == want.schema.names
    assert got.num_rows == want.num_rows
    assert got.to_pydict() == _rows(want)


@pytest.mark.parametrize("how", ALL_HOWS)
def test_chunked_probe_matches_unchunked_and_jax(rng, how):
    jl, jr, _, _ = _both(rng, 200, 60)
    whole = pc.hash_join(_host(jl), _host(jr), "k", join_type=how,
                         device="cpu")
    chunked = pc.hash_join(_host(jl), _host(jr), "k", join_type=how,
                           probe_chunk=23, device="cpu")
    want = jpc.hash_join(_jax_record(jl), _jax_record(jr), "k",
                         join_type=how, probe_chunk=23)
    assert chunked.to_pydict() == _rows(want)
    if how in ("inner", "left outer", "left semi", "left anti"):
        # chunking is exact for these: the same rows, chunk after chunk
        assert sorted(map(str, zip(*chunked.to_pydict().values()))) == \
            sorted(map(str, zip(*whole.to_pydict().values())))
    else:
        assert chunked.to_pydict() == whole.to_pydict()


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("cols", [["k", "s", "t", "v_right"],
                                  ["v", "i_right", "t"], ["nope"]])
def test_output_columns_and_suffixes_match_jax(rng, route, cols):
    jl, jr, tl, tr = _both(rng)
    for how in DEVICE_HOWS:
        kw = dict(join_type=how, output_columns=cols)
        if route == "device":
            _same_device(pc.hash_join(tl, tr, "k", **kw),
                         jpc.hash_join(jl, jr, "k", **kw))
        else:
            got = pc.hash_join(_host(jl), _host(jr), "k", device="cpu",
                               **kw)
            assert got.to_pydict() == _rows(jpc.hash_join(
                _jax_record(jl), _jax_record(jr), "k", **kw))


def test_suffix_collision_and_left_suffix_match_jax(rng):
    """The right side has both `v` and `v_right`: two output columns are
    named `v_right` in both packages (ROADMAP §3, a quirk kept)."""
    left = {"k": rng.integers(0, 5, 50), "v": rng.standard_normal(50)}
    right = {"k": np.arange(5), "v": rng.standard_normal(5),
             "v_right": rng.standard_normal(5)}
    jl, jr = jax_batch(left), jax_batch(right)
    for how in DEVICE_HOWS:
        for kw in ({}, {"left_suffix": "_l"}):
            _same_device(pc.hash_join(port_batch(jl), port_batch(jr), "k",
                                      join_type=how, **kw),
                         jpc.hash_join(jl, jr, "k", join_type=how, **kw))


@pytest.mark.parametrize("empty", ["left", "right", "both"])
@pytest.mark.parametrize("how", ALL_HOWS)
def test_empty_sides_match_jax(rng, empty, how):
    left, right, _, _ = _sides(rng, 40, 20, nulls=False)
    # (an empty str list has no type in the JAX package: numbers only)
    left = {c: left[c][:0 if empty in ("left", "both") else 40]
            for c in ("i", "v")}
    right = {c: right[c][:0 if empty in ("right", "both") else 20]
             for c in ("i", "v")}
    jl, jr = jax_batch(left), jax_batch(right)
    want = jpc.hash_join(_jax_record(jl), _jax_record(jr), "i",
                         join_type=how)
    got = pc.hash_join(_host(jl), _host(jr), "i", join_type=how,
                       device="cpu")
    assert got.num_rows == want.num_rows
    assert got.to_pydict() == _rows(want)
    if how in DEVICE_HOWS:
        _same_device(pc.hash_join(port_batch(jl), port_batch(jr), "i",
                                  join_type=how),
                     jpc.hash_join(jl, jr, "i", join_type=how))


@pytest.mark.parametrize("how", ALL_HOWS[4:])
@pytest.mark.parametrize("keys", [["k"], ["k", "i"]])
def test_semi_verdict_selects_the_rows_jax_keeps(rng, how, keys):
    """The device verdict that the HostBatch route selects rows by, over
    DeviceBatches: its set rows are the rows the JAX record-batch join
    keeps, in order, and no padding row is set."""
    from arrow_go_tpu_torch.compute.join import semi_verdict
    jl, jr, tl, tr = _both(rng)
    verdict = semi_verdict(tl, tr, keys, keys, how).numpy()
    kept = tr if how.startswith("right") else tl
    assert verdict.shape == (kept.padded,)
    assert not verdict[kept.length:].any()
    rows = device_batch_to_host(kept).to_pydict()
    idx = np.flatnonzero(verdict)
    want = jpc.hash_join(_jax_record(jl), _jax_record(jr), keys,
                         join_type=how)
    assert {c: [v[i] for i in idx] for c, v in rows.items()} == _rows(want)


def test_semi_and_anti_raise_on_device_batches(rng):
    _, _, tl, tr = _both(rng, 10, 10)
    for how in ALL_HOWS[4:]:
        with pytest.raises(pc.ArrowNotImplemented):
            pc.hash_join(tl, tr, "k", join_type=how)
    with pytest.raises(pc.ArrowNotImplemented):
        pc.hash_join(tl, tr, "k", join_type="cross")


def test_string_key_against_an_int_key_raises(rng):
    _, _, tl, tr = _both(rng, 10, 10)
    with pytest.raises(pc.ArrowInvalid):
        pc.hash_join(tl, tr, left_keys=["k"], right_keys=["i"])


def test_mixed_host_and_device_inputs_join_on_the_device(rng):
    jl, jr, tl, _ = _both(rng)
    got = pc.hash_join(tl, _host(jr), "k", join_type="left outer")
    _same_device(got, jpc.hash_join(jl, jr, "k", join_type="left outer"))


@pytest.mark.parametrize("how", DEVICE_HOWS)
def test_mixed_route_renumbers_a_host_batch_dictionary(how):
    """A right HostBatch built directly, its rows "z", "y", "a" over the
    dictionary ["a", "y", "z"] (not in first-occurrence order, as no
    HostBatch made from a JAX batch is), beside a left DeviceBatch: the
    rows and their order are the JAX package's, whose right side numbers
    its strings by first occurrence."""
    left = {"k": np.array(["a", "b", "a", "c"], dtype=object),
            "x": np.arange(4, dtype=np.int64)}
    right = {"k": np.array(["z", "y", "a"], dtype=object),
             "w": np.array([10, 20, 30], dtype=np.int64)}
    jl, jr = jax_batch(left), jax_batch(right)
    t = agt_torch.dtypes.dictionary(agt_torch.dtypes.int32,
                                    agt_torch.dtypes.string)
    host_right = HostBatch.from_arrays({
        "k": HostArray(np.array([2, 1, 0], np.int32), None, t,
                       np.array(["a", "y", "z"], dtype=object)),
        "w": HostArray(right["w"], None, agt_torch.dtypes.int64)})
    got = pc.hash_join(port_batch(jl), host_right, "k", join_type=how)
    _same_device(got, jpc.hash_join(jl, jr, "k", join_type=how))


@pytest.mark.parametrize("shared", [True, False])
def test_concat_host_arrays_keeps_or_merges_dictionaries(shared):
    d1 = np.array(["x", "y"], dtype=object)
    d2 = d1 if shared else np.array(["z", "x"], dtype=object)
    t = agt_torch.dtypes.dictionary(agt_torch.dtypes.int32,
                                    agt_torch.dtypes.string)
    a = HostArray(np.array([0, 1], np.int32), None, t, d1)
    b = HostArray(np.array([1, 0], np.int32), np.array([True, False]), t,
                  d2)
    out = concat_host_arrays([a, b])
    assert out.to_pylist() == ["x", "y"] + (["y", None] if shared
                                            else ["x", None])
    assert (out.dict_values is d1) == shared
    assert agt.array(out.to_pylist()).to_pylist() == out.to_pylist()
