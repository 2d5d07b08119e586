"""Nested types of the port (list, large_list, fixed_size_list, struct,
map, nested up to depth 3 with nulls at every level) against the JAX
package, on the CPU.

The same seeded values go to both packages: the JAX package builds its
host Array, and `torch_parity.port_array` carries it into the port's
HostArray. Offsets, validity and ints must match exactly, floats at
rtol 1e-9 (`torch_parity.same_array`). The device list column
(`list_take_device`, `list_from_device`) runs as the JAX package's own
test runs it (tests/test_device_ops.py), its fills on K2's plain
version here.
"""
import importlib

import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.array.concat import concat_arrays
from arrow_go_tpu.compute import expression as jexpr
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import nested_selection as jns
from arrow_go_tpu.device.block import (from_device, list_from_device as
                                       jlist_from_device, list_take_device as
                                       jlist_take_device, list_to_device as
                                       jlist_to_device, pad_length)

import arrow_go_tpu_torch as tagt
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.compute import expression as texpr
from arrow_go_tpu_torch.compute import nested_selection as tns
from arrow_go_tpu_torch.device.block import (HostArray, HostBatch,
                                             HostColumn, column_to_host,
                                             concat_host_arrays,
                                             device_batch_to_host,
                                             host_batch_to_device)
from torch_parity import (jax_array, jax_batch, port_array, port_batch,
                          port_type, same_array)

jcast = importlib.import_module("arrow_go_tpu.compute.cast")

WORDS = ["MAIL", "SHIP", "AIR", "", "TRUCK", "FOB", "REG AIR"]

TYPES = {
    "list<int64>": jdt.list_(jdt.int64),
    "large_list<double>": jdt.large_list(jdt.float64),
    "fixed_size_list<int32>[3]": jdt.fixed_size_list(jdt.int32, 3),
    "struct<a: int32, b: utf8>": jdt.struct({"a": jdt.int32,
                                            "b": jdt.string}),
    "map<utf8, int64>": jdt.map_(jdt.string, jdt.int64),
    "struct of list": jdt.struct({"a": jdt.list_(jdt.int64),
                                  "b": jdt.float64}),
    "list of struct": jdt.list_(jdt.struct({"x": jdt.int32,
                                            "y": jdt.string})),
    "list<list<int32>>": jdt.list_(jdt.list_(jdt.int32)),
    "struct<s: struct<a: list>>": jdt.struct({
        "s": jdt.struct({"a": jdt.list_(jdt.int64), "c": jdt.bool_}),
        "b": jdt.int32}),
    "list<fixed_size_list>": jdt.list_(jdt.fixed_size_list(jdt.float64, 2)),
    "large_list<list<utf8>>": jdt.large_list(jdt.list_(jdt.string)),
    "map<int32, list<double>>": jdt.map_(jdt.int32, jdt.list_(jdt.float64)),
    "list<list<list<int16>>>": jdt.list_(jdt.list_(jdt.list_(jdt.int16))),
    "list<uint32> not null": jdt.list_(jdt.Field("item", jdt.uint32, False)),
}


def random_values(t, n: int, rng, null_p: float = 0.15) -> list:
    """n Python values of JAX type t, None at rate null_p at every
    nullable level."""
    def one(t, nullable=True):
        if nullable and rng.random() < null_p:
            return None
        tid = t.id
        if tid in (jdt.TypeId.LIST, jdt.TypeId.LARGE_LIST):
            vf = t.value_field
            return [one(vf.type, vf.nullable)
                    for _ in range(rng.integers(0, 4))]
        if tid == jdt.TypeId.FIXED_SIZE_LIST:
            vf = t.value_field
            return [one(vf.type, vf.nullable) for _ in range(t.list_size)]
        if tid == jdt.TypeId.STRUCT:
            return {f.name: one(f.type, f.nullable) for f in t.fields()}
        if tid == jdt.TypeId.MAP:
            k = int(rng.integers(0, 4))
            keys = rng.choice(len(WORDS), k, replace=False)
            return [(WORDS[i] if t.key_type == jdt.string else int(i),
                     one(t.item_type)) for i in keys]
        if t == jdt.string:
            return WORDS[rng.integers(0, len(WORDS))]
        if t == jdt.bool_:
            return bool(rng.random() < 0.5)
        if t.is_floating:
            return float(rng.standard_normal())
        info = np.iinfo(t.np_dtype)
        return int(rng.integers(max(info.min, -1000), min(info.max, 1000)))
    return [one(t) for _ in range(n)]


def pair(name: str, n: int = 80, seed: int = 0):
    """(the JAX package's Array, the port's HostArray) of TYPES[name]."""
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    ja = agt.array(random_values(TYPES[name], n, rng), TYPES[name])
    return ja, port_array(ja)


@pytest.mark.parametrize("name", TYPES)
def test_type_names_and_equality_match_jax(name):
    jt = TYPES[name]
    t = port_type(jt)
    assert str(t) == str(jt)
    assert int(t.id) == int(jt.id)
    assert t == port_type(jt) and hash(t) == hash(port_type(jt))
    assert t.num_fields == jt.num_fields
    for f, jf_ in zip(t.fields(), jt.fields()):
        assert (f.name, str(f.type), f.nullable) == (
            jf_.name, str(jf_.type), jf_.nullable)
    if hasattr(jt, "offset_dtype"):
        assert t.offset_dtype == np.dtype(jt.offset_dtype)
    if jt.id == jdt.TypeId.MAP:
        assert str(t.value_field.type) == str(jt.value_field.type)
        assert not t.key_field.nullable


def test_factories_and_type_ids_match_jax():
    pairs = [(tdt.list_(tdt.int8), jdt.list_(jdt.int8)),
             (tdt.large_list(tdt.string), jdt.large_list(jdt.string)),
             (tdt.fixed_size_list(tdt.float32, 4),
              jdt.fixed_size_list(jdt.float32, 4)),
             (tdt.struct({"a": tdt.int64}), jdt.struct({"a": jdt.int64})),
             (tdt.map_(tdt.int32, tdt.string), jdt.map_(jdt.int32,
                                                        jdt.string))]
    for t, jt in pairs:
        assert str(t) == str(jt) and int(t.id) == int(jt.id)
        assert t.is_nested
    assert tdt.list_(tdt.int8) != tdt.list_(tdt.int16)
    assert tdt.fixed_size_list(tdt.int8, 2) != tdt.fixed_size_list(
        tdt.int8, 3)
    for name in ("LIST", "STRUCT", "MAP", "FIXED_SIZE_LIST", "LARGE_LIST"):
        assert int(getattr(tdt.TypeId, name)) == int(getattr(jdt.TypeId,
                                                             name))


@pytest.mark.parametrize("name", TYPES)
def test_host_arrays_carry_the_jax_values(name):
    ja, a = pair(name)
    same_array(a, ja)
    assert a.to_pylist() == ja.to_pylist() or name.count("double")
    # and back through the JAX builders
    same_array(port_array(jax_array(a)), ja)


@pytest.mark.parametrize("name", TYPES)
def test_take_host_vec_matches_jax(name):
    ja, a = pair(name)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(ja), 120).astype(np.int64)
    idx[rng.random(120) < 0.1] = -1
    same_array(tns.take_host_vec(a, idx), jns.take_host_vec(ja, idx))
    empty = np.zeros(0, np.int64)
    same_array(tns.take_host_vec(a, empty), jns.take_host_vec(ja, empty))


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_filter_indices_host_matches_jax(null_selection):
    rng = np.random.default_rng(5)
    m, v = rng.random(300) < 0.4, rng.random(300) < 0.9
    np.testing.assert_array_equal(
        tns.filter_indices_host(m, v, null_selection),
        jns.filter_indices_host(m, v, null_selection))


@pytest.mark.parametrize("name", TYPES)
@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_take_and_filter_of_nested_arrays_match_jax(name, null_selection):
    ja, a = pair(name, seed=1)
    rng = np.random.default_rng(8)
    n = len(ja)
    mvals, mvalid = rng.random(n) < 0.5, rng.random(n) > 0.1
    jm, tm = agt.from_numpy(mvals, mvalid), HostArray(mvals, mvalid,
                                                      tdt.bool_)
    same_array(pc.filter_(a, tm, pc.FilterOptions(null_selection)),
               jf.filter_(ja, jm, jf.FilterOptions(null_selection)))
    idx = rng.integers(0, n, 50).astype(np.int32)
    ivalid = rng.random(50) > 0.2
    same_array(pc.take(a, HostArray(idx, ivalid, tdt.int32)),
               jf.take(ja, agt.from_numpy(idx, ivalid)))


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_batches_with_nested_columns_select_like_jax(null_selection):
    """A HostBatch with nested and flat columns filters and takes on the
    host; a DeviceBatch carries them as HostColumns beside its device
    columns (the JAX package selects such a batch as a RecordBatch)."""
    names = ["list of struct", "map<utf8, int64>", "struct of list"]
    arrays = [pair(nm, n=90, seed=2) for nm in names]
    rng = np.random.default_rng(9)
    flat = rng.integers(-50, 50, 90).astype(np.int64)
    fmask = rng.random(90) > 0.1
    jrb = agt.record_batch({"l": arrays[0][0], "m": arrays[1][0],
                            "f": agt.from_numpy(flat, fmask),
                            "s": arrays[2][0]})
    thb = HostBatch.from_arrays({"l": arrays[0][1], "m": arrays[1][1],
                                 "f": HostArray(flat, fmask, tdt.int64),
                                 "s": arrays[2][1]})
    mvals, mvalid = rng.random(90) < 0.5, rng.random(90) > 0.1
    jm, tm = agt.from_numpy(mvals, mvalid), HostArray(mvals, mvalid,
                                                      tdt.bool_)
    opts = (jf.FilterOptions(null_selection),
            pc.FilterOptions(null_selection))
    want = jf.filter_(jrb, jm, opts[0])
    got = pc.filter_(thb, tm, opts[1])
    for i in range(4):
        same_array(got.column(i), want.column(i), jrb.schema.names[i])
    tdb = host_batch_to_device(thb, "cpu")
    assert isinstance(tdb.columns[0], HostColumn)
    assert not isinstance(tdb.columns[2], HostColumn)
    got = device_batch_to_host(pc.filter_(
        tdb, tagt.compute.functions.host_array_to_device(tm, "cpu",
                                                         tdb.padded),
        opts[1]))
    for i in range(4):
        same_array(got.column(i), want.column(i), jrb.schema.names[i])
    idx = rng.integers(0, 90, 40).astype(np.int64)
    ivalid = rng.random(40) > 0.2
    want = jf.take(jrb, agt.from_numpy(idx, ivalid))
    got = pc.take(thb, HostArray(idx, ivalid, tdt.int64))
    for i in range(4):
        same_array(got.column(i), want.column(i), jrb.schema.names[i])
    icol = tagt.compute.functions.host_array_to_device(
        HostArray(idx, ivalid, tdt.int64), "cpu")
    got = device_batch_to_host(pc.take(tdb, icol))
    for i in range(4):
        same_array(got.column(i), want.column(i), jrb.schema.names[i])


@pytest.mark.parametrize("name", TYPES)
def test_slice_and_concat_match_jax(name):
    ja, a = pair(name, n=60, seed=4)
    same_array(a.slice(7, 30), ja.slice(7, 30))
    same_array(a.slice(55, 30), ja.slice(55, 5))
    parts_j = [ja.slice(0, 13), ja.slice(13, 0), ja.slice(20, 40)]
    parts_t = [a.slice(0, 13), a.slice(13, 0), a.slice(20, 40)]
    same_array(concat_host_arrays(parts_t), concat_arrays(parts_j))


def test_host_batch_slice_and_batch_to_device_keep_nested_columns():
    ja, a = pair("list<list<int32>>", n=50)
    hb = HostBatch.from_arrays({"x": a, "y": HostArray(
        np.arange(50, dtype=np.int32), None, tdt.int32)})
    same_array(hb.slice(10, 20).column("x"), ja.slice(10, 20))
    db = tagt.batch_to_device({"x": a, "y": np.arange(50, dtype=np.int64)},
                              device="cpu")
    assert isinstance(db.columns[0], HostColumn) and db.length == 50
    assert db.padded == pad_length(50)
    same_array(device_batch_to_host(db).column("x"), ja)


def _jax_struct_args(rng, n):
    v = rng.integers(-9, 9, n).astype(np.int64)
    f = rng.standard_normal(n)
    m = rng.random(n) > 0.2
    jdb = jax_batch({"v": v, "f": f}, {"v": m})
    return jdb, port_batch(jdb)


@pytest.mark.parametrize("options", [None, ["a", "b", "c"],
                                     {"field_names": ["a", "b"],
                                      "field_nullability": [False, True]}])
def test_make_struct_matches_jax(options):
    rng = np.random.default_rng(6)
    jdb, tdb = _jax_struct_args(rng, 70)
    ja, a = pair("list<int64>", n=70)
    want = jf.make_struct(jdb.column("v"), ja, 7, options=options)
    got = pc.make_struct(tdb.column("v"), a, 7, options=options)
    same_array(got, want)
    assert [f.nullable for f in got.type.fields()] == [
        f.nullable for f in want.type.fields()]
    want = jf.make_struct(jdb.column("f"), "x", options=options)
    got = pc.make_struct(tdb.column("f"), "x", options=options)
    same_array(got, want)


def test_project_matches_jax():
    rng = np.random.default_rng(7)
    jdb, tdb = _jax_struct_args(rng, 64)
    jx = jexpr.project([jexpr.field("v"), jexpr.call(
        "add", [jexpr.field("v"), jexpr.literal(1)]), jexpr.field("f")],
        ["v", "v1", "f"])
    tx = texpr.project([texpr.field("v"), texpr.call(
        "add", [texpr.field("v"), texpr.literal(1)]), texpr.field("f")],
        ["v", "v1", "f"])
    same_array(texpr.execute_scalar_expression(tx, tdb),
               jexpr.execute_scalar_expression(jx, jdb))


@pytest.mark.parametrize("kind", ["int64", "uint32", "float64", "string",
                                  "bool", "no_null"])
def test_value_counts_matches_jax(kind):
    rng = np.random.default_rng(10)
    n = 500
    if kind == "string":
        v = np.array(WORDS, dtype=object)[rng.integers(0, 7, n)]
    elif kind == "bool":
        v = rng.random(n) < 0.3
    elif kind == "float64":
        v = rng.integers(0, 9, n) / 4.0
        v[:3] = [np.nan, -0.0, 0.0]
    else:
        v = rng.integers(0, 40, n).astype(
            np.uint32 if kind == "uint32" else np.int64)
        if kind == "uint32":
            v[:5] = 2 ** 32 - 1
    masks = {} if kind == "no_null" else {"v": rng.random(n) > 0.1}
    jdb = jax_batch({"v": v}, masks)
    want = jf.value_counts(jdb.column("v"))
    got = pc.value_counts(port_batch(jdb).column("v"))
    same_array(got, want)
    assert got.children[1].values.dtype == np.int64
    # a host array counts on the named device
    same_array(pc.value_counts(column_to_host(port_batch(jdb).column("v")),
                               device="cpu"), want)


LIST_CASTS = [
    ("list<int64>", jdt.large_list(jdt.int64)),
    ("list<int64>", jdt.list_(jdt.float64)),
    ("large_list<double>", jdt.list_(jdt.float64)),
    ("large_list<double>", jdt.large_list(jdt.float32)),
    ("fixed_size_list<int32>[3]", jdt.list_(jdt.int64)),
    ("fixed_size_list<int32>[3]", jdt.large_list(jdt.int32)),
    ("list<list<int32>>", jdt.large_list(jdt.list_(jdt.int64))),
    ("large_list<list<utf8>>", jdt.list_(jdt.list_(jdt.string))),
]


@pytest.mark.parametrize("name,to", LIST_CASTS)
def test_list_casts_match_jax(name, to):
    ja, a = pair(name, seed=5)
    want = jcast.cast_host(ja, to)
    got = pc.cast(a, port_type(to), device="cpu")
    same_array(got, want)
    assert jcast.can_cast(ja.type, to) == pc.can_cast(a.type, port_type(to))


def test_list_to_fixed_size_list_cast_matches_jax():
    rows = [[1, 2], None, [3, None], [5, 6]]
    ja = agt.array(rows, jdt.list_(jdt.int32))
    to = jdt.fixed_size_list(jdt.int64, 2)
    same_array(pc.cast(port_array(ja), port_type(to), device="cpu"),
               jcast.cast_host(ja, to))
    with pytest.raises(pc.ArrowInvalid):
        pc.cast(port_array(agt.array([[1, 2, 3]], jdt.list_(jdt.int32))),
                port_type(to), device="cpu")


def test_struct_cast_refuses_as_the_jax_one_does():
    ja, a = pair("struct<a: int32, b: utf8>")
    to = jdt.struct({"a": jdt.int64, "b": jdt.string})
    with pytest.raises(Exception):
        jf._exec_cast(ja, {"to_type": to})
    with pytest.raises(pc.ArrowNotImplemented):
        pc.cast(a, port_type(to), device="cpu")
    assert not pc.can_cast(a.type, port_type(to))


def test_registry_calls_the_nested_functions():
    rng = np.random.default_rng(12)
    jdb, tdb = _jax_struct_args(rng, 40)
    got = pc.call_function("make_struct", [tdb.column("v"), 3],
                           {"field_names": ["v", "k"]}, device="cpu")
    same_array(got, jpc.call_function("make_struct", [jdb.column("v"), 3],
                                      {"field_names": ["v", "k"]}))
    same_array(pc.call_function("value_counts", [tdb.column("v")],
                                device="cpu"),
               jpc.call_function("value_counts", [jdb.column("v")]))
    ja, a = pair("list<int64>")
    to = jdt.large_list(jdt.int32)
    same_array(pc.call_function("cast_large_list", [a],
                                {"to_type": port_type(to)}, device="cpu"),
               jpc.call_function("cast_large_list", [ja], {"to_type": to}))


# ---------------------------------------------------------------------------
# the device list column (list<flat> on the device; K2 fills, K1 filter)
# ---------------------------------------------------------------------------

def _list_values(rng, n, null_p=0.12):
    return [None if rng.random() < null_p else
            [int(x) for x in rng.integers(0, 1000, rng.integers(0, 6))]
            for _ in range(n)]


@pytest.mark.parametrize("child", ["int64", "float64", "int32_nulls"])
def test_device_list_column_take_and_filter_match_jax(child):
    import jax.numpy as jnp
    from arrow_go_tpu.ops import selection as jsel
    rng = np.random.default_rng(9)
    n = 3000
    vals = _list_values(rng, n)
    if child == "float64":
        vals = [None if v is None else [x / 7 for x in v] for v in vals]
        jt = jdt.list_(jdt.float64)
    elif child == "int32_nulls":
        vals = [None if v is None else [None if x % 5 == 0 else x
                                        for x in v] for v in vals]
        jt = jdt.list_(jdt.int32)
    else:
        jt = jdt.list_(jdt.int64)
    ja = agt.array(vals, jt)
    jcol = jlist_to_device(ja)
    col = tagt.list_to_device(port_array(ja), device="cpu")
    assert col.padded == jcol.padded and col.null_count == jcol.null_count
    np.testing.assert_array_equal(col.offsets.numpy(),
                                  np.asarray(jcol.offsets))
    same_array(tagt.list_from_device(col), jlist_from_device(jcol))
    idx_host = [None if rng.random() < 0.05 else int(rng.integers(0, n))
                for _ in range(1500)]
    P_out = pad_length(len(idx_host))
    idx = np.full(P_out, -1, np.int32)
    idx[:len(idx_host)] = [-1 if i is None else i for i in idx_host]
    jout = jlist_take_device(jcol, jnp.asarray(idx), len(idx_host))
    out = tagt.list_take_device(col, torch.from_numpy(idx), len(idx_host))
    np.testing.assert_array_equal(out.offsets.numpy(),
                                  np.asarray(jout.offsets))
    np.testing.assert_array_equal(out.validity.numpy().view(np.uint32),
                                  np.asarray(jout.validity))
    assert out.child.padded == jout.child.padded
    same_array(tagt.list_from_device(out), jlist_from_device(jout))
    assert tagt.list_from_device(out).to_pylist() == [
        None if i is None else vals[i] for i in idx_host]
    # the filter: a mask -> indices (K1) -> the list take
    mask = rng.random(n) < 0.5
    m = jnp.zeros(jcol.padded, jnp.bool_).at[:n].set(jnp.asarray(mask))
    jidx, jcnt = jsel.filter_indices(m, None, n)
    jout = jlist_take_device(jcol, jidx.astype(jnp.int32), int(jcnt))
    tm = torch.zeros(col.padded, dtype=torch.bool)
    tm[:n] = torch.from_numpy(mask)
    out = pc.filter_(col, tagt.DeviceColumn(tm, None, n, tdt.bool_))
    same_array(tagt.list_from_device(out), jlist_from_device(jout))
    np.testing.assert_array_equal(out.offsets.numpy(),
                                  np.asarray(jout.offsets))


def test_device_list_column_of_a_sliced_array_rebases_its_offsets():
    ja = agt.array(_list_values(np.random.default_rng(2), 200),
                   jdt.large_list(jdt.int64)).slice(37, 100)
    col = tagt.list_to_device(port_array(ja), device="cpu")
    jcol = jlist_to_device(ja)
    np.testing.assert_array_equal(col.offsets.numpy(),
                                  np.asarray(jcol.offsets))
    same_array(tagt.list_from_device(col), jlist_from_device(jcol))


def test_device_list_take_by_a_device_column_checks_bounds():
    ja = agt.array([[1, 2], None, [3]], jdt.list_(jdt.int64))
    col = tagt.list_to_device(port_array(ja), device="cpu")
    idx = tagt.batch_to_device({"i": np.array([2, 0, 0])},
                               device="cpu").column("i")
    out = pc.take(col, idx)
    assert tagt.list_from_device(out).to_pylist() == [[3], [1, 2], [1, 2]]
    bad = tagt.batch_to_device({"i": np.array([3])}, device="cpu")
    with pytest.raises(pc.ArrowIndexError):
        pc.take(col, bad.column("i"))


# the device route joins the inner and outer types
@pytest.mark.parametrize("how,route", [
    (how, route) for how in ("inner", "left outer", "full outer",
                             "left semi", "right anti")
    for route in ("host", "device")
    if route == "host" or how in ("inner", "left outer", "full outer")])
def test_joins_carry_nested_columns_like_jax(how, route):
    """Carried nested columns gather on the host through the pair
    indices, on the HostBatch route and beside a DeviceBatch's device
    columns (as HostColumns), as the JAX package's join gathers them."""
    rng = np.random.default_rng(13)
    jl, tl = pair("list of struct", n=60, seed=3)
    jr, tr = pair("map<utf8, int64>", n=40, seed=4)
    lk = rng.integers(0, 25, 60).astype(np.int64)
    rk = rng.integers(0, 25, 40).astype(np.int64)
    lmask = rng.random(60) > 0.1
    jleft = agt.record_batch({"k": agt.from_numpy(lk, lmask), "l": jl})
    jright = agt.record_batch({"k": agt.from_numpy(rk), "m": jr})
    tleft = HostBatch.from_arrays({"k": HostArray(lk, lmask, tdt.int64),
                                   "l": tl})
    tright = HostBatch.from_arrays({"k": HostArray(rk, None, tdt.int64),
                                    "m": tr})
    want = jpc.hash_join(jleft, jright, "k", join_type=how)
    if route == "host":
        got = pc.hash_join(tleft, tright, "k", join_type=how,
                           device="cpu")
    else:
        got = device_batch_to_host(pc.hash_join(
            host_batch_to_device(tleft, "cpu"),
            host_batch_to_device(tright, "cpu"), "k", join_type=how))
    assert got.schema.names == want.schema.names
    for i, name in enumerate(want.schema.names):
        same_array(got.column(i), want.column(i), name)
