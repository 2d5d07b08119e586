"""The JAX package's remaining types in the port, against the JAX
package on the CPU: the null column, the three intervals, large_string,
large_binary, string_view, binary_view, list_view, large_list_view, the
sparse and dense unions and extension columns.

The same seeded values go to both packages: the JAX package builds its
host Array, and `torch_parity.port_array` carries it into the port's
HostArray. Values, validity, offsets, sizes and type codes must match
exactly (`torch_parity.same_array`), on each route of filter and take
(the device route of a flat type runs the kernels' plain versions
here). Each difference from the JAX package is a named deviation with
its test here (ROADMAP §3).
"""
import importlib

import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import extensions as jext
from arrow_go_tpu.array.arrays import ArrayData, make_array
from arrow_go_tpu.array.concat import concat_arrays
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import registry as jreg
from arrow_go_tpu.compute import scalars as jsc
from arrow_go_tpu.device.block import from_device, to_device
from arrow_go_tpu.memory.buffer import Buffer

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import extensions as text
from arrow_go_tpu_torch.compute import registry
from arrow_go_tpu_torch.compute.cast import cast_host
from arrow_go_tpu_torch.device.block import (
    DeviceColumn, HostArray, HostBatch, HostColumn, column_to_host,
    concat_host_arrays, device_batch_to_host, host_array_to_device,
    host_batch_to_device)
from torch_parity import (jax_type, port_array, port_type, same_array,
                          words_u32)

jcast = importlib.import_module("arrow_go_tpu.compute.cast")

CPU = torch.device("cpu")
N = 40
BIG = 4200                 # past the JAX package's 4096-row host take
WORDS = ["MAIL", "SHIP", "AIR", "", "TRUCK", "a-long-value-past-12-bytes",
         "REG AIR"]

# the JAX package's module-level types (arrow_go_tpu/dtypes.py:834-857)
SINGLETONS = ["null", "bool_", "int8", "int16", "int32", "int64", "uint8",
              "uint16", "uint32", "uint64", "float16", "float32",
              "float64", "string", "binary", "large_string",
              "large_binary", "string_view", "binary_view", "date32",
              "date64", "month_interval", "day_time_interval",
              "month_day_nano_interval"]


def _union_fields(m):
    return [m.Field("i", m.int64), m.Field("s", m.string)]


# the factories and the classes without one, in both packages
PARAMETRIZED = {
    "list_view": (lambda: jdt.ListViewType(jdt.int32),
                  lambda: dt.list_view(dt.int32)),
    "large_list_view": (lambda: jdt.LargeListViewType(jdt.string),
                        lambda: dt.large_list_view(dt.string)),
    "sparse_union": (lambda: jdt.sparse_union(_union_fields(jdt), [5, 7]),
                     lambda: dt.sparse_union(_union_fields(dt), [5, 7])),
    "dense_union": (lambda: jdt.dense_union(_union_fields(jdt)),
                    lambda: dt.dense_union(_union_fields(dt))),
    "extension": (lambda: jdt.ExtensionType(jdt.int16, "x.y", b"ab"),
                  lambda: dt.ExtensionType(dt.int16, "x.y", b"ab")),
}


@pytest.mark.parametrize("name", SINGLETONS)
def test_every_jax_singleton_type_matches(name):
    jt, t = getattr(jdt, name), getattr(dt, name)
    assert int(t.id) == int(jt.id) and t.name == jt.name
    assert str(t) == str(jt) and t.bit_width == jt.bit_width
    # (the port's bool has numpy's bool dtype; the JAX package's none)
    assert t.np_dtype == (jt.np_dtype if name != "bool_" else np.bool_)
    assert getattr(t, "offset_dtype", None) == getattr(jt, "offset_dtype",
                                                       None)
    for p in ("is_binary_like", "is_temporal", "is_nested", "is_integer",
              "is_floating", "is_numeric", "is_decimal"):
        assert getattr(t, p) == getattr(jt, p), p
    assert t.on_device == jf._device_selectable(jt)
    assert dt.type_for_name(str(jt)) == t and jax_type(t) == jt


@pytest.mark.parametrize("name", list(PARAMETRIZED))
def test_the_nested_union_and_extension_types_match(name):
    make_j, make_t = PARAMETRIZED[name]
    jt, t = make_j(), make_t()
    assert int(t.id) == int(jt.id) and t.name == jt.name
    assert str(t) == str(jt) and t.bit_width == jt.bit_width
    assert t.np_dtype == jt.np_dtype and t.is_nested == jt.is_nested
    assert t.on_device == jf._device_selectable(jt)
    assert [str(f.type) for f in t.fields()] == [
        str(f.type) for f in jt.fields()]
    assert port_type(jt) == t and jax_type(t) == jt and t == make_t()
    if name.endswith("list_view"):
        assert t.offset_dtype == jt.offset_dtype
    if name.endswith("union"):
        assert t.type_codes == jt.type_codes
        assert [t.child_id(c) for c in t.type_codes] == [
            jt.child_id(c) for c in jt.type_codes]
        assert t != type(t)(t.fields(), [1, 2])
    if name == "extension":
        assert (t.storage_type, t.extension_name, t.serialized) == (
            dt.int16, "x.y", b"ab")
        assert t != dt.ExtensionType(dt.int16, "x.y")


# ---------------------------------------------------------------------------
# the cases: a JAX host Array of each type, with nulls, from a seed
# ---------------------------------------------------------------------------

def _maybe(rng, v, p=0.2):
    return None if rng.random() < p else v


def _union(t, n, rng):
    """A JAX union of n rows over (int64, utf8) children with nulls in
    each; a dense one's children sized by its type codes."""
    codes = np.array(t.type_codes, np.int8)
    tids = codes[rng.integers(0, 2, n)]
    if t.id == jdt.TypeId.SPARSE_UNION:
        kids = [agt.array([_maybe(rng, int(x)) for x in rng.integers(
            -99, 99, n)], jdt.int64),
            agt.array([_maybe(rng, WORDS[x]) for x in rng.integers(
                0, len(WORDS), n)], jdt.string)]
        return make_array(ArrayData(t, n, [Buffer.wrap(tids)],
                                    [k.data for k in kids]))
    which = (tids == codes[1]).astype(np.int64)
    offs = np.zeros(n, np.int32)
    for k in (0, 1):
        offs[which == k] = np.arange((which == k).sum())
    kids = [agt.array([_maybe(rng, int(x)) for x in rng.integers(
        -99, 99, int((which == 0).sum()) + 2)], jdt.int64),
        agt.array([_maybe(rng, WORDS[x]) for x in rng.integers(
            0, len(WORDS), int((which == 1).sum()))], jdt.string)]
    return make_array(ArrayData(t, n, [Buffer.wrap(tids),
                                       Buffer.wrap(offs)],
                                [k.data for k in kids]))


def _extension(ext, storage):
    d = storage.data
    return make_array(ArrayData(ext, len(storage), d.buffers, d.children,
                                d.dictionary, None, d.offset))


def jax_case(name: str, n: int = N, seed: int = 3):
    rng = np.random.default_rng(seed)
    ints = [int(x) for x in rng.integers(-500, 500, 3 * n)]
    words = [WORDS[x] for x in rng.integers(0, len(WORDS), n)]
    if name == "null":
        return agt.array([None] * n, jdt.null)
    if name == "month_interval":
        return agt.array([_maybe(rng, v) for v in ints[:n]], jdt.month_interval)
    if name == "day_time_interval":
        return agt.array([_maybe(rng, (ints[i], ints[n + i]))
                          for i in range(n)], jdt.day_time_interval)
    if name == "month_day_nano_interval":
        return agt.array([_maybe(rng, (ints[i], ints[n + i],
                                       ints[2 * n + i] * 10**9))
                          for i in range(n)], jdt.month_day_nano_interval)
    if name in ("large_string", "string_view"):
        return agt.array([_maybe(rng, w) for w in words],
                         getattr(jdt, name))
    if name in ("large_binary", "binary_view"):
        return agt.array([_maybe(rng, w.encode()) for w in words],
                         getattr(jdt, name))
    if name == "list_view<int32>":
        return agt.array([_maybe(rng, [_maybe(rng, int(x)) for x in
                                       rng.integers(-9, 9, rng.integers(
                                           0, 4))]) for _ in range(n)],
                         jdt.ListViewType(jdt.int32))
    if name == "large_list_view<utf8>":
        return agt.array([_maybe(rng, [_maybe(rng, WORDS[x]) for x in
                                       rng.integers(0, 7, rng.integers(
                                           0, 4))]) for _ in range(n)],
                         jdt.LargeListViewType(jdt.string))
    if name in ("sparse_union", "dense_union"):
        return _union(PARAMETRIZED[name][0](), n, rng)
    if name == "bool8":
        return _extension(jext.Bool8Type(), agt.array(
            [_maybe(rng, x % 2) for x in ints[:n]], jdt.int8))
    if name == "uuid":
        return _extension(jext.UuidType(), agt.array(
            [_maybe(rng, rng.bytes(16)) for _ in range(n)],
            jdt.fixed_size_binary(16)))
    if name == "json":
        return _extension(jext.JsonType(), agt.array(
            [_maybe(rng, f'{{"k": {x}}}') for x in ints[:n]], jdt.string))
    raise KeyError(name)


CASES = ["null", "month_interval", "day_time_interval",
         "month_day_nano_interval", "large_string", "large_binary",
         "string_view", "binary_view", "list_view<int32>",
         "large_list_view<utf8>", "sparse_union", "dense_union", "bool8",
         "uuid", "json"]
# the JAX device route of a bool8 fails (ExtensionArray has no `values`,
# arrow_go_tpu/device/block.py:506): test_bool8_on_the_device_route_is_a_
# recorded_deviation holds it
JAX_DEVICE_FAILS = {"bool8"}
HOST_ROUTE = {"day_time_interval", "month_day_nano_interval",
              "list_view<int32>", "large_list_view<utf8>", "sparse_union",
              "dense_union", "uuid", "json"}


@pytest.mark.parametrize("name", CASES)
def test_host_columns_carry_the_jax_values(name):
    ja = jax_case(name)
    a = port_array(ja)
    same_array(a, ja, name)
    assert a.to_pylist() == ja.to_pylist()
    assert a.type.on_device == (name not in HOST_ROUTE)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("lo,n", [(0, N), (3, 11), (N - 2, 5), (7, 0)])
def test_slices_match_jax(name, lo, n):
    ja = jax_case(name)
    same_array(port_array(ja).slice(lo, n), ja.slice(lo, min(n, N - lo)),
               name)


@pytest.mark.parametrize("name", CASES)
def test_concat_matches_jax(name):
    ja, jb = jax_case(name), jax_case(name, 17, seed=4)
    parts = [port_array(ja), port_array(jb).slice(3, 9)]
    if name.endswith("union") or name in ("bool8", "uuid", "json"):
        # the JAX package has no builder for them (array/concat.py:128)
        with pytest.raises(NotImplementedError):
            concat_arrays([ja, jb.slice(3, 9)])
        with pytest.raises(pc.ArrowNotImplemented):
            concat_host_arrays(parts)
        return
    same_array(concat_host_arrays(parts), concat_arrays([ja, jb.slice(3,
                                                                      9)]),
               name)


def _mask(n, seed=5, nulls=True):
    rng = np.random.default_rng(seed)
    vals = rng.random(n) < 0.6
    ok = rng.random(n) < 0.85 if nulls else np.ones(n, np.bool_)
    return (agt.array([bool(v) if o else None for v, o in zip(vals, ok)],
                      jdt.bool_),
            HostArray(vals, None if ok.all() else ok, dt.bool_))


def _indices(n_src, n, seed=6):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_src, n)
    ok = rng.random(n) < 0.9
    return (agt.array([int(i) if o else None for i, o in zip(idx, ok)],
                      jdt.int64), HostArray(idx, ok, dt.int64))


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
@pytest.mark.parametrize("name", sorted(set(CASES) - JAX_DEVICE_FAILS))
def test_filter_matches_jax(name, null_selection):
    ja = jax_case(name)
    jm, tm = _mask(N)
    want = jf.filter_(ja, jm, jf.FilterOptions(null_selection))
    got = pc.filter(port_array(ja), tm, pc.FilterOptions(null_selection),
                    device="cpu")
    same_array(got, want, name)


@pytest.mark.parametrize("n", [N, BIG], ids=["host_take", "device_take"])
@pytest.mark.parametrize("name", sorted(set(CASES) - JAX_DEVICE_FAILS))
def test_take_matches_jax(name, n):
    ja = jax_case(name, n)
    ji, ti = _indices(n, n + 7)
    same_array(pc.take(port_array(ja), ti, device="cpu"), jf.take(ja, ji),
               name)


@pytest.mark.parametrize("name", ["large_string", "large_binary",
                                  "string_view", "binary_view"])
def test_binary_like_results_are_dictionary_coded_on_every_route(name):
    """The JAX routes: its filter and its take of more than 4096 rows go
    through the device and give a DictionaryArray, its small take stays
    on the host and gives the plain type. The port's results have the
    JAX class and type on each route, over its one coded storage."""
    jt = getattr(jdt, name)
    for n, route in ((N, "small take"), (BIG, "large take"),
                     (N, "filter")):
        ja = jax_case(name, n)
        if route == "filter":
            jm, tm = _mask(n)
            want = jf.filter_(ja, jm)
            got = pc.filter(port_array(ja), tm, device="cpu")
        else:
            ji, ti = _indices(n, 50)
            want = jf.take(ja, ji)
            got = pc.take(port_array(ja), ti, device="cpu")
        expect = jt if route == "small take" else jdt.dictionary(
            jdt.int32, jt)
        assert want.type == expect, route
        assert type(got).__name__ == type(want).__name__, route
        same_array(got, want, f"{name} {route}")


def test_month_interval_and_null_keep_their_types_on_every_route():
    for name, t in (("month_interval", dt.month_interval),
                    ("null", dt.null)):
        for n in (N, BIG):
            ja = jax_case(name, n)
            ji, ti = _indices(n, 30)
            jm, tm = _mask(n)
            for want, got in ((jf.take(ja, ji),
                               pc.take(port_array(ja), ti, device="cpu")),
                              (jf.filter_(ja, jm),
                               pc.filter(port_array(ja), tm, device="cpu"))):
                assert str(want.type) == str(t) and got.type == t
                same_array(got, want, name)


def test_dense_union_null_take_appends_one_null_row_to_child_zero():
    ja = jax_case("dense_union", 12, seed=8)
    ji, ti = _indices(12, 9, seed=9)
    want = jf.take(ja, ji)
    got = pc.take(port_array(ja), ti, device="cpu")
    same_array(got, want, "dense_union")
    n0 = len(make_array(ja.data.children[0]))
    assert len(got.children[0]) == n0 + 1
    assert len(got.children[1]) == len(make_array(ja.data.children[1]))
    nulls = ~ti.validity_bools()
    assert nulls.any()
    assert (got.type_ids[nulls] == got.type.type_codes[0]).all()
    assert (got.value_offsets[nulls] == n0).all()
    assert not got.validity_bools()[nulls].any()


def test_union_validity_is_the_childs_a_recorded_deviation():
    """The JAX UnionArray's `validity_bools` (and `null_count`) read its
    type-code buffer as a validity bitmap (arrow_go_tpu/array/arrays.py:
    97-104 over buffers[0], the type ids); its `is_valid` and
    `to_pylist` read the child's validity (:445-452). The port's
    `validity_bools` is the child's, as `is_valid` (deviation)."""
    for name in ("sparse_union", "dense_union"):
        ja = jax_case(name, 64, seed=10)
        rows = np.array([ja.is_valid(i) for i in range(len(ja))])
        assert not np.array_equal(ja.validity_bools(), rows)
        np.testing.assert_array_equal(port_array(ja).validity_bools(), rows)
        assert [v is None for v in port_array(ja).to_pylist()] == list(
            ~rows)


def test_bool8_on_the_device_route_is_a_recorded_deviation():
    """A bool8 (int8 storage) is device-selectable in both packages. The
    JAX device route reads `arr.values`, which an ExtensionArray lacks,
    so its filter and its take past 4096 rows raise AttributeError; its
    small host take works on the storage. The port filters and takes
    it on the device as its int8 storage and keeps the extension type
    (deviation)."""
    ja = jax_case("bool8")
    jm, tm = _mask(N)
    with pytest.raises(AttributeError):
        jf.filter_(ja, jm)
    got = pc.filter(port_array(ja), tm, device="cpu")
    assert str(got.type) == str(ja.type)
    same_array(got.storage, jf.filter_(ja.storage, jm), "bool8 filter")
    big = jax_case("bool8", BIG)
    ji, ti = _indices(BIG, 30)
    with pytest.raises(AttributeError):
        jf.take(big, ji)
    got = pc.take(port_array(big), ti, device="cpu")
    same_array(got.storage, jf.take(big.storage, ji), "bool8 take")
    ji, ti = _indices(N, 30)
    same_array(pc.take(port_array(ja), ti, device="cpu"), jf.take(ja, ji),
               "bool8 small take")


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_batches_route_by_their_columns_like_jax(null_selection):
    """A batch of device-carried columns (null, month_interval, large
    and view strings) filters and takes through the device (K1's plain
    version here); one with a host column (an interval, a union, a list
    view) on the host, as the JAX package routes a RecordBatch."""
    opts = null_selection
    for names in (["null", "month_interval", "large_string",
                   "binary_view"],
                  ["month_interval", "day_time_interval", "dense_union",
                   "list_view<int32>", "string_view"]):
        jcols = {k: jax_case(k, N, seed=i) for i, k in enumerate(names)}
        rb = agt.record_batch(jcols)
        hb = HostBatch.from_arrays({k: port_array(v)
                                    for k, v in jcols.items()})
        jm, tm = _mask(N)
        want = jf.filter_(rb, jm, jf.FilterOptions(opts))
        got = pc.filter(hb, tm, pc.FilterOptions(opts), device="cpu")
        ji, ti = _indices(N, 23)
        want_t = jf.take(rb, ji)
        got_t = pc.take(hb, ti, device="cpu")
        for k in names:
            same_array(got.column(k), want.column(k), f"filter {k}")
            same_array(got_t.column(k), want_t.column(k), f"take {k}")


def test_device_batch_carries_host_columns_of_the_new_types():
    """A DeviceBatch of a HostBatch: null, month_interval, large/view
    codes and bool8 as DeviceColumns, the others as HostColumns; its
    filter (K1 for the device columns) and take give the host route's
    rows."""
    names = ["null", "month_interval", "large_string", "string_view",
             "bool8", "day_time_interval", "sparse_union",
             "large_list_view<utf8>", "uuid"]
    hb = HostBatch.from_arrays({k: port_array(jax_case(k, N, seed=i))
                                for i, k in enumerate(names)})
    db = host_batch_to_device(hb, CPU)
    kinds = {k: type(c).__name__ for k, c in zip(names, db.columns)}
    assert kinds == {k: "HostColumn" if k in HOST_ROUTE else "DeviceColumn"
                     for k in names}
    _, tm = _mask(N)
    mcol = host_array_to_device(tm, CPU, db.padded)
    got = device_batch_to_host(pc.filter(db, mcol))
    want = pc.filter(hb, tm, device="cpu")
    idx = HostArray(np.arange(N)[::-3].copy(), None, dt.int64)
    got_t = device_batch_to_host(pc.take(db, host_array_to_device(idx, CPU)))
    want_t = pc.take(hb, idx, device="cpu")
    for k in names:
        assert got.column(k).to_pylist() == want.column(k).to_pylist(), k
        assert got_t.column(k).to_pylist() == want_t.column(k).to_pylist(), k
        assert str(got.column(k).type) == str(want.column(k).type), k


@pytest.mark.parametrize("name", ["null", "month_interval", "large_string",
                                  "large_binary", "string_view",
                                  "binary_view"])
def test_device_columns_match_the_jax_to_device(name):
    """to_device / from_device of the JAX package: a null column as int8
    zeros with all-false words, month_interval as int32 values, the
    large and view types as dictionary(int32, T) codes."""
    ja = jax_case(name, 300)
    jc = to_device(ja)
    col = host_array_to_device(port_array(ja), CPU)
    assert col.type.id == jc.type.id
    assert str(getattr(col.type, "value_type", col.type)) == str(
        getattr(jc.type, "value_type", jc.type))
    assert col.values.dtype == {"null": torch.int8,
                                "month_interval": torch.int32}.get(
                                    name, torch.int32)
    np.testing.assert_array_equal(words_u32(col.validity),
                                  np.asarray(jc.validity))
    # (a string code under a null is either package's own choice)
    ok = col.validity_mask().numpy() if jc.dictionary is not None else \
        np.ones(col.padded, np.bool_)
    np.testing.assert_array_equal(col.values.numpy()[ok],
                                  np.asarray(jc.values)[ok])
    if jc.dictionary is not None:
        assert list(col.dict_values) == jc.dictionary.to_pylist()
    same_array(column_to_host(col), from_device(jc), name)


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------

BINARY_LIKE = ["string", "large_string", "string_view", "binary",
               "large_binary", "binary_view"]


@pytest.mark.parametrize("to", BINARY_LIKE)
@pytest.mark.parametrize("frm", BINARY_LIKE)
def test_binary_like_casts_match_jax(frm, to):
    words = [None, "a", "", "a-long-value-past-12-bytes", "a", "été"]
    ja = jcast.cast_host(agt.array(words, jdt.string), getattr(jdt, frm))
    a = port_array(ja)
    same_array(cast_host(a, getattr(dt, to)),
               jcast.cast_host(ja, getattr(jdt, to)), f"{frm} -> {to}")
    got = pc.call_function("cast", [a], {"to_type": getattr(dt, to)},
                           device="cpu")
    same_array(got, jreg.call_function("cast", [ja], {
        "to_type": getattr(jdt, to)}), f"{frm} -> {to}")


@pytest.mark.parametrize("to", ["string", "large_string", "string_view"])
def test_invalid_utf8_raises_like_jax(to):
    ja = agt.array([b"\xff\xfe", None], jdt.binary_view)
    with pytest.raises(UnicodeDecodeError):
        jcast.cast_host(ja, getattr(jdt, to)).to_pylist()
    with pytest.raises(UnicodeDecodeError):
        cast_host(port_array(ja), getattr(dt, to))


@pytest.mark.parametrize("frm,to,vals", [
    ("int64", "large_string", [3, None, -7]),
    ("double", "string_view", [1.5, None, 2.0]),
    ("large_string", "int64", ["12", None, "-3"]),
    ("string_view", "double", ["1.5", None, "nan"]),
    ("binary_view", "int32", [b"7", None, b"8"]),
    ("large_binary", "bool", [b"true", None, b"0"]),
    ("month_interval", "int32", [4, None, -1]),
    ("int32", "month_interval", [4, None, -1])])
def test_casts_to_and_from_the_new_types_match_jax(frm, to, vals):
    jt, t = dt.type_for_name(to), dt.type_for_name(frm)
    ja = agt.array(vals, jax_type(t))
    want = jreg.call_function("cast", [ja], {"to_type": jax_type(jt)})
    got = pc.call_function("cast", [port_array(ja)], {"to_type": jt},
                           device="cpu")
    same_array(got, want, f"{frm} -> {to}")


LIST_KINDS = {
    "list<int32>": lambda m: m.list_(m.int32),
    "large_list<int64>": lambda m: m.large_list(m.int64),
    "list_view<int32>": lambda m: (m.ListViewType if m is jdt
                                   else m.list_view)(m.int32),
    "large_list_view<double>": lambda m: (m.LargeListViewType if m is jdt
                                          else m.large_list_view)(
                                              m.float64),
    "fixed_size_list<int32>[2]": lambda m: m.fixed_size_list(m.int32, 2),
}


@pytest.mark.parametrize("to", list(LIST_KINDS))
@pytest.mark.parametrize("frm", list(LIST_KINDS))
def test_list_kind_casts_match_jax(frm, to):
    rows = [[1, 2], None, [3, None], [4, 5], [None, 6]]
    if not frm.startswith("fixed"):
        rows += [[], [7]]
    ja = agt.array(rows, LIST_KINDS[frm](jdt))
    jt, t = LIST_KINDS[to](jdt), LIST_KINDS[to](dt)
    a = port_array(ja)
    if to.startswith("fixed") and not frm.startswith("fixed"):
        with pytest.raises(ValueError):
            jcast.cast_host(ja, jt)
        with pytest.raises(ValueError):
            cast_host(a, t)
        return
    same_array(cast_host(a, t), jcast.cast_host(ja, jt), f"{frm} -> {to}")


def test_a_cast_of_a_large_column_works_on_its_dictionary():
    """A cast among the binary-like types re-types the dictionary and
    keeps the codes, whatever the column's length."""
    n = 2_000_000
    codes = np.random.default_rng(1).integers(0, 7, n).astype(np.int32)
    a = HostArray(codes, None, dt.string, np.array(WORDS, dtype=object))
    for to in (dt.string_view, dt.large_binary, dt.large_string):
        got = pc.call_function("cast_" + {"string_view": "string_view",
                                          "large_binary": "large_binary",
                                          "large_utf8": "large_string"}[
                                              to.name], [a], device="cpu")
        assert got.values is a.values and got.type == to
        assert got.dict_values[5] == (WORDS[5] if to.is_utf8
                                      else WORDS[5].encode())


NEW_CAST_NAMES = ["cast_binary_view", "cast_large_binary",
                  "cast_large_string", "cast_string_view"]


@pytest.mark.parametrize("name", NEW_CAST_NAMES)
@pytest.mark.parametrize("arg", ["int", "str", "device"])
def test_the_new_cast_names_match_jax_on_every_route(name, arg):
    ji = agt.array([1, None, 3], jdt.int64)
    js = agt.array(["x", None, "yz"], jdt.string)
    ja = {"int": ji, "str": js, "device": to_device(ji)}[arg]
    ta = host_array_to_device(port_array(ji), CPU) if arg == "device" \
        else port_array(ja)
    same_array(registry.call_function(name, [ta], device="cpu"),
               jreg.call_function(name, [ja]), name)


@pytest.mark.parametrize("name,to", [
    ("cast_dictionary", lambda m: m.dictionary(m.int32, m.int64)),
    ("cast_extension", lambda m: m.ExtensionType(m.int8, "arrow.bool8")),
    ("cast_fixed_sized_binary", lambda m: m.fixed_size_binary(8)),
    ("cast_month_day_nano_interval", lambda m: None)])
@pytest.mark.parametrize("arg", ["int", "str"])
def test_the_refused_cast_names_refuse_like_jax(name, to, arg):
    """The JAX package refuses these casts from an int64 or a string
    column (ArrowNotImplemented; its month_day_nano_interval cast from
    an int64 fails in jnp with TypeError). The port refuses each with
    ArrowNotImplemented."""
    ja = agt.array([1, None], jdt.int64) if arg == "int" else agt.array(
        ["1", None], jdt.string)
    jo = None if to(jdt) is None else {"to_type": to(jdt)}
    to_opts = None if to(dt) is None else {"to_type": to(dt)}
    with pytest.raises((NotImplementedError, TypeError)):
        jreg.call_function(name, [ja], jo)
    with pytest.raises(pc.ArrowNotImplemented):
        registry.call_function(name, [port_array(ja)], to_opts,
                               device="cpu")


# ---------------------------------------------------------------------------
# scalars
# ---------------------------------------------------------------------------

SCALARS = [(3, "month_interval"), ((1, -2), "day_time_interval"),
           ((1, 2, 3_000_000_000), "month_day_nano_interval"),
           ("x-long-value-past-12-bytes", "large_string"),
           ("y", "string_view"), (b"z", "binary_view"),
           (b"w", "large_binary")]


@pytest.mark.parametrize("v,tname", SCALARS, ids=repr)
def test_scalars_of_the_new_types_broadcast_like_jax(v, tname):
    t = dt.type_for_name(tname)
    for value in (v, None):
        same_array(pc.make_array_from_scalar(pc.scalar(value, t), 5),
                   jsc.make_array_from_scalar(jsc.Scalar(value,
                                                         jax_type(t)), 5),
                   repr((value, tname)))
    for jt, t in ((jdt.ListViewType(jdt.int32), dt.list_view(dt.int32)),
                  (jdt.LargeListViewType(jdt.string),
                   dt.large_list_view(dt.string))):
        value = [1, None, 2] if t.value_type == dt.int32 else ["a", None]
        for x in (value, None):
            same_array(pc.make_array_from_scalar(pc.scalar(x, t), 3),
                       jsc.make_array_from_scalar(jsc.Scalar(x, jt), 3),
                       str(t))


@pytest.mark.parametrize("name", ["sparse_union", "dense_union",
                                  "extension"])
def test_union_and_extension_scalars_refuse_like_jax(name):
    jt, t = PARAMETRIZED[name][0](), PARAMETRIZED[name][1]()
    with pytest.raises(NotImplementedError):
        jsc.make_array_from_scalar(jsc.Scalar(1, jt), 2)
    with pytest.raises(pc.ArrowNotImplemented):
        pc.make_array_from_scalar(pc.scalar(1, t), 2)


def test_an_empty_take_of_each_new_type_matches_jax():
    for name in CASES:
        ja = jax_case(name).slice(0, 0)
        ji, ti = (agt.array([], jdt.int64),
                  HostArray(np.zeros(0, np.int64), None, dt.int64))
        if name.endswith("union") or name in ("bool8", "uuid", "json"):
            with pytest.raises(NotImplementedError):
                jf.take(ja, ji)
            with pytest.raises(pc.ArrowNotImplemented):
                pc.take(port_array(ja), ti, device="cpu")
            continue
        same_array(pc.take(port_array(ja), ti, device="cpu"),
                   jf.take(ja, ji), name)


def test_the_null_column_is_a_length():
    a = pc.make_array_from_scalar(pc.scalar(None), 4)
    assert a.type == dt.null and len(a) == 4 and a.values is None
    assert not a.validity_bools().any() and a.to_pylist() == [None] * 4
    col = host_array_to_device(a, CPU)
    assert isinstance(col, DeviceColumn) and col.values.dtype == torch.int8
    assert column_to_host(col).type == dt.null
    assert isinstance(HostColumn(a).array, HostArray)


def test_dictionary_type_names_match_jax():
    """The repaired dictionary type: its str() names `ordered` as the JAX
    package's does, and equality reads the flag."""
    for vt in ("utf8", "int16", "large_utf8", "string_view"):
        t = dt.dictionary(dt.int32, dt.type_for_name(vt))
        jt = jdt.dictionary(jdt.int32, jax_type(dt.type_for_name(vt)))
        assert str(t) == str(jt)
        assert str(dt.dictionary(dt.int8, t.value_type, True)) == str(
            jdt.dictionary(jdt.int8, jt.value_type, True))
        assert t != dt.dictionary(dt.int32, t.value_type, True)
