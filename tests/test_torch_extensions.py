"""The port's extension types (arrow_go_tpu_torch/extensions.py) against
the JAX package's (arrow_go_tpu/extensions.py), on the CPU: the
registry, the five canonical types (uuid, json, bool8, opaque,
timestamp_with_offset) with their checks, and take and filter on their
storage, host and device routes."""
import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import extensions as jext
from arrow_go_tpu.array.arrays import ArrayData, make_array
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import nested_selection as jns
from arrow_go_tpu.compute.errors import ArrowInvalid as JArrowInvalid
from arrow_go_tpu.compute.errors import ArrowKeyError as JArrowKeyError

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import extensions as text
from arrow_go_tpu_torch.compute import nested_selection as tns
from arrow_go_tpu_torch.device.block import (ExtensionArray, HostArray,
                                             column_to_host,
                                             host_array_to_device)
from torch_parity import jax_type, port_array, port_type, same_array

TYPES = {
    "uuid": (jext.UuidType, text.UuidType, ()),
    "json": (jext.JsonType, text.JsonType, ()),
    "json_large": (jext.JsonType, text.JsonType, ("large_string",)),
    "bool8": (jext.Bool8Type, text.Bool8Type, ()),
    "opaque": (jext.OpaqueType, text.OpaqueType,
               ("int32", "geo.point", "acme")),
    "timestamp_with_offset": (jext.TimestampWithOffsetType,
                              text.TimestampWithOffsetType, ("ms",)),
    "timestamp_with_offset_dict": (
        jext.TimestampWithOffsetType, text.TimestampWithOffsetType,
        ("us", "dictionary<int16>")),
}


def _args(m, args):
    out = []
    for a in args:
        if a == "dictionary<int16>":
            out.append(m.dictionary(m.int32, m.int16))
        elif a in ("int32", "large_string"):
            out.append(getattr(m, a))
        else:
            out.append(a)
    return out


def _both(name):
    jcls, tcls, args = TYPES[name]
    return jcls(*_args(jdt, args)), tcls(*_args(dt, args))


@pytest.mark.parametrize("name", list(TYPES))
def test_the_canonical_types_match_jax(name):
    jt, t = _both(name)
    assert str(t) == str(jt)
    assert t.extension_name == jt.extension_name
    assert t.serialized == jt.serialized
    assert str(t.storage_type) == str(jt.storage_type)
    assert int(t.id) == int(jt.id) == int(jdt.TypeId.EXTENSION)
    assert t.np_dtype == jt.np_dtype and t.bit_width == jt.bit_width
    assert t.on_device == jf._device_selectable(jt)
    assert [f.name for f in t.fields()] == [f.name for f in jt.fields()]
    assert port_type(jt) == t and t == _both(name)[1]
    if not name.endswith("_dict"):     # (jax_type of a dictionary is its
        assert str(jax_type(t)) == str(jt)   # value type, a field's)


def test_the_registry_matches_jax():
    """Both packages register their canonical types at import,
    parquet.variant among them; a second registration of a name raises
    ArrowKeyError."""
    names = ["arrow.uuid", "arrow.json", "arrow.bool8",
             "arrow.timestamp_with_offset", "parquet.variant"]
    for n in names:
        assert str(text.get_extension_type(n)) == str(
            jext.get_extension_type(n))
    assert isinstance(text.get_extension_type("parquet.variant"),
                      text.VariantType)
    assert sorted(text._registry) == sorted(jext._registry)
    for reg, m, err in ((jext, jdt, JArrowKeyError),
                        (text, dt, pc.ArrowKeyError)):
        with pytest.raises(err):
            reg.register_extension_type(reg.Bool8Type())
        mine = reg.OpaqueType(m.int32, "t", "v")
        assert reg.get_extension_type("arrow.opaque") is None
        reg.register_extension_type(mine)
        try:
            assert reg.get_extension_type("arrow.opaque") is mine
            with pytest.raises(err):
                reg.register_extension_type(mine)
        finally:
            reg.unregister_extension_type("arrow.opaque")
        assert reg.get_extension_type("arrow.opaque") is None
        reg.unregister_extension_type("arrow.opaque")    # no error twice


@pytest.mark.parametrize("case", [
    ("JsonType", ("int32",)),
    ("TimestampWithOffsetType", ("s", "int32")),
    ("TimestampWithOffsetType", ("s", "dictionary<int32>"))])
def test_invalid_types_raise_like_jax(case):
    cls, args = case

    def make(mod, m):
        out = []
        for a in args:
            if a == "dictionary<int32>":
                out.append(m.dictionary(m.int32, m.int32))
            elif a == "int32":
                out.append(m.int32)
            else:
                out.append(a)
        return getattr(mod, cls)(*out)
    with pytest.raises(JArrowInvalid):
        make(jext, jdt)
    with pytest.raises(pc.ArrowInvalid):
        make(text, dt)


def _storage_struct(m, unit, tz, ok, off_nullable):
    return m.struct([m.Field("timestamp", m.timestamp(unit, tz), ok),
                     m.Field("offset_minutes", m.int16, off_nullable)])


@pytest.mark.parametrize("tz,ts_nullable,off_nullable,valid", [
    ("UTC", False, False, True), (None, False, False, False),
    ("UTC", True, False, False), ("UTC", False, True, False)])
def test_timestamp_with_offset_from_storage_matches_jax(
        tz, ts_nullable, off_nullable, valid):
    js = _storage_struct(jdt, "ms", tz, ts_nullable, off_nullable)
    ts = _storage_struct(dt, "ms", tz, ts_nullable, off_nullable)
    if not valid:
        with pytest.raises(JArrowInvalid):
            jext.TimestampWithOffsetType.from_storage(js)
        with pytest.raises(pc.ArrowInvalid):
            text.TimestampWithOffsetType.from_storage(ts)
        return
    jt = jext.TimestampWithOffsetType.from_storage(js)
    t = text.TimestampWithOffsetType.from_storage(ts)
    assert str(t) == str(jt) and t.unit == jt.unit


def test_uuid_values_read_as_uuids():
    b = bytes(range(16))
    assert text.UuidType.to_uuid(b) == jext.UuidType.to_uuid(b)


def _storage(name, n, rng):
    """A JAX storage array of the type's storage with nulls."""
    jt, _ = _both(name)
    st = jt.storage_type
    ok = rng.random(n) < 0.8
    if name == "uuid":
        vals = [rng.bytes(16) for _ in range(n)]
    elif name.startswith("json"):
        vals = [f'{{"v": {int(x)}}}' for x in rng.integers(0, 9, n)]
    elif name == "bool8":
        vals = [int(x) for x in rng.integers(0, 2, n)]
    elif name == "opaque":
        vals = [int(x) for x in rng.integers(-9, 9, n)]
    elif name == "timestamp_with_offset":
        return agt.array([{"timestamp": int(x), "offset_minutes": int(y)}
                          for x, y in zip(rng.integers(0, 10**12, n),
                                          rng.integers(-600, 600, n))], st)
    else:
        return None
    return agt.array([v if o else None for v, o in zip(vals, ok)], st)


def _extension(ext, storage):
    d = storage.data
    return make_array(ArrayData(ext, len(storage), d.buffers, d.children,
                                d.dictionary, None, d.offset))


CASES = ["uuid", "json", "json_large", "bool8", "opaque",
         "timestamp_with_offset"]


@pytest.mark.parametrize("name", CASES)
def test_take_is_on_storage_like_jax(name):
    rng = np.random.default_rng(7)
    jt, t = _both(name)
    ja = _extension(jt, _storage(name, 30, rng))
    a = port_array(ja)
    assert isinstance(a, ExtensionArray) and str(a.type) == str(jt)
    same_array(a, ja, name)
    idx = np.concatenate([rng.integers(0, 30, 20), [-1, 3, -1]])
    got, want = tns.take_host_vec(a, idx), jns.take_host_vec(ja, idx)
    assert isinstance(got, ExtensionArray) and got.type == a.type
    same_array(got, want, name)
    same_array(got.storage, jns.take_host_vec(ja.storage, idx), name)
    ji = agt.array([int(i) if i >= 0 else None for i in idx], jdt.int64)
    ti = HostArray(np.where(idx < 0, 0, idx), idx >= 0, dt.int64)
    same_array(pc.take(a, ti, device="cpu"), jf.take(ja, ji), name)


@pytest.mark.parametrize("name", [c for c in CASES if c != "bool8"])
def test_filter_is_on_storage_like_jax(name):
    """The host route (none of these storages is one number a row but
    opaque's int32, which the device route filters as its storage)."""
    rng = np.random.default_rng(8)
    jt, _ = _both(name)
    ja = _extension(jt, _storage(name, 30, rng))
    keep = rng.random(30) < 0.5
    jm = agt.array([bool(k) for k in keep], jdt.bool_)
    tm = HostArray(keep, None, dt.bool_)
    want = jf.filter_(ja, jm) if name != "opaque" else _extension(
        jt, jf.filter_(ja.storage, jm))
    if name == "opaque":      # the JAX device route cannot read it
        with pytest.raises(AttributeError):
            jf.filter_(ja, jm)
    same_array(pc.filter(port_array(ja), tm, device="cpu"), want, name)


def test_a_bool8_column_lives_on_the_device_as_its_storage():
    rng = np.random.default_rng(9)
    jt, t = _both("bool8")
    ja = _extension(jt, _storage("bool8", 50, rng))
    a = port_array(ja)
    col = host_array_to_device(a, torch.device("cpu"))
    assert col.type == t and col.values.dtype == torch.int8
    back = column_to_host(col)
    assert isinstance(back, ExtensionArray) and back.type == t
    same_array(back, ja, "bool8")
    idx = HostArray(np.array([4, 0, 49, 7]), np.array([1, 1, 0, 1], bool),
                    dt.int64)
    got = pc.take(col, host_array_to_device(idx, torch.device("cpu")))
    assert got.type == t
    same_array(column_to_host(got), jns.take_host_vec(
        ja, np.array([4, 0, -1, 7])), "bool8 device take")
