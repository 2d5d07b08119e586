"""Helpers of the parity tests between arrow_go_tpu (JAX) and its
PyTorch port: the same inputs, made from a seed with numpy, go to both."""
import numpy as np

import arrow_go_tpu as agt
from arrow_go_tpu.device.block import batch_to_device as jax_batch_to_device

import arrow_go_tpu_torch as agt_torch


def jax_batch(data, masks=None):
    """dict of numpy columns (+ optional validity masks by name, True =
    valid) -> JAX DeviceBatch."""
    masks = masks or {}
    rb = agt.record_batch({k: _jax_array(v, masks.get(k))
                           for k, v in data.items()})
    return jax_batch_to_device(rb)


def _jax_array(v, mask):
    """A numpy column as a JAX package array; an object (str) column
    becomes a string array, which the device holds as dictionary codes."""
    if v.dtype != object:
        return agt.from_numpy(v, mask)
    return agt.array([x if mask is None or mask[i] else None
                      for i, x in enumerate(v.tolist())])


def port_batch(jdb):
    """The port's DeviceBatch holding bit-identical copies of a JAX
    DeviceBatch's padded values and validity words (and a string
    column's codes and dictionary), on the CPU."""
    fields = [(f.name, port_type(f.type)) for f in jdb.schema.fields]
    columns = [(np.asarray(c.values),
                None if c.validity is None else np.asarray(c.validity))
               + (() if c.dictionary is None
                  else (c.dictionary.to_pylist(),))
               for c in jdb.columns]
    return agt_torch.batch_from_numpy(fields, columns, jdb.length,
                                      device="cpu")


def port_type(jt):
    """The port's type of a JAX package type (same name and parameters;
    a dictionary column's field type is its value type); nested types
    recursively."""
    from arrow_go_tpu import dtypes as jdt
    tdt = agt_torch.dtypes
    tid = jt.id
    if tid == jdt.TypeId.MAP:
        return tdt.map_(port_type(jt.key_type), port_type(jt.item_type),
                        jt.keys_sorted)
    if tid in (jdt.TypeId.LIST, jdt.TypeId.LARGE_LIST,
               jdt.TypeId.FIXED_SIZE_LIST):
        vf = jt.value_field
        f = tdt.Field(vf.name, port_type(vf.type), vf.nullable)
        if tid == jdt.TypeId.FIXED_SIZE_LIST:
            return tdt.fixed_size_list(f, jt.list_size)
        return (tdt.list_ if tid == jdt.TypeId.LIST else tdt.large_list)(f)
    if tid == jdt.TypeId.STRUCT:
        return tdt.struct([tdt.Field(f.name, port_type(f.type), f.nullable)
                           for f in jt.fields()])
    if tid in (jdt.TypeId.LIST_VIEW, jdt.TypeId.LARGE_LIST_VIEW):
        vf = jt.value_field
        f = tdt.Field(vf.name, port_type(vf.type), vf.nullable)
        return (tdt.list_view if tid == jdt.TypeId.LIST_VIEW
                else tdt.large_list_view)(f)
    if tid in (jdt.TypeId.SPARSE_UNION, jdt.TypeId.DENSE_UNION):
        return getattr(tdt, jt.name)(
            [tdt.Field(f.name, port_type(f.type), f.nullable)
             for f in jt.fields()], jt.type_codes)
    if tid == jdt.TypeId.EXTENSION:
        return tdt.ExtensionType(port_type(jt.storage_type),
                                 jt.extension_name, jt.serialized)
    if tid == jdt.TypeId.DICTIONARY:
        return tdt.dictionary(port_type(jt.index_type),
                              port_type(jt.value_type), jt.ordered)
    if tid == jdt.TypeId.RUN_END_ENCODED:
        return tdt.run_end_encoded(port_type(jt.run_ends_type),
                                   port_type(jt.values_type))
    return tdt.type_for_name(str(jt))


def jax_type(t):
    """The JAX package's type of a port type (nested types
    recursively)."""
    from arrow_go_tpu import dtypes as jdt
    tdt = agt_torch.dtypes
    if t.id == tdt.TypeId.MAP:
        return jdt.map_(jax_type(t.key_type), jax_type(t.item_type),
                        t.keys_sorted)
    if t.id in (tdt.TypeId.LIST, tdt.TypeId.LARGE_LIST,
                tdt.TypeId.FIXED_SIZE_LIST):
        vf = t.value_field
        f = jdt.Field(vf.name, jax_type(vf.type), vf.nullable)
        if t.id == tdt.TypeId.FIXED_SIZE_LIST:
            return jdt.fixed_size_list(f, t.list_size)
        return (jdt.list_ if t.id == tdt.TypeId.LIST else jdt.large_list)(f)
    if t.id == tdt.TypeId.STRUCT:
        return jdt.struct([jdt.Field(f.name, jax_type(f.type), f.nullable)
                           for f in t.fields()])
    if t.id in (tdt.TypeId.LIST_VIEW, tdt.TypeId.LARGE_LIST_VIEW):
        vf = t.value_field
        f = jdt.Field(vf.name, jax_type(vf.type), vf.nullable)
        return (jdt.ListViewType if t.id == tdt.TypeId.LIST_VIEW
                else jdt.LargeListViewType)(f)
    if t.id in (tdt.TypeId.SPARSE_UNION, tdt.TypeId.DENSE_UNION):
        return getattr(jdt, t.name)(
            [jdt.Field(f.name, jax_type(f.type), f.nullable)
             for f in t.fields()], t.type_codes)
    if t.id == tdt.TypeId.EXTENSION:
        return jdt.ExtensionType(jax_type(t.storage_type), t.extension_name,
                                 t.serialized)
    if t.id == tdt.TypeId.DICTIONARY:
        return jax_type(t.value_type)
    if t.is_decimal:
        return getattr(jdt, t.name)(t.precision, t.scale)
    if t.id == agt_torch.dtypes.TypeId.FIXED_SIZE_BINARY:
        return jdt.fixed_size_binary(t.byte_width)
    if t.id == agt_torch.dtypes.TypeId.TIMESTAMP:
        return jdt.timestamp(str(t.unit), t.tz)
    if hasattr(t, "unit"):
        return getattr(jdt, t.name)(str(t.unit))
    return {"halffloat": jdt.float16, "float": jdt.float32,
            "double": jdt.float64, "utf8": jdt.string,
            "large_utf8": jdt.large_string}.get(
                t.name) or getattr(jdt, t.name.rstrip("_") if t.name
                                   != "bool" else "bool_")


def words_u32(t):
    """The port's int32 validity words as the JAX package's uint32."""
    return t.numpy().view(np.uint32)


def host_tables(data, masks=None):
    """(the JAX package's RecordBatch, the port's HostBatch) of the same
    columns (object columns as strings, dictionary-coded)."""
    from arrow_go_tpu.device.block import batch_from_device
    from arrow_go_tpu_torch.device.block import device_batch_to_host
    jdb = jax_batch(data, masks)
    return batch_from_device(jdb), device_batch_to_host(port_batch(jdb))


def same_batch(got, want) -> None:
    """A port HostBatch equal to a JAX RecordBatch: names, rows, and each
    column's values (floats at rtol 1e-9, nulls where they are)."""
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows
    for i, name in enumerate(want.schema.names):
        g, w = got.column(i).to_pylist(), want.column(i).to_pylist()
        assert [x is None for x in g] == [x is None for x in w], name
        gv = [x for x in g if x is not None]
        wv = [x for x in w if x is not None]
        if wv and isinstance(wv[0], float):
            np.testing.assert_allclose(gv, wv, rtol=1e-9, atol=0,
                                       equal_nan=True, err_msg=name)
        else:
            assert gv == wv, name


# ---------------------------------------------------------------------------
# nested arrays: the JAX package's host Arrays <-> the port's HostArrays
# ---------------------------------------------------------------------------

def port_array(ja):
    """The port's HostArray of a JAX package host Array, nested types
    recursively with their offsets (as they stand, sliced arrays too),
    validity at every level and a fixed_size_list's child rows under
    null rows; a string-like or fixed_size_binary leaf becomes the port's
    column of that type (codes into its values), a
    primitive leaf its values (0 under a null). A null array becomes the
    port's null column, an interval its structured values, a list view
    its offsets, sizes and child, a union its type codes (a dense one's
    offsets) and children (a sparse one's cut to its rows), an extension
    array its storage's. A dictionary array becomes its indices and the
    port's dictionary values (str / bytes, or the values), a decimal
    array its unscaled values (limbs for decimal128 / decimal256)."""
    from arrow_go_tpu import dtypes as jdt
    from arrow_go_tpu.array.arrays import make_array
    from arrow_go_tpu_torch.device.block import (
        ExtensionArray, HostArray, ListViewArray, UnionArray,
        dictionary_values, factorize, nested_array, null_array)
    from arrow_go_tpu_torch.ops.decimal import from_ints
    t, n = ja.type, len(ja)
    tid = t.id
    pt = port_type(t)
    if tid == jdt.TypeId.NULL:
        return null_array(n)
    if tid == jdt.TypeId.EXTENSION:
        return ExtensionArray(pt, port_array(ja.storage))
    d = ja.data
    if tid == jdt.TypeId.SPARSE_UNION:
        return UnionArray(pt, ja.type_ids, [
            port_array(make_array(c.slice(d.offset, n)))
            for c in d.children])
    if tid == jdt.TypeId.DENSE_UNION:
        return UnionArray(pt, ja.type_ids, [
            port_array(make_array(c)) for c in d.children],
            d.buffers[1].view(np.int32)[d.offset:d.offset + n])
    mask = ja.validity_bools() if ja.null_count else None
    if tid in (jdt.TypeId.LIST_VIEW, jdt.TypeId.LARGE_LIST_VIEW):
        return ListViewArray(pt, mask, ja.offsets, ja.sizes,
                             port_array(make_array(d.children[0])))
    if tid in (jdt.TypeId.LIST, jdt.TypeId.LARGE_LIST, jdt.TypeId.MAP):
        return nested_array(pt, n, mask,
                            [port_array(make_array(ja.data.children[0]))],
                            np.asarray(ja.offsets))
    if tid == jdt.TypeId.FIXED_SIZE_LIST:
        k = t.list_size
        child = make_array(ja.data.children[0]).slice(ja.offset * k, n * k)
        return nested_array(pt, n, mask, [port_array(child)])
    if tid == jdt.TypeId.STRUCT:
        return nested_array(pt, n, mask, [port_array(ja.field(i))
                                          for i in range(ja.num_fields)])
    if tid == jdt.TypeId.DICTIONARY:
        from arrow_go_tpu_torch.array.arrays import DictionaryArray
        vt = pt.value_type
        values = ja.dictionary.to_pylist()
        return DictionaryArray(np.asarray(ja.indices.to_numpy(),
                                    pt.index_type.np_dtype), mask, pt,
                         dictionary_values(values, vt)
                         if vt.codes_on_device else np.asarray(values,
                                                              vt.np_dtype))
    if t.is_decimal:
        ints = [int(u) for u in ja.unscaled_array()]
        return HostArray(from_ints(ints, pt.limbs) if pt.limbs
                         else np.asarray(ints, pt.np_dtype), mask, pt)
    vals = ja.to_pylist()
    ok = np.array([v is not None for v in vals], np.bool_)
    if t.is_binary_like or tid == jdt.TypeId.FIXED_SIZE_BINARY:
        obj = np.empty(n, dtype=object)
        obj[:] = ["" if v is None else v for v in vals]
        codes, dictionary = factorize(obj, ok)
        return HostArray(codes, mask, pt, dictionary)
    out = np.zeros(n, pt.np_dtype)
    out[ok] = [v for v in vals if v is not None]
    return HostArray(out, mask, pt)


def port_record_batch(rb):
    """The port's HostBatch of a JAX RecordBatch: its schema's fields
    (port_type, nullability kept) and each column by port_array."""
    from arrow_go_tpu_torch.device.block import HostBatch
    tdt = agt_torch.dtypes
    return HostBatch(tdt.Schema([tdt.Field(f.name, port_type(f.type),
                                           f.nullable)
                                 for f in rb.schema.fields]),
                     [port_array(c) for c in rb.columns], rb.num_rows)


def jax_array(a):
    """The JAX package's host Array of a port HostArray (its Python
    values through the JAX builders)."""
    return agt.array(a.to_pylist(), jax_type(a.type))


def same_array(got, want, what: str = "") -> None:
    """A port HostArray equal to a JAX package Array: field type,
    validity at every level, offsets rebased to 0 exactly, a
    fixed_size_list's child rows, ints and strings exactly and floats at
    rtol 1e-9. A list view's offsets and sizes, and a union's type codes
    and dense offsets, are held exactly, its children as they stand. A
    union's validity is its rows' `is_valid` (the JAX package's
    `validity_bools` of a union reads its type-code buffer as a bitmap,
    ROADMAP §3). A DictionaryArray is held by its type and values."""
    from arrow_go_tpu import dtypes as jdt
    from arrow_go_tpu.array.arrays import make_array
    assert str(got.type) == str(want.type), (what, got.type, want.type)
    if want.type.id == jdt.TypeId.DICTIONARY:
        assert type(got).__name__ == "DictionaryArray", what
        assert got.to_pylist() == want.to_pylist(), what
        return
    assert len(got) == len(want), what
    tid = want.type.id
    unions = (jdt.TypeId.SPARSE_UNION, jdt.TypeId.DENSE_UNION)
    np.testing.assert_array_equal(
        got.validity_bools(),
        [want.is_valid(i) for i in range(len(want))] if tid in unions
        else want.validity_bools(), err_msg=what)
    if tid == jdt.TypeId.EXTENSION:
        same_array(got.storage, want.storage, what + ".storage")
        return
    if tid in unions:
        np.testing.assert_array_equal(got.type_ids, want.type_ids,
                                      err_msg=what)
        d = want.data
        if tid == jdt.TypeId.DENSE_UNION:
            np.testing.assert_array_equal(
                got.value_offsets, d.buffers[1].view(np.int32)[
                    d.offset:d.offset + len(want)], err_msg=what)
        for i, c in enumerate(d.children):
            wc = make_array(c) if tid == jdt.TypeId.DENSE_UNION else \
                make_array(c.slice(d.offset, len(want)))
            same_array(got.children[i], wc, f"{what}.{i}")
        assert got.to_pylist() == want.to_pylist(), what
        return
    if tid in (jdt.TypeId.LIST_VIEW, jdt.TypeId.LARGE_LIST_VIEW):
        assert got.offsets.dtype == np.dtype(want.type.offset_dtype), what
        np.testing.assert_array_equal(got.offsets, want.offsets,
                                      err_msg=what)
        np.testing.assert_array_equal(got.sizes, want.sizes, err_msg=what)
        same_array(got.children[0], make_array(want.data.children[0]),
                   what + ".child")
        assert got.to_pylist() == want.to_pylist(), what
        return
    if tid in (jdt.TypeId.LIST, jdt.TypeId.LARGE_LIST, jdt.TypeId.MAP):
        go, wo = got.offsets.astype(np.int64), np.asarray(
            want.offsets, np.int64)
        assert got.offsets.dtype == np.dtype(want.type.offset_dtype), what
        np.testing.assert_array_equal(go - go[0], wo - wo[0], err_msg=what)
        same_array(got.children[0].slice(int(go[0]), int(go[-1] - go[0])),
                   make_array(want.data.children[0]).slice(
                       int(wo[0]), int(wo[-1] - wo[0])), what + ".child")
        return
    if tid == jdt.TypeId.FIXED_SIZE_LIST:
        k = want.type.list_size
        same_array(got.children[0].slice(0, len(got) * k),
                   make_array(want.data.children[0]).slice(
                       want.offset * k, len(want) * k), what + ".child")
        return
    if tid == jdt.TypeId.STRUCT:
        for i in range(want.num_fields):
            same_array(got.children[i], want.field(i), f"{what}.{i}")
        return
    g, w = got.to_pylist(), want.to_pylist()
    assert [x is None for x in g] == [x is None for x in w], what
    gv = [x for x in g if x is not None]
    wv = [x for x in w if x is not None]
    if wv and isinstance(wv[0], float):
        np.testing.assert_allclose(gv, wv, rtol=1e-9, atol=0,
                                   equal_nan=True, err_msg=what)
    else:
        assert gv == wv, what


# ---------------------------------------------------------------------------
# tables: a JAX Table or RecordBatch against a port HostBatch
# ---------------------------------------------------------------------------

def _exact(v):
    """Python values with NaN made comparable (nested lists and dicts
    too)."""
    if isinstance(v, float) and v != v:
        return "NaN"
    if isinstance(v, (list, tuple)):
        return [_exact(x) for x in v]
    if isinstance(v, dict):
        return {k: _exact(x) for k, x in v.items()}
    return v


def same_table(got, want, what: str = "") -> None:
    """A port HostBatch or Table equal to a JAX Table or RecordBatch: names, field
    types, rows, each column as same_array and its Python values exactly
    (floats bit for bit, NaN where NaN)."""
    assert list(got.schema.names) == list(want.schema.names), what
    assert [f.type for f in got.schema.fields] == \
        [port_type(f.type) for f in want.schema.fields], (
            what, got.schema, want.schema)
    assert got.num_rows == want.num_rows, what
    for i, name in enumerate(want.schema.names):
        w, g = want.column(i), got.column(i)
        if hasattr(w, "combine"):
            w = w.combine()
        if hasattr(g, "combine"):       # a port Table's ChunkedArray
            g = g.combine()
        same_array(g, w, f"{what} {name}")
        assert _exact(g.to_pylist()) == _exact(w.to_pylist()), (what, name)
