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
    a dictionary column's field type is its value type)."""
    return agt_torch.dtypes.type_for_name(str(jt))


def jax_type(t):
    """The JAX package's type of a port type."""
    from arrow_go_tpu import dtypes as jdt
    if t.is_decimal:
        return getattr(jdt, t.name)(t.precision, t.scale)
    if t.id == agt_torch.dtypes.TypeId.FIXED_SIZE_BINARY:
        return jdt.fixed_size_binary(t.byte_width)
    if t.id == agt_torch.dtypes.TypeId.TIMESTAMP:
        return jdt.timestamp(str(t.unit), t.tz)
    if hasattr(t, "unit"):
        return getattr(jdt, t.name)(str(t.unit))
    return {"halffloat": jdt.float16, "float": jdt.float32,
            "double": jdt.float64, "utf8": jdt.string}.get(
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
