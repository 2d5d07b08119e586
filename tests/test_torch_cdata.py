"""The port's C data interface on ctypes (arrow_go_tpu_torch/cdata.py)
against the JAX package's on cffi, in one process: the JAX export read
by the port's import and the port's export read by the JAX import, for
every type of the JAX `_FMT` table and `_format_for` (every case of
tests/test_torch_ipc.py the format carries, with nulls and the unsigned
extremes), whole and sliced (a JAX-exported slice has an offset);
pyarrow's `_export_to_c` / `_import_from_c` both ways; streams, device
arrays, device streams and the async stream in both directions; every
exported struct released exactly once (the keepalive drops counted);
and the refusals by exception class, a device_type of 2 among them."""
import ctypes
import gc
import time

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import cdata as jcd
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.compute.errors import ArrowInvalid as JArrowInvalid
from arrow_go_tpu.compute.errors import \
    ArrowNotImplemented as JArrowNotImplemented

from arrow_go_tpu_torch import cdata as tcd
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute.errors import (ArrowInvalid,
                                               ArrowNotImplemented)
from arrow_go_tpu_torch.device.block import HostArray, HostBatch
from fixtures import canonical_batches
from test_torch_ipc import FLAT, NESTED, SLICES, _same, case
from torch_parity import port_record_batch, same_table

pa = pytest.importorskip("pyarrow")

EXPORTED = list(FLAT) + list(NESTED) + ["null", "large_string",
                                        "large_binary", "dictionary<utf8>"]
REFUSED = ["string_view", "binary_view", "list_view<int32>",
           "large_list_view<utf8>", "sparse_union", "dense_union",
           "month_interval", "day_time_interval", "month_day_nano_interval",
           "run_end_encoded<int32, int64>", "bool8", "uuid", "json",
           "variant"]


class _Drops:
    """Counts each handle a package's keepalive registry drops (one
    drop = one release of an exported base struct)."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        keep = module._keep
        real = keep.drop

        def drop(h):
            self.calls.append(int(h))
            real(h)
        monkeypatch.setattr(keep, "drop", drop)

    def of(self, h: int) -> int:
        return self.calls.count(int(h))


def _handle(addr: int) -> int:
    return tcd.ArrowArray.from_address(addr).private_data


def _sliced(name, lo, n):
    ja, pa_, t = case(name)
    return ja.slice(lo, n), pa_.slice(lo, n), t


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", EXPORTED)
def test_jax_export_port_import(name, lo, n, monkeypatch):
    ja, _, t = _sliced(name, lo, n)
    drops = _Drops(monkeypatch, jcd)
    s, a = jcd.schema_handles()
    jcd.export_array(ja, a, s)
    if lo:
        assert tcd.ArrowArray.from_address(a).offset == lo
    h = _handle(a)
    f = tcd.import_field(s)
    assert f.type == t
    got = tcd.import_array(a, s)
    _same(got, ja, name)
    assert drops.of(h) == 1                       # released once
    assert not tcd.ArrowArray.from_address(a).release


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", EXPORTED)
def test_port_export_jax_import(name, lo, n, monkeypatch):
    ja, pa_, t = _sliced(name, lo, n)
    drops = _Drops(monkeypatch, tcd)
    s, a = tcd.schema_handles()
    tcd.export_array(pa_, a, s, field_type=t)
    h, hs = _handle(a), tcd.ArrowSchema.from_address(s).private_data
    field = jcd.import_field(s)
    assert str(field.type) == str(ja.type)
    back = jcd.import_array(a, field)
    assert back.to_pylist() == ja.to_pylist()
    assert back.null_count == ja.null_count
    assert drops.of(h) == 1
    assert not tcd.ArrowArray.from_address(a).release
    schema = tcd.ArrowSchema.from_address(s)
    schema.release(ctypes.pointer(schema))        # the importer's part
    assert drops.of(hs) == 1 and not schema.release


@pytest.mark.parametrize("lo,n", SLICES)
@pytest.mark.parametrize("name", EXPORTED)
def test_pyarrow_both_ways(name, lo, n, monkeypatch):
    ja, pa_, t = _sliced(name, lo, n)
    drops = _Drops(monkeypatch, tcd)
    s, a = tcd.schema_handles()
    tcd.export_array(pa_, a, s, field_type=t)
    h = _handle(a)
    parr = pa.Array._import_from_c(a, s)
    parr.validate(full=True)
    assert len(parr) == n and parr.null_count == ja.null_count
    s2, a2 = tcd.schema_handles()
    parr.slice(0, n)._export_to_c(a2, s2)
    del parr
    got = tcd.import_array(a2, s2)    # releases pyarrow's export, which
    gc.collect()                      # held the port's buffers: released
    assert drops.of(h) == 1
    _same(got, ja, name)
    # a pyarrow slice carries its offset into the port's import
    if n > 2:
        s3, a3 = tcd.schema_handles()
        pa.Array._import_from_c(*_exported(pa_, t)).slice(1, n - 2) \
            ._export_to_c(a3, s3)
        _same(tcd.import_array(a3, s3), ja.slice(1, n - 2), name)


def _exported(arr, t):
    s, a = tcd.schema_handles()
    tcd.export_array(arr, a, s, field_type=t)
    return a, s


@pytest.mark.parametrize("name", REFUSED)
def test_refused_types_raise_in_both(name):
    ja, pa_, t = case(name)
    s, a = tcd.schema_handles()
    with pytest.raises(ArrowNotImplemented):
        tcd.export_array(pa_, a, s, field_type=t)
    assert not tcd.ArrowArray.from_address(a).release
    s, a = jcd.schema_handles()
    with pytest.raises(JArrowNotImplemented):
        jcd.export_array(ja, a, s)


@pytest.mark.parametrize("fmt", ["vu", "+us:0,1", "+r", "tiM", "w"])
def test_unknown_formats_raise_in_both(fmt):
    for mod, exc in ((tcd, ArrowNotImplemented),
                     (jcd, JArrowNotImplemented)):
        s, _ = tcd.schema_handles()
        c = tcd.ArrowSchema.from_address(s)
        buf = ctypes.create_string_buffer(fmt.encode())
        c.format = ctypes.cast(buf, ctypes.c_char_p)
        c.name = None
        c.n_children = 0
        with pytest.raises(exc):
            mod.import_field(s)


def test_default_field_type_of_a_coded_string_column():
    """A coded string HostArray exports as a string (`u`), its type; a
    dictionary column over the same codes as its dictionary field type,
    by default or when `field_type` names it."""
    codes = np.array([1, 0, 1], np.int32)
    values = np.array(["x", "y"], dtype=object)
    arr = HostArray(codes, None, dt.string, values)
    s, a = tcd.schema_handles()
    tcd.export_array(arr, a, s)
    assert tcd.ArrowSchema.from_address(s).format == b"u"
    assert jcd.import_array(a, s).to_pylist() == ["y", "x", "y"]
    arr = HostArray(codes, None, dt.dictionary(dt.int32, dt.string), values)
    s, a = tcd.schema_handles()
    tcd.export_array(arr, a, s)
    assert tcd.ArrowSchema.from_address(s).format == b"i"
    s, a = tcd.schema_handles()
    tcd.export_array(arr, a, s, field_type=arr.type)
    assert tcd.ArrowSchema.from_address(s).format == b"i"
    back = jcd.import_array(a, s)
    assert back.type.id == jdt.TypeId.DICTIONARY
    assert back.to_pylist() == ["y", "x", "y"]


# -- streams -----------------------------------------------------------------

def _tables():
    """(JAX Table, its batches, the port's batches) per family."""
    for fam, rb in canonical_batches().items():
        t = agt.Table.from_batches([rb, rb.slice(1, 2)])
        batches = t.to_batches()
        yield fam, t, batches, [port_record_batch(b) for b in batches]


FAMILIES = [f for f, *_ in _tables()]


def _table(fam):
    return next(x for x in _tables() if x[0] == fam)[1:]


def _same_rows(got: HostBatch, t, what: str) -> None:
    same_table(got, t.combine_chunks() if hasattr(t, "combine_chunks")
               else t, what)


@pytest.mark.parametrize("fam", FAMILIES)
def test_streams_both_ways(fam, monkeypatch):
    t, batches, pbs = _table(fam)
    drops = _Drops(monkeypatch, tcd)
    # the port's stream read by the JAX reader
    p = tcd.stream_handle()
    tcd.export_stream((pbs[0].schema, pbs), p)
    h = tcd.ArrowArrayStream.from_address(p).private_data
    got = jcd.import_stream(p).read_all()
    assert got.to_pydict() == t.to_pydict()
    assert h not in tcd._streams                # the stream released
    assert len(drops.calls) == len(set(drops.calls)) == len(pbs) + 1
    # the JAX stream read by the port's reader, batch by batch
    p = jcd.stream_handle()
    jcd.export_stream(t, p)
    r = tcd.import_stream(p)
    assert r.schema == pbs[0].schema
    got = list(r)
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        same_table(g, b, fam)
    assert r.read_next_batch() is None
    # the port's stream read by the port, in one HostBatch
    p = tcd.stream_handle()
    tcd.export_stream((pbs[0].schema, iter(pbs)), p)
    one = tcd.import_stream(p).read_all()
    assert one.num_rows == t.num_rows
    assert one.to_pydict() == t.to_pydict()


@pytest.mark.parametrize("fam", FAMILIES)
def test_pyarrow_streams_both_ways(fam):
    t, batches, pbs = _table(fam)
    p = tcd.stream_handle()
    tcd.export_stream((pbs[0].schema, pbs), p)
    ptab = pa.RecordBatchReader._import_from_c(p).read_all()
    ptab.validate(full=True)
    assert ptab.num_rows == t.num_rows
    q = tcd.stream_handle()
    pa.RecordBatchReader.from_batches(ptab.schema, ptab.to_batches()) \
        ._export_to_c(q)
    got = tcd.import_stream(q)
    assert [f.name for f in got.schema.fields] == t.schema.names
    hbs = list(got)
    assert sum(h.num_rows for h in hbs) == t.num_rows
    # pyarrow keeps the rows; the port reads them back as it wrote them
    r = tcd.stream_handle()
    pa.RecordBatchReader.from_batches(ptab.schema, ptab.to_batches()) \
        ._export_to_c(r)
    assert tcd.import_stream(r).read_all().to_pydict() == \
        _port_dict(pbs)


def _port_dict(pbs):
    out = {}
    for hb in pbs:
        for k, v in hb.to_pydict().items():
            out.setdefault(k, []).extend(v)
    return out


def test_stream_errors_reach_the_reader_in_both():
    schema = dt.Schema([dt.Field("x", dt.int64)])

    def boom():
        yield HostBatch(schema, [HostArray(np.arange(3), None, dt.int64)], 3)
        raise RuntimeError("producer failed at batch 2")
    p = tcd.stream_handle()
    tcd.export_stream((schema, boom()), p)
    r = jcd.import_stream(p)
    assert r.read_next_batch().column(0).to_pylist() == [0, 1, 2]
    with pytest.raises(JArrowInvalid, match="producer failed"):
        r.read_next_batch()

    def jboom():
        yield agt.record_batch({"x": agt.array([1], jdt.int64)})
        raise RuntimeError("the JAX producer failed")
    p = jcd.stream_handle()
    jcd.export_stream((agt.schema({"x": jdt.int64}), jboom()), p)
    r = tcd.import_stream(p)
    assert r.read_next_batch().columns[0].to_pylist() == [1]
    with pytest.raises(ArrowInvalid, match="the JAX producer failed"):
        r.read_next_batch()


# -- the device interface ----------------------------------------------------

@pytest.mark.parametrize("name", ["int64", "float64", "string", "uint64",
                                  "decimal128(30, 4)", "list<int64>",
                                  "struct<a: int32, b: utf8>"])
def test_device_arrays_both_ways(name, monkeypatch):
    ja, pa_, t = case(name)
    drops = _Drops(monkeypatch, tcd)
    d = tcd.device_array_handle()
    s, _ = tcd.schema_handles()
    tcd.export_device_array(pa_, d, s, field_type=t)
    dev = tcd.ArrowDeviceArray.from_address(d)
    assert dev.device_type == tcd.ARROW_DEVICE_CPU and dev.device_id == -1
    h = dev.array.private_data
    back = jcd.import_device_array(d, jcd.import_field(s).type)
    assert back.to_pylist() == ja.to_pylist()
    assert drops.of(h) == 1
    d = jcd.device_array_handle()
    s, _ = jcd.schema_handles()
    jcd.export_device_array(ja.slice(2, 20), d, s)
    _same(tcd.import_device_array(d, s), ja.slice(2, 20), name)
    d = tcd.device_array_handle()
    s, _ = tcd.schema_handles()
    tcd.export_device_array(pa_, d, s, field_type=t)
    parr = pa.Array._import_from_c_device(d, s)
    parr.validate(full=True)
    assert len(parr) == len(ja) and parr.null_count == ja.null_count


def test_a_cuda_device_type_is_refused_by_both():
    ja, pa_, t = case("int64")
    for make, export, mod, exc in (
            (tcd.device_array_handle, tcd.export_device_array, tcd,
             ArrowInvalid),
            (jcd.device_array_handle, jcd.export_device_array, jcd,
             JArrowInvalid)):
        d = make()
        s, _ = tcd.schema_handles()
        if mod is tcd:
            export(pa_, d, s, field_type=t)
        else:
            export(ja, d, s)
        tcd.ArrowDeviceArray.from_address(d).device_type = 2  # kDLCUDA
        for importer, e in ((tcd.import_device_array, ArrowInvalid),
                            (jcd.import_device_array, JArrowInvalid)):
            with pytest.raises(e, match="non-CPU"):
                importer(d, s)
        arr = tcd.ArrowDeviceArray.from_address(d).array
        arr.release(ctypes.pointer(arr))
    for make, export, src in (
            (tcd.device_stream_handle, tcd.export_device_stream,
             (dt.Schema([dt.Field("x", t)]), [])),
            (jcd.device_stream_handle, jcd.export_device_stream,
             (agt.schema({"x": jdt.int64}), []))):
        p = make()
        export(src, p)
        tcd.ArrowDeviceArrayStream.from_address(p).device_type = 2
        with pytest.raises(ArrowInvalid):
            tcd.import_device_stream(p)
        with pytest.raises(JArrowInvalid):
            jcd.import_device_stream(p)
        c = tcd.ArrowDeviceArrayStream.from_address(p)
        c.release(ctypes.pointer(c))


@pytest.mark.parametrize("fam", FAMILIES)
def test_device_streams_both_ways(fam, monkeypatch):
    t, batches, pbs = _table(fam)
    drops = _Drops(monkeypatch, tcd)
    p = tcd.device_stream_handle()
    tcd.export_device_stream((pbs[0].schema, pbs), p)
    h = tcd.ArrowDeviceArrayStream.from_address(p).private_data
    assert jcd.import_device_stream(p).read_all().to_pydict() == \
        t.to_pydict()
    assert h not in tcd._device_streams
    assert len(drops.calls) == len(set(drops.calls)) == len(pbs) + 1
    p = jcd.device_stream_handle()
    jcd.export_device_stream(t, p)
    got = list(tcd.import_device_stream(p))
    for g, b in zip(got, batches):
        same_table(g, b, fam)
    assert len(got) == len(batches)


@pytest.mark.parametrize("queue_size", [1, 2, 8])
@pytest.mark.parametrize("fam", ["primitives", "binary", "nested"])
def test_async_streams_both_ways(fam, queue_size):
    t, batches, pbs = _table(fam)
    consumer = jcd.AsyncRecordBatchStream(queue_size=queue_size)
    tcd.export_async_stream((pbs[0].schema, pbs), consumer.handler_ptr)
    assert consumer.read_all().to_pydict() == t.to_pydict()
    assert consumer.error is None
    consumer = tcd.AsyncRecordBatchStream(queue_size=queue_size)
    jcd.export_async_stream((t.schema, iter(batches)), consumer.handler_ptr)
    got = list(consumer)
    assert consumer.error is None and consumer.schema == pbs[0].schema
    for g, b in zip(got, batches):
        same_table(g, b, fam)
    consumer = tcd.AsyncRecordBatchStream(queue_size=queue_size)
    tcd.export_async_stream((pbs[0].schema, iter(pbs)), consumer.handler_ptr)
    assert consumer.read_all().to_pydict() == t.to_pydict()
    # the producer releases the handler last, after the end of stream
    h = tcd.ArrowAsyncDeviceStreamHandler.from_address(
        consumer.handler_ptr).private_data
    deadline = time.monotonic() + 10
    while h in tcd._async_handlers and time.monotonic() < deadline:
        time.sleep(0.01)
    assert h not in tcd._async_handlers


def test_async_errors_reach_the_consumer_in_both():
    schema = dt.Schema([dt.Field("x", dt.int64)])

    def boom():
        yield HostBatch(schema, [HostArray(np.arange(2), None, dt.int64)], 2)
        raise RuntimeError("the port's producer failed")
    for consumer, exc in ((jcd.AsyncRecordBatchStream(), JArrowInvalid),
                          (tcd.AsyncRecordBatchStream(), ArrowInvalid)):
        tcd.export_async_stream((schema, boom()), consumer.handler_ptr)
        with pytest.raises(exc, match="producer failed"):
            consumer.read_all()


def test_async_cancel_stops_the_producer():
    schema = dt.Schema([dt.Field("x", dt.int64)])
    sent = []

    def endless():
        i = 0
        while True:
            sent.append(i)
            yield HostBatch(schema, [HostArray(np.array([i]), None,
                                               dt.int64)], 1)
            i += 1
    consumer = tcd.AsyncRecordBatchStream(queue_size=2)
    tcd.export_async_stream((schema, endless()), consumer.handler_ptr)
    it = iter(consumer)
    first = next(it)
    assert first.columns[0].to_pylist() == [0]
    prod = tcd.ArrowAsyncDeviceStreamHandler.from_address(
        consumer.handler_ptr).producer
    prod.contents.cancel(prod)
    time.sleep(0.2)
    n = len(sent)
    time.sleep(0.2)
    assert len(sent) == n <= 4


# -- the slice as a whole: chip_smoke.py's cdata_q6 on the CPU ---------------

PATH_ROWS = 200_000


def test_chip_smoke_cdata_q6_matches_jax():
    """Q6 over an ArrowArrayStream at 200,000 rows through chip_smoke.py's
    own functions (q6_host_batches, cdata_q6 with every column held bit
    for bit, the device array check), against numpy and against the
    same batches exported by the JAX package's stream, read by the port
    and run through the JAX functions."""
    import chip_smoke as cs
    import arrow_go_tpu.compute as jpc
    from arrow_go_tpu.compute.functions import agg_sum as jax_agg_sum
    from test_torch_dataset import _jax_q6_expression, _jproject
    from torch_parity import jax_batch
    li, _ = cs.make_data(PATH_ROWS, PATH_ROWS // 4)
    cs.add_quantity(li)
    batches = cs.q6_host_batches(li, rows=1 << 15)
    assert len(batches) == 7 and sum(b.num_rows for b in batches) == \
        PATH_ROWS
    times = {}
    got = cs.cdata_q6(batches, "cpu", times, source=li)
    cs.check_q6(got, cs.q6_oracle(li))
    assert times["batches"] == 7 and times["rows"] == PATH_ROWS
    assert cs.cdata_export_s(batches) >= 0
    assert cs.check_device_array(batches[0])["cuda_device_type_refused"]
    # the JAX package's stream of the same rows, read by the port
    jbatches = [agt.RecordBatch.from_arrays(
        [agt.from_numpy(np.ascontiguousarray(c.values)) for c in b.columns],
        b.schema.names) for b in batches]
    p = jcd.stream_handle()
    jcd.export_stream((jbatches[0].schema, iter(jbatches)), p)
    for hb, b in zip(tcd.import_stream(p), batches):
        for g, w in zip(hb.columns, b.columns):
            assert g.values.tobytes() == w.values.tobytes()
    revenue, count = 0.0, 0
    for jb in jbatches:
        jdb = jax_batch({n: jb.column(i).to_numpy()
                         for i, n in enumerate(jb.schema.names)})
        li_f = jpc.filter(_jproject(jdb, ["l_price", "l_disc"]),
                          jpc.execute_scalar_expression(
                              _jax_q6_expression(), jdb))
        if li_f.length:
            revenue += jax_agg_sum(jpc.execute_scalar_expression(
                jpc.call("multiply", [jpc.field("l_price"),
                                      jpc.field("l_disc")]), li_f))
        count += li_f.length
    assert got["count"] == count
    np.testing.assert_allclose(got["revenue"], revenue, rtol=1e-9)


def test_concurrent_async_streams_keep_every_batch(monkeypatch):
    """More producer threads than cores, with the interpreter switching
    threads every microsecond: every consumer gets its own batches in
    order, and every exported array is released exactly once."""
    import os
    import sys
    import threading
    drops = _Drops(monkeypatch, tcd)
    schema = dt.Schema([dt.Field("x", dt.int64)])
    n_streams, n_batches = 2 * (os.cpu_count() or 4), 12
    got = {}

    def consume(k):
        consumer = tcd.AsyncRecordBatchStream(queue_size=2)
        tcd.export_async_stream((schema, [
            HostBatch(schema, [HostArray(np.array([k, i]), None, dt.int64)],
                      2) for i in range(n_batches)]), consumer.handler_ptr)
        got[k] = [hb.columns[0].to_pylist() for hb in consumer]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(k,))
                   for k in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert got == {k: [[k, i] for i in range(n_batches)]
                   for k in range(n_streams)}
    # each stream's schema and every batch's array, released once each
    assert len(drops.calls) == len(set(drops.calls)) == \
        n_streams * (n_batches + 1)
