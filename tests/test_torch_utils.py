"""The port's utilities against the JAX package's: the metrics registry
(op names, calls and rows after the same call_function calls in both
packages), the profiler trace file, the memory watcher and the live-byte
count on the CPU (no stats there, in either package, so nothing is
asserted), Tensor (tests/test_misc_components.py's cases and more),
global_mesh at world size 1 and inside a 4-rank gloo pool, and the
debug assertions under their environment flags."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
from arrow_go_tpu import tensor as jtensor
from arrow_go_tpu.utils import memwatch as jmemwatch
from arrow_go_tpu.utils.metrics import metrics as jmetrics

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch import tensor as ttensor
from arrow_go_tpu_torch.device.block import HostArray
from arrow_go_tpu_torch.utils import (DeviceMemoryWatcher, device_live_bytes,
                                      metrics, trace)
from test_torch_types import jax_column, port_column
from torch_dist_worker import pool  # noqa: F401  (the 4-rank fixture)


def test_metrics_record_the_jax_ops_calls_and_rows():
    """The same call_function calls in both packages (device columns, a
    scalar, host arrays; a raw-argument function records no rows). One
    recorded deviation: the scalar aggregates, set lookups, vector hash
    functions, fill_null and if_else take raw arguments in the JAX
    registry (rows 0) and coerced ones in the port's, which counts
    their rows."""
    rng = np.random.default_rng(2)
    v, mask = rng.normal(size=300), rng.random(300) < 0.9
    snaps = []
    for cf, reg, col, host in (
            (lambda name, args: pc.call_function(name, args, device="cpu"),
             metrics, port_column(v, mask, dt.float64),
             HostArray(v, mask, dt.float64)),
            (jpc.call_function, jmetrics, jax_column(v, mask, dt.float64),
             agt.from_numpy(v, mask))):
        reg.reset()
        reg.enable()
        try:
            for name, args in (("add", [col, 1]), ("add", [col, col]),
                               ("sum", [col]), ("sort_indices", [host]),
                               ("multiply", [host, 2.0])):
                cf(name, args)
        finally:
            reg.disable()
        snap = reg.snapshot()
        ops = snap.ops if reg is metrics else snap
        snaps.append({k: (s.calls, s.rows) for k, s in ops.items()})
        reg.reset()
    assert snaps[0].pop("sum") == (1, 300) and snaps[1].pop("sum") == (1, 0)
    assert snaps[0] == snaps[1] == {"add": (2, 600), "sort_indices": (1, 0),
                                    "multiply": (1, 300)}
    pc.call_function("add", [port_column(v, mask, dt.float64), 1])
    assert metrics.snapshot().ops == {}      # off unless enabled


def test_trace_writes_a_chrome_trace(tmp_path):
    col = port_column(np.arange(100.0), None, dt.float64)
    with trace("front", log_dir=str(tmp_path), device="cpu") as d:
        pc.add(col, 1.0)
    assert d == str(tmp_path)
    data = json.loads((tmp_path / "front.json").read_text())
    assert data["traceEvents"]
    with trace(device="cpu") as d2:
        pass
    assert os.path.exists(os.path.join(d2, "arrow_go_tpu.json"))


def test_memory_watcher_asserts_nothing_on_the_cpu():
    """The JAX CPU backend gives no memory stats, and torch's CPU has no
    allocator count: both watchers see None and assert nothing."""
    assert jmemwatch.device_live_bytes() is None
    assert device_live_bytes("cpu") is None
    with jmemwatch.DeviceMemoryWatcher(tolerance=0) as jw:
        keep_j = [np.zeros(1000)]
    with DeviceMemoryWatcher(device="cpu", tolerance=0) as w:
        keep = [torch.zeros(100000)]
    assert w.growth is None and jw.growth is None and keep and keep_j
    with pytest.raises(ZeroDivisionError):      # a failure passes through
        with DeviceMemoryWatcher(device="cpu"):
            1 / 0


def test_memory_watcher_resolves_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMemoryWatcher()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_live_bytes()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace():
            pass


# ---------------------------------------------------------------------------
# tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "int8", "int64",
                                   "uint16", "uint32", "uint64"])
def test_tensor_from_numpy_matches_jax(dtype):
    m = np.arange(24, dtype=dtype).reshape(2, 3, 4)
    t, jt = ttensor.tensor(m, dim_names=["x", "y", "z"]), jtensor.tensor(
        m, dim_names=["x", "y", "z"])
    for attr in ("shape", "strides", "ndim", "size", "is_row_major",
                 "is_column_major", "is_contiguous"):
        assert getattr(t, attr) == getattr(jt, attr), attr
    assert t.dim_name(1) == jt.dim_name(1) == "y"
    assert str(t.type) == str(jt.type)
    assert t.value(1, 2, 3) == jt.value(1, 2, 3)
    np.testing.assert_array_equal(t.to_numpy(), jt.to_numpy())
    dev = t.to_device("cpu")
    assert dev.is_contiguous() and tuple(dev.shape) == m.shape
    np.testing.assert_array_equal(
        dev.numpy().view(m.dtype), np.asarray(jt.to_device()))


def test_tensor_from_an_array_and_column_major_strides_match_jax():
    v = np.arange(6, dtype=np.int64)
    a, ja = HostArray(v, None, dt.int64), agt.array(list(range(6)))
    t, jt = ttensor.Tensor(a, (2, 3)), jtensor.Tensor(ja, (2, 3))
    assert t.strides == jt.strides == (24, 8)
    assert t.value(1, 0) == jt.value(1, 0) == 3
    t, jt = (ttensor.Tensor(a, (2, 3), (8, 16)),
             jtensor.Tensor(ja, (2, 3), (8, 16)))
    assert t.is_column_major and jt.is_column_major and not t.is_row_major
    np.testing.assert_array_equal(t.to_numpy(), jt.to_numpy())
    assert t.value(1, 2) == jt.value(1, 2)
    np.testing.assert_array_equal(t.to_device("cpu").numpy(),
                                  np.asarray(jt.to_device()))
    assert repr(ttensor.tensor(a)) == repr(jtensor.tensor(ja))


def test_tensor_refusals_match_jax():
    for jcall, tcall in (
            (lambda: jtensor.Tensor(agt.array([1, None]), (2,)),
             lambda: ttensor.Tensor(HostArray(np.array([1, 0]), np.array(
                 [True, False]), dt.int64), (2,))),
            (lambda: jtensor.Tensor(agt.array([1, 2]), (3,)),
             lambda: ttensor.Tensor(HostArray(np.array([1, 2]), None,
                                              dt.int64), (3,))),
            (lambda: jtensor.Tensor(agt.array(["a"]), (1,)),
             lambda: ttensor.Tensor(HostArray(np.zeros(1, np.int32), None,
                                              dt.dictionary(dt.int32,
                                                            dt.string),
                                              np.array(["a"], object)),
                                    (1,)))):
        with pytest.raises(jpc.ArrowInvalid):
            jcall()
        with pytest.raises(pc.ArrowInvalid):
            tcall()
    # an all-true mask is no null
    t = ttensor.Tensor(HostArray(np.array([1, 2]), np.array([True, True]),
                                 dt.int64), (2,))
    assert t.shape == (2,)


def test_tensor_to_device_resolves_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttensor.tensor(np.eye(2)).to_device()


# ---------------------------------------------------------------------------
# global_mesh
# ---------------------------------------------------------------------------

def test_global_mesh_at_world_size_one():
    import torch.distributed as dist
    from arrow_go_tpu_torch.parallel import global_mesh, make_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        global_mesh(device="cpu")
    try:
        m = make_mesh(device="cpu")
        g = global_mesh(device="cpu")
        assert (g.rank, g.world_size, g.device.type, g.group) == \
            (0, 1, "cpu", None)
        assert g == m
    finally:
        dist.destroy_process_group()


def test_global_mesh_spans_the_whole_pool(pool):  # noqa: F811
    """Inside the 4-rank pool, global_mesh is the default group: all four
    ranks, whatever subgroup a task runs in (D = 4 here)."""
    out = pool.run(4, "global_mesh_info")
    assert out == [(r, 4, "cpu", True, r, 4) for r in range(4)]


# ---------------------------------------------------------------------------
# debug assertions
# ---------------------------------------------------------------------------

_DEBUG_PROBE = (
    "import sys\n"
    "sys.path.insert(0, {root!r})\n"
    "from {pkg}.utils.debug import debug_assert, debug_log\n"
    "debug_log('hello')\n"
    "try:\n"
    "    debug_assert(1 == 2, 'boom')\n"
    "    print('quiet')\n"
    "except AssertionError as e:\n"
    "    print('raised', e)\n")


@pytest.mark.parametrize("flags", [{}, {"AGT_ASSERT": "1"},
                                   {"AGT_ASSERT": "0", "AGT_DEBUG": "1"}],
                         ids=["off", "assert", "debug"])
def test_debug_flags_act_as_in_jax(flags):
    """Both packages read AGT_ASSERT and AGT_DEBUG at import: the same
    flags give the same behaviour (in fresh interpreters)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("AGT_ASSERT", "AGT_DEBUG")}
    env.update(flags, JAX_PLATFORMS="cpu")
    outs = []
    for pkg in ("arrow_go_tpu", "arrow_go_tpu_torch"):
        r = subprocess.run([sys.executable, "-c", _DEBUG_PROBE.format(
            root=root, pkg=pkg)], env=env, capture_output=True, text=True,
            timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append((r.stdout, "[agt-debug] hello" in r.stderr))
    assert outs[0] == outs[1]
    assert outs[0][0] == ("raised boom\n" if flags.get("AGT_ASSERT") == "1"
                          else "quiet\n")
    assert outs[0][1] == (flags.get("AGT_DEBUG") == "1")
