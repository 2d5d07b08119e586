"""The port's host-array leftovers against the JAX package, on the same
seeded inputs: ChunkedArray (arrow_go_tpu_torch/array/record.py) and
the chunked input of filter, take, run_end_encode and the aggregates,
Buffer / Allocator / TrackedAllocator (memory/buffer.py), and
array_equal / array_approx_equal / diff (array/compare.py)."""
import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
from arrow_go_tpu import compute as jpc
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.array.compare import DiffEdit as JDiffEdit
from arrow_go_tpu.array.compare import array_approx_equal as j_approx
from arrow_go_tpu.array.compare import array_equal as j_equal
from arrow_go_tpu.array.compare import diff as j_diff

import arrow_go_tpu_torch as tagt
from arrow_go_tpu_torch import compute as tpc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch import torchenv
from arrow_go_tpu_torch.array import (ChunkedArray, DiffEdit,
                                      array_approx_equal, array_equal, diff)
from arrow_go_tpu_torch.device.block import from_pylist

from torch_parity import port_type

KINDS = ["int64", "float64", "string", "bool"]


def _values(kind, rng, n):
    """n Python values of a kind, about a fifth of them None."""
    if kind == "int64":
        vals = rng.integers(-1000, 1000, n).tolist()
    elif kind == "float64":
        vals = rng.normal(size=n).tolist()
    elif kind == "string":
        vals = [f"s{v}" for v in rng.integers(0, 7, n)]
    else:
        vals = (rng.random(n) < 0.5).tolist()
    return [None if rng.random() < 0.2 else v for v in vals]


def _chunks(kind, seed, sizes=(5, 0, 7, 3)):
    rng = np.random.default_rng(seed)
    return [_values(kind, rng, n) for n in sizes]


def _both(kind, parts):
    """(the JAX ChunkedArray, the port's) of the same chunk values."""
    jt, tt = getattr(jdt, kind if kind != "bool" else "bool_"), \
        getattr(tdt, kind if kind != "bool" else "bool_")
    return (agt.ChunkedArray([agt.array(p, jt) for p in parts], jt),
            ChunkedArray([from_pylist(p, tt) for p in parts], tt))


# ---------------------------------------------------------------------------
# ChunkedArray
# ---------------------------------------------------------------------------

def test_chunked_array_ops():
    """tests/test_arrays.py::test_chunked_array_ops on the port."""
    ca = tagt.ChunkedArray([from_pylist([1, 2], tdt.int64),
                            from_pylist([None, 4], tdt.int64)], tdt.int64)
    assert len(ca) == 4
    assert ca.null_count == 1
    assert ca[2] is None and ca[3] == 4
    assert ca.slice(1, 2).to_pylist() == [2, None]
    assert ca.combine().to_pylist() == [1, 2, None, 4]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_array_matches_jax(kind, seed):
    parts = _chunks(kind, seed)
    j, t = _both(kind, parts)
    assert len(t) == len(j) and t.length == j.length
    assert t.num_chunks == j.num_chunks == 4
    assert t.null_count == j.null_count
    assert t.to_pylist() == j.to_pylist()
    assert [c.to_pylist() for c in t.chunks] == \
        [c.to_pylist() for c in j.chunks]
    assert t.chunk(2).to_pylist() == j.chunk(2).to_pylist()
    for i in range(-len(t), len(t)):
        assert t[i] == j[i]
    with pytest.raises(IndexError):
        t[len(t)]
    for off, n in ((0, None), (3, 6), (5, 7), (12, 3), (14, 9), (15, None)):
        assert t.slice(off, n).to_pylist() == j.slice(off, n).to_pylist()
        assert t.slice(off, n).num_chunks == j.slice(off, n).num_chunks
    assert t.combine().to_pylist() == j.combine().to_pylist()
    assert t.equals(ChunkedArray([t.combine()], t.type))
    assert not t.equals(t.slice(1))
    assert port_type(j.type) == t.type
    assert repr(t) == f"ChunkedArray({t.type}, chunks=4, len={len(t)})"


def test_chunked_array_type_checks():
    with pytest.raises(ValueError, match="need type"):
        ChunkedArray([])
    with pytest.raises(ValueError, match="mismatch"):
        ChunkedArray([from_pylist([1], tdt.int64),
                      from_pylist([1.0], tdt.float64)])
    with pytest.raises(ValueError, match="mismatch"):
        agt.ChunkedArray([agt.array([1]), agt.array([1.0])])
    empty = ChunkedArray([], tdt.float64)
    assert len(empty) == 0 and empty.null_count == 0
    assert empty.combine().type == tdt.float64 and \
        len(empty.combine()) == 0
    one = from_pylist([3, None], tdt.int32)
    assert ChunkedArray([one]).combine() is one
    # a dictionary-coded string chunk is a chunk of its value type
    assert ChunkedArray([from_pylist(["a"], tdt.string)],
                        tdt.string).type == tdt.string


def _mask_parts(seed, sizes):
    rng = np.random.default_rng(100 + seed)
    return [[None if rng.random() < 0.1 else bool(rng.random() < 0.6)
             for _ in range(n)] for n in sizes]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_filter_matches_jax(kind, seed):
    """tests/test_compute.py's chunked input through filter: the values
    chunked, the mask a flat array, then the mask chunked too."""
    parts = _chunks(kind, seed)
    j, t = _both(kind, parts)
    mparts = _mask_parts(seed, (4, 8, 3))
    flat = sum(mparts, [])
    jm, tm = agt.array(flat, jdt.bool_), from_pylist(flat, tdt.bool_)
    want = jpc.filter(j, jm).to_pylist()
    assert tpc.filter_(t, tm, device="cpu").to_pylist() == want
    jcm, tcm = _both("bool", mparts)
    assert jpc.filter(j, jcm).to_pylist() == want
    assert tpc.filter_(t, tcm, device="cpu").to_pylist() == want
    assert tpc.filter_(t.combine(), tcm, device="cpu").to_pylist() == want


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_take_matches_jax(kind, seed):
    parts = _chunks(kind, seed)
    j, t = _both(kind, parts)
    rng = np.random.default_rng(200 + seed)
    idx = [None if rng.random() < 0.15 else int(v)
           for v in rng.integers(0, len(t), 11)]
    iparts = [idx[:4], idx[4:]]
    want = jpc.take(j, agt.ChunkedArray(
        [agt.array(p, jdt.int64) for p in iparts], jdt.int64)).to_pylist()
    got = tpc.take(t, ChunkedArray([from_pylist(p, tdt.int64)
                                    for p in iparts], tdt.int64),
                   device="cpu")
    assert got.to_pylist() == want
    assert tpc.take(t, from_pylist(idx, tdt.int64),
                    device="cpu").to_pylist() == want


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["int64", "float64", "bool"])
def test_chunked_run_end_encode_matches_jax(kind, seed):
    rng = np.random.default_rng(300 + seed)
    vals = rng.integers(0, 3, 24).tolist()
    if kind == "float64":
        vals = [float(v) for v in vals]
    elif kind == "bool":
        vals = [bool(v % 2) for v in vals]
    vals = [None if rng.random() < 0.15 else v for v in vals]
    j, t = _both(kind, [vals[:9], vals[9:10], vals[10:]])
    want = jpc.run_end_encode(j)
    got = tpc.run_end_encode(t, device="cpu")
    assert got.to_pylist() == want.to_pylist()
    assert got.run_ends.values.tolist() == want.run_ends.to_pylist()
    assert got.values.to_pylist() == want.values.to_pylist()


def test_chunked_aggregates_combine_on_the_card(monkeypatch):
    """An aggregate of a ChunkedArray combines it and moves it to the
    card, as the JAX package moves it to its device; with no card that
    raises, and with the card mapped to the CPU the results are the JAX
    ones (tests/test_compute.py::test_chunked_array_input)."""
    j, t = _both("int64", [[1, 2], [None, 4]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpc.agg_sum(t)
    monkeypatch.setattr(torchenv, "device",
                        lambda dev=None: torch.device("cpu"))
    assert tpc.agg_sum(t) == jpc.sum(j) == 7
    assert tpc.agg_min(t) == jpc.min(j)
    assert tpc.agg_count(t) == jpc.count(j)
    jf, tf = _both("float64", _chunks("float64", 4))
    assert tpc.agg_mean(tf) == pytest.approx(jpc.mean(jf), rel=1e-12)


# ---------------------------------------------------------------------------
# Buffer, Allocator, TrackedAllocator
# ---------------------------------------------------------------------------

def test_tracked_allocator():
    """tests/test_arrays.py::test_tracked_allocator on the port."""
    alloc = tagt.TrackedAllocator()
    b = alloc.allocate(100)
    assert alloc.allocated_bytes == 100
    with pytest.raises(AssertionError):
        alloc.assert_size(0)
    alloc.free(b)
    alloc.assert_size(0)
    with pytest.raises(RuntimeError):
        alloc.free(b)


@pytest.mark.parametrize("seed", range(3))
def test_tracked_allocator_matches_jax(seed):
    """The same seeded allocate / reallocate / free sequence through both
    packages: live bytes, peak, capacities and the failures agree."""
    from arrow_go_tpu.memory.buffer import TrackedAllocator as JTracked
    rng = np.random.default_rng(seed)
    ours, theirs = tagt.TrackedAllocator(), JTracked()
    live_o, live_t = [], []
    for _ in range(60):
        op = rng.integers(0, 3)
        if op < 2 or not live_o:
            size = int(rng.integers(0, 300))
            bo, bt = ours.allocate(size), theirs.allocate(size)
            assert (bo.length, bo.capacity) == (bt.length, bt.capacity)
            live_o.append(bo)
            live_t.append(bt)
        else:
            k = int(rng.integers(0, len(live_o)))
            ours.free(live_o.pop(k))
            theirs.free(live_t.pop(k))
        assert ours.allocated_bytes == theirs.allocated_bytes
        assert ours.peak_bytes == theirs.peak_bytes
    for bo, bt in zip(live_o, live_t):
        ours.free(bo)
        theirs.free(bt)
    ours.assert_size(0)
    theirs.assert_size(0)
    with pytest.raises(RuntimeError, match="double free"):
        ours.free(tagt.Buffer(np.zeros(4, np.uint8)))


def test_tracked_allocator_names_the_leak_sites():
    alloc = tagt.TrackedAllocator(record_stacks=True)
    alloc.allocate(10)
    with pytest.raises(AssertionError, match="leaked allocation sites"):
        alloc.assert_size(0)
    alloc.assert_size(10)


def test_buffer_and_allocator_match_jax():
    from arrow_go_tpu.memory import buffer as jbuf
    from arrow_go_tpu_torch.memory import buffer as tbuf
    data = np.arange(37, dtype=np.int32)
    for mod in (jbuf, tbuf):
        b = mod.Buffer.wrap(data)
        assert len(b) == b.length == b.capacity == 148
        assert b.view(np.int32).tolist() == data.tolist()
        s = b.slice(8, 12)
        assert s.view(np.int32).tolist() == [2, 3, 4]
        assert s.to_bytes() == data[2:5].tobytes()
        assert b.equals(mod.Buffer.from_bytes(data.tobytes()))
        assert not b.equals(s)
        assert mod.Buffer(b"abc").to_bytes() == b"abc"
        assert repr(mod.Buffer()) == "Buffer(len=0)"
        a = mod.Allocator()
        x = a.allocate(10)
        assert (x.length, x.capacity) == (10, 64)
        x.raw[:10] = 7
        y = a.reallocate(x, 40)
        assert (y.length, y.capacity) == (40, 64)
        assert np.shares_memory(y.raw, x.raw)
        z = a.reallocate(y, 100)
        assert (z.length, z.capacity) == (100, 128)
        assert z.data[:10].tolist() == [7] * 10
        assert mod.default_allocator.allocate(1).capacity == \
            mod.ALIGNMENT == 64


# ---------------------------------------------------------------------------
# array_equal, array_approx_equal, diff
# ---------------------------------------------------------------------------

def test_array_equal_approx():
    """tests/test_misc_components.py::test_array_equal_approx on the
    port."""
    def a(v, t=None):
        return from_pylist(v, t or tdt.int64)
    f = tdt.float64
    assert array_equal(a([1, None]), a([1, None]))
    assert not array_equal(a([1]), a([2]))
    assert array_approx_equal(a([1.0], f), a([1.0 + 1e-7], f))
    assert not array_approx_equal(a([1.0], f), a([1.1], f))
    nan = float("nan")
    assert array_approx_equal(a([nan], f), a([nan], f), nans_equal=True)
    assert not array_approx_equal(a([nan], f), a([nan], f))


def test_diff_edit_script():
    """tests/test_misc_components.py::test_diff_edit_script on the
    port."""
    base = from_pylist([1, 2, 3, 4], tdt.int64)
    target = from_pylist([1, 3, 4, 5], tdt.int64)
    assert diff(base, target) == [DiffEdit("-", 1, 2), DiffEdit("+", 3, 5)]
    assert diff(base, base) == []
    assert repr(DiffEdit("+", 3, 5)) == repr(JDiffEdit("+", 3, 5))


def _pair(kind, vals):
    jt = getattr(jdt, kind if kind != "bool" else "bool_")
    tt = getattr(tdt, kind if kind != "bool" else "bool_")
    return agt.array(vals, jt), from_pylist(vals, tt)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", KINDS)
def test_compare_and_diff_match_jax(kind, seed):
    rng = np.random.default_rng(400 + seed)
    base = _values(kind, rng, int(rng.integers(0, 12)))
    target = list(base)
    for _ in range(int(rng.integers(0, 5))):      # random edits
        op = rng.integers(0, 3)
        if op == 0 or not target:
            target.insert(int(rng.integers(0, len(target) + 1)),
                          _values(kind, rng, 1)[0])
        elif op == 1:
            del target[int(rng.integers(0, len(target)))]
        else:
            k = int(rng.integers(0, len(target)))
            target[k] = _values(kind, rng, 1)[0]
    if kind == "float64" and target:
        k = int(rng.integers(0, len(target)))
        if target[k] is not None:
            target[k] += float(rng.choice([1e-7, 1e-3, 0.0]))
    jb, tb = _pair(kind, base)
    jt, tt = _pair(kind, target)
    assert array_equal(tb, tt) == j_equal(jb, jt)
    for atol in (1e-5, 1e-2):
        assert array_approx_equal(tb, tt, atol=atol) == \
            j_approx(jb, jt, atol=atol)
    want = j_diff(jb, jt)
    got = diff(tb, tt)
    assert [(e.op, e.index, e.value) for e in got] == \
        [(e.op, e.index, e.value) for e in want]
    # a different type or length is unequal in both packages
    other = "float64" if kind != "float64" else "int64"
    jo, to = _pair(other, [None] * len(base))
    assert array_equal(tb, to) == j_equal(jb, jo) is False
    assert array_approx_equal(tb, to) == j_approx(jb, jo) is False
    assert array_equal(tb, tb.slice(0, max(len(tb) - 1, 0))) == \
        j_equal(jb, jb.slice(0, max(len(jb) - 1, 0)))
