"""K3's module (ops/reductions.py) and the scalar aggregates of the port
against the JAX package.

The JAX reduce runs both ways it runs on the CPU: impl="pallas" (the
TPU kernel in Pallas interpret mode for 32-bit lanes, reduce_xla for
64-bit ones) and impl="xla". The port's reduce runs its plain version
(CPU tensors), the function K3 is held against on the card. Inputs are
padded, with junk in [n, P) (extreme values, NaN and infinities for
floats) and validity bits set there, so only `i < n` keeps them out.
Ints, min and max match bit for bit; float sums and products agree to
rtol=1e-9 (f64, PARITY.md D4) and 1e-5 (f32, tests/test_device_ops.py).
"""
import math

import numpy as np
import pytest
import torch

from arrow_go_tpu.compute import functions as jfn
from arrow_go_tpu.jaxenv import jnp
from arrow_go_tpu.ops import reductions as jred

from arrow_go_tpu_torch.compute import functions as tfn
from arrow_go_tpu_torch.ops import reductions as tred
from arrow_go_tpu_torch.utils.metrics import metrics
from torch_parity import jax_batch, port_batch

DTYPES = ("int32", "int64", "float32", "float64")
OPS = ("sum", "prod", "min", "max")
RTOL = {"float32": 1e-5, "float64": 1e-9}
P = 1024


def _values(rng, dtype: str, op: str, n: int) -> np.ndarray:
    """n values for `op`, then junk up to P."""
    d = np.dtype(dtype)
    if op == "prod":
        # +-1 with a few 2s: products stay exact in every type
        v = rng.choice(np.array([-1, 1], d), n)
        v[rng.choice(n, min(n, 20), replace=False)] = 2
    elif d.kind == "f":
        v = rng.uniform(-50, 100, n).astype(d)
    else:
        info = np.iinfo(d)
        v = rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    if d.kind == "f":
        junk = np.array([np.nan, np.inf, -np.inf, np.finfo(d).max], d)
    else:
        junk = np.array([np.iinfo(d).min, np.iinfo(d).max], d)
    return np.concatenate([v, rng.choice(junk, P - n)])


def _words(rng, n: int, density):
    """Validity words over P rows (bits in [n, P) set), or None."""
    if density is None:
        return None
    bits = rng.random(P) < density
    bits[n:] = True
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _port(vals, words, n, op):
    w = None if words is None else torch.from_numpy(words.view(np.int32))
    return tred.reduce(torch.from_numpy(vals), w, n, op)


def _jax(vals, words, n, op, impl):
    w = None if words is None else jnp.asarray(words)
    return jred.reduce(jnp.asarray(vals), w, n, op, impl=impl)


def _same(got, want, dtype: str, op: str) -> None:
    """Ints, min, max: bit for bit (NaN equals NaN); float sums and
    products: isclose at the type's rtol."""
    got, want = got.item(), float(want) if dtype.startswith("float") \
        else int(want)
    if isinstance(got, float) and math.isnan(got):
        assert math.isnan(want)
    elif dtype.startswith("float") and op in ("sum", "prod"):
        assert np.isclose(got, want, rtol=RTOL[dtype], atol=0)
    else:
        assert got == want


@pytest.mark.parametrize("density", [None, 0.0, 0.5, 1.0])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_matches_jax(rng, dtype, op, density):
    n = 1000
    vals = _values(rng, dtype, op, n)
    words = _words(rng, n, density)
    got = _port(vals, words, n, op)
    int_sum = op == "sum" and not dtype.startswith("float")
    assert got.dtype == (torch.int64 if int_sum else getattr(torch, dtype))
    for impl in ("pallas", "xla"):
        _same(got, _jax(vals, words, n, op, impl), dtype, op)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reduce_nan_propagates_only_from_counted_rows(rng, dtype, op):
    n = 600
    vals = _values(rng, dtype, "sum" if op != "prod" else op, n)
    words = _words(rng, n, 0.5)
    hidden = vals.copy()
    row = int(np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                           bitorder="little")[:n] == 0)[0])
    hidden[row] = np.nan                      # a null row: not counted
    assert not math.isnan(_port(hidden, words, n, op).item())
    shown = vals.copy()
    shown[n // 2] = np.nan
    for w in (None, _words(rng, n, 1.0)):
        got = _port(shown, w, n, op)
        assert math.isnan(got.item())
        for impl in ("pallas", "xla"):
            assert math.isnan(float(_jax(shown, w, n, op, impl)))


def test_reduce_int64_sum_wraps_like_jax():
    vals = np.full(P, 2 ** 62 + 12345, np.int64)
    got = _port(vals, None, 700, "sum")
    want = _jax(vals, None, 700, "sum", "xla")
    assert got.item() == int(want)
    assert got.item() == (700 * (2 ** 62 + 12345) + 2 ** 63) % 2 ** 64 \
        - 2 ** 63


def test_reduce_int32_prod_wraps_like_the_tpu_kernel(rng):
    """int32 products keep int32 (_acc_dtype) and wrap, as the TPU
    kernel does (JAX's XLA path promotes them to int64 instead)."""
    vals = (rng.integers(-2 ** 15, 2 ** 15, P).astype(np.int32) | 1)
    got = _port(vals, None, 900, "prod")
    assert got.dtype == torch.int32
    assert got.item() == int(_jax(vals, None, 900, "prod", "pallas"))


@pytest.mark.parametrize("n", [0, 1, 31, 129, P])
@pytest.mark.parametrize("density", [None, 0.3])
def test_count_valid_and_mean_match_jax(rng, n, density):
    vals = _values(rng, "float64", "sum", n)
    words = _words(rng, n, density)
    w = None if words is None else torch.from_numpy(words.view(np.int32))
    jw = None if words is None else jnp.asarray(words)
    t = torch.from_numpy(vals)
    assert tred.count_valid(t, w, n).item() == \
        int(jred.count_valid(jnp.asarray(vals), jw, n))
    got = tred.mean(t, w, n).item()
    want = float(jred.mean(jnp.asarray(vals), jw, n))
    assert np.isclose(got, want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("n", [0, 1, 777, P])
@pytest.mark.parametrize("density", [None, 0.0, 0.5])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_with_count_matches_jax(rng, dtype, op, density, n):
    """reduce_with_count (its plain version, as on the CPU) against the
    JAX reduce, both ways, and the JAX valid count; density 0.0 is an
    all-null column, n = 0 an empty one."""
    vals = _values(rng, dtype, op, n)
    words = _words(rng, n, density)
    w = None if words is None else torch.from_numpy(words.view(np.int32))
    acc, count = tred.reduce_with_count(torch.from_numpy(vals), w, n, op)
    want_count = int(jred.count_valid(
        jnp.asarray(vals), None if words is None else jnp.asarray(words), n))
    assert count.dtype == torch.int64 and count.item() == want_count
    assert acc.dtype == tred.reduce(torch.from_numpy(vals), w, n, op).dtype
    for impl in ("pallas", "xla"):
        _same(acc, _jax(vals, words, n, op, impl), dtype, op)
    host_acc, host_count = tred.reduce_with_count_host(
        torch.from_numpy(vals), w, n, op)
    assert host_count == want_count and type(host_count) is int
    assert host_acc == acc.item() or (math.isnan(host_acc)
                                      and math.isnan(acc.item()))


def test_reduce_with_count_takes_the_plain_version_on_cpu(rng):
    """A CPU tensor never reaches K3: the launch count stays put."""
    vals = _values(rng, "float64", "sum", 500)
    before = metrics.counter("kernel.K3")
    tred.reduce_with_count(torch.from_numpy(vals), None, 500, "sum")
    tred.reduce_with_count_host(torch.from_numpy(vals), None, 500, "max")
    assert metrics.counter("kernel.K3") == before


def test_reduce_wrapper_raises_on_what_k3_does_not_take():
    """The CUDA wrapper's checks, which run before any launch, and the
    op and type checks every path shares."""
    x = torch.arange(64, dtype=torch.int64)
    words = torch.zeros(2, dtype=torch.int32)
    bad = [
        (torch.arange(128)[::2], None, 64, "sum"),             # strided
        (x, words.to(torch.int64), 64, "sum"),                 # word type
        (x, torch.zeros(4, dtype=torch.int32)[::2], 64, "sum"),
        (x, torch.zeros(1, dtype=torch.int32), 64, "sum"),     # too few
        (x, words, 64, "mean"),                                # op
        (x.to(torch.int16), None, 64, "sum"),                  # value type
        (x.reshape(8, 8), None, 64, "sum"),                    # not 1-D
    ]
    for args in bad:
        with pytest.raises(ValueError, match="reduce"):
            tred._reduce_cuda(*args)
    for op, vals in (("mean", x), ("sum", x.to(torch.uint8))):
        with pytest.raises(ValueError, match="reduce"):
            tred.reduce_with_count(vals, None, 64, op)


# ---------------------------------------------------------------------------
# scalar aggregates on DeviceColumns
# ---------------------------------------------------------------------------

def _columns(rng, dtype: str, case: str):
    """(values, mask or None) of one aggregate case."""
    n = {"empty": 0}.get(case, 777)
    d = np.dtype(dtype)
    v = rng.integers(-10 ** 6, 10 ** 6, n).astype(d) if d.kind == "i" \
        else rng.standard_normal(n).astype(d)
    mask = {"required": None, "nullable": rng.random(n) < 0.7,
            "all_null": np.zeros(n, np.bool_), "empty": None}[case]
    return v, mask


AGGS = {
    "sum": (tfn.agg_sum, jfn.agg_sum),
    "min": (tfn.agg_min, jfn.agg_min),
    "max": (tfn.agg_max, jfn.agg_max),
    "mean": (tfn.agg_mean, jfn.agg_mean),
    "count_only_valid": (lambda c: tfn.agg_count(c, tfn.CountOptions()),
                         lambda c: jfn.agg_count(c, jfn.CountOptions())),
    "count_only_null": (
        lambda c: tfn.agg_count(c, tfn.CountOptions("only_null")),
        lambda c: jfn.agg_count(c, jfn.CountOptions("only_null"))),
    "count_all": (lambda c: tfn.agg_count(c, tfn.CountOptions("all")),
                  lambda c: jfn.agg_count(c, jfn.CountOptions("all"))),
    "min_max": (tfn.min_max, jfn.min_max),
}


@pytest.mark.parametrize("case", ["required", "nullable", "all_null",
                                  "empty"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("agg", sorted(AGGS))
def test_aggregates_match_jax(rng, agg, dtype, case):
    v, mask = _columns(rng, dtype, case)
    jdb = jax_batch({"x": v}, {"x": mask} if mask is not None else None)
    tcol = port_batch(jdb).column("x")
    port_fn, jax_fn = AGGS[agg]
    got, want = port_fn(tcol), jax_fn(jdb.column("x"))
    if agg == "min_max":
        got, want = (got["min"], got["max"]), (want["min"], want["max"])
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif agg in ("sum", "mean") and dtype.startswith("float"):
            assert np.isclose(g, w, rtol=RTOL[dtype], atol=0)
        else:
            assert type(g) is type(w) and g == w
    if case in ("all_null", "empty") and agg in ("sum", "min", "max",
                                                 "mean"):
        assert got == (None,)


def test_aggregates_count_valid_rows_only():
    vals = np.arange(10, dtype=np.int64)
    mask = vals % 3 != 0
    tcol = port_batch(jax_batch({"x": vals}, {"x": mask})).column("x")
    assert tfn.agg_sum(tcol) == int(vals[mask].sum())
    assert tfn.min_max(tcol) == {"min": 1, "max": 8}
    assert tfn.agg_count(tcol) == 6
    assert tfn.agg_count(tcol, tfn.CountOptions("only_null")) == 4


# F8, F9: the scalar aggregates of narrow and unsigned types read them as
# the JAX package does (its accumulators, its result values and types)

def _narrow_column(rng, dtype, n=61):
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    info = np.iinfo(dtype)
    v = rng.integers(max(info.min, -100), min(info.max, 100), n).astype(dtype)
    if dtype == np.uint32:
        v[:3] = [2 ** 32 - 1, 2 ** 32 - 2, 2 ** 31 + 5]
    if dtype == np.uint64:
        v[:3] = [2 ** 64 - 1, 2 ** 63 + 1, 2 ** 63 - 1]
    return v


AGG_FNS = ["agg_sum", "agg_mean", "agg_min", "agg_max", "agg_product",
           "min_max", "agg_variance", "agg_stddev"]


# the JAX package has no min or max of bool
@pytest.mark.parametrize("dtype,fn", [
    (d, f) for d in (np.bool_, np.int8, np.int16, np.uint8, np.uint16,
                     np.uint32, np.uint64, np.float16) for f in AGG_FNS
    if not (d == np.bool_ and f in ("agg_min", "agg_max", "min_max"))])
def test_narrow_and_unsigned_aggregates_match_jax(rng, dtype, fn):
    v = _narrow_column(rng, dtype)
    jdb = jax_batch({"v": v}, {"v": rng.random(len(v)) > 0.2})
    want = getattr(jfn, fn)(jdb.column("v"))
    got = getattr(tfn, fn)(port_batch(jdb).column("v"))
    pairs = list(zip(got.values(), want.values())) if fn == "min_max" \
        else [(got, want)]
    for g, w in pairs:
        assert type(g) is type(w), (g, w)
        if isinstance(w, float) and (fn in ("agg_variance", "agg_stddev")
                                     or dtype == np.float16):
            # order of addition: float64 at 1e-9, float16's float32 sums
            # at 1e-5
            tol = 1e-5 if dtype == np.float16 and fn in (
                "agg_sum", "agg_mean", "agg_product") else 1e-9
            assert math.isclose(g, w, rel_tol=tol), (g, w)
        else:
            assert g == w


def test_uint32_sum_reads_unsigned_like_jax(rng):
    """F9's example: 2**32 - 1, 2**32 - 2 and 5 sum to 8589934594 (the
    signed storage gave 2)."""
    v = np.array([2 ** 32 - 1, 2 ** 32 - 2, 5], np.uint32)
    jdb = jax_batch({"v": v})
    assert jfn.agg_sum(jdb.column("v")) == 8589934594
    assert tfn.agg_sum(port_batch(jdb).column("v")) == 8589934594


def test_int8_sum_widens_like_jax():
    """F8's example: an int8 column sums in int64."""
    v = np.array([100, 100, 100, -41], np.int8)
    jdb = jax_batch({"v": v})
    assert tfn.agg_sum(port_batch(jdb).column("v")) == \
        jfn.agg_sum(jdb.column("v")) == 259
