"""Decimals in the port against the JAX package, on the CPU.

ops/decimal.py bit for bit against arrow_go_tpu/ops/decimal.py on random
full-width limbs (zero, -1, the extremes, carries and wraps), and
against Python integers mod 2**(64k); `_decimal_binary` through
`arithmetic_binary` and `compare` (mixed scales, mixed 128/256 widths,
int and Decimal scalars on either side); filter, take and sort_indices
of limb columns with nulls; decimal32 / decimal64 arithmetic,
aggregates, set lookups and group-by, each JAX quirk matched; the raises
where the JAX package fails; the string <-> decimal host casts; and a
Decimal literal in an expression. Every port call runs on the CPU."""
import decimal

import numpy as np
import pytest
import torch

import arrow_go_tpu as agt
import arrow_go_tpu.compute as jpc
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import kernels as jk
from arrow_go_tpu.compute import registry as jreg
from arrow_go_tpu.compute.groupby import group_by as jgroup_by
from arrow_go_tpu.device.block import DeviceBatch as JaxBatch
from arrow_go_tpu.device.block import DeviceColumn as JaxColumn
from arrow_go_tpu.device.block import _pack_words, from_device, to_device
from arrow_go_tpu.jaxenv import jnp
from arrow_go_tpu.ops import decimal as jdec

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute import functions as tf
from arrow_go_tpu_torch.compute import kernels as tk
from arrow_go_tpu_torch.compute import registry as treg
from arrow_go_tpu_torch.device.block import (DeviceBatch, DeviceColumn,
                                             HostArray, column_to_host,
                                             pad_length)
from arrow_go_tpu_torch.ops import decimal as tdec
from torch_parity import jax_type, port_batch, port_type

D = decimal.Decimal
N = 300
SPECIAL = np.array([0, 1, 2**64 - 1, 2**63, 2**63 - 1, 2**32, 2**32 - 1],
                   np.uint64)


def _limbs(rng, n: int, k: int) -> np.ndarray:
    """Random full-width uint64 limbs, the first rows the special ones."""
    a = rng.integers(0, 2**64, (n, k), dtype=np.uint64, endpoint=False)
    a[:64] = SPECIAL[rng.integers(0, len(SPECIAL), (64, k))]
    return a


def _small(rng, n: int, k: int, digits: int = 15) -> np.ndarray:
    """TPC-H-sized signed values as limbs."""
    return tdec.from_ints(rng.integers(-10**digits, 10**digits, n).tolist(),
                          k).view(np.uint64)


def _columns(limbs: np.ndarray, mask, t):
    """(JAX DeviceColumn, port DeviceColumn) holding the same padded limbs
    and validity words."""
    n, k = limbs.shape
    P = pad_length(n)
    vals = np.zeros((P, k), np.uint64)
    vals[:n] = limbs
    words = None if mask is None else _pack_words(mask, P)
    jc = JaxColumn(jnp.asarray(vals), None if words is None
                   else jnp.asarray(words), n, jax_type(t))
    tc = DeviceColumn(torch.from_numpy(vals.view(np.int64).copy()),
                      None if words is None
                      else torch.from_numpy(words.view(np.int32).copy()),
                      n, t)
    return jc, tc


def _same(tc: DeviceColumn, jc: JaxColumn) -> None:
    """Type, length, padding, validity words and the valid rows' values,
    bit for bit (limbs as their u64 bits)."""
    assert str(tc.type) == str(jc.type)
    assert (tc.length, tc.padded) == (jc.length, jc.padded)
    assert (tc.validity is None) == (jc.validity is None)
    n = jc.length
    ok = np.ones(n, np.bool_)
    if jc.validity is not None:
        np.testing.assert_array_equal(tc.validity.numpy().view(np.uint32),
                                      np.asarray(jc.validity))
        ok = np.asarray(jc.validity_mask())[:n]
    got = tc.values[:n].numpy()
    want = np.asarray(jc.values)[:n]
    if want.dtype == np.uint64:
        got = got.view(np.uint64)
    else:
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(got[ok], want[ok])


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

TYPES = [dt.decimal32(9, 2), dt.decimal64(18, 4), dt.decimal128(38, 10),
         dt.decimal256(76, 0), dt.decimal128(15, 2),
         dt.fixed_size_binary(12)]


@pytest.mark.parametrize("t", TYPES, ids=str)
def test_type_matches_jax(t):
    jt = jax_type(t)
    assert (int(t.id), t.name, str(t), t.bit_width, t.is_decimal) == (
        int(jt.id), jt.name, str(jt), jt.bit_width, jt.is_decimal)
    if t.is_decimal:
        assert (t.precision, t.scale) == (jt.precision, jt.scale)
        assert t.limbs == (t.bit_width // 64 if t.bit_width > 64 else 0)
    assert dt.type_for_name(str(t)) == t == port_type(jt)


@pytest.mark.parametrize("make,p", [(dt.decimal32, 10), (dt.decimal64, 19),
                                    (dt.decimal128, 39), (dt.decimal256, 77),
                                    (dt.decimal128, 0)])
def test_precision_out_of_range_raises_as_jax(make, p):
    with pytest.raises(ValueError):
        getattr(jdt, make.__name__)(p, 0)
    with pytest.raises(ValueError):
        make(p, 0)


# ---------------------------------------------------------------------------
# ops/decimal.py
# ---------------------------------------------------------------------------

BINARY_N = ["addn", "subn", "muln", "cmpn"]
BINARY_128 = ["add128", "sub128", "mul128", "cmp128"]


def _as_bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


@pytest.mark.parametrize("fn,k", [(f, k) for f in BINARY_N for k in (2, 4)]
                         + [(f, 2) for f in BINARY_128])
def test_limb_binary_op_matches_jax(fn, k):
    rng = np.random.default_rng(7 + k)
    a, b = _limbs(rng, 4000, k), _limbs(rng, 4000, k)
    b[64:128] = a[64:128]                      # equal rows for the compares
    want = getattr(jdec, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tdec, fn)(torch.from_numpy(a.view(np.int64)),
                            torch.from_numpy(b.view(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _as_bits(want))


UNARY_N = [("negn", None), ("shln_1", 0), ("shln_1", 1), ("shln_1", 3),
           ("shln_1", 33), ("shln_1", 63), ("scale_by_pow10_n", 0),
           ("scale_by_pow10_n", 1), ("scale_by_pow10_n", 7),
           ("is_negative_n", None)]
UNARY_128 = [("neg128", None), ("is_negative", None), ("scale_by_pow10", 4)]


@pytest.mark.parametrize("fn,arg,k", [f + (k,) for f in UNARY_N
                                      for k in (2, 4)]
                         + [f + (2,) for f in UNARY_128])
def test_limb_unary_op_matches_jax(fn, arg, k):
    rng = np.random.default_rng(11 + k)
    a = _limbs(rng, 4000, k)
    args = () if arg is None else (arg,)
    want = getattr(jdec, fn)(jnp.asarray(a), *args)
    got = getattr(tdec, fn)(torch.from_numpy(a.view(np.int64)), *args)
    np.testing.assert_array_equal(got.numpy(), _as_bits(want))


@pytest.mark.parametrize("k", [2, 4])
def test_from_int64_matches_jax(k):
    rng = np.random.default_rng(3)
    v = rng.integers(-2**63, 2**63, 3000, dtype=np.int64)
    v[:3] = [0, -1, -2**63]
    want = jdec.from_int64_n(jnp.asarray(v), k)
    got = tdec.from_int64_n(torch.from_numpy(v), k)
    np.testing.assert_array_equal(got.numpy(), _as_bits(want))
    if k == 2:
        np.testing.assert_array_equal(
            tdec.from_int64(torch.from_numpy(v)).numpy(),
            _as_bits(jdec.from_int64(jnp.asarray(v))))


@pytest.mark.parametrize("k", [2, 4])
def test_limb_ops_hold_python_ints(k):
    """addn, subn, muln, negn and cmpn against Python integers mod
    2**(64k): every carry, borrow and wrap of the random limbs."""
    rng = np.random.default_rng(5 + k)
    a, b = _limbs(rng, 3000, k), _limbs(rng, 3000, k)
    ia, ib = tdec.to_ints(a), tdec.to_ints(b)
    np.testing.assert_array_equal(tdec.from_ints(ia, k), a.view(np.int64))
    M = 1 << (64 * k)
    ta, tb = (torch.from_numpy(x.view(np.int64)) for x in (a, b))

    def ints(t):
        return [x % M for x in tdec.to_ints(t.numpy())]

    assert ints(tdec.addn(ta, tb)) == [(x + y) % M for x, y in zip(ia, ib)]
    assert ints(tdec.subn(ta, tb)) == [(x - y) % M for x, y in zip(ia, ib)]
    assert ints(tdec.muln(ta, tb)) == [(x * y) % M for x, y in zip(ia, ib)]
    assert ints(tdec.negn(ta)) == [(-x) % M for x in ia]
    assert tdec.cmpn(ta, tb).tolist() == [(x > y) - (x < y)
                                          for x, y in zip(ia, ib)]


# ---------------------------------------------------------------------------
# decimal128 / decimal256 kernels
# ---------------------------------------------------------------------------

CASES = {
    # name: (left type, right type or a scalar, left on the right)
    "same": (dt.decimal128(38, 2), dt.decimal128(38, 2), False),
    "scales": (dt.decimal128(20, 2), dt.decimal128(30, 5), False),
    "widths": (dt.decimal128(38, 3), dt.decimal256(60, 1), False),
    "wide": (dt.decimal256(76, 4), dt.decimal256(70, 4), False),
    "int": (dt.decimal128(15, 2), 7, False),
    "int_left": (dt.decimal256(40, 3), -3, True),
    "decimal": (dt.decimal128(15, 2), D("-12.345"), False),
    "decimal_left": (dt.decimal128(15, 4), D("0.055"), True),
}
OPS = ["add", "subtract", "multiply", "equal", "not_equal", "less",
       "less_equal", "greater", "greater_equal"]


def _operands(case: str, full: bool):
    ta, tb, left = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case) + 60)
    make = _limbs if full else _small
    ja, pa = _columns(make(rng, N, ta.limbs), rng.random(N) < 0.85, ta)
    if isinstance(tb, dt.DataType):
        limbs = make(rng, N, tb.limbs)
        limbs[:40] = np.pad(np.asarray(ja.values)[:40],
                            ((0, 0), (0, tb.limbs - ta.limbs)))
        jb, pb = _columns(limbs, rng.random(N) < 0.85, tb)
    else:
        jb = pb = tb
    return ((jb, ja), (pb, pa)) if left else ((ja, jb), (pa, pb))


@pytest.mark.parametrize("full", [True, False], ids=["full", "tpch"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("op", OPS)
def test_decimal_binary_matches_jax(op, case, full):
    (ja, jb), (pa, pb) = _operands(case, full)
    fn = (jk.compare, tk.compare) if op in tk._COMPARE else \
        (jk.arithmetic_binary, tk.arithmetic_binary)
    want = fn[0](op, ja, jb)
    got = fn[1](op, pa, pb)
    _same(got, want)


@pytest.mark.parametrize("args", [
    ("divide", "col", "col"), ("divide", "col", 2), ("add", "col", "i64"),
    ("add", "col", 0.5), ("less", "i64", "col"), ("power", "col", "col")])
def test_decimal_binary_raises_as_jax(args):
    op, x, y = args
    rng = np.random.default_rng(2)
    jc, pc_ = _columns(_small(rng, N, 2), None, dt.decimal128(15, 2))
    ji = to_device(agt.from_numpy(np.arange(N, dtype=np.int64)))
    pi = DeviceColumn(torch.arange(pad_length(N)), None, N, dt.int64)
    pick = {"col": (jc, pc_), "i64": (ji, pi)}
    jx, tx = pick.get(x, (x, x))
    jy, ty = pick.get(y, (y, y))
    fn = (jk.compare, tk.compare) if op in tk._COMPARE else \
        (jk.arithmetic_binary, tk.arithmetic_binary)
    with pytest.raises(jpc.ArrowNotImplemented):
        fn[0](op, jx, jy)
    with pytest.raises(pc.ArrowNotImplemented):
        fn[1](op, tx, ty)


def test_decimal_literal_in_an_expression_matches_jax():
    rng = np.random.default_rng(4)
    ja, pa = _columns(_small(rng, N, 2, 3), rng.random(N) < 0.9,
                      dt.decimal128(15, 2))
    from arrow_go_tpu.compute.expression import field as jfield
    from arrow_go_tpu.compute.expression import execute_scalar_expression
    jdb = _jax_batch_of({"d": ja})
    want = execute_scalar_expression(
        (jfield("d") >= D("0.06")) & (jfield("d") * 2 < D("9.99")), jdb)
    tdb = DeviceBatch(dt.Schema([dt.Field("d", pa.type)]), [pa], N)
    got = pc.execute_scalar_expression(pc.call("and_kleene", [
        pc.call("greater_equal", [pc.field("d"), D("0.06")]),
        pc.call("less", [pc.call("multiply", [pc.field("d"), 2]),
                         D("9.99")])]), tdb)
    ok = np.asarray(want.validity_mask())[:N] if want.validity is not None \
        else np.ones(N, bool)
    np.testing.assert_array_equal(got.validity_mask()[:N].numpy(), ok)
    np.testing.assert_array_equal(got.values[:N].numpy()[ok],
                                  np.asarray(want.values)[:N][ok])


def _jax_batch_of(cols: dict) -> JaxBatch:
    from arrow_go_tpu.dtypes import Field, Schema
    return JaxBatch(Schema([Field(k, c.type) for k, c in cols.items()]),
                    list(cols.values()), next(iter(cols.values())).length)


# ---------------------------------------------------------------------------
# selection and sort of limb columns
# ---------------------------------------------------------------------------

def _batch(rng):
    """Port DeviceBatch and the JAX columns of decimal128, decimal256 and
    int64 columns with nulls."""
    cols = {}
    for name, t in (("a", dt.decimal128(38, 2)), ("b", dt.decimal256(60, 3))):
        cols[name] = _columns(_limbs(rng, N, t.limbs), rng.random(N) < 0.85,
                              t)
    iv = rng.integers(-50, 50, N)
    cols["i"] = (to_device(agt.from_numpy(iv)),
                 DeviceColumn(torch.from_numpy(np.pad(iv, (0, pad_length(N)
                                                           - N))),
                              None, N, dt.int64))
    tdb = DeviceBatch(dt.Schema([dt.Field(k, c[1].type)
                                 for k, c in cols.items()]),
                      [c[1] for c in cols.values()], N)
    return cols, tdb


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_filter_of_limb_columns_matches_jax(null_selection):
    rng = np.random.default_rng(8)
    cols, tdb = _batch(rng)
    mvals = rng.random(N) < 0.4
    mmask = rng.random(N) < 0.9
    jm = to_device(agt.from_numpy(mvals, mmask))
    tm = DeviceColumn(torch.from_numpy(np.asarray(jm.values).copy()),
                      torch.from_numpy(np.asarray(jm.validity).view(
                          np.int32).copy()), N, dt.bool_)
    # the JAX package's DeviceBatch filter fails on a limb matrix's shape
    # (its compaction takes 1-D payloads); its Array filter gathers
    with pytest.raises(TypeError):
        jf.filter_(_jax_batch_of({k: c[0] for k, c in cols.items()}), jm)
    opts = tf.FilterOptions(null_selection)
    got = tf.filter_(tdb, tm, opts)
    for k, (jc, _) in cols.items():
        want = jf.filter_(from_device(jc), from_device(jm),
                          jf.FilterOptions(null_selection))
        g = column_to_host(got.column(k))
        assert g.to_pylist() == want.to_pylist(), k
        assert got.length == len(want)


def test_take_of_limb_columns_matches_jax():
    rng = np.random.default_rng(9)
    cols, _ = _batch(rng)
    idx = rng.integers(0, N, 200)
    imask = rng.random(200) < 0.9
    ji = to_device(agt.from_numpy(idx, imask))
    ti = DeviceColumn(torch.from_numpy(np.asarray(ji.values).copy()),
                      torch.from_numpy(np.asarray(ji.validity).view(
                          np.int32).copy()), 200, dt.int64)
    for k in ("a", "b"):
        jc, tc = cols[k]
        want = jf.take(from_device(jc), from_device(ji))
        got = tf.take(tc, ti)
        assert column_to_host(got).to_pylist() == want.to_pylist()
        host = tf.take(column_to_host(tc), column_to_host(ti))
        assert host.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("where", ["device", "host"])
@pytest.mark.parametrize("null_placement", ["at_end", "at_start"])
@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("t", [dt.decimal128(38, 2), dt.decimal256(70, 1)],
                         ids=str)
def test_sort_indices_of_limbs_matches_jax(t, order, null_placement, where):
    rng = np.random.default_rng(10)
    limbs = _limbs(rng, N, t.limbs)
    limbs[100:160] = limbs[:60]                  # ties keep their order
    jc, tc = _columns(limbs, rng.random(N) < 0.85, t)
    opts = jf.SortOptions([jf.SortKey(0, order)], null_placement)
    want = np.asarray(jf.sort_indices(from_device(jc), opts).to_numpy())
    topts = tf.SortOptions([tf.SortKey(0, order)], null_placement)
    arg = tc if where == "device" else column_to_host(tc)
    got = tf.sort_indices(arg, topts)
    got = got.values[:N].numpy() if where == "device" else got.values
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# decimal32 / decimal64: the integer path and its quirks
# ---------------------------------------------------------------------------

NARROW = [dt.decimal32(7, 2), dt.decimal64(15, 2)]


def _narrow(t, rng, n=N, lo=-5000, hi=5000):
    v = rng.integers(lo, hi, n).astype(t.np_dtype)
    mask = rng.random(n) < 0.85
    jarr = agt.from_numpy(v, mask, jax_type(t))
    return to_device(jarr), tf.host_array_to_device(HostArray(v, mask, t),
                                                     "cpu")


@pytest.mark.parametrize("rhs", ["col", 3, -7])
@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide",
                                "less", "greater_equal"])
@pytest.mark.parametrize("t", NARROW, ids=str)
def test_narrow_decimal_arithmetic_matches_jax(t, op, rhs):
    """decimal32 / decimal64 run as their unscaled ints: an int scalar is
    unscaled, a product keeps the operand type (1.25 * 0.05 = 6.25).
    The JAX divide leaves float64 quotients in a decimal column, which
    truncate toward zero on the way to the host; the port's divide
    truncates on the device: the host values agree."""
    rng = np.random.default_rng(12)
    ja, pa = _narrow(t, rng)
    if rhs == "col":
        jb, pb = _narrow(t, rng, lo=1, hi=90)
    else:
        jb = pb = rhs
    fn = (jk.compare, tk.compare) if op in tk._COMPARE else \
        (jk.arithmetic_binary, tk.arithmetic_binary)
    want = fn[0](op, ja, jb, **({} if op in tk._COMPARE
                                else {"checked": False}))
    got = fn[1](op, pa, pb, **({} if op in tk._COMPARE
                               else {"checked": False}))
    assert str(got.type) == str(want.type)
    assert column_to_host(got).to_pylist() == from_device(want).to_pylist()
    if op != "divide":
        _same(got, want)


@pytest.mark.parametrize("t", NARROW, ids=str)
def test_narrow_decimal_scalar_raises_as_jax(t):
    ja, pa = _narrow(t, np.random.default_rng(1))
    with pytest.raises(TypeError):
        jk.arithmetic_binary("add", ja, D("0.02"))
    with pytest.raises(TypeError):
        tk.arithmetic_binary("add", pa, D("0.02"))


AGGS = ["agg_sum", "agg_min", "agg_max", "agg_mean", "agg_product",
        "agg_count", "agg_count_distinct", "agg_variance", "min_max"]


@pytest.mark.parametrize("fn", AGGS)
@pytest.mark.parametrize("t", NARROW, ids=str)
def test_narrow_decimal_aggregates_match_jax(t, fn):
    """agg_sum, min and max give the unscaled int, mean and variance an
    unscaled float, product the integer product (JAX quirks)."""
    ja, pa = _narrow(t, np.random.default_rng(13), n=40, lo=-9, hi=9)
    want = getattr(jf, fn)(ja)
    got = getattr(tf, fn)(pa)
    assert type(got) is type(want)
    if isinstance(want, float):        # (a sum in another order)
        assert got == pytest.approx(want, rel=1e-12)
    else:
        assert got == want


@pytest.mark.parametrize("t", NARROW, ids=str)
def test_narrow_decimal_group_by_matches_jax(t):
    """A decimal key and decimal values: sum, min, max, first and last
    typed as the decimal, mean an unscaled float, product the integer
    product typed as the decimal."""
    rng = np.random.default_rng(14)
    kv = rng.integers(-3, 3, N).astype(t.np_dtype) * 25
    vv = rng.integers(-99, 99, N).astype(t.np_dtype)
    km, vm = rng.random(N) < 0.9, rng.random(N) < 0.9
    data = {"k": (kv, km), "v": (vv, vm)}
    jdb = _jax_batch_of({k: to_device(agt.from_numpy(v, m, jax_type(t)))
                         for k, (v, m) in data.items()})
    tdb = port_batch(jdb)
    aggs = [("v", a) for a in ("sum", "min", "max", "count", "count_all",
                               "mean", "first", "last")]
    want = jgroup_by(jdb, "k", aggs)
    got = pc.group_by(tdb, "k", aggs)
    assert [str(f.type) for f in got.schema.fields] == [
        str(f.type) for f in want.schema.fields]
    assert got.to_pydict() == want.to_pydict()
    small = {"v": (rng.integers(-3, 4, N).astype(t.np_dtype), vm),
             "k": (kv, km)}
    jdb = _jax_batch_of({k: to_device(agt.from_numpy(v, m, jax_type(t)))
                         for k, (v, m) in small.items()})
    got = pc.group_by(port_batch(jdb), "k", [("v", "product")])
    assert got.to_pydict() == jgroup_by(jdb, "k", [("v", "product")]
                                        ).to_pydict()


@pytest.mark.parametrize("vset", [[D("0.25"), None, D("-0.50")], [25, -50],
                                  [0.25, D("1.00")]], ids=str)
@pytest.mark.parametrize("fn", ["is_in", "index_in"])
@pytest.mark.parametrize("t", NARROW, ids=str)
def test_narrow_decimal_set_lookup_matches_jax(t, fn, vset):
    """The value set becomes an array of the column's type: a Decimal
    scales, an int is unscaled, a float rounds."""
    ja, pa = _narrow(t, np.random.default_rng(15), lo=-60, hi=60)
    want = getattr(jf, fn)(ja, value_set=vset)
    got = getattr(tf, fn)(pa, value_set=vset)
    assert column_to_host(got).to_pylist() == from_device(want).to_pylist()


def test_wide_decimal_index_in_matches_jax():
    """index_in of a decimal128 column looks rows up by value (the JAX
    package's host lookup)."""
    rng = np.random.default_rng(16)
    ja, pa = _columns(_small(rng, N, 2, 2), rng.random(N) < 0.9,
                      dt.decimal128(15, 2))
    vals = from_device(ja).to_pylist()
    vset = [vals[3], None, D("0.07"), vals[9], vals[3]]
    want = jf.index_in(ja, value_set=vset)
    got = tf.index_in(pa, value_set=vset)
    assert column_to_host(got).to_pylist() == from_device(want).to_pylist()
    assert tf.agg_count(pa) == jf.agg_count(ja)


# ---------------------------------------------------------------------------
# where the JAX package fails on a limb matrix, the port refuses
# ---------------------------------------------------------------------------

REFUSED = ["agg_sum", "agg_min", "agg_max", "agg_mean", "agg_product",
           "agg_variance", "agg_count_distinct", "min_max", "unique",
           "dictionary_encode", "is_in", "group_by_value", "group_by_key"]


@pytest.mark.parametrize("fn", REFUSED)
@pytest.mark.parametrize("t", [dt.decimal128(15, 2), dt.decimal256(40, 2)],
                         ids=str)
def test_wide_decimal_refusals_where_jax_fails(t, fn):
    rng = np.random.default_rng(17)
    ja, pa = _columns(_small(rng, N, t.limbs, 3), rng.random(N) < 0.9, t)
    ji = to_device(agt.from_numpy(np.arange(N, dtype=np.int64) % 3))
    pi = DeviceColumn(torch.arange(pad_length(N)) % 3, None, N, dt.int64)
    if fn.startswith("group_by"):
        jdb = _jax_batch_of({"d": ja, "i": ji})
        tdb = DeviceBatch(dt.Schema([dt.Field("d", t),
                                     dt.Field("i", dt.int64)]), [pa, pi], N)
        key, val = ("d", "i") if fn == "group_by_key" else ("i", "d")
        with pytest.raises((TypeError, ValueError)):
            jgroup_by(jdb, key, [(val, "sum")])
        with pytest.raises(pc.ArrowNotImplemented):
            pc.group_by(tdb, key, [(val, "sum")])
        return
    kw = {"value_set": [D("1.00")]} if fn == "is_in" else {}
    with pytest.raises((TypeError, ValueError)):
        getattr(jf, fn)(ja, **kw)
    with pytest.raises(pc.ArrowNotImplemented):
        getattr(tf, fn)(pa, **kw)


# ---------------------------------------------------------------------------
# casts: string <-> decimal on the host, nothing else
# ---------------------------------------------------------------------------

STRINGS = ["1.25", "-0.05", "123456.10", "0", "-7", "3.1"]


def _string_arrays(strs, mask):
    jarr = agt.array([s if ok else None for s, ok in zip(strs, mask)])
    from arrow_go_tpu_torch.device.block import factorize
    vals = np.array(strs, dtype=object)
    codes, dictionary = factorize(vals, mask)
    return jarr, HostArray(codes, None if mask.all() else mask,
                           dt.dictionary(dt.int32, dt.string), dictionary)


@pytest.mark.parametrize("name", ["cast", "cast_decimal", "cast_decimal256"])
@pytest.mark.parametrize("t", [dt.decimal128(20, 2), dt.decimal64(15, 3),
                               dt.decimal32(8, 2), dt.decimal256(50, 4)],
                         ids=str)
def test_string_decimal_casts_match_jax(t, name):
    mask = np.array([True, True, True, False, True, True])
    jarr, tarr = _string_arrays(STRINGS, mask)
    jo = {"to_type": jax_type(t)}
    to = {"to_type": t}
    want = jreg.call_function(name, [jarr], jo)
    got = treg.call_function(name, [tarr], to, device="cpu")
    assert str(got.type) == str(want.type)
    assert got.to_pylist() == want.to_pylist()
    # and back to strings, from the host array and from the device
    back_w = jreg.call_function("cast", [want], {"to_type": jdt.string})
    back_g = treg.call_function("cast", [got], {"to_type": dt.string},
                                device="cpu")
    assert back_g.to_pylist() == back_w.to_pylist()
    dev = tf.host_array_to_device(got, "cpu")
    from_dev = treg.call_function("cast", [dev], {"to_type": dt.string},
                                  device="cpu")
    assert from_dev.to_pylist() == back_w.to_pylist()


def test_decimal_cast_raises_as_jax():
    mask = np.ones(2, np.bool_)
    jarr, tarr = _string_arrays(["1.255", "2"], mask)
    t = dt.decimal128(10, 2)
    with pytest.raises(ValueError):                  # more digits than 2
        jreg.call_function("cast", [jarr], {"to_type": jax_type(t)})
    with pytest.raises(ValueError):
        treg.call_function("cast", [tarr], {"to_type": t}, device="cpu")
    jarr, tarr = _string_arrays(["12345678901.10"], mask[:1])
    t32 = dt.decimal32(9, 2)                          # past int32
    with pytest.raises(OverflowError):
        jreg.call_function("cast", [jarr], {"to_type": jax_type(t32)})
    with pytest.raises(OverflowError):
        treg.call_function("cast", [tarr], {"to_type": t32}, device="cpu")
    rng = np.random.default_rng(18)
    ja, pa = _columns(_small(rng, N, 2, 3), None, t)
    for to in (dt.int64, dt.float64, dt.decimal128(12, 3)):
        with pytest.raises(jpc.ArrowNotImplemented):
            jreg.call_function("cast", [ja], {"to_type": jax_type(to)})
        with pytest.raises(pc.ArrowNotImplemented):
            treg.call_function("cast", [pa], {"to_type": to},
                               device="cpu")
    ji = to_device(agt.from_numpy(np.arange(4, dtype=np.int64)))
    pi = DeviceColumn(torch.arange(128), None, 4, dt.int64)
    with pytest.raises(jpc.ArrowNotImplemented):
        jreg.call_function("cast", [ji], {"to_type": jax_type(t)})
    with pytest.raises(pc.ArrowNotImplemented):
        treg.call_function("cast", [pi], {"to_type": t}, device="cpu")


def test_host_array_decimals_are_python_decimals():
    t = dt.decimal256(76, 5)
    ints = [0, -1, 10**70, -(10**75) + 3, 12345]
    arr = HostArray(tdec.from_ints(ints, 4), np.array([1, 1, 1, 1, 0], bool),
                    t)
    assert arr.unscaled() == ints
    want = [D(v).scaleb(-5, decimal.Context(prec=80)) for v in ints[:4]]
    assert arr.to_pylist() == want + [None]
