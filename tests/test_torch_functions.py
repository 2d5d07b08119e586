"""The port's scalar kernels, expression branches, vector hash, set
lookup and scalar aggregates against the JAX package, on the CPU.

Inputs are seeded numpy columns with nulls, held by both packages
bit for bit (torch_parity). Ints, bools, codes and validity words must
match exactly. Floats from an elementwise kernel agree to rtol 1e-12
(float64) and 1e-5 (float32), NaN where JAX has NaN: torch and XLA
evaluate transcendental functions with their own code; and a denormal
result may be zero in the JAX package, whose XLA flushes denormals to
zero on the CPU. Float sums,
products and variances agree to rtol 1e-9 (order of addition).
"""
import numpy as np
import pytest
import torch

import arrow_go_tpu.compute as jpc
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import kernels as jk
from arrow_go_tpu.device.block import from_device

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.compute import kernels
from arrow_go_tpu_torch.device.block import DeviceColumn, column_to_host
from torch_parity import jax_batch, port_batch, words_u32

N = 700
WORDS = np.array(["MAIL", "SHIP", "AIR", "RAIL", "TRUCK", "FOB",
                  "REG AIR"], dtype=object)


def _columns(rng, n=N):
    """A batch of every column kind, with nulls: (jax batch, port batch)."""
    data = {
        "i32": rng.integers(-40, 40, n).astype(np.int32),
        "i64": rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64),
        "f32": (rng.standard_normal(n) * 3).astype(np.float32),
        "f64": rng.standard_normal(n) * 3,
        "b": rng.random(n) < 0.5,
        "c": rng.random(n) < 0.3,
        "s": WORDS[rng.integers(0, 7, n)],
        "small": rng.integers(-3, 4, n).astype(np.int64),
        "amt": rng.integers(-70, 70, n).astype(np.int32),
        "g": rng.uniform(-5.0, 5.0, n),
    }
    data["f64"][rng.integers(0, n, 6)] = np.nan
    data["f64"][rng.integers(0, n, 6)] = np.inf
    data["f64"][rng.integers(0, n, 6)] = -0.0
    masks = {c: rng.random(n) > 0.12 for c in data}
    masks["i64"] = None
    jdb = jax_batch(data, {k: m for k, m in masks.items() if m is not None})
    return jdb, port_batch(jdb)


@pytest.fixture(scope="module")
def cols():
    return _columns(np.random.default_rng(5))


FLOAT_RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-5}


def _same(tc, jc):
    """A port DeviceColumn against a JAX one: type, length, validity words
    bit for bit, values on the valid rows of [0, n)."""
    assert tc.type.name == jc.type.name
    assert tc.length == jc.length
    assert tc.padded == jc.padded
    n = jc.length
    jv = None if jc.validity is None else np.asarray(jc.validity)
    tv = None if tc.validity is None else words_u32(tc.validity)
    assert (tv is None) == (jv is None)
    valid = np.ones(n, np.bool_)
    if jv is not None:
        np.testing.assert_array_equal(tv, jv)
        valid = np.unpackbits(jv.view(np.uint8),
                              bitorder="little")[:n].astype(bool)
    got = tc.values.numpy()[:n][valid]
    want = np.asarray(jc.values)[:n][valid]
    assert got.dtype == want.dtype
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL[got.dtype],
                                   atol=np.finfo(got.dtype).tiny,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


BINARY = ["add", "subtract", "multiply", "divide", "power", "atan2", "logb",
          "bit_wise_and", "bit_wise_or", "bit_wise_xor", "shift_left",
          "shift_right", "max_element_wise", "min_element_wise", "mod"]
PAIRS = [("i32", "small"), ("i64", "amt"), ("f64", "i32"), ("f32", "f32"),
         ("f64", "f64")]


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("pair", PAIRS)
def test_arithmetic_binary_matches_jax(cols, op, pair):
    jdb, tdb = cols
    ja, jb = (jdb.column(c) for c in pair)
    ta, tb = (tdb.column(c) for c in pair)
    try:
        want = jk.arithmetic_binary(op, ja, jb, checked=False)
    except jpc.ArrowNotImplemented:
        with pytest.raises(pc.ArrowNotImplemented):
            kernels.arithmetic_binary(op, ta, tb, checked=False)
        return
    _same(kernels.arithmetic_binary(op, ta, tb, checked=False), want)
    # a scalar on the right broadcasts
    _same(kernels.arithmetic_binary(op, ta, 3, checked=False),
          jk.arithmetic_binary(op, ja, 3, checked=False))


def _int_col(values, dtype=np.int64):
    v = np.asarray(values, dtype)
    jdb = jax_batch({"x": v})
    return jdb.column("x"), port_batch(jdb).column("x")


def test_integer_divide_truncates_toward_zero_like_jax():
    a = [7, -7, 7, -7, 0, 5, -(2 ** 63), -9]
    b = [2, 2, -2, -2, 3, 0, -1, 4]
    (ja, ta), (jb, tb) = _int_col(a), _int_col(b)
    got = kernels.arithmetic_binary("divide", ta, tb, checked=False)
    _same(got, jk.arithmetic_binary("divide", ja, jb, checked=False))
    assert got.values[:8].tolist() == [3, -3, -3, 3, 0, 5, -(2 ** 63), -2]
    for mod in (jk, kernels):
        with pytest.raises((jpc.ArrowInvalid, pc.ArrowInvalid),
                           match="divide by zero"):
            mod.arithmetic_binary("divide", ja if mod is jk else ta,
                                  jb if mod is jk else tb)
    # a zero divisor in a null row does not raise
    jdb = jax_batch({"a": np.array(a), "b": np.array(b)},
                    {"b": np.array(b) != 0})
    tdb = port_batch(jdb)
    _same(kernels.arithmetic_binary("divide", tdb.column("a"),
                                    tdb.column("b")),
          jk.arithmetic_binary("divide", jdb.column("a"), jdb.column("b")))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_mod_takes_the_divisor_sign_like_jax(dtype):
    a = [7, -7, 7, -7, 6, 5, -5, 0]
    b = [3, 3, -3, -3, 3, 0, -1, 4]
    if np.dtype(dtype).kind == "i":
        a[-1] = np.iinfo(dtype).min
    (ja, ta), (jb, tb) = _int_col(a, dtype), _int_col(b, dtype)
    got = kernels.arithmetic_binary("mod", ta, tb)
    _same(got, jk.arithmetic_binary("mod", ja, jb))
    assert got.values[:4].tolist() == [1, 2, -2, -1]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_shifts_mask_the_amount_to_the_width_like_jax(dtype):
    bits = np.dtype(dtype).itemsize * 8
    a = [1, -8, 5, 1, -1, 3, 12345, -12345]
    b = [bits, bits + 1, -1, bits - 1, 3, 2 * bits + 2, 0, 5]
    (ja, ta), (jb, tb) = _int_col(a, dtype), _int_col(b, dtype)
    for op in ("shift_left", "shift_right"):
        _same(kernels.arithmetic_binary(op, ta, tb),
              jk.arithmetic_binary(op, ja, jb))
    got = kernels.arithmetic_binary("shift_left", ta, tb)
    assert got.values[:2].tolist() == [1, -16]


UNARY = ["negate", "abs", "sign", "sqrt", "exp", "expm1", "sin", "cos",
         "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "ln",
         "log10", "log2", "log1p", "floor", "ceil", "trunc", "bit_wise_not"]


@pytest.mark.parametrize("op", UNARY)
@pytest.mark.parametrize("col", ["i32", "i64", "f32", "f64"])
def test_arithmetic_unary_matches_jax(cols, op, col):
    jdb, tdb = cols
    try:
        want = jk.arithmetic_unary(op, jdb.column(col), checked=False)
    except jpc.ArrowNotImplemented:
        with pytest.raises(pc.ArrowNotImplemented):
            kernels.arithmetic_unary(op, tdb.column(col), checked=False)
        return
    _same(kernels.arithmetic_unary(op, tdb.column(col), checked=False),
          want)


def test_checked_negate_of_unsigned_values_raises():
    vals = torch.zeros(128, dtype=torch.uint8)
    col = DeviceColumn(vals, None, 3, tdt.uint8)
    kernels.arithmetic_unary("negate", col)       # all zero: no overflow
    vals[1] = 2
    with pytest.raises(pc.ArrowInvalid, match="unsigned"):
        kernels.arithmetic_unary("negate", col)
    kernels.arithmetic_unary("negate", col, checked=False)


OPS = ["equal", "not_equal", "less", "less_equal", "greater",
       "greater_equal"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("lit", ["RAIL", "NONE", "A", b"SHIP"])
def test_compare_dictionary_with_a_string_literal_matches_jax(cols, op, lit):
    jdb, tdb = cols
    _same(kernels.compare(op, tdb.column("s"), lit),
          jk.compare(op, jdb.column("s"), lit))
    _same(kernels.compare(op, lit, tdb.column("s")),
          jk.compare(op, lit, jdb.column("s")))


def test_compare_dictionary_with_dictionary_raises(cols):
    _, tdb = cols
    with pytest.raises(pc.ArrowNotImplemented, match="dictionary"):
        kernels.compare("equal", tdb.column("s"), tdb.column("s"))


@pytest.mark.parametrize("fn", ["is_null", "is_valid", "is_nan",
                                "is_finite"])
@pytest.mark.parametrize("col", ["i32", "i64", "f32", "f64", "s"])
def test_validity_predicates_match_jax(cols, fn, col):
    jdb, tdb = cols
    tc = getattr(kernels, fn)(tdb.column(col))
    jc = getattr(jk, fn)(jdb.column(col))
    _same(tc, jc)
    # is_null / is_valid have no nulls: their padding compares too
    if fn in ("is_null", "is_valid"):
        np.testing.assert_array_equal(tc.values.numpy(),
                                      np.asarray(jc.values))


@pytest.mark.parametrize("op", ["xor", "and_not", "and_not_kleene"])
def test_new_boolean_kernels_match_jax(cols, op):
    jdb, tdb = cols
    tc = kernels.boolean_binary(op, tdb.column("b"), tdb.column("c"))
    jc = jk.boolean_binary(op, jdb.column("b"), jdb.column("c"))
    n = jc.length
    known = np.ones(n, bool) if jc.validity is None else np.unpackbits(
        np.asarray(jc.validity).view(np.uint8), bitorder="little")[:n] > 0
    tknown = np.unpackbits(words_u32(tc.validity).view(np.uint8),
                           bitorder="little")[:n] > 0
    np.testing.assert_array_equal(tknown, known)
    np.testing.assert_array_equal(tc.values.numpy()[:n][known],
                                  np.asarray(jc.values)[:n][known])


EXPRESSIONS = [
    ("negate", ["i64"], None), ("sqrt", ["f64"], None),
    ("abs", ["i32"], None), ("is_null", ["f64"], None),
    ("is_valid", ["s"], None), ("is_nan", ["f64"], None),
    ("is_finite", ["f64"], None), ("xor", ["b", "c"], None),
    ("and_not", ["b", "c"], None), ("and_not_kleene", ["b", "c"], None),
    ("fill_null", ["i32", 0], None), ("fill_null", ["f64", "f64"], None),
    ("if_else", ["b", "i32", -1], None),
    ("if_else", ["c", 2.5, "f64"], None),
    ("is_in", ["s"], {"value_set": ["MAIL", "SHIP"]}),
    ("is_in", ["i32"], {"value_set": [1, 2, 3, None]}),
    ("divide", ["f64", "i32"], None), ("mod", ["i64", "small"], None),
]


@pytest.mark.parametrize("fname,args,options", EXPRESSIONS)
def test_new_expression_branches_match_jax(cols, fname, args, options):
    jdb, tdb = cols

    def expr(m):
        return m.call(fname, [m.field(a) if isinstance(a, str) else
                              m.literal(a) for a in args], options)
    tc = pc.execute_scalar_expression(expr(pc), tdb)
    jc = jpc.execute_scalar_expression(expr(jpc), jdb)
    if fname == "and_not_kleene":
        # the JAX expression keeps Kleene validity words, as here
        np.testing.assert_array_equal(words_u32(tc.validity),
                                      np.asarray(jc.validity))
    _same(tc, jc)


def test_cast_in_an_expression_is_not_ported(cols):
    """The cast branch of an expression (once missing) runs the unsafe
    device cast, as the JAX package's does."""
    from arrow_go_tpu import dtypes as jdt
    jdb, tdb = cols
    for to in ("int64", "int8", "float32", "float64"):
        expr = pc.call("cast", [pc.field("i32")],
                       {"to_type": tdt.type_for_name(to)})
        jexpr = jpc.call("cast", [jpc.field("i32")],
                         {"to_type": getattr(jdt, to)})
        _same(pc.execute_scalar_expression(expr, tdb),
              jpc.execute_scalar_expression(jexpr, jdb))


SETS = {
    "i32": [[3, -7, 3, 11], [0, None, 5], [], [None]],
    "i64": [[1, 2, 3], [None, 99]],
    "f64": [[np.nan, 0.0, 1.5], [None, -0.0, np.inf]],
    "s": [["MAIL", "SHIP"], ["AIR", None, "NOPE", "AIR"], []],
    "b": [[True], [False, None]],
}
SET_CASES = [(c, i) for c, sets in SETS.items() for i in range(len(sets))]


@pytest.mark.parametrize("col,which", SET_CASES)
@pytest.mark.parametrize("skip_nulls", [False, True])
def test_is_in_matches_jax(cols, col, which, skip_nulls):
    jdb, tdb = cols
    vset = SETS[col][which]
    _same(pc.is_in(tdb.column(col), pc.SetLookupOptions(vset, skip_nulls)),
          jf.is_in(jdb.column(col), jf.SetLookupOptions(vset, skip_nulls)))


@pytest.mark.parametrize("col,which", SET_CASES)
def test_index_in_matches_jax(cols, col, which):
    jdb, tdb = cols
    vset = SETS[col][which]
    got = column_to_host(pc.index_in(tdb.column(col), value_set=vset))
    want = from_device(jf.index_in(jdb.column(col), value_set=vset))
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("col", ["i32", "f64", "s", "b"])
def test_fill_null_matches_jax(cols, col):
    jdb, tdb = cols
    fill = {"i32": 7, "f64": -1.0, "s": 2, "b": True}[col]
    tc = pc.fill_null(tdb.column(col), fill)
    _same(tc, jf.fill_null(jdb.column(col), fill))
    assert tc.dictionary is tdb.column(col).dictionary
    _same(pc.fill_null(tdb.column("i64"), 0),
          jf.fill_null(jdb.column("i64"), 0))


@pytest.mark.parametrize("left,right", [("i32", "amt"), ("f64", 0.5),
                                        (-4, "i64"), ("b", "c")])
@pytest.mark.parametrize("cond", ["b", "c"])
def test_if_else_matches_jax(cols, cond, left, right):
    jdb, tdb = cols

    def arg(db, a):
        return db.column(a) if isinstance(a, str) else a
    tc = pc.if_else(tdb.column(cond), arg(tdb, left), arg(tdb, right))
    jc = jf.if_else(jdb.column(cond), arg(jdb, left), arg(jdb, right))
    assert tc.validity is not None
    _same(tc, jc)


# Two string columns over different dictionaries (first occurrence
# "x", "y", "z", "w" and "p", "q", "r"), "a" with nulls; a condition "c"
# with a null row and one "k" without nulls; an int column "i".
STR_DATA = {"a": np.array(["x", "y", "x", "z", "y", "w", "z"], dtype=object),
            "b": np.array(["p", "q", "r", "p", "x", "q", "r"], dtype=object),
            "c": np.array([True, False, True, False, True, False, True]),
            "k": np.array([False, True, True, False, False, True, True]),
            "i": np.arange(7, dtype=np.int32)}
STR_MASKS = {"a": np.array([True, False, True, False, True, True, False]),
             "c": np.array([True, True, False, True, True, True, True])}


def _py(name):
    """Column `name` of STR_DATA as Python values, None where null."""
    m = STR_MASKS.get(name)
    return [v if m is None or m[i] else None
            for i, v in enumerate(STR_DATA[name].tolist())]


def _py_if_else(cond, left, right):
    return [None if c is None else (lv if c else rv)
            for c, lv, rv in zip(_py(cond), left, right)]


def _py_fill_null(values, fill):
    return [f if v is None else v for v, f in zip(values, fill)]


N_STR = len(STR_DATA["a"])
# (function, args: a column name or a Python scalar, the Python result)
STRING_SELECTIONS = [
    ("if_else", ["c", "a", "b"], _py_if_else("c", _py("a"), _py("b"))),
    ("if_else", ["k", "b", "a"], _py_if_else("k", _py("b"), _py("a"))),
    ("if_else", ["c", "a", "y"], _py_if_else("c", _py("a"), ["y"] * N_STR)),
    ("if_else", ["k", "v", "b"], _py_if_else("k", ["v"] * N_STR, _py("b"))),
    ("fill_null", ["a", "b"], _py_fill_null(_py("a"), _py("b"))),
    ("fill_null", ["a", "z"], _py_fill_null(_py("a"), ["z"] * N_STR)),
    ("fill_null", ["a", "v"], _py_fill_null(_py("a"), ["v"] * N_STR)),
]


def _jax_pylist_or_raised(fn):
    try:
        return from_device(fn()).to_pylist()
    except Exception as e:      # the reference's failure is the point
        return type(e).__name__


@pytest.mark.parametrize("fname,args,want", STRING_SELECTIONS)
def test_string_selections_give_the_python_values(fname, args, want):
    """if_else and fill_null over string (dictionary) operands select in
    one code space and carry its dictionary: two columns over different
    dictionaries, a string scalar in the dictionary or not, a null
    condition. The JAX package raises or gives other values on the same
    inputs (a deviation on purpose, ROADMAP §3)."""
    jdb = jax_batch(STR_DATA, STR_MASKS)
    tdb = port_batch(jdb)

    def call(mod, db):
        return getattr(mod, fname)(*[db.column(a) if a in STR_DATA else a
                                     for a in args])
    out = call(pc, tdb)
    assert out.type == tdb.column("a").type and out.dictionary is not None
    assert column_to_host(out).to_pylist() == want
    # the same through an expression
    expr = pc.call(fname, [pc.field(a) if a in STR_DATA else pc.literal(a)
                           for a in args])
    assert column_to_host(pc.execute_scalar_expression(expr, tdb)
                          ).to_pylist() == want
    assert _jax_pylist_or_raised(lambda: call(jf, jdb)) != want


def test_string_beside_a_non_string_column_raises():
    tdb = port_batch(jax_batch(STR_DATA, STR_MASKS))
    a, c, i = (tdb.column(n) for n in ("a", "c", "i"))
    for fn in (lambda: pc.if_else(c, a, i), lambda: pc.if_else(c, i, a),
               lambda: pc.fill_null(a, i)):
        with pytest.raises(pc.ArrowInvalid):
            fn()


def _pylist_nan(xs):
    return [("nan" if isinstance(x, float) and np.isnan(x) else x)
            for x in xs]


@pytest.mark.parametrize("col", ["i32", "i64", "f64", "s", "b", "small"])
def test_unique_matches_jax(cols, col):
    jdb, tdb = cols
    got = column_to_host(pc.unique(tdb.column(col))).to_pylist()
    want = from_device(jf.unique(jdb.column(col))).to_pylist()
    assert _pylist_nan(got) == _pylist_nan(want)


@pytest.mark.parametrize("col", ["i32", "i64", "f64", "small"])
def test_dictionary_encode_matches_jax(cols, col):
    jdb, tdb = cols
    tc = pc.dictionary_encode(tdb.column(col))
    jc = jf.dictionary_encode(jdb.column(col))
    assert tc.type == tdt.dictionary(tdt.int32, tdb.column(col).type)
    n = jc.length
    np.testing.assert_array_equal(tc.values.numpy()[:n],
                                  np.asarray(jc.values)[:n])
    assert (tc.validity is None) == (jc.validity is None)
    assert _pylist_nan(tc.dictionary.tolist()) == _pylist_nan(
        jc.dictionary.to_pylist())
    s = tdb.column("s")
    assert pc.dictionary_encode(s) is s


AGG_COLS = ["i32", "i64", "f32", "g", "small"]


@pytest.mark.parametrize("col", AGG_COLS + ["s", "b"])
def test_count_distinct_matches_jax(cols, col):
    jdb, tdb = cols
    assert pc.agg_count_distinct(tdb.column(col)) == \
        jf.agg_count_distinct(jdb.column(col))


@pytest.mark.parametrize("fn", ["agg_any", "agg_all"])
@pytest.mark.parametrize("col", ["b", "c"])
def test_any_all_match_jax(cols, fn, col):
    jdb, tdb = cols
    assert getattr(pc, fn)(tdb.column(col)) == getattr(jf, fn)(
        jdb.column(col))


def _agg_col(rng, dtype, n, density):
    if np.dtype(dtype).kind == "f":
        v = rng.uniform(0.5, 1.5, n).astype(dtype)
    else:
        v = rng.choice(np.array([1, -1, 2, 3, 1, 1, -1], dtype), n)
    masks = None if density is None else {"x": rng.random(n) < density}
    jdb = jax_batch({"x": v}, masks)
    return jdb.column("x"), port_batch(jdb).column("x")


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
@pytest.mark.parametrize("density", [None, 0.4, 0.0])
def test_product_matches_jax(rng, dtype, density):
    jc, tc = _agg_col(rng, dtype, 90, density)
    got, want = pc.agg_product(tc), jf.agg_product(jc)
    if want is None:
        assert got is None
    elif np.dtype(dtype).kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-9 if dtype ==
                                   np.float64 else 1e-5)
    else:
        assert got == want and isinstance(got, int)


def test_product_widens_int32_like_jax():
    jc, tc = _int_col([2 ** 20, 2 ** 20, 3, -1], np.int32)
    assert pc.agg_product(tc) == jf.agg_product(jc) == -3 * 2 ** 40


@pytest.mark.parametrize("col", AGG_COLS)
@pytest.mark.parametrize("ddof", [0, 1])
def test_variance_and_stddev_match_jax(cols, col, ddof):
    jdb, tdb = cols
    for fn in ("agg_variance", "agg_stddev"):
        got = getattr(pc, fn)(tdb.column(col), pc.VarianceOptions(ddof))
        want = getattr(jf, fn)(jdb.column(col), jf.VarianceOptions(ddof))
        np.testing.assert_allclose(got, want, rtol=1e-9)


def test_variance_of_no_valid_row_is_nan_like_jax(rng):
    jc, tc = _agg_col(rng, np.float64, 50, 0.0)
    assert np.isnan(pc.agg_variance(tc)) and np.isnan(jf.agg_variance(jc))


# F6: the device take checks the raw index values under the validity

@pytest.mark.parametrize("itype,bad", [(np.int64, -1), (np.int32, -1),
                                       (np.int8, -1), (np.uint32, 2 ** 32 - 1),
                                       (np.int64, 4), (np.uint8, 200)])
def test_take_bounds_check_reads_the_raw_indices_like_jax(itype, bad):
    from arrow_go_tpu.compute.errors import ArrowIndexError as JaxIndexError
    vals = {"v": np.array([10, 20, 30, 40], np.int64)}
    idx = {"i": np.array([0, bad, 2], itype)}
    jv, ji = jax_batch(vals), jax_batch(idx)
    with pytest.raises(JaxIndexError):
        jf.take(jv.column("v"), ji.column("i"))
    with pytest.raises(pc.ArrowIndexError):
        pc.take(port_batch(jv).column("v"), port_batch(ji).column("i"))
    # the same slot null: a null row in both packages
    ji = jax_batch(idx, {"i": np.array([True, False, True])})
    want = from_device(jf.take(jv.column("v"), ji.column("i"))).to_pylist()
    got = column_to_host(pc.take(port_batch(jv).column("v"),
                                 port_batch(ji).column("i"))).to_pylist()
    assert got == want == [10, None, 30]


# F7: take accepts every integer index type, and mixed host / device
# operands

INDEX_TYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
               np.uint32, np.uint64]


@pytest.mark.parametrize("itype", INDEX_TYPES)
@pytest.mark.parametrize("route", ["host", "device", "device_by_host",
                                   "host_by_device"])
def test_take_by_every_integer_index_type_matches_jax(itype, route):
    import arrow_go_tpu as agt
    from arrow_go_tpu_torch.device.block import HostArray
    rng = np.random.default_rng(int(np.dtype(itype).itemsize) * 7)
    vals = np.array([10, 20, 30, 40, 50], np.int64)
    vmask = np.array([True, True, False, True, True])
    idx = rng.integers(0, 5, 40).astype(itype)
    imask = rng.random(40) > 0.2
    jdv = jax_batch({"v": vals}, {"v": vmask})
    jdi = jax_batch({"i": idx}, {"i": imask})
    jhv, jhi = agt.from_numpy(vals, vmask), agt.from_numpy(idx, imask)
    thv = HostArray(vals, vmask, tdt.int64)
    thi = HostArray(idx, imask, tdt.from_numpy_dtype(idx.dtype))
    tdv, tdi = port_batch(jdv).column("v"), port_batch(jdi).column("i")
    jargs, targs = {"host": ((jhv, jhi), (thv, thi)),
                    "device": ((jdv.column("v"), jdi.column("i")),
                               (tdv, tdi)),
                    "device_by_host": ((jdv.column("v"), jhi), (tdv, thi)),
                    "host_by_device": ((jhv, jdi.column("i")),
                                       (thv, tdi))}[route]
    want = jf.take(*jargs)
    got = pc.take(*targs, device="cpu")
    want = (from_device(want) if route == "device" else want).to_pylist()
    got = (column_to_host(got) if route == "device" else got).to_pylist()
    assert got == want


def test_take_of_indices_3_0_2_by_int8_gives_the_rows():
    from arrow_go_tpu_torch.device.block import HostArray
    got = pc.take(HostArray(np.array([10, 20, 30, 40], np.int64), None,
                            tdt.int64),
                  HostArray(np.array([3, 0, 2], np.int8), None, tdt.int8))
    assert got.to_pylist() == [40, 10, 30]


def test_int64_take_index_past_int32_is_a_recorded_deviation():
    """Decided on purpose: the JAX package casts a take's indices to
    int32 before its bounds check, so an int64 index of 2**32 wraps to
    row 0 there; the port checks the int64 value and raises, as the JAX
    package's own host route does."""
    vals = {"v": np.array([10, 20, 30, 40], np.int64)}
    idx = {"i": np.array([2 ** 32, 1], np.int64)}
    jv, ji = jax_batch(vals), jax_batch(idx)
    assert from_device(jf.take(jv.column("v"),
                               ji.column("i"))).to_pylist() == [10, 20]
    with pytest.raises(pc.ArrowIndexError):
        pc.take(port_batch(jv).column("v"), port_batch(ji).column("i"))


# F13: filter takes a DeviceColumn (K1's payloads), a HostArray and a
# HostBatch, as the JAX package's filter does

@pytest.mark.parametrize("col", ["i32", "f64", "s", "b", "i64"])
@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_filter_of_a_column_matches_jax(cols, col, null_selection):
    jdb, tdb = cols
    opts = dict(null_selection=null_selection)
    want = jf.filter_(jdb.column(col), jdb.column("c"),
                      jf.FilterOptions(**opts))
    got = pc.filter_(tdb.column(col), tdb.column("c"),
                     pc.FilterOptions(**opts))
    _same(got, want)


@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_filter_of_host_arrays_and_batches_matches_jax(cols,
                                                       null_selection):
    from arrow_go_tpu.device.block import batch_from_device
    from arrow_go_tpu_torch.device.block import device_batch_to_host
    jdb, tdb = cols
    jhb, thb = batch_from_device(jdb), device_batch_to_host(tdb)
    jm, tm = jhb.column("c"), thb.column("c")
    jo = jf.FilterOptions(null_selection=null_selection)
    to = pc.FilterOptions(null_selection=null_selection)
    want = jf.filter_(jhb, jm, jo)
    got = pc.filter_(thb, tm, to, device="cpu")
    assert got.num_rows == want.num_rows
    assert got.to_pydict() == {k: v for k, v in
                               zip(want.schema.names,
                                   [c.to_pylist() for c in want.columns])}
    for name in ("i32", "s", "f64"):
        want = jf.filter_(jhb.column(name), jm, jo).to_pylist()
        got = pc.filter_(thb.column(name), tm, to,
                         device="cpu").to_pylist()
        assert got == want or np.allclose(
            [np.nan if x is None else x for x in got],
            [np.nan if x is None else x for x in want], equal_nan=True)


# ---------------------------------------------------------------------------
# host input: a HostArray or a ChunkedArray moves to the device (the JAX
# `_as_device`) and a host input gets a host result back (`_maybe_host`)
# ---------------------------------------------------------------------------

HOST_COLS = ["i32", "i64", "f64", "s", "b", "small"]


def _host_pair(cols, col, form):
    """Column `col` of both batches on the host: as one array, or as a
    ChunkedArray of three chunks (one of them a single row)."""
    import arrow_go_tpu as jagt
    import arrow_go_tpu_torch as tagt
    jdb, tdb = cols
    ja, ta = from_device(jdb.column(col)), column_to_host(tdb.column(col))
    if form == "array":
        return ja, ta
    cuts = [(0, 250), (250, 251), (251, N)]
    return (jagt.ChunkedArray([ja.slice(a, b - a) for a, b in cuts]),
            tagt.ChunkedArray([ta.slice(a, b - a) for a, b in cuts]))


def _host_result(got):
    from arrow_go_tpu_torch.device.block import HostArray
    assert isinstance(got, HostArray), type(got)
    return got


@pytest.mark.parametrize("col", HOST_COLS)
@pytest.mark.parametrize("form", ["array", "chunked"])
def test_unique_of_host_input_matches_jax(cols, col, form):
    ja, ta = _host_pair(cols, col, form)
    got = _host_result(pc.unique(ta, device="cpu"))
    assert _pylist_nan(got.to_pylist()) == _pylist_nan(
        jf.unique(ja).to_pylist())


@pytest.mark.parametrize("col", ["i32", "i64", "f64", "small"])
@pytest.mark.parametrize("form", ["array", "chunked"])
def test_dictionary_encode_of_host_input_matches_jax(cols, col, form):
    ja, ta = _host_pair(cols, col, form)
    got = _host_result(pc.dictionary_encode(ta, device="cpu"))
    want = jf.dictionary_encode(ja)
    assert _pylist_nan(got.to_pylist()) == _pylist_nan(want.to_pylist())
    codes = want.indices.to_pylist()
    valid = np.array([i is not None for i in codes])
    np.testing.assert_array_equal(
        np.asarray(got.values)[valid],
        np.asarray([i for i in codes if i is not None], np.int32))
    assert _pylist_nan(got.dictionary.tolist()) == _pylist_nan(
        want.dictionary.to_pylist())


@pytest.mark.parametrize("col,which", SET_CASES)
@pytest.mark.parametrize("form", ["array", "chunked"])
def test_set_lookups_of_host_input_match_jax(cols, col, which, form):
    ja, ta = _host_pair(cols, col, form)
    vset = SETS[col][which]
    for skip in (False, True):
        got = _host_result(pc.is_in(ta, pc.SetLookupOptions(vset, skip),
                                    device="cpu"))
        assert got.to_pylist() == jf.is_in(
            ja, jf.SetLookupOptions(vset, skip)).to_pylist()
    got = _host_result(pc.index_in(ta, value_set=vset, device="cpu"))
    assert got.to_pylist() == jf.index_in(ja, value_set=vset).to_pylist()


@pytest.mark.parametrize("col", ["i32", "f64", "i64", "b"])
@pytest.mark.parametrize("form", ["array", "chunked"])
def test_fill_null_of_host_input_matches_jax(cols, col, form):
    ja, ta = _host_pair(cols, col, form)
    fill = {"i32": 7, "f64": -1.0, "i64": 0, "b": True}[col]
    got = _host_result(pc.fill_null(ta, fill, device="cpu"))
    assert _pylist_nan(got.to_pylist()) == _pylist_nan(
        jf.fill_null(ja, fill).to_pylist())
    assert got.null_count == 0


@pytest.mark.parametrize("left,right", [("i32", "amt"), ("f64", 0.5),
                                        (-4, "i64"), ("b", "c")])
@pytest.mark.parametrize("form", ["array", "chunked"])
def test_if_else_of_host_input_matches_jax(cols, left, right, form):
    jc, tc = _host_pair(cols, "c", form)

    def arg(which, a):
        return _host_pair(cols, a, form)[which] if isinstance(a, str) else a
    got = _host_result(pc.if_else(tc, arg(1, left), arg(1, right),
                                  device="cpu"))
    want = jf.if_else(jc, arg(0, left), arg(0, right))
    assert _pylist_nan(got.to_pylist()) == _pylist_nan(want.to_pylist())


def test_if_else_of_host_operands_beside_a_device_cond_matches_jax(cols):
    jdb, tdb = cols
    ja, ta = _host_pair(cols, "i32", "array")
    got = pc.if_else(tdb.column("b"), ta, -1)
    want = jf.if_else(jdb.column("b"), ja, -1)
    assert _pylist_nan(got.to_pylist()) == _pylist_nan(want.to_pylist())


@pytest.mark.parametrize("fn", ["agg_sum", "agg_min", "agg_max", "agg_mean",
                                "agg_count", "agg_product", "agg_variance",
                                "agg_stddev", "agg_count_distinct",
                                "min_max"])
@pytest.mark.parametrize("col", ["i32", "i64", "f64", "small"])
@pytest.mark.parametrize("form", ["array", "chunked"])
def test_aggregates_of_host_input_match_jax(cols, fn, col, form):
    ja, ta = _host_pair(cols, col, form)
    got = getattr(pc, fn)(ta, device="cpu")
    want = getattr(jf, fn)(ja)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        got, want = list(got.values()), list(want.values())
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-9,
                               equal_nan=True)


def test_any_all_of_host_input_match_jax(cols):
    for form in ("array", "chunked"):
        for col in ("b", "c"):
            ja, ta = _host_pair(cols, col, form)
            assert pc.agg_any(ta, device="cpu") == jf.agg_any(ja)
            assert pc.agg_all(ta, device="cpu") == jf.agg_all(ja)


def test_value_counts_of_a_chunked_array_matches_jax(cols):
    ja, ta = _host_pair(cols, "small", "chunked")
    assert pc.value_counts(ta, device="cpu").to_pylist() == \
        jf.value_counts(ja).to_pylist()


def test_the_decimal128_refusals_stay(cols):
    """The JAX package fails on a decimal128 column's limb matrix in the
    aggregates and unique: the port refuses host input there too."""
    from decimal import Decimal

    import arrow_go_tpu_torch as tagt
    from arrow_go_tpu.compute.errors import ArrowNotImplemented
    a = tagt.array([Decimal("1.5"), None, Decimal("2.25")],
                   tdt.decimal128(10, 2))
    for fn in (pc.agg_sum, pc.unique, pc.agg_mean):
        with pytest.raises(Exception) as e:
            fn(a, device="cpu")
        assert type(e.value).__name__ == ArrowNotImplemented.__name__


# ---------------------------------------------------------------------------
# a Table's selection is a Table and a RecordBatch's a RecordBatch
# ---------------------------------------------------------------------------

def _table_pair(cols):
    """The batch's flat columns as a Table of three chunks a column and
    as a RecordBatch, in both packages."""
    import arrow_go_tpu as jagt
    import arrow_go_tpu_torch as tagt
    from arrow_go_tpu.device.block import batch_from_device
    from arrow_go_tpu_torch.device.block import device_batch_to_host
    jdb, tdb = cols
    names = ["i32", "i64", "f64", "s", "b"]
    jhb, thb = batch_from_device(jdb), device_batch_to_host(tdb)
    jrb = jagt.RecordBatch.from_arrays([jhb.column(n) for n in names], names)
    trb = tagt.RecordBatch.from_arrays([thb.column(n) for n in names], names)
    cuts = [(0, 300), (300, 301), (301, N)]
    jt = jagt.Table.from_batches([jrb.slice(a, b - a) for a, b in cuts])
    tt = tagt.Table.from_batches([trb.slice(a, b - a) for a, b in cuts])
    return (jt, tt), (jrb, trb)


@pytest.mark.parametrize("form", ["table", "record_batch"])
@pytest.mark.parametrize("null_selection", ["drop", "emit_null"])
def test_filter_of_a_table_or_record_batch_keeps_its_class(cols, form,
                                                           null_selection):
    """tests/test_nested_selection.py::test_filter_table_returns_table."""
    import arrow_go_tpu_torch as tagt
    (jt, tt), (jrb, trb) = _table_pair(cols)
    jv, tv = (jt, tt) if form == "table" else (jrb, trb)
    jm, tm = _host_pair(cols, "c", "array")
    want = jf.filter_(jv, jm, jf.FilterOptions(null_selection))
    got = pc.filter(tv, tm, pc.FilterOptions(null_selection), device="cpu")
    assert type(got) is (tagt.Table if form == "table" else tagt.RecordBatch)
    assert type(want).__name__ == type(got).__name__
    assert got.num_rows == want.num_rows
    assert _pylist_nan(got.to_pydict()["f64"]) == _pylist_nan(
        want.to_pydict()["f64"])
    assert {k: v for k, v in got.to_pydict().items() if k != "f64"} == \
        {k: v for k, v in want.to_pydict().items() if k != "f64"}


@pytest.mark.parametrize("form", ["table", "record_batch"])
def test_take_of_a_table_or_record_batch_keeps_its_class(cols, form):
    import arrow_go_tpu as jagt
    import arrow_go_tpu_torch as tagt
    (jt, tt), (jrb, trb) = _table_pair(cols)
    jv, tv = (jt, tt) if form == "table" else (jrb, trb)
    idx = np.random.default_rng(9).integers(0, N, 50)
    want = jf.take(jv, jagt.from_numpy(idx))
    got = pc.take(tv, tagt.from_numpy(idx), device="cpu")
    assert type(got) is (tagt.Table if form == "table" else tagt.RecordBatch)
    assert type(want).__name__ == type(got).__name__
    assert _pylist_nan(got.to_pydict()["f64"]) == _pylist_nan(
        want.to_pydict()["f64"])
    assert got.to_pydict()["s"] == want.to_pydict()["s"]


def test_a_readers_host_batch_keeps_its_class(cols):
    from arrow_go_tpu_torch.device.block import HostBatch, device_batch_to_host
    _, tdb = cols
    thb = device_batch_to_host(tdb)
    got = pc.filter(thb, thb.column("c"), device="cpu")
    assert type(got) is HostBatch
