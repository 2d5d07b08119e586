"""The port's expression front against the JAX package's: the operator
methods build the same trees, the reference's quirks (Literal's
dataclass equality, dotted field paths) hold in both, a HostBatch
evaluates like a RecordBatch, and `compile_expression` gives the JAX
compiled function's values and validity on random trees of the device
function set over every numeric type, one compiled function across
three lengths. Ints and bools must match bit for bit; floats at rtol
1e-14 (the registry test's tolerance for the last place of XLA's and
torch's arithmetic)."""
import numpy as np
import pytest

import arrow_go_tpu.compute as jpc
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.compute.errors import ArrowInvalid as JaxInvalid
from arrow_go_tpu.compute.errors import ArrowKeyError as JaxKeyError
from arrow_go_tpu.device.block import DeviceColumn as JaxColumn

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.device.block import DeviceColumn, HostArray
from torch_parity import host_tables, jax_batch, port_batch, same_array

NUMERIC = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
           "uint64", "float16", "float32", "float64"]
FLOAT_RTOL = 1e-14


def trees(m):
    """Expressions built with module m's operators (m is either
    package's compute module)."""
    f, lit = m.field, m.literal
    a, b = f("a"), f("b")
    return [a + 1, 1 + a, a - 2.5, 3 - a, a * b, 2 * b, a / 2, a / b,
            a == 1, a != b, a < 2, a <= b, a > 0, a >= lit(3),
            (a > 1) & (b < 2), (a > 1) | (b < 2), ~(a == b),
            ((a + b) * 2 > 3) & ~b.is_null(), a.is_null(), a.is_valid(),
            a.isin([1, 2, 3]), a + b + 1, m.call("add", [a, 4]),
            m.call("if_else", [a > b, a, b]), m.call("fill_null", [a, 0])]


def test_operators_build_the_jax_trees():
    for got, want in zip(trees(pc), trees(jpc)):
        assert repr(got) == repr(want)
        assert type(got).__name__ == type(want).__name__
        assert hash(got) == hash(want)
    assert repr(pc.field("a").cast(dt.int64)) == repr(
        jpc.field("a").cast(jdt.int64)) == "cast($a)"


def test_literal_equality_is_the_dataclass_one():
    """Quirk 3: Literal's generated __eq__ overrides the operator, so two
    literals compare as values; a field or a call builds an `equal`."""
    for m in (pc, jpc):
        assert (m.literal(3) == m.literal(3)) is True
        assert (m.literal(3) == m.literal(4)) is False
        assert repr(m.field("a") == 3) == "equal($a, 3)"
        assert repr(m.call("add", [m.field("a"), 1]) == 2) == \
            "equal(add($a, 1), 2)"
        assert hash(m.literal(3)) == hash(m.literal(3))


def test_dotted_paths_split_and_fail_only_on_the_device():
    """Quirk 4: "a.b" is the path (a, b); building it is fine, evaluating
    it over a DeviceBatch raises ArrowInvalid (a missing first step
    ArrowKeyError), in both packages."""
    data = {"a": np.arange(4.0)}
    jdb = jax_batch(data)
    db = port_batch(jdb)
    for m, batch, invalid, key in ((pc, db, pc.ArrowInvalid,
                                    pc.ArrowKeyError),
                                   (jpc, jdb, JaxInvalid, JaxKeyError)):
        ref = m.field("a.b")
        assert ref.path == ("a", "b") and repr(ref) == "$a.b"
        assert m.field("a", "b").path == ("a", "b")
        with pytest.raises(invalid):
            m.execute_scalar_expression(ref + 1, batch)
        with pytest.raises(key):
            m.execute_scalar_expression(m.field("zz.b"), batch)
    with pytest.raises(pc.ArrowInvalid):
        pc.compile_expression(pc.field("a.b") > 1, db.schema)
    with pytest.raises(JaxInvalid):
        jpc.compile_expression(jpc.field("a.b") > 1, jdb.schema)(jdb)


def test_a_host_batch_evaluates_like_a_record_batch():
    rng = np.random.default_rng(1)
    data = {"a": rng.integers(-9, 9, 40), "b": rng.normal(size=40),
            "s": np.array(["x", "y", "z", "x"] * 10, dtype=object)}
    masks = {"a": rng.random(40) < 0.8}
    rb, hb = host_tables(data, masks)
    for m_expr in ((lambda m: (m.field("a") * 2 + m.field("b") > 0.5)
                    | m.field("a").is_null()),
                   lambda m: m.field("s") == "x",
                   lambda m: m.call("fill_null", [m.field("a"), 7])):
        want = jpc.execute_scalar_expression(m_expr(jpc), rb)
        got = pc.execute_scalar_expression(m_expr(pc), hb, device="cpu")
        assert isinstance(got, HostArray)
        same_array(got, want)


# ---------------------------------------------------------------------------
# compile_expression on random trees
# ---------------------------------------------------------------------------

def _column(m, x):
    """x, or the field a where x is a literal (every call takes at least
    one column, and fill_null's and if_else's value operands are
    columns)."""
    return m.field("a") if isinstance(x, m.Literal) else x


def _numeric(m, rng, depth: int):
    f = m.field
    if depth == 0 or rng.random() < 0.3:
        if rng.random() < 0.75:
            return f(["a", "b", "c"][rng.integers(3)])
        return m.literal(int(rng.integers(0, 5)))
    kind = rng.integers(5)
    x = _column(m, _numeric(m, rng, depth - 1))
    y = _column(m, _numeric(m, rng, depth - 1)) if kind == 2 else \
        _numeric(m, rng, depth - 1)
    if kind == 0:
        return m.call(["add", "subtract", "multiply",
                       "max_element_wise"][rng.integers(4)], [x, y])
    if kind == 1:
        return m.call(["negate", "abs"][rng.integers(2)], [x])
    if kind == 2:
        return m.call("if_else", [_boolean(m, rng, depth - 1), x, y])
    if kind == 3:
        return m.call("fill_null", [x, m.literal(int(rng.integers(0, 5)))])
    return m.call("subtract", [x, y])


def _boolean(m, rng, depth: int):
    if depth == 0 or rng.random() < 0.4:
        x = _column(m, _numeric(m, rng, max(depth - 1, 0)))
        y = _numeric(m, rng, max(depth - 1, 0))
        op = ["equal", "not_equal", "less", "less_equal", "greater",
              "greater_equal"][rng.integers(6)]
        return m.call(op, [x, y])
    kind = rng.integers(5)
    if kind == 0:
        return m.call("invert", [_boolean(m, rng, depth - 1)])
    if kind == 1:
        return m.call(["is_null", "is_valid"][rng.integers(2)],
                      [_numeric(m, rng, depth - 1)])
    op = ["and_kleene", "or_kleene", "and", "or"][rng.integers(4)]
    return m.call(op, [_boolean(m, rng, depth - 1),
                       _boolean(m, rng, depth - 1)])


def random_tree(m, seed: int):
    """The same random tree in module m's classes (one seed, one tree)."""
    rng = np.random.default_rng(seed)
    return _column(m, (_boolean if rng.random() < 0.5 else _numeric)(
        m, rng, 3))


def _batches(tname: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    d = np.dtype(tname)
    if d.kind == "f":
        cols = {k: (rng.normal(size=n) * 4).round(1).astype(d)
                for k in "abc"}
    else:
        lo = 0 if d.kind == "u" else -20
        cols = {k: rng.integers(lo, 20, n).astype(d) for k in "abc"}
    masks = {k: rng.random(n) < 0.8 for k in "ab"}
    jdb = jax_batch(cols, masks)
    return jdb, port_batch(jdb)


def same_result(got: DeviceColumn, want: JaxColumn, n: int) -> None:
    """Values and validity over [0, n): validity bit for bit, values on
    the valid rows (ints bit for bit, floats at FLOAT_RTOL)."""
    ok = np.asarray(want.validity_mask())[:n]
    np.testing.assert_array_equal(got.validity_mask().numpy()[:n], ok)
    g = got.values.numpy()[:n][ok]
    w = np.asarray(want.values)[:n][ok]
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=FLOAT_RTOL,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(g.view(f"u{g.itemsize}"),
                                      w.view(f"u{w.itemsize}"))


@pytest.mark.parametrize("seed", range(1, 9))
@pytest.mark.parametrize("tname", NUMERIC)
def test_compiled_random_trees_match_jax(tname, seed):
    jtree, ttree = random_tree(jpc, seed), random_tree(pc, seed)
    assert repr(jtree) == repr(ttree)
    jdb, db = _batches(tname, 5, seed)
    jfn = jpc.compile_expression(jtree, jdb.schema)
    fn = pc.compile_expression(ttree, db.schema)
    assert fn.expression is ttree
    for n in (5, 50, 100):           # one compiled function, three lengths
        jdb, db = _batches(tname, n, seed + n)
        got = fn(db)
        same_result(got, jfn(jdb), n)
        eager = jpc.execute_scalar_expression(jtree, jdb)
        assert str(got.type) == str(eager.type)
        same_result(pc.execute_scalar_expression(ttree, db), eager, n)


@pytest.mark.parametrize("build", [
    lambda m: m.field("a") + 1,
    lambda m: m.call("fill_null", [m.field("a"), 0]),
    lambda m: m.call("divide", [m.field("a"), 2])],
    ids=["add_literal", "fill_null", "divide"])
def test_output_type_is_the_eager_type(build):
    """Quirk 1, a recorded deviation: the JAX compiled function labels
    these int64 (a Python int literal types as int64) over int32
    storage, while its eager evaluation types them int32; the port's
    compiled output carries the eager type."""
    jdb, db = _batches("int32", 50, 3)
    want = jpc.compile_expression(build(jpc), jdb.schema)(jdb)
    eager = jpc.execute_scalar_expression(build(jpc), jdb)
    assert str(want.type) == "int64" and want.values.dtype == np.int32
    assert str(eager.type) == "int32"
    got = pc.compile_expression(build(pc), db.schema)(db)
    assert str(got.type) == "int32"
    same_result(got, want, 50)


def test_functions_off_the_device_are_refused_at_compile_time():
    jdb, db = _batches("int64", 20, 4)
    proj = pc.project([pc.field("a"), pc.field("b")], ["x", "y"])
    with pytest.raises(pc.ArrowInvalid):
        pc.compile_expression(proj, db.schema)
    jproj = jpc.project([jpc.field("a"), jpc.field("b")], ["x", "y"])
    with pytest.raises(Exception):
        jpc.compile_expression(jproj, jdb.schema)(jdb)
    with pytest.raises(pc.ArrowKeyError):
        pc.compile_expression(pc.field("zz") + 1, db.schema)
    with pytest.raises(pc.ArrowInvalid):
        pc.compile_expression(pc.call("value_counts", [pc.field("a")]),
                              db.schema)


def test_compiled_q6_reads_nothing_back_from_the_device(monkeypatch):
    """TPC-H Q6's predicate and revenue, built with the operators and
    compiled, call no tensor-to-host read (item, bool, int, float,
    tolist, cpu, numpy, nonzero): on the card they run under sync debug
    "error" (chip_smoke.py), here every such read raises. The mask
    equals the eager `and` chain's, bit for bit."""
    import torch
    rng = np.random.default_rng(12)
    n = 1000
    data = {"l_price": rng.uniform(1, 1000, n).round(2),
            "l_disc": rng.uniform(0, 0.1, n).round(2),
            "l_sdate": rng.integers(8000, 12000, n).astype(np.int32),
            "l_qty": rng.integers(1, 51, n).astype(np.int32)}
    db = port_batch(jax_batch(data))
    f = pc.field
    pred = ((f("l_sdate") >= 8766) & (f("l_sdate") < 9131)
            & (f("l_disc") >= 0.05) & (f("l_disc") <= 0.07)
            & (f("l_qty") < 24))
    pred_fn = pc.compile_expression(pred, db.schema)
    rev_fn = pc.compile_expression(f("l_price") * f("l_disc"), db.schema)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read in a compiled expression")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                     "cpu", "numpy", "nonzero"):
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch, "nonzero", refuse)
        mask, rev = pred_fn(db), rev_fn(db)
    eager = pc.execute_scalar_expression(
        pc.call("and", [pc.call("and", [f("l_sdate") >= 8766,
                                        f("l_sdate") < 9131]),
                        pc.call("and", [pc.call("and", [
                            f("l_disc") >= 0.05, f("l_disc") <= 0.07]),
                            f("l_qty") < 24])]), db)
    assert torch.equal(mask.values[:n], eager.values[:n])
    assert torch.equal(mask.validity_mask()[:n], eager.validity_mask()[:n])
    np.testing.assert_array_equal(rev.values[:n].numpy(),
                                  data["l_price"] * data["l_disc"])
