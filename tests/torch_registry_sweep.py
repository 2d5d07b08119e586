"""The registry-wide parity sweep between arrow_go_tpu (JAX) and its
PyTorch port: every function that both default registries register is
fed every input class below through both packages' `call_function` on
the CPU (the port's with `device="cpu"`), made from fixed values.

A case passes when both packages raise, or when both return the same
class name, type string and `to_pylist()` (floats by `isclose` at
PARITY.md D4's tolerances: rtol 1e-9 for float64 and Python floats,
numpy's default rtol 1e-5 for float32 and float16 results), and the
port's values are JSON-serialisable (bytes aside, which both packages
give for binary columns). The port's own result on DeviceColumn inputs
must keep each column in its type's storage dtype (`check_storage`).

A deliberate deviation is one entry of EXEMPT, keyed by (function,
input) and naming the PR that decided it; its test asserts what each
package does. Add one only for a decision recorded in ROADMAP §3
"Decided on purpose": a fault is repaired, not listed.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass

import arrow_go_tpu as agt
from arrow_go_tpu.compute import functions as jf
from arrow_go_tpu.compute import registry as jreg
from arrow_go_tpu.device.block import DeviceColumn as JaxColumn
from arrow_go_tpu.device.block import from_device, to_device

import arrow_go_tpu_torch as agt_torch
from arrow_go_tpu_torch.compute import kernels as tkernels
from arrow_go_tpu_torch.compute import registry as treg
from arrow_go_tpu_torch.compute.errors import ArrowNotImplemented
from arrow_go_tpu_torch.device.block import (DeviceColumn, HostArray,
                                             check_storage,
                                             host_array_to_device)

NAMES = sorted(set(jreg.default_registry().function_names())
               & set(treg.default_registry().function_names()))


def _table(P):
    return P.Table.from_batches([
        P.record_batch({"a": P.array([3, None, 1]),
                        "b": P.array([1.5, 2.5, None])}),
        P.record_batch({"a": P.array([2, 5]), "b": P.array([0.5, -1.0])})])


#: one-argument inputs: name -> builder over a package module
UNARY = {
    "int": lambda P: P.array([3, None, 1, 7, -2]),
    "float": lambda P: P.array([0.5, 2.0, -3.25, 4.0, 1e300]),
    "chunked": lambda P: P.ChunkedArray([P.array([3, None, 1]),
                                         P.array([2, 5])]),
    "empty": lambda P: P.array([], P.int64),
    "allnull": lambda P: P.array([None, None, None], P.int64),
    "uint8": lambda P: P.array([200, 3, None, 255, 0], P.uint8),
    "date32": lambda P: P.array([0, 19000, None, -5, 365], P.date32),
    "table": _table,
    "strings": lambda P: P.ChunkedArray([P.array(["b", None, "a"]),
                                         P.array(["b", "c"])]),
    "bool": lambda P: P.array([True, False, None, True]),
    "float32": lambda P: P.array([0.5, None, -3.25, 3e38], P.float32),
}

#: two-argument inputs
PAIRS = {
    "int/int": lambda P: (P.array([3, None, 1, 7, -2]),
                          P.array([2, 5, None, 3, 4])),
    "int/float": lambda P: (P.array([3, None, 1, 7, -2]),
                            P.array([2.5, 5.5, None, 0.25, -4.0])),
    "bool/bool": lambda P: (P.array([True, False, None, True]),
                            P.array([True, True, False, None])),
    "chunked/chunked": lambda P: (
        P.ChunkedArray([P.array([3, None]), P.array([1, 7])]),
        P.ChunkedArray([P.array([2]), P.array([5, None, 3])])),
    "uint8/int8": lambda P: (P.array([200, 3, None, 255], P.uint8),
                             P.array([-1, 3, 4, None], P.int8)),
    "int/scalar": lambda P: (P.array([3, None, 1, 7, -2]), 2),
    "date32/date32": lambda P: (P.array([0, 19000, None, 5], P.date32),
                                P.array([1, 18000, 3, None], P.date32)),
}

#: three-argument inputs (if_else)
TRIPLES = {
    "bool/int/int": lambda P: (P.array([True, False, None, True]),
                               P.array([1, 2, 3, None]),
                               P.array([-4, None, 6, 7])),
    "bool/int/float": lambda P: (P.array([True, False, None, False]),
                                 P.array([1, 2, 3, 4]),
                                 P.array([1.5, -2.5, 3.5, None])),
    "bool/float/scalar": lambda P: (P.array([False, True, None, False]),
                                    P.array([1.5, None, 3.5, -0.5]), 2),
}


def inputs_of(name: str) -> list:
    """The input keys a function takes by its JAX arity."""
    ar = jreg.default_registry().get_function(name).arity
    keys = []
    if ar.num_args == 1 or ar.is_varargs:
        keys += list(UNARY)
    if ar.num_args == 2 or ar.is_varargs and ar.num_args <= 2:
        keys += list(PAIRS)
    if ar.num_args == 3:
        keys += list(TRIPLES)
    return keys


CASES = [(n, k) for n in NAMES for k in inputs_of(n)]


def args_of(key: str, P) -> list:
    if key in UNARY:
        return [UNARY[key](P)]
    return list((PAIRS.get(key) or TRIPLES[key])(P))


# ---------------------------------------------------------------------------
# the deliberate deviations
# ---------------------------------------------------------------------------

RESULT = "a result"     # the JAX package returns a value (of its own codes)
DIRECT = "the JAX direct function's result on DeviceColumns"


@dataclass(frozen=True)
class Deviation:
    reason: str          # names the PR that decided it
    jax: object          # an exception class, or RESULT
    port: object         # an exception class, or DIRECT


EXEMPT = {}

for _k in PAIRS:
    EXEMPT[("fill_null", _k)] = Deviation(
        "PRs 6 and 12: the JAX registry's fill_null passes options= to a "
        "function that takes none and raises TypeError; the port's "
        "registry gives the direct fill_null's result, in the column's "
        "type and storage (PR 26, F22)", TypeError, DIRECT)
for _k in TRIPLES:
    EXEMPT[("if_else", _k)] = Deviation(
        "PRs 6 and 12: the JAX registry's if_else passes options= to a "
        "function that takes none and raises TypeError; the port's "
        "registry gives the direct if_else's result, in left's type and "
        "storage (PR 26, F22)", TypeError, DIRECT)

# F20: arithmetic and math of a string column are refused; the
# JAX package raises AttributeError on the first group and computes the
# float functions over its own dictionary codes
_JAX_FAILS = ("negate", "abs", "sign", "floor", "ceil", "trunc")
for _op in tkernels._ARITH_UNARY:
    if _op == "bit_wise_not":
        continue            # both refuse: no integer operand
    for _name in (_op, _op + "_unchecked"):
        EXEMPT[(_name, "strings")] = Deviation(
            "PR 26 (F20): arithmetic and math of a string column are "
            "refused (ArrowNotImplemented); the rows are dictionary codes",
            AttributeError if _op in _JAX_FAILS else RESULT,
            ArrowNotImplemented)
EXEMPT[("round_to_multiple", "strings")] = Deviation(
    "PR 26 (F20): round_to_multiple of a string column is refused "
    "(ArrowNotImplemented); the JAX package fails in it",
    AttributeError, ArrowNotImplemented)
# F19: the numeric aggregates of a string column are refused;
# the JAX package answers from its own dictionary codes
for _name in ("sum", "mean", "min", "max", "min_max", "product",
              "variance", "stddev"):
    EXEMPT[(_name, "strings")] = Deviation(
        "PR 26 (F19): a numeric aggregate of a string column is refused "
        "(ArrowNotImplemented); the JAX package answers a dictionary "
        "code", RESULT, ArrowNotImplemented)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def outcome(fn):
    """("raise", exception) or ("ok", result) of fn()."""
    try:
        return "ok", fn()
    except Exception as e:              # noqa: BLE001 (the class is data)
        return "raise", e


def norm(r):
    """A result as plain data: (class name, type string, Python rows)."""
    if isinstance(r, tuple):
        return ("tuple", None, [norm(x) for x in r])
    if hasattr(r, "schema") and hasattr(r, "to_pydict"):
        return (type(r).__name__, str(r.schema), r.to_pydict())
    if hasattr(r, "to_pylist"):
        return (type(r).__name__, str(r.type), r.to_pylist())
    return (type(r).__name__, None, r)


def _rtol(type_str) -> float:
    if type_str is not None and ("halffloat" in type_str
                                 or type_str == "float"):
        return 1e-5
    return 1e-9


def same(a, b, rtol: float) -> bool:
    """Plain data equal, floats by isclose (NaN equal to NaN); ints and
    bools must keep their Python types."""
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=rtol, abs_tol=1e-300)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y, rtol)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k], rtol)
                                            for k in a)
    return type(a) is type(b) and a == b


def same_result(jr, pr) -> bool:
    """Two normalized results agree: class, type and rows."""
    (jc, jt, jv), (pc_, pt, pv) = jr, pr
    if jc == "tuple":
        return pc_ == "tuple" and len(jv) == len(pv) and all(
            same_result(x, y) for x, y in zip(jv, pv))
    return jc == pc_ and jt == pt and same(jv, pv, _rtol(jt))


def _bytes_hex(v):
    if isinstance(v, bytes):
        return v.hex()
    raise TypeError(f"{type(v).__name__} is not JSON serialisable")


def json_rows(r) -> str:
    """The port's rows as JSON (bytes as hex): a numpy scalar fails."""
    return json.dumps(r[2], default=_bytes_hex)


def port_call(name: str, args: list):
    return treg.call_function(name, args, device="cpu")


def jax_direct(name: str, args: list):
    """The JAX package's direct function (`fill_null` / `if_else`) on
    its DeviceColumns of the same arguments, back on the host."""
    cols = [to_device(a.combine() if isinstance(a, agt.ChunkedArray)
                      else a) if isinstance(a, (agt.Array,
                                                 agt.ChunkedArray))
            else a for a in args]
    out = getattr(jf, name)(*cols)
    return from_device(out) if isinstance(out, JaxColumn) else out


def storage_kept(name: str, args: list) -> None:
    """The port's call on DeviceColumns of the same host arguments: each
    DeviceColumn it returns holds its type's storage dtype. A call that
    raises there is not this check's concern (the host call's outcome
    is compared above)."""
    dev = [host_array_to_device(a.combine() if isinstance(
        a, agt_torch.ChunkedArray) else a, "cpu")
        if isinstance(a, (HostArray, agt_torch.ChunkedArray)) else a
        for a in args]
    kind, out = outcome(lambda: port_call(name, dev))
    if kind == "raise":
        return
    for col in out if isinstance(out, tuple) else (out,):
        if isinstance(col, DeviceColumn):
            check_storage(col)


def check_case(name: str, key: str) -> None:
    """One (function, input) case of the sweep."""
    jargs, pargs = args_of(key, agt), args_of(key, agt_torch)
    jk, jr = outcome(lambda: jreg.call_function(name, jargs))
    pk, pr = outcome(lambda: port_call(name, pargs))
    dev = EXEMPT.get((name, key))
    if dev is not None:
        check_deviation(dev, (jk, jr), (pk, pr), name, jargs, pargs)
        return
    if jk == pk == "raise":
        return
    assert jk == pk, (f"{name}({key}): JAX {jk} {jr!r:.200}, "
                      f"port {pk} {pr!r:.200}")
    jn, pn = norm(jr), norm(pr)
    assert same_result(jn, pn), f"{name}({key}): JAX {jn}, port {pn}"
    json_rows(pn)
    storage_kept(name, pargs)


def check_deviation(dev: Deviation, j, p, name: str, jargs: list,
                    pargs: list) -> None:
    """What each package does in a recorded deviation."""
    jk, jr = j
    pk, pr = p
    if dev.jax is RESULT:
        assert jk == "ok", f"{name}: JAX raised {jr!r}"
    else:
        assert jk == "raise" and isinstance(jr, dev.jax), (name, jk, jr)
    if dev.port is DIRECT:
        assert pk == "ok", f"{name}: the port raised {pr!r}"
        want = norm(jax_direct(name, jargs))
        got = norm(pr)
        assert same_result(want, got), f"{name}: JAX direct {want}, " \
            f"port {got}"
        json_rows(got)
        storage_kept(name, pargs)
    else:
        assert pk == "raise" and isinstance(pr, dev.port), (name, pk, pr)


# ---------------------------------------------------------------------------
# the direct (non-registry) calls on the two-chunk Table
# ---------------------------------------------------------------------------

TABLE_CALLS = {
    "sort_indices": lambda m, P, t, **kw: m.sort_indices(
        t, m.SortOptions([m.SortKey("a")]), **kw),
    "sort_indices_two_keys": lambda m, P, t, **kw: m.sort_indices(
        t, m.SortOptions([m.SortKey("b", "descending"), m.SortKey("a")]),
        **kw),
    "sort": lambda m, P, t, **kw: m.sort(
        t, m.SortOptions([m.SortKey("a")]), **kw),
    "take": lambda m, P, t, **kw: m.take(t, P.array([4, 0, None, 2]),
                                         **kw),
    "filter": lambda m, P, t, **kw: m.filter(
        t, P.array([True, False, None, True, True]), **kw),
    "unique": lambda m, P, t, **kw: m.unique(t, **kw),
    "value_counts": lambda m, P, t, **kw: m.value_counts(t, **kw),
    "count": lambda m, P, t, **kw: m.count(t, **kw),
    "sum": lambda m, P, t, **kw: m.sum(t, **kw),
    "mean": lambda m, P, t, **kw: m.mean(t, **kw),
    "min_max": lambda m, P, t, **kw: m.min_max(t, **kw),
}


def check_table_call(name: str) -> None:
    """One direct compute call on the Table through both packages: both
    raise, or the same class, type or schema, and rows."""
    import arrow_go_tpu.compute as jc
    import arrow_go_tpu_torch.compute as tc
    call = TABLE_CALLS[name]
    jk, jr = outcome(lambda: call(jc, agt, _table(agt)))
    pk, pr = outcome(lambda: call(tc, agt_torch, _table(agt_torch),
                                  device="cpu"))
    if jk == pk == "raise":
        return
    assert jk == pk, f"{name}: JAX {jk} {jr!r:.200}, port {pk} {pr!r:.200}"
    jn, pn = norm(jr), norm(pr)
    assert same_result(jn, pn), f"{name}: JAX {jn}, port {pn}"
    json_rows(pn)
