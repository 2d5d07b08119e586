"""The port's top-level names against the JAX package's: every public
name of arrow_go_tpu/__init__.py is on arrow_go_tpu_torch or has a
decided stand-in (STAND_INS), the lazy submodules resolve, the type
names are the port's dtypes, and `table`, `record_batch`, `array`,
`nulls`, `from_numpy` and `concat_arrays` of the same Python data give
HostBatches and HostArrays equal to the JAX results."""
import ast
import datetime
import decimal
import importlib
import pathlib

import numpy as np
import pytest

import arrow_go_tpu as jagt
from arrow_go_tpu import dtypes as jdt

import arrow_go_tpu_torch as agt
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.device.block import HostArray, HostBatch
from torch_parity import port_type, same_array, same_table

ROOT = pathlib.Path(__file__).resolve().parents[1]

# JAX names the port does not carry, each beside the port's stand-in:
# none since the port has the JAX data-model classes (array/)
STAND_INS: dict = {}


def _jax_public_names() -> set:
    """The names arrow_go_tpu/__init__.py binds (its imports and
    __version__) and the submodules its __getattr__ loads that exist."""
    tree = ast.parse((ROOT / "arrow_go_tpu" / "__init__.py").read_text())
    names = {"__version__"}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    lazy = {c.value for node in ast.walk(tree) if isinstance(node, ast.Tuple)
            for c in node.elts if isinstance(c, ast.Constant)}
    for name in lazy:
        try:
            getattr(jagt, name)
        except ImportError:     # "csv": named there, no such module
            continue
        names.add(name)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def _resolve(path: str):
    obj = agt
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def test_every_jax_name_is_on_the_port_or_stands_in():
    names = _jax_public_names()
    assert {"dataset", "cli", "tensor", "table", "record_batch", "int64",
            "schema", "field", "compute", "parallel"} <= names
    missing = sorted(n for n in names
                     if not hasattr(agt, n) and n not in STAND_INS)
    assert missing == []
    for name, stand_in in STAND_INS.items():
        assert name in names
        assert not hasattr(agt, name), name
        assert _resolve(stand_in) is not None, stand_in


@pytest.mark.parametrize("name", ["dataset", "cli", "tensor", "interop",
                                  "cdata", "flight", "ipc", "parallel",
                                  "native", "compute", "device", "ops",
                                  "parquet", "formats", "extensions"])
def test_submodules_resolve(name):
    mod = getattr(agt, name)
    assert mod is importlib.import_module(f"arrow_go_tpu_torch.{name}")


def test_type_names_are_the_ports_dtypes():
    tree = ast.parse((ROOT / "arrow_go_tpu" / "__init__.py").read_text())
    typenames = next(
        [a.name for a in node.names] for node in tree.body
        if isinstance(node, ast.ImportFrom) and node.module == "dtypes")
    assert typenames[0] == "DataType" and typenames[-1] == "uint64"
    for name in typenames:
        assert getattr(agt, name) is getattr(dt, name), name
    assert agt.field("x", agt.int32, False) == dt.Field("x", dt.int32, False)
    assert agt.schema({"a": agt.int64, "b": agt.string},
                      dt.Metadata({"k": "v"})).metadata.get("k") == "v"
    assert agt.schema([("a", agt.int64)]) == \
        dt.Schema([dt.Field("a", dt.int64)])


def test_the_flightsql_table_is_the_top_level_one():
    from arrow_go_tpu_torch.flight import dbapi, sql
    assert sql.table is agt.table
    assert dbapi.table is agt.table


# ---------------------------------------------------------------------------
# table / record_batch / array of the same Python data
# ---------------------------------------------------------------------------

TABLES = {
    "scalars": {"i": [1, None, 3], "f": [1.5, None, -2.0],
                "s": ["a", None, "a"], "b": [True, False, None],
                "y": [b"x", b"", None]},
    "empty": {"e": [], "s": []},
    "all null": {"n": [None, None, None], "i": [4, 5, 6]},
    "temporal and decimal": {
        "d": [datetime.date(2024, 1, 2), None, datetime.date(1970, 1, 1)],
        "t": [datetime.datetime(2024, 1, 2, 3, 4, 5), None,
              datetime.datetime(1999, 12, 31)],
        "m": [decimal.Decimal("1.25"), None, decimal.Decimal("-3.5")]},
    "nested": {"l": [[1, 2], None, []],
               "st": [{"x": 1, "y": "a"}, None, {"x": 3, "y": None}]},
    "numpy": {"a": np.arange(4, dtype=np.int32),
              "u": np.array([0, 2**64 - 1, 5, 7], np.uint64),
              "f": np.linspace(0, 1, 4)},
}


@pytest.mark.parametrize("make", ["table", "record_batch"])
@pytest.mark.parametrize("name", TABLES)
def test_tables_of_python_data_equal_the_jax_ones(name, make):
    data = TABLES[name]
    got = getattr(agt, make)(data)
    want = getattr(jagt, make)(data)
    assert isinstance(got, agt.Table if make == "table" else agt.RecordBatch)
    assert isinstance(agt.RecordBatch.from_pydict(data), HostBatch)
    same_table(got, want, name)
    assert [f.nullable for f in got.schema.fields] == \
        [f.nullable for f in want.schema.fields]


def test_a_table_under_a_schema_and_from_named_arrays():
    js = jdt.schema({"a": jdt.int16, "s": jdt.large_string,
                     "l": jdt.list_(jdt.float32)})
    ts = dt.schema({"a": dt.int16, "s": dt.large_string,
                    "l": dt.list_(dt.float32)})
    data = {"a": [1, None, -3], "s": ["x", "y", None],
            "l": [[1.5], None, [2.0, 3.0]]}
    same_table(agt.table(data, schema=ts), jagt.table(data, schema=js),
               "schema")
    same_table(agt.record_batch(data, schema=ts),
               jagt.record_batch(data, schema=js), "schema")
    arrays = [[1, 2], ["p", None]]
    same_table(agt.table([agt.array(a) for a in arrays], ["x", "y"]),
               jagt.table([jagt.array(a) for a in arrays], ["x", "y"]),
               "arrays")
    with pytest.raises(ValueError):
        jagt.record_batch({"a": [1, 2], "b": [1]})
    with pytest.raises(ValueError):
        agt.record_batch({"a": [1, 2], "b": [1]})


ARRAYS = [
    ([1, 2, None], None), ([1.5, None], None), (["a", None, "bc"], None),
    ([], None), ([None, None], None), ([True, None], None),
    ([[1], None, [2, 3]], None), ([{"k": 1}, None], None),
    ([1, None, 3], jdt.int8), ([0, 65535], jdt.uint16),
    (["a", None], jdt.large_string), ([b"ab", None], jdt.binary),
    ([1, None], jdt.float32), ([5, None], jdt.date32),
    ([decimal.Decimal("1.5"), None], jdt.decimal64(10, 2)),
    ([[1, 2], None], jdt.fixed_size_list(jdt.int32, 2)),
    (["x", "y", "x", None], jdt.dictionary(jdt.int32, jdt.string)),
]


@pytest.mark.parametrize("values,jt", ARRAYS, ids=lambda v: str(v)[:30])
def test_arrays_of_python_values_equal_the_jax_ones(values, jt):
    want = jagt.array(values, jt)
    got = agt.array(values, None if jt is None else port_type(jt))
    assert isinstance(got, HostArray)
    same_array(got, want, str(values))
    assert agt.array(got) is got


def test_numpy_arrays_nulls_and_concat_equal_the_jax_ones():
    v = np.array([3, -1, 7, 0], np.int64)
    mask = np.array([True, False, True, True])
    same_array(agt.array(v, mask=mask), jagt.array(v, mask=mask), "mask")
    same_array(agt.from_numpy(v.astype(np.uint8)),
               jagt.from_numpy(v.astype(np.uint8)), "uint8")
    same_array(agt.from_numpy(v, np.ones(4, bool), agt.int32),
               jagt.from_numpy(v, np.ones(4, bool), jdt.int32), "typed")
    same_array(agt.from_numpy(v > 0), jagt.from_numpy(v > 0), "bool")
    for jt in (jdt.null, jdt.int32, jdt.string, jdt.list_(jdt.int64)):
        same_array(agt.nulls(3, port_type(jt)), jagt.nulls(3, jt), str(jt))
    parts = [["a", None], ["b", "a"], []]
    same_array(agt.concat_arrays([agt.array(p, agt.string) for p in parts]),
               jagt.concat_arrays([jagt.array(p, jdt.string)
                                   for p in parts]), "strings")
    ints = [[1, None], [3]]
    same_array(agt.concat_arrays([agt.array(p) for p in ints]),
               jagt.concat_arrays([jagt.array(p) for p in ints]), "ints")
    for pkg in (agt, jagt):
        with pytest.raises(ValueError):
            pkg.concat_arrays([])
        with pytest.raises(ValueError):
            pkg.concat_arrays([pkg.array([1]), pkg.array(["a"])])
