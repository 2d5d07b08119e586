"""The port's CSV reader and writer (arrow_go_tpu_torch/formats/csv.py)
against the JAX package's (arrow_go_tpu/formats/csv.py) on the same
bytes: every case through both tiers (the numpy tier as the bytes
stand; the csv-module tier with the first cell quoted, which sends both
packages there), the tier each package takes, the values, validity,
field types and exception classes; explicit types of every kind the
converters take; the options; the streaming reader with its pinned
schema; write_csv byte for byte for every type and option; a hypothesis
round trip through both writers and readers; pyarrow's reader as an
extra oracle."""
import datetime
import decimal
import io

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu.formats import csv as jcsv

from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.device.block import HostBatch, from_pylist
from arrow_go_tpu_torch.formats import csv as tcsv
from torch_parity import port_array, port_type, same_table


def _opts(mod, d, kw):
    """ReadOptions of `mod` from a factory of keyword arguments given the
    dtypes module `d` (a schema's fields, column types)."""
    kw = kw(d) if callable(kw) else dict(kw or {})
    if "schema" in kw:
        kw["schema"] = d.Schema([d.Field(n, t) for n, t in kw["schema"]])
    return mod.ReadOptions(**kw)


def _quote_first(data: bytes) -> bytes:
    """The bytes with their first cell quoted: the same cells, read by
    the csv-module tier in both packages."""
    line, sep, rest = data.partition(b"\n")
    cell, comma, tail = line.partition(b",")
    return b'"' + cell.rstrip(b"\r") + b'"' + (b"\r" if cell.endswith(b"\r")
                                               and not comma else b"") + \
        comma + tail + sep + rest


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:              # the class is compared across
        return None, type(e).__name__


def _same_read(data: bytes, kw=None, tier: str = "fast"):
    """read_csv of `data` through both packages: the same tier taken, the
    same table or the same exception class."""
    if tier == "module":
        data = _quote_first(data)
    jo, to = _opts(jcsv, jdt, kw), _opts(tcsv, dt, kw)
    jf, _ = _outcome(lambda: jcsv._read_csv_fast(data, jo))
    tf, _ = _outcome(lambda: tcsv._read_csv_fast(data, to))
    assert (jf is None) == (tf is None)
    if tier == "module":
        assert tf is None
    want, jerr = _outcome(lambda: jcsv.read_csv(data, jo))
    got, terr = _outcome(lambda: tcsv.read_csv(data, to))
    assert terr == jerr, (terr, jerr)
    if jerr is None:
        same_table(got, want, repr(data[:40]))
    return got, jerr


CASES = {
    "basic": b"a,b,c,d\n1,1.5,true,hello\n2,2.5,false,world\n3,,true,\n",
    "null_spellings": b"x\nNULL\n5\nn/a\n",
    "every_default_null": b"x,y\n,1\nNULL,2\nnull,3\nN/A,4\nn/a,5\nNA,6\n"
                          b"nan,7\nNaN,8\n9,9\n",
    "nan_in_floats": b"f\n1.5\nnan\nNaN\n2\n",
    "bool_digits": b"b\n1\n0\n1\n",
    "bool_words": b"b\ntrue\nFalse\nTRUE\nfalse\n",
    "bool_and_int": b"b\n1\n0\n2\n",
    "padded_int": b"i,j\n 12 ,1\n3,2\n",
    "padded_tab": b"i\n\t12\n3\n",
    "signs": b"i\n-5\n+7\n0\n-0\n",
    "int64_limits": b"i\n9223372036854775807\n-9223372036854775808\n",
    "nineteen_nines": b"i\n9999999999999999999\n1\n",
    "twenty_digits": b"i\n12345678901234567890\n1\n",
    "lone_sign": b"i\n-\n1\n",
    "floats": b"f\n1e3\n-2.5E-3\ninf\n-inf\n.5\n5.\n",
    "float_and_text": b"f\n1.5\nabc\n",
    "dates": b"d\n2020-01-01\n1999-12-31\n1970-01-01\n",
    "timestamps_t": b"t\n2020-01-01T12:00:00\n2020-01-01T00:00:00.123456\n",
    "timestamps_space": b"t\n2020-01-01 12:00:00\n2021-06-30 23:59:59\n",
    "timestamps_minutes": b"t\n2020-01-01T12:00\n",
    "date_and_timestamp": b"t\n2020-01-01\n2020-01-01T12:00:00\n",
    "date_and_text": b"d\n2020-01-01\nsoon\n",
    "bad_date": b"d\n2020-13-01\n",
    "short_date": b"d\n2020-1-01\n",
    "all_null": b"a,b\n,1\n,2\n",
    "strings_with_nulls": b"s,n\nx,1\nNULL,2\n,3\nn/a,4\n",
    "blank_lines": b"a,b\n1,x\n\n2,y\n\n",
    "crlf": b"a,b\r\n1,x\r\n2,y\r\n",
    "lone_cr_cell": b"a,b\n1,x\r\n2,y\n",
    "no_trailing_newline": b"a,b\n1,x\n2,y",
    "unicode": "s,n\nünï,1\nα,2\nünï,3\n".encode(),
    "ragged_short": b"a,b,c\n1,2,3\n4,5\n",
    "ragged_long": b"a,b\n1,2,3\n4,5\n",
    "ragged_strings": b"a,b,c\nx,y,z\nu\n",
    "header_only": b"a,b\n",
    "header_no_newline": b"a,b",
    "empty": b"",
    "one_column": b"v\n3\n4\n",
    "mixed": b"i,f,s,b,d\n1,0.5,x,true,2020-01-01\n-2,,y,false,\n3,1e2,,,"
             b"2021-02-03\n",
}


@pytest.mark.parametrize("tier", ["fast", "module"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_read_matches_jax(case, tier):
    data = CASES[case]
    # an empty input has no cell to quote: both variants read it as is
    _same_read(data, tier=tier if data else "fast")


OPTION_CASES = {
    "delimiter_pipe": (b"d|ts\n2020-01-01|2020-01-01T12:00:00\n",
                       {"delimiter": "|"}),
    "delimiter_tab": (b"a\tb\n1\tx\n2\ty\n", {"delimiter": "\t"}),
    "delimiter_semicolon": (b"a;b\n1,5;x\n", {"delimiter": ";"}),
    "delimiter_multi": (b"a||b\n1||x\n", {"delimiter": "||"}),
    "comment": (b"a,b\n#skip,me\n1,2\n# again\n3,4\n", {"comment": "#"}),
    "skip_rows": (b"junk line\nmore junk\na,b\n1,2\n", {"skip_rows": 2}),
    "skip_all": (b"a,b\n1,2\n", {"skip_rows": 5}),
    "no_header": (b"1,x\n2,y\n", {"has_header": False}),
    "no_header_names": (b"1,x\n2,y\n", {"has_header": False,
                                        "column_names": ["p", "q"]}),
    "no_header_schema": (b"1,x\n2,y\n", {"has_header": False, "schema": [
        ("a", "int32"), ("b", "string")]}),
    "no_header_empty_schema": (b"", {"has_header": False, "schema": [
        ("a", "int32")]}),
    "no_header_empty": (b"", {"has_header": False}),
    "names_replace_header": (b"a,b\n1,2\n", {"column_names": ["x", "y"]}),
    "include_columns": (b"a,b,c\n1,x,9.5\n2,y,8.5\n",
                        {"include_columns": ["a", "c"]}),
    "include_missing": (b"a,b\n1,2\n", {"include_columns": ["zz"]}),
    "include_and_types": (b"a,b,c\n1,x,9.5\n2,y,8.5\n",
                          {"include_columns": ["a", "c"],
                           "column_types": {"a": "float64"}}),
    "strings_can_be_null": (b"s,n\nx,1\nNULL,2\n,3\nn/a,4\n",
                            {"strings_can_be_null": True}),
    "strings_can_be_null_declared": (b"s,n\nx,1\nNULL,2\n,3\n",
                                     {"strings_can_be_null": True,
                                      "column_types": {"s": "string"}}),
    "declared_string_keeps_null_text": (b"s\nx\nNULL\n\n",
                                        {"column_types": {"s": "string"}}),
    "null_values": (b"a,b\n-,1\n2,-\nNULL,3\n", {"null_values": ["-"]}),
    "true_false_values": (b"b\nY\nN\nY\n", {"true_values": ["Y"],
                                           "false_values": ["N"]}),
    "malformed_declared_int": (b"a\n1\nx\n", {"column_types": {
        "a": "int64"}}),
    "malformed_declared_float": (b"a\n1\nx\n", {"column_types": {
        "a": "float64"}}),
    "malformed_declared_date": (b"a\n2020-01-01\nx\n", {"column_types": {
        "a": "date32"}}),
    "declared_bool_other_text": (b"a\ntrue\nyes\n", {"column_types": {
        "a": "bool"}}),
    "schema_subset": (b"a,b\n1,2\n", {"schema": [("b", "float32")]}),
}


def _typed(kw):
    """A case's options with type names turned into each package's types."""
    def make(d):
        out = dict(kw)
        if "column_types" in out:
            out["column_types"] = {k: _type_of(d, v) for k, v in
                                   out["column_types"].items()}
        if "schema" in out:
            out["schema"] = [(n, _type_of(d, t)) for n, t in out["schema"]]
        return out
    return make


def _type_of(d, name):
    if not isinstance(name, str):
        return name(d)
    return {"bool": d.bool_, "string": d.string}.get(name) or \
        getattr(d, name)


@pytest.mark.parametrize("tier", ["fast", "module"])
@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_options_match_jax(case, tier):
    data, kw = OPTION_CASES[case]
    _same_read(data, _typed(kw), tier if data else "fast")


TYPE_CASES = {
    "bool": (lambda d: d.bool_, "true\nfalse\n\n1\n0\nTRUE"),
    "int8": (lambda d: d.int8, "1\n-5\n\n127\n-128"),
    "int16": (lambda d: d.int16, "1\n-5\n\n32767"),
    "int32": (lambda d: d.int32, "1\n-5\n\n2147483647"),
    "int64": (lambda d: d.int64, "1\n-5\n\n9223372036854775807"),
    "uint8": (lambda d: d.uint8, "1\n5\n\n255"),
    "uint16": (lambda d: d.uint16, "1\n5\n\n65535"),
    "uint32": (lambda d: d.uint32, "1\n5\n\n4294967295"),
    "uint64": (lambda d: d.uint64, "1\n5\n\n9223372036854775807"),
    "float32": (lambda d: d.float32, "1.5\n-2.25\n\n1e3\n0.1"),
    "float64": (lambda d: d.float64, "1.5\n-2.25\n\n1e300\n0.1"),
    "date32": (lambda d: d.date32, "2020-01-01\n1970-01-02\n\n1900-03-01"),
    "timestamp_s": (lambda d: d.timestamp("s"),
                    "2020-01-01T00:00:01\n\n2021-06-01 12:30:00"),
    "timestamp_ms": (lambda d: d.timestamp("ms"),
                     "2020-01-01T00:00:01.5\n\n2021-06-01 12:30:00"),
    "timestamp_us": (lambda d: d.timestamp("us"),
                     "2020-01-01T00:00:01.000123\n\n2021-06-01"),
    "timestamp_ns": (lambda d: d.timestamp("ns"),
                     "2020-01-01T00:00:01.000000123\n\n2021-06-01"),
    "timestamp_utc": (lambda d: d.timestamp("us", "UTC"),
                      "2020-01-01T00:00:01\n\n2020-01-01T00:00:00+05:30"),
    "timestamp_offset_ms": (lambda d: d.timestamp("ms", "+05:30"),
                            "2020-01-01T10:00:00\n\n1969-12-31T23:59:59"),
    "decimal128": (lambda d: d.decimal128(10, 2), "1.25\n-3.5\n\n100"),
    "decimal128_scale0": (lambda d: d.decimal128(20, 0),
                          "12345678901234567890\n\n-1"),
    "decimal256": (lambda d: d.decimal256(40, 3), "1.125\n\n-7"),
    "decimal_too_fine": (lambda d: d.decimal128(10, 1), "1.25"),
    "string": (lambda d: d.string, "x\n\ny\nx\nNULL"),
    "large_string": (lambda d: d.large_string, "x\n\ny\nx"),
    "binary": (lambda d: d.binary, "x\n\ny\nx"),
    "large_binary": (lambda d: d.large_binary, "x\n\nyz"),
}


@pytest.mark.parametrize("how", ["column_types", "schema"])
@pytest.mark.parametrize("tier", ["fast", "module"])
@pytest.mark.parametrize("case", sorted(TYPE_CASES))
def test_explicit_types_match_jax(case, tier, how):
    """A declared type of every kind the converters take, beside an
    inferred int column, through both tiers."""
    typ, cells = TYPE_CASES[case]
    data = ("v,k\n" + "".join(f"{c},{i}\n" for i, c in
                              enumerate(cells.split("\n")))).encode()
    if how == "schema":
        kw = (lambda d: {"schema": [("v", typ(d)), ("k", d.int16)]})
    else:
        kw = (lambda d: {"column_types": {"v": typ(d)}})
    got, err = _same_read(data, kw, tier)
    if err is None:
        assert got.schema.field(0).type == typ(dt)


@pytest.mark.parametrize("values", [
    ["1", "2", None], ["1", "x"], ["true", "0"], ["1.5", "2"],
    ["2020-01-01", None], ["2020-01-01T10:00:00"], [" 7"], [None, None],
    ["nan"], ["1e5", "inf"], ["2020-01-01", "2020-01-01 10:00"]])
def test_value_inference_matches_jax(values):
    """_infer_column_type, the value-by-value inference."""
    jt = jcsv._infer_column_type(values, jcsv.ReadOptions())
    tt = tcsv._infer_column_type(values, tcsv.ReadOptions())
    assert tt == port_type(jt)


def test_the_tiers_differ_where_the_jax_tiers_do():
    """The numpy tier reads a padded cell as an int, as the JAX numpy tier
    does; the csv-module tier decides as the JAX one does (quirk of the
    reference, matched)."""
    fast = tcsv.read_csv(b"i\n 12 \n3\n")
    module = tcsv.read_csv(b'"i"\n 12 \n3\n')
    assert fast.schema.field(0).type == dt.int64
    assert fast.column("i").to_pylist() == [12, 3]
    assert module.schema.field(0).type == port_type(
        jcsv.read_csv(b'"i"\n 12 \n3\n').schema.field(0).type)


def test_a_budget_past_cell_takes_the_module_tier(monkeypatch):
    """A cell matrix past the fast tier's budget sends the input to the
    csv-module tier in both packages."""
    data = b"a,b\n" + b"".join(b"%d,%s\n" % (i, b"x" * (i % 7))
                               for i in range(50))
    monkeypatch.setattr(jcsv, "_FAST_CELL_BUDGET", 64)
    monkeypatch.setattr(tcsv, "_FAST_CELL_BUDGET", 64)
    assert tcsv._read_csv_fast(data, tcsv.ReadOptions()) is None
    assert jcsv._read_csv_fast(data, jcsv.ReadOptions()) is None
    _same_read(data)


def test_threaded_columns_match_jax():
    """Past 65,536 rows the numpy tier converts columns on a thread pool."""
    rng = np.random.default_rng(3)
    n = 70000
    rows = [f"{a},{b:.3f},{c},2020-01-{d:02d}" for a, b, c, d in zip(
        rng.integers(-1000, 1000, n).tolist(), rng.random(n).tolist(),
        rng.choice(["x", "yy", "NULL"], n).tolist(),
        rng.integers(1, 29, n).tolist())]
    data = ("i,f,s,d\n" + "\n".join(rows) + "\n").encode()
    for kw in (None, {"strings_can_be_null": True}):
        got, _ = _same_read(data, kw)
        assert got.num_rows == n


# -- the streaming reader ---------------------------------------------------

def _same_stream(data: bytes, chunk: int, kw=None):
    jo = _opts(jcsv, jdt, dict(kw or {}, chunk_size=chunk))
    to = _opts(tcsv, dt, dict(kw or {}, chunk_size=chunk))
    jr, jerr = _outcome(lambda: jcsv.open_csv(data, jo))
    tr, terr = _outcome(lambda: tcsv.open_csv(data, to))
    assert terr == jerr
    if jerr:
        return [], jerr
    got = []
    while True:
        want, jerr = _outcome(jr.read_next_batch)
        b, terr = _outcome(tr.read_next_batch)
        assert terr == jerr
        if jerr or want is None:
            assert jerr or b is None
            return got, jerr
        same_table(b, want)
        assert tr.schema == port_type_schema(jr.schema)
        got.append(b)


def port_type_schema(s):
    return dt.Schema([dt.Field(f.name, port_type(f.type)) for f in s.fields])


STREAM_CASES = {
    "ints": (("x,y\n" + "".join(f"{i},{i * 2}\n" for i in range(10))
              ).encode(), 4, None),
    "pinned_int_then_text": (b"a\n1\n2\nx\n", 2, None),
    "pinned_int_then_float": (b"a\n1\n2\n1.5\n", 2, None),
    "pinned_float_then_int": (b"a\n1.5\n2.5\n3\n", 2, None),
    "pinned_string_then_int": (b"a\nx\ny\n3\n", 2, None),
    "pinned_bool_then_null": (b"a\ntrue\nfalse\nNULL\n", 2, None),
    "pinned_null_column": (b"a,b\n,1\n,2\nx,3\n", 2, None),
    "pinned_date_then_bad": (b"a\n2020-01-01\n2020-01-02\nnope\n", 2, None),
    "ragged_later": (b"a,b\n1,2\n3,4\n5\n", 2, None),
    "no_header": (b"1,x\n2,y\n3,z\n", 2, {"has_header": False}),
    "comment_and_skip": (b"junk\na,b\n#c\n1,2\n3,4\n", 1,
                         {"skip_rows": 1, "comment": "#"}),
    "empty": (b"", 3, None),
    "header_only": (b"a,b\n", 3, None),
    "strings_can_be_null": (b"s\nx\nNULL\ny\n", 2,
                            {"strings_can_be_null": True}),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streaming_reader_matches_jax(case):
    data, chunk, kw = STREAM_CASES[case]
    _same_stream(data, chunk, kw)


def test_streaming_reader_chunks_and_read_all():
    """tests/test_formats.py::test_csv_streaming_reader through the port."""
    src = ("x,y\n" + "\n".join(f"{i},{i * 2}" for i in range(10)) + "\n"
           ).encode()
    with tcsv.open_csv(src, tcsv.ReadOptions(chunk_size=4)) as r:
        batches = list(r)
    assert [b.num_rows for b in batches] == [4, 4, 2]
    assert batches[0].schema == batches[2].schema
    t = tcsv.open_csv(src, tcsv.ReadOptions(chunk_size=3)).read_all()
    assert t.num_rows == 10 and t.column("y").to_pylist()[-1] == 18
    jt = jcsv.open_csv(src, jcsv.ReadOptions(chunk_size=3)).read_all()
    same_table(t, jt)
    from arrow_go_tpu_torch.compute.errors import ArrowInvalid
    with pytest.raises(ArrowInvalid):
        tcsv.open_csv(b"a,b\n", tcsv.ReadOptions()).read_all()


def test_streaming_reader_from_a_path_and_a_text_stream(tmp_path):
    p = tmp_path / "x.csv"
    p.write_bytes(b"a,b\n1,x\n2,y\n3,z\n")
    for src in (str(p), io.StringIO(p.read_text()), io.BytesIO(
            p.read_bytes())):
        with tcsv.CSVReader(src, tcsv.ReadOptions(chunk_size=2)) as r:
            got = r.read_all()
        same_table(got, jcsv.read_csv(p.read_bytes()))
    same_table(tcsv.read_csv(str(p)), jcsv.read_csv(str(p)))
    same_table(tcsv.read_csv(io.BytesIO(p.read_bytes())),
               jcsv.read_csv(io.BytesIO(p.read_bytes())))


# -- the writer -------------------------------------------------------------

def _tables():
    """(name, JAX Table) of every type the writer takes, with nulls."""
    ts = [datetime.datetime(2020, 1, 1, 3, 4, 5), None,
          datetime.datetime(1969, 12, 31, 23, 59, 59)]
    return {
        "ints": agt.table({"i8": agt.array([1, None, -128], jdt.int8),
                           "u32": agt.array([0, 4294967295, None],
                                            jdt.uint32),
                           "i64": agt.array([2 ** 62, None, -7],
                                            jdt.int64)}),
        "floats": agt.table({
            "f": agt.array([0.1, 1e20, None], jdt.float64),
            "g": agt.array([1e-5, float("nan"), float("inf")], jdt.float64),
            "h": agt.array([-0.0, 2.5, 1 / 3], jdt.float64),
            "f32": agt.array([0.1, None, 3.0], jdt.float32)}),
        "strings": agt.table({
            "s": agt.array(["a", "b,c", None], jdt.string),
            "q": agt.array(['say "hi"', "two\nlines", ""], jdt.string),
            "u": agt.array(["ünï", " pad ", "x"],
                           jdt.large_string)}),
        "binary": agt.table({"b": agt.array([b"ab", None, b"\xff\xfe"],
                                            jdt.binary)}),
        "bools": agt.table({"b": agt.array([True, False, None],
                                           jdt.bool_)}),
        "temporal": agt.table({
            "d": agt.array([datetime.date(2020, 1, 1), None,
                            datetime.date(1900, 3, 1)], jdt.date32),
            "ts": agt.array(ts, jdt.timestamp("ms")),
            "tz": agt.array(ts, jdt.timestamp("us", "UTC"))}),
        "decimals": agt.table({
            "d": agt.array([decimal.Decimal("1.25"), None,
                            decimal.Decimal("-3.50")],
                           jdt.decimal128(10, 2))}),
        "mixed": agt.table({"i": [1, None, 3], "s": ["a", "b,c", None],
                            "f": [0.5, 1.5, None],
                            "b": [True, False, None]}),
        "empty": agt.table({"i": agt.array([], jdt.int64),
                            "s": agt.array([], jdt.string)}),
    }


def _port_batch(t) -> HostBatch:
    """The port's HostBatch of a JAX table's columns (a decimal's by its
    Python values)."""
    cols = [from_pylist(c.to_pylist(), port_type(c.type)) if c.type.is_decimal
            else port_array(c) for c in (t.column(i).combine()
                                         for i in range(t.num_columns))]
    return HostBatch(dt.Schema([dt.Field(f.name, port_type(f.type))
                                for f in t.schema.fields]), cols, t.num_rows)


WRITE_OPTIONS = {
    "default": {},
    "semicolon_no_header": {"delimiter": ";", "include_header": False},
    "null_crlf": {"null_string": "NULL", "crlf": True},
    "bool_formatter": {"bool_formatter": lambda b: "YES" if b else "NO"},
    "tab": {"delimiter": "\t", "null_string": "\\N"},
}


@pytest.mark.parametrize("opt", sorted(WRITE_OPTIONS))
@pytest.mark.parametrize("table", sorted(_tables()))
def test_write_csv_is_the_jax_bytes(table, opt):
    t = _tables()[table]
    kw = WRITE_OPTIONS[opt]
    js, ts = io.StringIO(), io.StringIO()
    jcsv.write_csv(t, js, jcsv.WriteOptions(**kw))
    tcsv.write_csv(_port_batch(t), ts, tcsv.WriteOptions(**kw))
    assert ts.getvalue() == js.getvalue()


def test_write_csv_to_paths_and_byte_streams(tmp_path):
    t = _tables()["mixed"]
    jp, tp = tmp_path / "j.csv", tmp_path / "t.csv"
    jcsv.write_csv(t, str(jp))
    tcsv.write_csv(_port_batch(t), str(tp))
    assert tp.read_bytes() == jp.read_bytes()
    jb, tb = io.BytesIO(), io.BytesIO()
    jcsv.write_csv(t, jb)
    tcsv.write_csv(_port_batch(t), tb)
    assert tb.getvalue() == jb.getvalue() and not tb.closed
    # a sequence of batches is one table (the JAX package's Table)
    two = io.StringIO()
    tcsv.write_csv([_port_batch(t), _port_batch(t)], two)
    j2 = io.StringIO()
    jcsv.write_csv(agt.Table.from_batches(t.to_batches() * 2), j2)
    assert two.getvalue() == j2.getvalue()


def test_write_options_and_roundtrip():
    """tests/test_formats.py::test_csv_write_options and
    ::test_csv_roundtrip through the port."""
    t = _port_batch(agt.table({"b": [True, False, None]}))
    sink = io.StringIO()
    tcsv.write_csv(t, sink, tcsv.WriteOptions(
        null_string="NULL", crlf=True,
        bool_formatter=lambda b: "YES" if b else "NO"))
    assert sink.getvalue() == "b\r\nYES\r\nNO\r\nNULL\r\n"
    jt = _tables()["mixed"]
    buf = io.StringIO()
    tcsv.write_csv(_port_batch(jt), buf)
    back = tcsv.read_csv(buf.getvalue().encode(),
                         tcsv.ReadOptions(strings_can_be_null=True))
    assert back.to_pydict() == jt.to_pydict()


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(
    st.one_of(st.none(), st.integers(-2 ** 63, 2 ** 63 - 1)),
    st.one_of(st.none(), st.floats(allow_nan=False, width=64)),
    st.one_of(st.none(), st.text(alphabet=st.characters(
        blacklist_categories=("Cs",), blacklist_characters="\r\x00"),
        max_size=6)),
    st.one_of(st.none(), st.booleans())), min_size=1, max_size=12),
    st.booleans())
def test_round_trip_through_both_writers_and_readers(rows, null_strings):
    cols = list(zip(*rows))
    t = agt.table({"i": agt.array(list(cols[0]), jdt.int64),
                   "f": agt.array(list(cols[1]), jdt.float64),
                   "s": agt.array(list(cols[2]), jdt.string),
                   "b": agt.array(list(cols[3]), jdt.bool_)})
    js, ts = io.StringIO(), io.StringIO()
    jcsv.write_csv(t, js)
    tcsv.write_csv(_port_batch(t), ts)
    assert ts.getvalue() == js.getvalue()
    data = ts.getvalue().encode()
    kw = {"strings_can_be_null": null_strings}
    _same_read(data, kw)


def test_csv_matches_pyarrow():
    """tests/test_formats.py::test_csv_matches_pyarrow: pyarrow's reader
    as a third opinion."""
    pacsv = pytest.importorskip("pyarrow.csv")
    for data in (b"a,b\n1,x\n,y\n3,\n", b"a,b,c\n1,2.5,x\n2,,y\n"):
        ours = tcsv.read_csv(data)
        theirs = pacsv.read_csv(io.BytesIO(data))
        assert ours.to_pydict() == theirs.to_pydict()
        same_table(ours, jcsv.read_csv(data))


# -- chip_smoke.py's csv paths on the CPU -------------------------------------

PATH_ROWS = 200_000


@pytest.fixture(scope="module")
def lineitem():
    import chip_smoke as cs
    li, _ = cs.make_data(PATH_ROWS, PATH_ROWS // 4)
    cs.add_quantity(li)
    cs.add_q1_columns(li)
    return li


def _jax_q6(jdb):
    """TPC-H Q6 composed of the JAX package's functions over a JAX
    DeviceBatch, as chip_smoke.compute_q6 composes the port's."""
    import arrow_go_tpu.compute as jpc
    from arrow_go_tpu.compute.functions import agg_sum as jax_agg_sum
    from test_torch_dataset import _jax_q6_expression, _jproject
    pred = _jax_q6_expression()
    li_f = jpc.filter(_jproject(jdb, ["l_price", "l_disc"]),
                      jpc.execute_scalar_expression(pred, jdb))
    rev = jpc.execute_scalar_expression(jpc.call("multiply", [
        jpc.field("l_price"), jpc.field("l_disc")]), li_f)
    return {"revenue": jax_agg_sum(rev) if li_f.length else 0.0,
            "count": li_f.length}


def _jax_device(table):
    from arrow_go_tpu.device.block import batch_to_device
    return batch_to_device(table.to_batches()[0])


def test_csv_q1_and_q6_paths_match_jax(lineitem):
    """Q1 and Q6 from csv text at 200,000 rows through chip_smoke.py's own
    functions (the text builder held byte for byte against the port's
    write_csv on every row; read_csv, the batch, compute_q1 /
    compute_q6) against the same composition of JAX functions over the
    JAX reader's table, and against numpy."""
    import chip_smoke as cs
    from test_torch_pipeline import _jax_q1, _same_q1
    li = lineitem
    text = cs.csv_text(li, cs.Q1_COLUMNS)
    assert cs.check_csv_writer(li, cs.Q1_COLUMNS, text, PATH_ROWS) == \
        len(text)
    times = {}
    hb, _, out = cs.csv_q1(text, "cpu", times)
    assert set(times) == {"read_s", "h2d_s", "compute_s"}
    cs.check_read("csv_q1", hb, li, cs.Q1_COLUMNS, 0, PATH_ROWS,
                  cs.CSV_TYPES)
    cs.check_q1(out, cs.q1_oracle(li))
    jt = jcsv.read_csv(text)
    same_table(hb, jt)
    _same_q1(out, _jax_q1(_jax_device(jt)))

    hb, _, q6 = cs.csv_q6(text, "cpu", {})
    cs.check_q6(q6, cs.q6_oracle(li))
    jt = jcsv.read_csv(text, jcsv.ReadOptions(
        include_columns=cs.Q6_COLUMNS))
    same_table(hb, jt)
    want = _jax_q6(_jax_device(jt))
    assert q6["count"] == want["count"]
    np.testing.assert_allclose(q6["revenue"], want["revenue"], rtol=1e-9)

    times = {}
    cut = cs._line_end(text, 65536)
    sq6, batches = cs.csv_stream_q6(text[:cut], "cpu", times)
    assert batches == -(-65536 // cs.CSV_STREAM_CHUNK)
    cs.check_q6(sq6, cs.q6_oracle(cs._rows(li, 0, 65536)))
