"""The port's CLI (arrow_go_tpu_torch/cli.py) against the JAX package's
(tests/test_cli.py, case for case): on the same JAX-written files the
port's stdout is the JAX CLI's, its conversions hold the same values,
and the integration-JSON tool converts and validates as the JAX one
does. The port runs with --device cpu."""
import contextlib
import io

import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import cli as jcli
from arrow_go_tpu import dtypes as dt
from arrow_go_tpu import ipc
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.interop import arrjson

from arrow_go_tpu_torch import cli as tcli
from arrow_go_tpu_torch import formats as tformats
from arrow_go_tpu_torch import parquet as tpq


@pytest.fixture
def sample(tmp_path):
    t = agt.table({"x": agt.array([1, None, 3], dt.int64),
                   "s": ["a", None, "c"],
                   "f": [0.5, None, -2.25]})
    p = tmp_path / "t.arrow"
    with open(p, "wb") as f:
        with ipc.new_file(f, t.schema) as w:
            w.write_table(t)
    jpq.write_table(t, str(tmp_path / "j.parquet"))
    return t, str(p), tmp_path


def _out(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _same(argv) -> str:
    want = _out(jcli.main, argv)
    got = _out(tcli.main, ["--device", "cpu"] + argv)
    assert got == want
    return got


def test_cat_ls_schema(sample):
    t, arrow_path, tmp = sample
    pq_path = str(tmp / "j.parquet")
    for path in (arrow_path, pq_path):
        out = _same(["cat", path])
        assert "x" in out and "s" in out
        assert "3" in _same(["ls", path])
        _same(["cat", "--rows", "2", path])
    out = _same(["schema", pq_path])
    assert "x" in out and "codec=SNAPPY" in out
    _same(["schema", arrow_path])
    # the port's conversion to parquet reads back as the JAX one does
    ours, theirs = str(tmp / "p.parquet"), str(tmp / "q.parquet")
    assert _out(tcli.main, ["--device", "cpu", "convert", arrow_path,
                            ours]) == f"wrote {ours}\n"
    _out(jcli.main, ["convert", arrow_path, theirs])
    assert jpq.read_table(ours).to_pydict() == \
        jpq.read_table(theirs).to_pydict() == t.to_pydict()
    assert _out(tcli.main, ["--device", "cpu", "ls", ours]) == \
        _out(jcli.main, ["ls", theirs])


def test_convert_roundtrip(sample):
    t, arrow_path, tmp = sample
    for ext in ("csv", "json", "arrow", "arrows", "parquet"):
        ours = str(tmp / f"p.{ext}")
        _out(tcli.main, ["--device", "cpu", "convert", arrow_path, ours])
        back = _out(tcli.main, ["--device", "cpu", "cat", ours])
        if ext != "arrows":
            assert back == _out(jcli.main, ["cat", arrow_path])
    back = tformats.read_csv(str(tmp / "p.csv"))
    assert back.column("x").to_pylist() == [1, None, 3]
    assert tpq.read_table(str(tmp / "p.parquet"), device="cpu").column(
        "f").to_pylist() == [0.5, None, -2.25]
    with pytest.raises(SystemExit):
        tcli.main(["--device", "cpu", "convert", arrow_path,
                   str(tmp / "p.xyz")])


def test_json_integration(sample, capsys):
    t, arrow_path, tmp = sample
    jpath = str(tmp / "t.json")
    with open(jpath, "w") as f:
        f.write(arrjson.write_arrjson(t.to_batches()))
    a2 = str(tmp / "t2.arrow")
    tcli.main(["json-integration", "--mode", "JSON_TO_ARROW",
               "--json", jpath, "--arrow", a2])
    tcli.main(["json-integration", "--mode", "VALIDATE",
               "--json", jpath, "--arrow", a2])
    assert "validation passed" in capsys.readouterr().out
    # the JAX tool validates the port's arrow file too
    jcli.main(["json-integration", "--mode", "VALIDATE",
               "--json", jpath, "--arrow", a2])
    assert "validation passed" in capsys.readouterr().out
    j2 = str(tmp / "t2.json")
    tcli.main(["json-integration", "--mode", "ARROW_TO_JSON",
               "--json", j2, "--arrow", a2])
    assert arrjson.read_arrjson(open(j2).read())[0].num_rows == 3
    assert _out(tcli.main, ["cat", a2]) == _out(jcli.main, ["cat",
                                                            arrow_path])


def test_flight_integration_lists_the_ported_scenarios():
    """The JAX CLI's list, unfiltered: the two FlightSQL scenarios are
    ported too."""
    from arrow_go_tpu_torch.flight import integration as tfi
    got = _out(tcli.main, ["flight-integration", "list"]).split()
    want = _out(jcli.main, ["flight-integration", "list"]).split()
    assert got == want == sorted(tfi.SCENARIOS) and len(got) == 13
    assert {"flight_sql", "flight_sql:ingestion"} <= set(got)


@pytest.mark.parametrize("name", ["ordered", "session_options",
                                  "flight_sql", "flight_sql:ingestion"])
def test_flight_integration_runs_a_scenario(name):
    """The port's CLI client against the port's scenario server, and
    against the JAX one."""
    pytest.importorskip("grpc")
    from arrow_go_tpu.flight import integration as jfi
    from arrow_go_tpu_torch.flight import integration as tfi
    for fi in (tfi, jfi):
        srv = fi.run_scenario_server(name, block=False)
        try:
            out = _out(tcli.main, ["flight-integration", "client",
                                   "--scenario", name, "--port",
                                   str(srv.port)])
        finally:
            srv.shutdown()
        assert f"scenario {name!r} passed" in out


def test_json_integration_validate_mismatch(sample, tmp_path):
    t, arrow_path, tmp = sample
    bad = agt.table({"x": agt.array([9, 9, 9], dt.int64),
                     "s": ["a", None, "c"], "f": [0.5, None, -2.25]})
    jpath = str(tmp / "bad.json")
    with open(jpath, "w") as f:
        f.write(arrjson.write_arrjson(bad.to_batches()))
    with pytest.raises(SystemExit, match="data mismatch"):
        tcli.main(["json-integration", "--mode", "VALIDATE",
                   "--json", jpath, "--arrow", arrow_path])
    other = agt.table({"y": agt.array([1, None, 3], dt.int64)})
    with open(jpath, "w") as f:
        f.write(arrjson.write_arrjson(other.to_batches()))
    with pytest.raises(SystemExit, match="schema mismatch"):
        tcli.main(["json-integration", "--mode", "VALIDATE",
                   "--json", jpath, "--arrow", arrow_path])
