"""The port's Flight SQL (arrow_go_tpu_torch/flight/sql.py, dbapi.py)
against the JAX package's: every case of tests/test_flightsql.py in three
pairings of an SQLite example server and a client (port and port, JAX
server and port client, port server and JAX client), the port's DB-API
driver against both servers, and the columns a query gives typed as the
JAX `table(dict)` types them. The JAX side needs grpc and protobuf; the
port needs neither."""
import numpy as np
import pytest

from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.flight import h2, rpc
from arrow_go_tpu_torch.flight import sql as tsql

from torch_parity import port_type

PAIRINGS = [("port", "port"), ("jax", "port"), ("port", "jax")]
IDS = ["port-port", "jaxserver-portclient", "portserver-jaxclient"]


@pytest.fixture(autouse=True)
def _short_waits(monkeypatch):
    monkeypatch.setattr(h2, "TIMEOUT", 30.0)


def _sql(kind):
    """The flight.sql module of a side: the port's, or the JAX one."""
    if kind == "port":
        return tsql
    pytest.importorskip("grpc")
    from arrow_go_tpu.flight import sql as jsql
    return jsql


def _table(kind, data):
    if kind == "port":
        return tsql.table(data)
    import arrow_go_tpu as agt
    return agt.table(data)


def _client(kind, port):
    return _sql(kind).FlightSQLClient(f"grpc://127.0.0.1:{port}")


@pytest.fixture(scope="module", params=PAIRINGS, ids=IDS)
def pairing(request):
    return request.param


@pytest.fixture(scope="module")
def server(pairing):
    with _sql(pairing[0]).SQLiteFlightSQLServer() as srv:
        with _client(pairing[1], srv.port) as c:
            c.execute_update("CREATE TABLE people (id INTEGER, name TEXT, "
                             "score REAL)")
            c.execute_update("INSERT INTO people VALUES (1,'ann',9.5),"
                             "(2,'bo',7.25),(3,NULL,NULL)")
        yield srv


@pytest.fixture()
def client(server, pairing):
    with _client(pairing[1], server.port) as c:
        yield c


def test_execute_query(client):
    t = client.execute_query("SELECT id, name FROM people ORDER BY id")
    assert t.to_pydict() == {"id": [1, 2, 3], "name": ["ann", "bo", None]}


def test_execute_with_expression(client):
    t = client.execute_query("SELECT COUNT(*) AS c, SUM(score) AS s "
                             "FROM people")
    assert t.to_pydict() == {"c": [3], "s": [16.75]}


def test_execute_update_rowcount(client):
    n = client.execute_update("INSERT INTO people VALUES (9,'tmp',0)")
    assert n == 1
    client.execute_update("DELETE FROM people WHERE id = 9")


def test_get_flight_info_schema(client):
    info = client.execute("SELECT id FROM people")
    assert info.schema.names == ["id"]
    assert info.total_records == 3


def test_catalog_metadata(client):
    assert client.get_catalogs().to_pydict() == {"catalog_name": ["main"]}
    assert "people" in client.get_tables().column("table_name").to_pylist()
    assert client.get_table_types().column("table_type").to_pylist() == \
        ["TABLE", "VIEW"]
    assert client.get_db_schemas().column("db_schema_name").to_pylist() == \
        ["main"]


def test_get_tables_filter(client):
    t = client.get_tables(table_name_filter_pattern="peo%")
    assert t.column("table_name").to_pylist() == ["people"]
    t2 = client.get_tables(table_name_filter_pattern="zzz%")
    assert t2.num_rows == 0


def test_prepared_statement(client):
    ps = client.prepare("SELECT name FROM people WHERE id <= 2 ORDER BY id")
    assert ps.dataset_schema.names == ["name"]
    assert ps.execute().to_pydict() == {"name": ["ann", "bo"]}
    ps.close()


def test_bad_sql_raises(client, pairing):
    """A handler's sqlite error reaches the port's client as rpc.RpcError
    with status UNKNOWN, the JAX client as grpc.RpcError."""
    if pairing[1] == "port":
        with pytest.raises(rpc.RpcError) as e:
            client.execute_query("SELECT nope FROM missing_table")
        assert e.value.code() == rpc.StatusCode.UNKNOWN
        assert "missing_table" in e.value.details()
    else:
        import grpc
        with pytest.raises(grpc.RpcError) as e:
            client.execute_query("SELECT nope FROM missing_table")
        assert e.value.code() == grpc.StatusCode.UNKNOWN


# ---------------------------------------------------------------------------
# keys metadata, sql info, xdbc types, ingest, bind params, transactions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keyed_server(pairing):
    with _sql(pairing[0]).SQLiteFlightSQLServer() as srv:
        with _client(pairing[1], srv.port) as c:
            c.execute_update(
                "CREATE TABLE dept (id INTEGER PRIMARY KEY, name TEXT)")
            c.execute_update(
                "CREATE TABLE emp (id INTEGER PRIMARY KEY, dept_id INTEGER "
                "REFERENCES dept(id), name TEXT)")
            c.execute_update("INSERT INTO dept VALUES (1,'eng'),(2,'ops')")
        yield srv


@pytest.fixture()
def kclient(keyed_server, pairing):
    with _client(pairing[1], keyed_server.port) as c:
        yield c


def test_get_primary_keys(kclient):
    t = kclient.get_primary_keys("dept")
    d = t.to_pydict()
    assert d["column_name"] == ["id"]
    assert d["table_name"] == ["dept"]
    assert d["key_sequence"] == [1]


def test_get_imported_keys(kclient):
    t = kclient.get_imported_keys("emp")
    d = t.to_pydict()
    assert d["pk_table_name"] == ["dept"]
    assert d["fk_table_name"] == ["emp"]
    assert d["fk_column_name"] == ["dept_id"]


def test_get_exported_keys(kclient):
    t = kclient.get_exported_keys("dept")
    d = t.to_pydict()
    assert d["fk_table_name"] == ["emp"]


def test_get_cross_reference(kclient):
    t = kclient.get_cross_reference("dept", "emp")
    assert t.to_pydict()["fk_column_name"] == ["dept_id"]
    empty = kclient.get_cross_reference("nosuch", "emp")
    assert empty.num_rows == 0


def test_get_sql_info(kclient, pairing):
    t = kclient.get_sql_info()
    d = t.to_pydict()
    assert len(d["info_name"]) >= 5
    # filtered fetch
    SqlInfo = _sql(pairing[1]).SqlInfo
    t2 = kclient.get_sql_info([SqlInfo.FLIGHT_SQL_SERVER_NAME])
    assert t2.num_rows == 1
    assert t2.column("value").to_pylist()[0] == "arrow_go_tpu sqlite example"


def test_get_xdbc_type_info(kclient):
    t = kclient.get_xdbc_type_info()
    assert "INTEGER" in t.column("type_name").to_pylist()
    t2 = kclient.get_xdbc_type_info(12)
    assert t2.column("type_name").to_pylist() == ["TEXT"]


def test_tables_with_included_schema(kclient, pairing):
    t = kclient.get_tables(table_name_filter_pattern="dept")
    assert "table_schema" not in t.schema.names
    if pairing[1] == "port":
        from arrow_go_tpu_torch.flight import sql_messages as sqlpb
        from arrow_go_tpu_torch.flight.service import (
            FlightDescriptor, _schema_from_ipc_bytes)
    else:
        import arrow_go_tpu.flight.FlightSql_pb2 as sqlpb
        from arrow_go_tpu.flight.service import (FlightDescriptor,
                                                 _schema_from_ipc_bytes)
    pack_any = _sql(pairing[1]).pack_any
    cmd = sqlpb.CommandGetTables(table_name_filter_pattern="dept",
                                 include_schema=True)
    info = kclient._inner.get_flight_info(
        FlightDescriptor.for_command(pack_any(cmd)))
    tt = kclient._inner.do_get(info.endpoints[0].ticket).read_all()
    blob = tt.column("table_schema").to_pylist()[0]
    sch = _schema_from_ipc_bytes(blob)
    assert sch.names == ["id", "name"]


def test_execute_ingest(kclient, pairing):
    data = _table(pairing[1], {"a": [1, 2, 3], "b": ["x", "y", "z"]})
    n = kclient.execute_ingest(data, "ingested")
    assert n == 3
    t = kclient.execute_query("SELECT * FROM ingested ORDER BY a")
    assert t.to_pydict() == {"a": [1, 2, 3], "b": ["x", "y", "z"]}
    # append mode
    n = kclient.execute_ingest(data, "ingested", if_exists="append")
    assert n == 3
    assert kclient.execute_query(
        "SELECT COUNT(*) AS c FROM ingested").to_pydict()["c"] == [6]
    # replace mode
    n = kclient.execute_ingest(data, "ingested", if_exists="replace")
    assert kclient.execute_query(
        "SELECT COUNT(*) AS c FROM ingested").to_pydict()["c"] == [3]
    # fail mode raises
    with pytest.raises(Exception):
        kclient.execute_ingest(data, "ingested", if_exists="fail")


def test_prepared_statement_parameters(kclient, pairing):
    ps = kclient.prepare("SELECT name FROM dept WHERE id = ?")
    params = _table(pairing[1], {"p": [2]})
    ps.set_parameters(params)
    t = ps.execute()
    assert t.to_pydict() == {"name": ["ops"]}
    ps.close()


def test_prepared_update_with_params(kclient, pairing):
    kclient.execute_update("CREATE TABLE IF NOT EXISTS scratch (v INTEGER)")
    ps = kclient.prepare("INSERT INTO scratch VALUES (?)")
    n = ps.execute_update(_table(pairing[1], {"v": [10, 20, 30]}))
    assert n == 3
    assert kclient.execute_query(
        "SELECT COUNT(*) AS c FROM scratch").to_pydict()["c"] == [3]
    ps.close()


def test_transactions(kclient):
    kclient.execute_update("CREATE TABLE IF NOT EXISTS txt (v INTEGER)")
    tid = kclient.begin_transaction()
    kclient.execute_update("INSERT INTO txt VALUES (1)")
    kclient.rollback(tid)
    assert kclient.execute_query(
        "SELECT COUNT(*) AS c FROM txt").to_pydict()["c"] == [0]
    tid = kclient.begin_transaction()
    kclient.execute_update("INSERT INTO txt VALUES (2)")
    kclient.commit(tid)
    assert kclient.execute_query(
        "SELECT COUNT(*) AS c FROM txt").to_pydict()["c"] == [1]


def test_savepoints(kclient):
    kclient.execute_update("CREATE TABLE IF NOT EXISTS spt (v INTEGER)")
    tid = kclient.begin_transaction()
    kclient.execute_update("INSERT INTO spt VALUES (1)")
    sid = kclient.begin_savepoint(tid, "sp1")
    kclient.execute_update("INSERT INTO spt VALUES (2)")
    kclient.rollback_savepoint(sid)      # undoes the second insert only
    kclient.commit(tid)
    assert kclient.execute_query(
        "SELECT COUNT(*) AS c FROM spt").to_pydict()["c"] == [1]
    tid = kclient.begin_transaction()
    sid = kclient.begin_savepoint(tid, "sp2")
    kclient.execute_update("INSERT INTO spt VALUES (3)")
    kclient.release_savepoint(sid)
    kclient.commit(tid)
    assert kclient.execute_query(
        "SELECT COUNT(*) AS c FROM spt").to_pydict()["c"] == [2]


def test_cancel_query_action(kclient):
    from arrow_go_tpu_torch.flight import sql_messages as sqlpb
    info = kclient.execute("SELECT 1 AS one")
    res = kclient.cancel_query(info)
    assert res == sqlpb.ActionCancelQueryResult.CANCEL_RESULT_NOT_CANCELLABLE


def test_savepoint_listed_in_actions(kclient):
    names = {a[0] for a in kclient._inner.list_actions()}
    assert {"BeginSavepoint", "EndSavepoint", "CancelQuery"} <= names


# ---------------------------------------------------------------------------
# the port's DB-API driver against either server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["port", "jax"],
                ids=["portserver", "jaxserver"])
def db_server(request):
    with _sql(request.param).SQLiteFlightSQLServer() as srv:
        with _client(request.param, srv.port) as c:
            c.execute_update(
                "CREATE TABLE dept (id INTEGER PRIMARY KEY, name TEXT)")
            c.execute_update("INSERT INTO dept VALUES (1,'eng'),(2,'ops')")
        yield srv


def test_dbapi_basic(db_server):
    from arrow_go_tpu_torch.flight import dbapi
    with dbapi.connect(f"grpc://127.0.0.1:{db_server.port}") as conn:
        cur = conn.cursor()
        cur.execute("CREATE TABLE IF NOT EXISTS dbt (a INTEGER, b TEXT)")
        cur.executemany("INSERT INTO dbt VALUES (?, ?)",
                        [(1, "x"), (2, "y"), (3, None)])
        conn.commit()
        cur.execute("SELECT a, b FROM dbt ORDER BY a")
        assert cur.description[0][0] == "a"
        assert cur.description[0][1] == dbapi.NUMBER
        assert cur.description[1][1] == dbapi.STRING
        assert cur.fetchone() == (1, "x")
        assert cur.fetchmany(2) == [(2, "y"), (3, None)]
        assert cur.fetchone() is None
        cur.execute("SELECT COUNT(*) FROM dbt WHERE a > ?", (1,))
        assert cur.fetchall() == [(2,)]
        t = cur.fetch_arrow_table()
        assert t.num_rows == 1


def test_dbapi_rollback(db_server):
    from arrow_go_tpu_torch.flight import dbapi
    with dbapi.connect(f"grpc://127.0.0.1:{db_server.port}") as conn:
        cur = conn.cursor()
        cur.execute("CREATE TABLE IF NOT EXISTS dbr (v INTEGER)")
        conn.commit()
        cur.execute("INSERT INTO dbr VALUES (1)")
        conn.rollback()
        cur.execute("SELECT COUNT(*) FROM dbr")
        assert cur.fetchone() == (0,)


def test_dbapi_iteration(db_server):
    from arrow_go_tpu_torch.flight import dbapi
    with dbapi.connect(f"grpc://127.0.0.1:{db_server.port}") as conn:
        with conn.cursor() as cur:
            cur.execute("SELECT id FROM dept ORDER BY id")
            assert [r[0] for r in cur] == [1, 2]


def test_dbapi_closed_connection_and_no_result(db_server):
    from arrow_go_tpu_torch.flight import dbapi
    conn = dbapi.connect(f"grpc://127.0.0.1:{db_server.port}")
    cur = conn.cursor()
    cur.execute("CREATE TABLE IF NOT EXISTS dbc (v INTEGER)")
    with pytest.raises(dbapi.ProgrammingError):
        cur.fetch_arrow_table()
    conn.close()
    with pytest.raises(dbapi.InterfaceError):
        cur.execute("SELECT 1")


# ---------------------------------------------------------------------------
# a query's columns typed as the JAX table(dict) types them
# ---------------------------------------------------------------------------

TYPED = {
    "integers": "SELECT v FROM typed WHERE k = 'i'",
    "reals": "SELECT r FROM typed WHERE k = 'i'",
    "integral real": "SELECT CAST(2 AS REAL) AS r",
    "mixed nulls": "SELECT r FROM typed ORDER BY rowid",
    "all nulls": "SELECT NULL AS n, NULL AS m",
    "no rows": "SELECT v, s FROM typed WHERE 0",
    "strings and blobs": "SELECT s, b FROM typed ORDER BY rowid",
    "expression": "SELECT SUM(v) AS s, COUNT(*) AS c, AVG(r) AS a FROM typed",
}


@pytest.fixture(scope="module")
def typed_servers():
    pytest.importorskip("grpc")
    from arrow_go_tpu.flight import sql as jsql
    rng = np.random.default_rng(19)
    rows = [("i", int(v), float(r), f"s{v}", bytes([v % 256]))
            for v, r in zip(rng.integers(-50, 50, 9), rng.normal(size=9))]
    rows += [("n", None, None, None, None), ("i", 7, 2.0, "", b"")]
    out = []
    for mod in (tsql, jsql):
        srv = mod.SQLiteFlightSQLServer()
        srv.serve(block=False)
        with mod.FlightSQLClient(f"grpc://127.0.0.1:{srv.port}") as c:
            c.execute_update("CREATE TABLE typed (k TEXT, v INTEGER, "
                             "r REAL, s TEXT, b BLOB)")
        with srv._lock:
            srv._conn.executemany(
                "INSERT INTO typed VALUES (?, ?, ?, ?, ?)", rows)
        out.append(srv)
    yield out
    for srv in out:
        srv.shutdown()


@pytest.mark.parametrize("query", list(TYPED.values()), ids=list(TYPED))
def test_query_columns_are_typed_as_jax_types_them(typed_servers, query):
    from arrow_go_tpu.flight import sql as jsql
    port_srv, jax_srv = typed_servers
    with tsql.FlightSQLClient(f"grpc://127.0.0.1:{port_srv.port}") as c:
        ours = c.execute_query(query)
    with jsql.FlightSQLClient(f"grpc://127.0.0.1:{jax_srv.port}") as c:
        theirs = c.execute_query(query)
    assert [(f.name, f.type) for f in ours.schema.fields] == [
        (f.name, port_type(f.type)) for f in theirs.schema.fields]
    assert ours.to_pydict() == theirs.to_pydict()
    assert ours.num_rows == theirs.num_rows
    # and `sql.table` types the same values as the JAX `table` does
    import arrow_go_tpu as agt
    d = theirs.to_pydict()
    assert [f.type for f in tsql.table(d).schema.fields] == [
        port_type(f.type) for f in agt.table(d).schema.fields]


def test_sql_info_union_reads_the_same_across(typed_servers):
    """The SqlInfo dense union of each server, read by each client, gives
    the same names and values."""
    from arrow_go_tpu.flight import sql as jsql
    got = []
    for srv in typed_servers:
        for mod in (tsql, jsql):
            with mod.FlightSQLClient(f"grpc://127.0.0.1:{srv.port}") as c:
                got.append(c.get_sql_info().to_pydict())
    assert all(g == got[0] for g in got), got
    assert got[0]["value"][got[0]["info_name"].index(508)] == \
        ["SELECT", "FROM", "WHERE", "INSERT"]
    assert tsql.SCHEMA_SQL_INFO.field(1).type == port_type(
        jsql.SCHEMA_SQL_INFO.field(1).type)


def test_ingested_int32_reads_back_as_int64(typed_servers):
    """SQLite's INTEGER affinity: an int32 column ingested by the port
    comes back as int64, on either server."""
    from arrow_go_tpu_torch.device.block import HostArray, HostBatch
    hb = HostBatch(tdt.Schema([tdt.Field("q", tdt.int32, False)]),
                   [HostArray(np.arange(5, dtype=np.int32), None,
                              tdt.int32)], 5)
    for srv in typed_servers:
        with tsql.FlightSQLClient(f"grpc://127.0.0.1:{srv.port}") as c:
            assert c.execute_ingest(hb, "narrow", if_exists="replace") == 5
            out = c.execute_query("SELECT q FROM narrow ORDER BY q")
        assert out.schema.field(0).type == tdt.int64
        assert out.column("q").combine().values.tolist() == list(range(5))
