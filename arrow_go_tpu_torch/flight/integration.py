"""The Flight integration scenarios (after
arrow_go_tpu/flight/integration.py; reference
arrow/internal/flight_integration/scenario.go and the archery drivers
cmd/arrow-flight-integration-{server,client}), on the port's own gRPC;
`flight_sql` and `flight_sql:ingestion` against the SQLite example
server (flight/sql.py).

Each scenario is a (server factory, client runner) pair in SCENARIOS;
the client raises AssertionError (or an rpc.RpcError) on any deviation.
From the CLI:

    python -m arrow_go_tpu_torch.cli flight-integration server --scenario ordered
    python -m arrow_go_tpu_torch.cli flight-integration client \\
        --scenario ordered --uri grpc://localhost:PORT
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..device.block import HostArray, HostBatch
from . import messages as fm
from .rpc import RpcError, StatusCode
from .service import (Action, FlightClient, FlightDescriptor, FlightEndpoint,
                      FlightInfo, FlightServerBase, Result, Ticket)
from .session import CookieMiddleware, SessionManager

class Scenario:
    def __init__(self, name: str,
                 make_server: Callable[[], FlightServerBase],
                 run_client: Callable[[str], None]):
        self.name = name
        self.make_server = make_server
        self.run_client = run_client


SCENARIOS: Dict[str, Scenario] = {}


def _register(name):
    def deco(pair_fn):
        make_server, run_client = pair_fn()
        SCENARIOS[name] = Scenario(name, make_server, run_client)
        return pair_fn
    return deco


def scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"no flight integration scenario {name!r}")
    return SCENARIOS[name]


_NUMBER = dt.Schema([dt.Field("number", dt.int32, False)])


def _int_table(values: List[int]) -> HostBatch:
    return HostBatch(_NUMBER, [HostArray(np.asarray(values, np.int32), None,
                                         dt.int32)], len(values))


def _numbers(batch: HostBatch) -> List[int]:
    return batch.column("number").to_pylist()


class HeaderMiddleware(CookieMiddleware):
    """Sends fixed metadata with every call and keeps the last response's
    initial metadata (the client half of the 'middleware' scenario)."""

    def __init__(self, headers: Optional[List[Tuple[str, object]]] = None):
        super().__init__()
        self.headers = list(headers or [])
        self.last_initial_metadata: List[Tuple[str, object]] = []

    def sending_headers(self, method: str):
        return list(self.headers)

    def received_headers(self, method: str, metadata) -> None:
        self.last_initial_metadata = list(metadata or ())

    def received(self, key: str) -> Optional[object]:
        for k, v in self.last_initial_metadata:
            if k.lower() == key.lower():
                return v
        return None


# ---------------------------------------------------------------------------
# auth:basic_proto
# ---------------------------------------------------------------------------

AUTH_USER, AUTH_PASS = "arrow", "flight"
_AUTH_TOKEN = b"secret-session-token"


@_register("auth:basic_proto")
def _auth_basic_proto():
    class Server(FlightServerBase):
        def handshake(self, ctx, requests):
            for req in requests:
                auth = fm.BasicAuth.FromString(req.payload)
                if (auth.username, auth.password) != (AUTH_USER, AUTH_PASS):
                    ctx.abort(StatusCode.UNAUTHENTICATED,
                              "invalid credentials")
                yield fm.HandshakeResponse(payload=_AUTH_TOKEN)

        def _require_auth(self, ctx) -> None:
            for k, v in ctx.invocation_metadata() or ():
                if k.lower() == "auth-token-bin" and v == _AUTH_TOKEN:
                    return
            ctx.abort(StatusCode.UNAUTHENTICATED, "no token")

        def do_action(self, ctx, action: Action):
            self._require_auth(ctx)
            yield Result(AUTH_USER.encode() if action.type == "who-am-i"
                         else b"")

    def client(uri: str):
        with FlightClient(uri) as c:
            try:
                list(c.do_action(Action("who-am-i")))
                raise AssertionError("expected UNAUTHENTICATED")
            except RpcError as e:
                assert e.code() == StatusCode.UNAUTHENTICATED, e.code()
            token = c.handshake(fm.BasicAuth(
                username=AUTH_USER, password=AUTH_PASS).SerializeToString())
            assert token == _AUTH_TOKEN
        mw = HeaderMiddleware([("auth-token-bin", token)])
        with FlightClient(uri, middleware=[mw]) as c:
            (res,) = list(c.do_action(Action("who-am-i")))
            assert res.body == AUTH_USER.encode(), res.body

    return Server, client


# ---------------------------------------------------------------------------
# middleware
# ---------------------------------------------------------------------------

@_register("middleware")
def _middleware():
    class Server(FlightServerBase):
        def get_flight_info(self, ctx, descriptor: FlightDescriptor):
            # the client's x-middleware header comes back on the success
            # and on the error path
            val = ""
            for k, v in ctx.invocation_metadata() or ():
                if k.lower() == "x-middleware":
                    val = v
            ctx.send_initial_metadata((("x-middleware", val),))
            if descriptor.command == b"success":
                return FlightInfo(_NUMBER, descriptor,
                                  [FlightEndpoint(Ticket(b"foo"))])
            ctx.abort(StatusCode.UNIMPLEMENTED, "expected failure")

    def client(uri: str):
        mw = HeaderMiddleware([("x-middleware", "expected value")])
        with FlightClient(uri, middleware=[mw]) as c:
            try:
                c.get_flight_info(FlightDescriptor.for_command(b"fail"))
                raise AssertionError("expected failure")
            except RpcError:
                pass
            assert mw.received("x-middleware") == "expected value", \
                mw.last_initial_metadata
            mw.last_initial_metadata = []
            c.get_flight_info(FlightDescriptor.for_command(b"success"))
            assert mw.received("x-middleware") == "expected value"

    return Server, client


# ---------------------------------------------------------------------------
# ordered
# ---------------------------------------------------------------------------

@_register("ordered")
def _ordered():
    parts = {b"1": [1, 2, 3], b"2": [10, 20, 30], b"3": [100, 200, 300]}

    class Server(FlightServerBase):
        def get_flight_info(self, ctx, descriptor):
            return FlightInfo(
                _NUMBER, descriptor,
                [FlightEndpoint(Ticket(t)) for t in (b"1", b"2", b"3")],
                ordered=True)

        def do_get(self, ctx, ticket: Ticket):
            if ticket.ticket not in parts:
                ctx.abort(StatusCode.NOT_FOUND, "no such ticket")
            return _int_table(parts[ticket.ticket])

    def client(uri: str):
        with FlightClient(uri) as c:
            info = c.get_flight_info(FlightDescriptor.for_command(b"ordered"))
            assert info.ordered, "expected ordered FlightInfo"
            got = []
            for ep in info.endpoints:        # in order, as ordered demands
                got.extend(_numbers(c.do_get(ep.ticket).read_all()))
            assert got == [1, 2, 3, 10, 20, 30, 100, 200, 300], got

    return Server, client


# ---------------------------------------------------------------------------
# the expiration_time family
# ---------------------------------------------------------------------------

def _expiration_server():
    class Server(FlightServerBase):
        def __init__(self):
            super().__init__()
            self.cancelled = False
            self.lock = threading.Lock()

        def get_flight_info(self, ctx, descriptor):
            now = time.time()
            return FlightInfo(
                _NUMBER, descriptor,
                [FlightEndpoint(Ticket(b"no-expiration")),
                 FlightEndpoint(Ticket(b"valid"), expiration_time=now + 600),
                 FlightEndpoint(Ticket(b"expired"),
                                expiration_time=now - 1)])

        def do_get(self, ctx, ticket: Ticket):
            with self.lock:
                if self.cancelled:
                    ctx.abort(StatusCode.NOT_FOUND, "flight cancelled")
            if ticket.ticket == b"expired":
                ctx.abort(StatusCode.NOT_FOUND, "endpoint expired")
            return _int_table([1, 2, 3])

        def cancel_flight_info(self, ctx, info: FlightInfo) -> int:
            with self.lock:
                already = self.cancelled
                self.cancelled = True
            return (fm.CANCEL_STATUS_NOT_CANCELLABLE if already
                    else fm.CANCEL_STATUS_CANCELLED)

        def renew_flight_endpoint(self, ctx, endpoint) -> FlightEndpoint:
            ep = FlightEndpoint.from_proto(endpoint)
            ep.expiration_time = (ep.expiration_time or time.time()) + 600
            return ep

        def list_actions(self, ctx):
            return iter([("CancelFlightInfo", "cancel a FlightInfo"),
                         ("RenewFlightEndpoint", "extend an endpoint")])

    return Server


@_register("expiration_time:do_get")
def _expiration_do_get():
    def client(uri: str):
        with FlightClient(uri) as c:
            eps = c.get_flight_info(
                FlightDescriptor.for_command(b"x")).endpoints
            assert eps[0].expiration_time is None
            assert eps[1].expiration_time is not None
            assert eps[2].expiration_time is not None
            assert c.do_get(eps[0].ticket).read_all().num_rows == 3
            assert c.do_get(eps[1].ticket).read_all().num_rows == 3
            try:
                c.do_get(eps[2].ticket).read_all()
                raise AssertionError("expected expired-endpoint error")
            except RpcError as e:
                assert e.code() == StatusCode.NOT_FOUND, e.code()

    return _expiration_server(), client


@_register("expiration_time:list_actions")
def _expiration_list_actions():
    def client(uri: str):
        with FlightClient(uri) as c:
            types = {t for t, _ in c.list_actions()}
            assert types == {"CancelFlightInfo", "RenewFlightEndpoint"}, types

    return _expiration_server(), client


@_register("expiration_time:cancel_flight_info")
def _expiration_cancel():
    def client(uri: str):
        with FlightClient(uri) as c:
            info = c.get_flight_info(FlightDescriptor.for_command(b"x"))
            assert c.cancel_flight_info(info) == fm.CANCEL_STATUS_CANCELLED
            assert c.cancel_flight_info(info) == \
                fm.CANCEL_STATUS_NOT_CANCELLABLE        # a no-op
            try:
                c.do_get(info.endpoints[0].ticket).read_all()
                raise AssertionError("expected cancelled-flight error")
            except RpcError as e:
                assert e.code() == StatusCode.NOT_FOUND, e.code()

    return _expiration_server(), client


@_register("expiration_time:renew_flight_endpoint")
def _expiration_renew():
    def client(uri: str):
        with FlightClient(uri) as c:
            info = c.get_flight_info(FlightDescriptor.for_command(b"x"))
            ep = info.endpoints[1]
            renewed = c.renew_flight_endpoint(ep)
            assert renewed.expiration_time is not None
            assert renewed.expiration_time > ep.expiration_time, \
                (renewed.expiration_time, ep.expiration_time)
            assert c.do_get(renewed.ticket).read_all().num_rows == 3

    return _expiration_server(), client


# ---------------------------------------------------------------------------
# poll_flight_info
# ---------------------------------------------------------------------------

@_register("poll_flight_info")
def _poll():
    class Server(FlightServerBase):
        def poll_flight_info(self, ctx, descriptor: FlightDescriptor):
            if descriptor.command == b"poll":
                # in progress: a partial info and a descriptor to retry
                info = FlightInfo(_NUMBER, descriptor,
                                  [FlightEndpoint(Ticket(b"part-1"))])
                return fm.PollInfo(
                    info=info.to_proto(), progress=0.1,
                    flight_descriptor=FlightDescriptor.for_command(
                        b"poll-retry").proto)
            info = FlightInfo(_NUMBER, descriptor,
                              [FlightEndpoint(Ticket(b"part-1")),
                               FlightEndpoint(Ticket(b"part-2"))])
            return fm.PollInfo(info=info.to_proto(), progress=1.0)

    def client(uri: str):
        with FlightClient(uri) as c:
            info, retry, progress = c.poll_flight_info(
                FlightDescriptor.for_command(b"poll"))
            assert retry is not None and retry.command == b"poll-retry"
            assert progress is not None and progress < 1.0
            assert len(info.endpoints) == 1
            info, retry, progress = c.poll_flight_info(retry)
            assert retry is None, "complete query must clear the descriptor"
            assert progress == 1.0
            assert len(info.endpoints) == 2

    return Server, client


# ---------------------------------------------------------------------------
# app_metadata_flight_info_endpoint
# ---------------------------------------------------------------------------

@_register("app_metadata_flight_info_endpoint")
def _app_metadata():
    class Server(FlightServerBase):
        def get_flight_info(self, ctx, descriptor):
            return FlightInfo(
                _NUMBER, descriptor,
                [FlightEndpoint(Ticket(b"foo"), app_metadata=b"bar")],
                app_metadata=b"foobar")

    def client(uri: str):
        with FlightClient(uri) as c:
            info = c.get_flight_info(FlightDescriptor.for_command(b"md"))
            assert info.app_metadata == b"foobar", info.app_metadata
            assert info.endpoints[0].app_metadata == b"bar"

    return Server, client


# ---------------------------------------------------------------------------
# location:reuse_connection
# ---------------------------------------------------------------------------

REUSE_URI = "arrow-flight-reuse-connection://?"


@_register("location:reuse_connection")
def _reuse_connection():
    class Server(FlightServerBase):
        def get_flight_info(self, ctx, descriptor):
            return FlightInfo(
                _NUMBER, descriptor,
                [FlightEndpoint(Ticket(b"reuse"), locations=[REUSE_URI])])

        def do_get(self, ctx, ticket: Ticket):
            return _int_table([1, 2, 3])

    def client(uri: str):
        with FlightClient(uri) as c:
            info = c.get_flight_info(FlightDescriptor.for_command(b"reuse"))
            ep = info.endpoints[0]
            assert ep.locations == [REUSE_URI], ep.locations
            # reuse-connection: the data comes over the same connection
            assert _numbers(c.do_get(ep.ticket).read_all()) == [1, 2, 3]

    return Server, client


# ---------------------------------------------------------------------------
# session_options
# ---------------------------------------------------------------------------

@_register("session_options")
def _session_options():
    class Server(FlightServerBase):
        def __init__(self):
            super().__init__()
            self.sessions = SessionManager()

    def client(uri: str):
        mw = CookieMiddleware()
        with FlightClient(uri, middleware=[mw]) as c:
            errors = c.set_session_options({
                "foolong": 123,
                "bardouble": 456.0,
                "big_ol_string_list": ["a", "b", "see"],
                "": "invalid-empty-name",
            })
            assert set(errors) == {""}, errors
            got = c.get_session_options()
            assert got == {"foolong": 123, "bardouble": 456.0,
                           "big_ol_string_list": ["a", "b", "see"]}, got
            assert c.set_session_options({"foolong": None}) == {}
            got = c.get_session_options()
            assert "foolong" not in got and "bardouble" in got
            assert c.close_session() == fm.CloseSessionResult.STATUS_CLOSED

    return Server, client


# ---------------------------------------------------------------------------
# flight_sql / flight_sql:ingestion (reference scenario.go:77-91, backed by
# the SQLite example server like flightsql/example)
# ---------------------------------------------------------------------------

def _sqlite_server():
    from .sql import SQLiteFlightSQLServer
    return SQLiteFlightSQLServer


@_register("flight_sql")
def _flight_sql():
    def client(uri: str):
        from .sql import FlightSQLClient, table
        with FlightSQLClient(uri) as c:
            c.execute_update(
                "CREATE TABLE IF NOT EXISTS intTable "
                "(id INTEGER PRIMARY KEY, keyName TEXT, value INTEGER)")
            assert c.execute_update(
                "INSERT INTO intTable (keyName, value) VALUES "
                "('one', 1), ('zero', 0), ('negative one', -1)") == 3
            t = c.execute_query(
                "SELECT keyName, value FROM intTable ORDER BY value")
            assert t.to_pydict() == {
                "keyName": ["negative one", "zero", "one"],
                "value": [-1, 0, 1]}, t.to_pydict()
            # catalog metadata round trips
            tables = c.get_tables(table_types=["table"])
            assert "intTable" in tables.column("table_name").to_pylist()
            assert c.get_table_types().num_rows >= 1
            info = c.get_sql_info()
            assert info.num_rows > 0
            # prepared statement with parameter binding
            ps = c.prepare("SELECT keyName FROM intTable WHERE value = ?")
            ps.set_parameters(table({"p": [1]}))
            got = ps.execute()
            assert got.to_pydict() == {"keyName": ["one"]}, got.to_pydict()
            ps.close()
            # transaction commit/rollback
            txn = c.begin_transaction()
            c.execute_update("INSERT INTO intTable (keyName, value) "
                             "VALUES ('txn', 9)")
            c.rollback(txn)
            t = c.execute_query(
                "SELECT COUNT(*) AS c FROM intTable WHERE value = 9")
            assert t.to_pydict()["c"] == [0]
            c.execute_update("DROP TABLE intTable")

    return _sqlite_server(), client


@_register("flight_sql:ingestion")
def _flight_sql_ingestion():
    def client(uri: str):
        from .sql import FlightSQLClient, table
        with FlightSQLClient(uri) as c:
            data = table({"a": [1, 2, 3], "b": ["x", "y", "z"]})
            assert c.execute_ingest(data, "ingest_tbl") == 3
            assert c.execute_ingest(data, "ingest_tbl",
                                    if_exists="append") == 3
            t = c.execute_query("SELECT COUNT(*) AS c FROM ingest_tbl")
            assert t.to_pydict()["c"] == [6]
            assert c.execute_ingest(data, "ingest_tbl",
                                    if_exists="replace") == 3
            t = c.execute_query(
                "SELECT a, b FROM ingest_tbl ORDER BY a")
            assert t.to_pydict() == {"a": [1, 2, 3], "b": ["x", "y", "z"]}
            c.execute_update("DROP TABLE ingest_tbl")

    return _sqlite_server(), client


# ---------------------------------------------------------------------------
# the runners (cmd/arrow-flight-integration-{server,client})
# ---------------------------------------------------------------------------

def run_scenario_server(name: str, port: int = 0,
                        block: bool = True) -> FlightServerBase:
    srv = scenario(name).make_server()
    srv._location = f"grpc://0.0.0.0:{port}"
    srv.serve(block=False)
    print(f"scenario {name!r} serving on port {srv.port}", flush=True)
    if block:
        srv._server.wait_for_termination()
    return srv


def run_scenario_client(name: str, uri: str) -> None:
    scenario(name).run_client(uri)
    print(f"scenario {name!r} passed", flush=True)


def run_scenario_inprocess(name: str) -> None:
    """The server and the client on a loopback ephemeral port, in one
    process."""
    srv = run_scenario_server(name, block=False)
    try:
        run_scenario_client(name, f"grpc://localhost:{srv.port}")
    finally:
        srv.shutdown()
