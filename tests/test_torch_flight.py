"""The port's Flight (arrow_go_tpu_torch/flight) on its own gRPC, held
against the JAX package's Flight (grpc C-core) and pyarrow.flight (Arrow
C++ over grpc C-core): every test of tests/test_flight.py in every
pairing of a server and a client of the three, then a 24 MB batch (cut
frames, waited windows), concurrent calls on one connection, a DoGet
closed early, and error statuses with `-bin` metadata. Every server
binds port 0 on the loopback and closes in a fixture; every call the
port makes waits at most h2.TIMEOUT seconds."""
import threading
import time

import numpy as np
import pytest

import arrow_go_tpu as agt
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu_torch import compute as tpc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch import flight as tfl
from arrow_go_tpu_torch.device.block import HostArray, HostBatch
from arrow_go_tpu_torch.flight import h2, messages as fm, rpc

from torch_parity import port_record_batch

grpc = pytest.importorskip("grpc")
from arrow_go_tpu import flight as jfl  # noqa: E402

pafl = pytest.importorskip("pyarrow.flight")
import pyarrow as pa  # noqa: E402

T1 = {"x": [1, 2, None], "s": ["a", None, "c"]}


@pytest.fixture(autouse=True)
def _short_waits(monkeypatch):
    monkeypatch.setattr(h2, "TIMEOUT", 30.0)


def _jax_t1():
    return agt.table(T1)


def _port(table) -> HostBatch:
    return port_record_batch(table.to_batches()[0])


def _put_table():
    return agt.table({"v": [9, 8], "w": [None, "z"],
                      "d": agt.array(["p", "p", None],
                                     jdt.dictionary(jdt.int32, jdt.string))
                      .slice(0, 2)})


# ---------------------------------------------------------------------------
# the three servers
# ---------------------------------------------------------------------------

class PortDemo(tfl.FlightServerBase):
    def __init__(self):
        super().__init__("grpc://127.0.0.1:0")
        self.tables = {b"t1": _port(_jax_t1())}

    def do_get(self, ctx, ticket):
        if ticket.ticket == b"many":
            return self.many(ctx)
        return self.tables[ticket.ticket]

    def many(self, ctx):
        """A long stream whose end the server records (the early-close
        test)."""
        self.closed_early = threading.Event()
        schema = tdt.Schema([tdt.Field("i", tdt.int64, False)])

        def gen():
            try:
                for k in range(100_000):
                    yield HostBatch(schema, [HostArray(
                        np.arange(k * 4096, (k + 1) * 4096), None,
                        tdt.int64)], 4096)
            except GeneratorExit:
                self.closed_early.set()
                raise
        return schema, gen()

    def do_put(self, ctx, desc, reader):
        self.tables[desc.path[0].encode()] = reader.read_all()
        yield b"ok"

    def get_flight_info(self, ctx, desc):
        t = self.tables[desc.path[0].encode()]
        return tfl.FlightInfo(t.schema, desc,
                              [tfl.FlightEndpoint(tfl.Ticket(desc.path[0]))],
                              t.num_rows, -1)

    def list_flights(self, ctx, criteria):
        for name, t in list(self.tables.items()):
            d = tfl.FlightDescriptor.for_path(name.decode())
            yield tfl.FlightInfo(t.schema, d,
                                 [tfl.FlightEndpoint(tfl.Ticket(name))],
                                 t.num_rows, -1)

    def do_exchange(self, ctx, desc, reader):
        t = reader.read_all().to_batches()[0]
        c0 = t.columns[0]
        keep = np.ones(t.num_rows, np.bool_) if c0.mask is None else c0.mask
        out = tpc.filter_(t, HostArray(keep, None, tdt.bool_), device="cpu")
        return out.schema, [out]

    def do_action(self, ctx, action):
        if action.type == "ping":
            yield tfl.Result(b"pong:" + action.body)
        elif action.type == "fail-bin":
            ctx.set_trailing_metadata([("x-detail-bin",
                                        b"\x00\xffdetail" * 9)])
            ctx.abort(rpc.StatusCode.FAILED_PRECONDITION, "with detail")
        elif action.type == "refused":
            raise ConnectionRefusedError("the backend is down")
        else:
            raise NotImplementedError(action.type)

    def list_actions(self, ctx):
        yield ("ping", "responds with pong")


class JaxDemo(jfl.FlightServerBase):
    """The JAX test's DemoServer (tests/test_flight.py)."""

    def __init__(self):
        super().__init__("grpc://127.0.0.1:0")
        self.tables = {b"t1": _jax_t1()}

    def do_get(self, ctx, ticket):
        return self.tables[ticket.ticket]

    def do_put(self, ctx, desc, reader):
        self.tables[desc.path[0].encode()] = reader.read_all()
        yield b"ok"

    def get_flight_info(self, ctx, desc):
        t = self.tables[desc.path[0].encode()]
        return jfl.FlightInfo(t.schema, desc,
                              [jfl.FlightEndpoint(jfl.Ticket(desc.path[0]))],
                              t.num_rows, -1)

    def list_flights(self, ctx, criteria):
        for name, t in list(self.tables.items()):
            d = jfl.FlightDescriptor.for_path(name.decode())
            yield jfl.FlightInfo(t.schema, d,
                                 [jfl.FlightEndpoint(jfl.Ticket(name))],
                                 t.num_rows, -1)

    def do_exchange(self, ctx, desc, reader):
        from arrow_go_tpu import compute as pc
        rb = reader.read_all().to_batches()[0]
        out = pc.filter(rb, pc.is_valid(rb.column(0)))
        return out.schema, [out]

    def do_action(self, ctx, action):
        if action.type == "ping":
            yield jfl.Result(b"pong:" + action.body)
        elif action.type == "fail-bin":
            ctx.set_trailing_metadata((("x-detail-bin",
                                        b"\x00\xffdetail" * 9),))
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, "with detail")
        elif action.type == "refused":
            raise ConnectionRefusedError("the backend is down")
        else:
            raise NotImplementedError(action.type)

    def list_actions(self, ctx):
        yield ("ping", "responds with pong")


class PaDemo(pafl.FlightServerBase):
    def __init__(self):
        super().__init__("grpc://127.0.0.1:0")
        self.tables = {b"t1": pa.table(T1)}

    def do_get(self, ctx, ticket):
        return pafl.RecordBatchStream(self.tables[ticket.ticket])

    def do_put(self, ctx, desc, reader, writer):
        self.tables[desc.path[0]] = reader.read_all()
        writer.write(pa.py_buffer(b"ok"))

    def get_flight_info(self, ctx, desc):
        t = self.tables[desc.path[0]]
        return pafl.FlightInfo(t.schema, desc,
                               [pafl.FlightEndpoint(desc.path[0], [])],
                               t.num_rows, -1)

    def list_flights(self, ctx, criteria):
        for name, t in list(self.tables.items()):
            yield pafl.FlightInfo(t.schema,
                                  pafl.FlightDescriptor.for_path(name),
                                  [pafl.FlightEndpoint(name, [])],
                                  t.num_rows, -1)

    def get_schema(self, ctx, desc):
        return pafl.SchemaResult(self.tables[desc.path[0]].schema)

    def do_exchange(self, ctx, desc, reader, writer):
        t = reader.read_all()
        out = t.filter(t.column(0).is_valid())
        writer.begin(out.schema)
        writer.write_table(out)

    def do_action(self, ctx, action):
        if action.type == "ping":
            return [pafl.Result(pa.py_buffer(b"pong:" +
                                             action.body.to_pybytes()))]
        raise NotImplementedError(action.type)

    def list_actions(self, ctx):
        return [("ping", "responds with pong")]


@pytest.fixture(scope="module")
def servers():
    port, jax = PortDemo(), JaxDemo()
    port.serve()
    jax.serve()
    pas = PaDemo()
    th = threading.Thread(target=pas.serve, daemon=True)
    th.start()
    yield {"port": port, "jax": jax, "pyarrow": pas}
    port.shutdown()
    jax.shutdown()
    pas.shutdown()
    th.join(10)


# ---------------------------------------------------------------------------
# the three clients, behind one interface of plain values
# ---------------------------------------------------------------------------

class PortClient:
    ERROR = rpc.RpcError

    def __init__(self, uri):
        self.c = tfl.FlightClient(uri)

    def close(self):
        self.c.close()

    def info(self, path):
        i = self.c.get_flight_info(tfl.FlightDescriptor.for_path(path))
        return i.schema.names, i.total_records, i.endpoints[0].ticket.ticket

    def get(self, ticket):
        return self.c.do_get(tfl.Ticket(ticket)).read_all().to_pydict()

    def put(self, path, table):
        hb = _port(table)
        return self.c.do_put(tfl.FlightDescriptor.for_path(path), hb.schema,
                             [hb])

    def paths(self):
        return [i.descriptor.path for i in self.c.list_flights()]

    def schema(self, path):
        s = self.c.get_schema(tfl.FlightDescriptor.for_path(path))
        return s.names, str(s.field(0).type)

    def exchange(self, table):
        hb = _port(table)
        return self.c.do_exchange(tfl.FlightDescriptor.for_command(b"f"),
                                  hb.schema, [hb]).read_all().to_pydict()

    def actions(self):
        return self.c.list_actions()

    def action(self, kind, body=b""):
        return [r.body for r in self.c.do_action(tfl.Action(kind, body))]

    def handshake(self, payload):
        return self.c.handshake(payload)


class JaxClient(PortClient):
    ERROR = grpc.RpcError

    def __init__(self, uri):
        self.c = jfl.FlightClient(uri)

    def info(self, path):
        i = self.c.get_flight_info(jfl.FlightDescriptor.for_path(path))
        return i.schema.names, i.total_records, i.endpoints[0].ticket.ticket

    def get(self, ticket):
        return self.c.do_get(jfl.Ticket(ticket)).read_all().to_pydict()

    def put(self, path, table):
        return self.c.do_put(jfl.FlightDescriptor.for_path(path),
                             table.schema, table.to_batches())

    def paths(self):
        return [i.descriptor.path for i in self.c.list_flights()]

    def schema(self, path):
        s = self.c.get_schema(jfl.FlightDescriptor.for_path(path))
        return s.names, str(s.field(0).type)

    def exchange(self, table):
        return self.c.do_exchange(jfl.FlightDescriptor.for_command(b"f"),
                                  table.schema, table.to_batches()) \
            .read_all().to_pydict()

    def action(self, kind, body=b""):
        return [r.body for r in self.c.do_action(jfl.Action(kind, body))]


class _PaAuth(pafl.ClientAuthHandler):
    def __init__(self, payload):
        super().__init__()
        self.payload, self.token = payload, None

    def authenticate(self, outgoing, incoming):
        outgoing.write(self.payload)
        self.token = incoming.read()

    def get_token(self):
        return self.token


class PaClient:
    ERROR = pafl.FlightError

    def __init__(self, uri):
        self.c = pafl.connect(uri)

    def close(self):
        self.c.close()

    def info(self, path):
        i = self.c.get_flight_info(pafl.FlightDescriptor.for_path(path))
        return i.schema.names, i.total_records, i.endpoints[0].ticket.ticket

    def get(self, ticket):
        t = self.c.do_get(pafl.Ticket(ticket)).read_all()
        t.validate(full=True)
        return t.to_pydict()

    def put(self, path, table):
        t = _pa(table)
        w, meta = self.c.do_put(pafl.FlightDescriptor.for_path(path),
                                t.schema)
        w.write_table(t)
        w.done_writing()
        acks = []
        while True:
            buf = meta.read()
            if buf is None:
                break
            acks.append(buf.to_pybytes())
        w.close()
        return acks

    def paths(self):
        return [[p.decode() for p in i.descriptor.path]
                for i in self.c.list_flights()]

    def schema(self, path):
        s = self.c.get_schema(pafl.FlightDescriptor.for_path(path)).schema
        return s.names, {"int64": "int64"}.get(str(s.field(0).type),
                                               str(s.field(0).type))

    def exchange(self, table):
        t = _pa(table)
        w, r = self.c.do_exchange(pafl.FlightDescriptor.for_command(b"f"))
        w.begin(t.schema)
        w.write_table(t)
        w.done_writing()
        out = r.read_all()
        w.close()
        return out.to_pydict()

    def actions(self):
        return [(a.type, a.description) for a in self.c.list_actions()]

    def action(self, kind, body=b""):
        return [r.body.to_pybytes()
                for r in self.c.do_action(pafl.Action(kind, body))]

    def handshake(self, payload):
        h = _PaAuth(payload)
        self.c.authenticate(h)
        return h.token


def _pa(table):
    d = {}
    for f in table.schema.fields:
        vals = table.column(f.name).to_pylist()
        d[f.name] = pa.array(vals, pa.dictionary(pa.int32(), pa.string())) \
            if f.type.id == jdt.TypeId.DICTIONARY else pa.array(vals)
    return pa.table(d)


CLIENTS = {"port": PortClient, "jax": JaxClient, "pyarrow": PaClient}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"),
         ("port", "pyarrow"), ("pyarrow", "port")]
PAIR_IDS = [f"{s}-server-{c}-client" for s, c in PAIRS]


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def pair(request, servers):
    server, client = request.param
    srv = servers[server]
    c = CLIENTS[client](f"grpc://127.0.0.1:{srv.port}")
    yield srv, c, f"{server}-{client}"
    c.close()


def test_get_flight_info(pair):
    _, c, _ = pair
    names, total, ticket = c.info("t1")
    assert names == ["x", "s"]
    assert total == 3
    assert ticket == b"t1"


def test_do_get(pair):
    _, c, _ = pair
    assert c.get(b"t1") == T1


def test_do_put_roundtrip(pair):
    _, c, tag = pair
    src = _put_table()
    assert c.put(f"up-{tag}", src) == [b"ok"]
    assert c.get(f"up-{tag}".encode()) == src.to_pydict()


def test_list_flights(pair):
    _, c, _ = pair
    assert ["t1"] in c.paths()


def test_get_schema(pair):
    _, c, _ = pair
    assert c.schema("t1") == (["x", "s"], "int64")


def test_do_exchange(pair):
    _, c, _ = pair
    assert c.exchange(agt.table({"k": [1, None, 3]})) == {"k": [1, 3]}


def test_actions(pair):
    _, c, _ = pair
    assert c.actions() == [("ping", "responds with pong")]
    assert c.action("ping", b"hi") == [b"pong:hi"]


def test_unimplemented_action_raises(pair):
    _, c, _ = pair
    with pytest.raises(c.ERROR):
        c.action("nope")


@pytest.mark.parametrize("server,client", [p for p in PAIRS
                                           if p[0] != "pyarrow"],
                         ids=[i for p, i in zip(PAIRS, PAIR_IDS)
                              if p[0] != "pyarrow"])
def test_handshake(servers, server, client):
    c = CLIENTS[client](f"grpc://127.0.0.1:{servers[server].port}")
    try:
        assert c.handshake(b"x") == b""
    finally:
        c.close()


def test_handshake_with_a_pyarrow_server(servers):
    """pyarrow's server without an auth handler answers a Handshake with
    UNIMPLEMENTED; the port's client reads the status."""
    c = PortClient(f"grpc://127.0.0.1:{servers['pyarrow'].port}")
    try:
        with pytest.raises(rpc.RpcError) as e:
            c.handshake(b"x")
        assert e.value.code().name == "UNIMPLEMENTED"
    finally:
        c.close()


def test_pyarrow_client_puts_to_our_server(servers):
    """The JAX test's pyarrow put, on the port's server."""
    srv = servers["port"]
    c = pafl.connect(f"grpc://127.0.0.1:{srv.port}")
    src = pa.table({"y": [10, None], "z": ["q", "r"]})
    w, _ = c.do_put(pafl.FlightDescriptor.for_path("from_pa"), src.schema)
    w.write_table(src)
    w.done_writing()
    w.close()
    c.close()
    deadline = time.time() + 5
    while b"from_pa" not in srv.tables and time.time() < deadline:
        time.sleep(0.05)
    assert srv.tables[b"from_pa"].to_pydict() == \
        {"y": [10, None], "z": ["q", "r"]}


# ---------------------------------------------------------------------------
# sessions, cancel and renew (port and JAX servers and clients)
# ---------------------------------------------------------------------------

GRPC_PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]
GRPC_IDS = [f"{s}-server-{c}-client" for s, c in GRPC_PAIRS]
PKG = {"port": tfl, "jax": jfl}


def _sess_server(fl):
    class SessServer(fl.FlightServerBase):
        def __init__(self):
            super().__init__("grpc://127.0.0.1:0")
            self.sessions = fl.SessionManager()

        def do_action(self, ctx, action):
            sess = self.sessions.session(ctx)
            if action.type == "bump":
                sess["hits"] = sess.get("hits", 0) + 1
                yield fl.Result(str(sess["hits"]).encode())
            elif action.type == "close":
                self.sessions.close(ctx)
                yield fl.Result(b"closed")
    return SessServer()


@pytest.mark.parametrize("server,client", GRPC_PAIRS, ids=GRPC_IDS)
def test_session_middleware(server, client):
    sf, cf = PKG[server], PKG[client]
    with _sess_server(sf) as srv:
        uri = f"grpc://127.0.0.1:{srv.port}"
        with cf.FlightClient(uri, middleware=[cf.CookieMiddleware()]) as c:
            vals = [list(c.do_action(cf.Action("bump")))[0].body
                    for _ in range(3)]
            assert vals == [b"1", b"2", b"3"]
            assert len(srv.sessions) == 1
            list(c.do_action(cf.Action("close")))
            assert len(srv.sessions) == 0
        with cf.FlightClient(uri, middleware=[cf.CookieMiddleware()]) as c2:
            assert list(c2.do_action(cf.Action("bump")))[0].body == b"1"


def _cancellable(fl, msgs):
    class CancellableServer(fl.FlightServerBase):
        def __init__(self):
            super().__init__("grpc://127.0.0.1:0")
            self.cancelled, self.renewed = [], []

        def get_flight_info(self, ctx, desc):
            t = agt.table({"x": [1]})
            schema = t.schema if fl is jfl else _port(t).schema
            return fl.FlightInfo(schema, desc,
                                 [fl.FlightEndpoint(fl.Ticket(b"tk"))], 1, -1)

        def cancel_flight_info(self, ctx, info):
            self.cancelled.append(info)
            return msgs.CANCEL_STATUS_CANCELLED

        def renew_flight_endpoint(self, ctx, endpoint):
            self.renewed.append(endpoint)
            return fl.FlightEndpoint(fl.Ticket(b"tk-renewed"),
                                     ["grpc://example:1234"])
    return CancellableServer()


@pytest.mark.parametrize("server,client", GRPC_PAIRS, ids=GRPC_IDS)
def test_cancel_and_renew_actions(server, client):
    from arrow_go_tpu.flight import Flight_pb2 as fp
    sf, cf = PKG[server], PKG[client]
    with _cancellable(sf, fm if sf is tfl else fp) as srv:
        c = cf.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        info = c.get_flight_info(cf.FlightDescriptor.for_path("t"))
        assert c.cancel_flight_info(info) == fp.CANCEL_STATUS_CANCELLED
        assert len(srv.cancelled) == 1
        assert srv.cancelled[0].endpoints[0].ticket.ticket == b"tk"
        ep = c.renew_flight_endpoint(info.endpoints[0])
        assert ep.ticket.ticket == b"tk-renewed"
        assert ep.locations == ["grpc://example:1234"]
        assert len(srv.renewed) == 1
        c.close()


@pytest.mark.parametrize("server,client", GRPC_PAIRS, ids=GRPC_IDS)
def test_session_options_actions(server, client):
    from arrow_go_tpu.flight import Flight_pb2 as fp
    sf, cf = PKG[server], PKG[client]

    class SessServer(sf.FlightServerBase):
        def __init__(self):
            super().__init__("grpc://127.0.0.1:0")
            self.sessions = sf.SessionManager()

    with SessServer() as srv:
        with cf.FlightClient(f"grpc://127.0.0.1:{srv.port}",
                             middleware=[cf.CookieMiddleware()]) as c:
            opts = {"catalog": "main", "max_rows": 1000, "trace": True,
                    "ratio": 0.5, "paths": ["a", "b"]}
            assert c.set_session_options(opts) == {}
            assert c.get_session_options() == opts
            c.set_session_options({"catalog": None})
            assert "catalog" not in c.get_session_options()
            errs = c.set_session_options({"": "x"})
            assert errs[""] == \
                fp.SetSessionOptionsResult.ERROR_VALUE_INVALID_NAME
            assert c.close_session() == fp.CloseSessionResult.STATUS_CLOSED
            assert len(srv.sessions) == 0


# ---------------------------------------------------------------------------
# the transport's own cases
# ---------------------------------------------------------------------------

def _big(n=3_000_000):
    """A batch of 3,000,000 int64 rows: 24 MB of body."""
    schema = tdt.Schema([tdt.Field("i", tdt.int64, False)])
    vals = np.random.default_rng(5).integers(-2**62, 2**62, n)
    return HostBatch(schema, [HostArray(vals, None, tdt.int64)], n), vals


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
def test_a_24_mb_batch(servers, server, client):
    """24 MB in one message: DATA frames cut to the peer's frame size and
    writers waiting on the 65,535-byte windows C-core starts with."""
    hb, vals = _big()
    srv = servers[server]
    uri = f"grpc://127.0.0.1:{srv.port}"
    path = f"big-{server}-{client}"
    if client == "port":
        c = tfl.FlightClient(uri)
        assert c.do_put(tfl.FlightDescriptor.for_path(path), hb.schema,
                        [hb]) == [b"ok"]
        got = c.do_get(tfl.Ticket(path)).read_all()
        c.close()
        assert np.array_equal(got.column("i").combine().values, vals)
        return
    if client == "jax":
        c = jfl.FlightClient(uri)
        t = agt.table({"i": agt.array(vals, jdt.int64)})
        assert c.do_put(jfl.FlightDescriptor.for_path(path), t.schema,
                        t.to_batches()) == [b"ok"]
        got = c.do_get(jfl.Ticket(path)).read_all()
        c.close()
        assert np.array_equal(np.concatenate([
            ch.to_numpy() for ch in got.column("i").chunks]), vals)
        return
    c = pafl.connect(uri)
    t = pa.table({"i": pa.array(vals)})
    w, _ = c.do_put(pafl.FlightDescriptor.for_path(path), t.schema)
    w.write_table(t)
    w.done_writing()
    w.close()
    got = c.do_get(pafl.Ticket(path)).read_all()
    c.close()
    assert np.array_equal(got.column("i").to_numpy(), vals)


@pytest.mark.parametrize("server", ["port", "jax", "pyarrow"])
def test_concurrent_calls_on_one_connection(servers, server):
    c = tfl.FlightClient(f"grpc://127.0.0.1:{servers[server].port}")
    errors, got = [], []

    def work(k):
        try:
            for _ in range(5):
                got.append((c.do_get(tfl.Ticket(b"t1")).read_all()
                            .to_pydict() == T1,
                            [r.body for r in c.do_action(tfl.Action(
                                "ping", str(k).encode()))] ==
                            [b"pong:" + str(k).encode()]))
        except Exception as e:           # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    conn = c._channel._conn
    c.close()
    assert not errors, errors
    assert len(got) == 40 and all(a and b for a, b in got)
    assert conn.next_id == 1 + 2 * 80          # 80 streams, one connection


def test_a_do_get_closed_early(servers):
    """The client resets the stream after one batch; the server's
    generator is closed."""
    srv = servers["port"]
    c = tfl.FlightClient(f"grpc://127.0.0.1:{srv.port}")
    reader = c.do_get(tfl.Ticket(b"many"))
    first = reader.read_next_batch()
    assert first.column("i").values[:3].tolist() == [0, 1, 2]
    reader.cancel()
    assert srv.closed_early.wait(20)
    # the connection serves the next call
    assert c.do_get(tfl.Ticket(b"t1")).read_all().to_pydict() == T1
    c.close()


def test_a_pyarrow_client_closes_a_do_get_early(servers):
    srv = servers["port"]
    c = pafl.connect(f"grpc://127.0.0.1:{srv.port}")
    r = c.do_get(pafl.Ticket(b"many"))
    r.read_chunk()
    r.cancel()
    assert srv.closed_early.wait(20)
    c.close()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_an_error_with_bin_metadata(servers, server):
    """A FAILED_PRECONDITION with a `-bin` trailer (C-core Huffman-codes
    its base64) reaches the port's client with the bytes; the port's
    trailer reaches grpc's client too."""
    srv = servers[server]
    c = tfl.FlightClient(f"grpc://127.0.0.1:{srv.port}")
    with pytest.raises(rpc.RpcError) as e:
        list(c.do_action(tfl.Action("fail-bin")))
    c.close()
    assert e.value.code().name == grpc.StatusCode.FAILED_PRECONDITION.name
    assert e.value.details() == "with detail"
    assert ("x-detail-bin", b"\x00\xffdetail" * 9) in \
        e.value.trailing_metadata()
    j = jfl.FlightClient(f"grpc://127.0.0.1:{srv.port}")
    with pytest.raises(grpc.RpcError) as g:
        list(j.do_action(jfl.Action("fail-bin")))
    j.close()
    assert g.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    assert ("x-detail-bin", b"\x00\xffdetail" * 9) in \
        tuple(g.value.trailing_metadata())


@pytest.mark.parametrize("client", ["port", "jax"])
def test_a_handler_raising_a_connection_error_is_unknown(servers, client):
    """A handler whose own connection fails (ConnectionRefusedError is a
    ConnectionError) ends its call UNKNOWN with grpc's details, as the
    JAX server does, and the connection serves the next call."""
    got = {}
    for server in ("port", "jax"):
        c = CLIENTS[client](f"grpc://127.0.0.1:{servers[server].port}")
        with pytest.raises(c.ERROR) as e:
            c.action("refused")
        got[server] = (e.value.code().name, e.value.details())
        assert c.action("ping", b"again") == [b"pong:again"]
        c.close()
    assert got["port"] == got["jax"] == (
        "UNKNOWN", "Exception iterating responses: the backend is down")


def test_a_truncated_request_message_is_internal(servers):
    """A request whose stream ends inside its message gets a status
    (INTERNAL), not silence."""
    ch = rpc.Channel(f"127.0.0.1:{servers['port'].port}")
    conn = ch.connection()
    st = conn.request([(":method", "POST"), (":scheme", "http"),
                       (":path", "/arrow.flight.protocol.FlightService/"
                        "GetFlightInfo"), (":authority", ch.target),
                       ("content-type", "application/grpc"),
                       ("te", "trailers")])
    conn.send_data(st, [b"\0\0\0\0\x0aabc"], end_stream=True)
    assert conn.wait_headers(st, 1)
    ch.close()
    status = dict(st.headers[-1])
    assert status["grpc-status"] == str(int(rpc.StatusCode.INTERNAL))
    assert rpc.percent_decode(status["grpc-message"]) == \
        "stream ended inside a message"


def test_status_codes_are_grpcs():
    assert [(s.name, s.value) for s in rpc.StatusCode] == \
        [(s.name, s.value[0]) for s in grpc.StatusCode]


def test_unknown_method_is_unimplemented(servers):
    ch = grpc.insecure_channel(f"127.0.0.1:{servers['port'].port}")
    with pytest.raises(grpc.RpcError) as e:
        ch.unary_unary("/arrow.flight.protocol.FlightService/Nope")(b"")
    ch.close()
    assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_a_refused_connection_is_unavailable():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    c = tfl.FlightClient(f"grpc://127.0.0.1:{port}")
    with pytest.raises(rpc.RpcError) as e:
        c.list_actions()
    assert e.value.code() == rpc.StatusCode.UNAVAILABLE


# ---------------------------------------------------------------------------
# the slice as a whole: chip_smoke.py's flight phase on the CPU
# ---------------------------------------------------------------------------

PATH_ROWS = 200_000


def test_chip_smoke_flight_paths_match_jax(tmp_path):
    """chip_smoke.py's own functions at 200,000 rows: the file written
    with the phase's WriterProperties and its footer checked, read by the
    JAX reader; served from a spawned port server process; Q6 over the
    DoGet stream (every column bit for bit) against numpy and against
    the JAX composition over the JAX client's DoGet of the same server;
    DoPut acknowledged batch by batch; DoExchange against a port server
    that runs Q6 per batch."""
    import chip_smoke as cs
    import arrow_go_tpu.compute as jpc
    from arrow_go_tpu.compute.functions import agg_sum as jax_agg_sum
    from test_torch_dataset import _jax_q6_expression, _jproject
    from torch_parity import jax_batch
    li, _ = cs.make_data(PATH_ROWS, PATH_ROWS // 4)
    cs.add_quantity(li)
    table = cs.flight_table(li, PATH_ROWS)
    assert np.all(np.diff(table["l_sdate"]) >= 0)
    path = str(tmp_path / "q6.parquet")
    cs.write_flight_file(path, table, rows_per_group=1 << 16,
                         page_bytes=1 << 16)
    foot = cs.check_flight_footer(path)
    assert foot["row_groups"] == 4 and foot["codecs"] == cs.FLIGHT_CODECS
    jt = jpq_read(path)
    for c in cs.Q6_COLUMNS:
        assert np.array_equal(np.concatenate(
            [ch.to_numpy() for ch in jt.column(c).chunks]), table[c])
    want = cs.q6_oracle(table)
    proc, pipe, (port, yard, served) = cs.start_flight_server(
        path, rows=1 << 15)
    try:
        assert served == PATH_ROWS
        client = tfl.FlightClient(f"grpc://127.0.0.1:{port}")
        times = {}
        got = cs.flight_q6(client, "cpu", times, source=table)
        cs.check_q6(got, want)
        assert times["batches"] == 7 and times["rows"] == PATH_ROWS
        assert times["body_bytes"] == PATH_ROWS * 24
        assert cs.flight_stream_ms(client)[1] == PATH_ROWS * 24
        assert cs.loopback_ms(yard, PATH_ROWS * 24) > 0
        batches = cs.flight_batches(table, rows=1 << 15)
        assert cs.flight_put(client, batches)[0] == \
            f"{1 << 15}:{int(table['l_qty'][:1 << 15].sum())}".encode()
        client.close()
        # the JAX client's stream of the same server, through the JAX
        # functions
        j = jfl.FlightClient(f"grpc://127.0.0.1:{port}")
        revenue, count = 0.0, 0
        for rb in j.do_get(jfl.Ticket(b"lineitem")):
            jdb = jax_batch({n: rb.column(i).to_numpy()
                             for i, n in enumerate(rb.schema.names)})
            li_f = jpc.filter(_jproject(jdb, ["l_price", "l_disc"]),
                              jpc.execute_scalar_expression(
                                  _jax_q6_expression(), jdb))
            if li_f.length:
                revenue += jax_agg_sum(jpc.execute_scalar_expression(
                    jpc.call("multiply", [jpc.field("l_price"),
                                          jpc.field("l_disc")]), li_f))
            count += li_f.length
        j.close()
        assert got["count"] == count
        np.testing.assert_allclose(got["revenue"], revenue, rtol=1e-9)
    finally:
        cs.stop_flight_server(proc, pipe)
    assert not proc.is_alive()
    with cs.q6_exchange_server("cpu") as srv:
        c = tfl.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        cs.check_q6(cs.flight_exchange(c, batches), want)
        c.close()
    assert sorted(cs.flight_scenarios()) == sorted(
        __import__("arrow_go_tpu_torch.flight.integration",
                   fromlist=["x"]).SCENARIOS)


def jpq_read(path):
    from arrow_go_tpu import parquet as jpq
    return jpq.read_table(path)


def test_server_middleware_sees_each_call_first():
    """The port's server middleware (`call_started`, where the JAX server
    takes grpc interceptors) runs before each handler and may abort."""
    seen = []

    class RequireKey:
        def call_started(self, method, ctx):
            seen.append(method)
            if ("x-key", "open") not in ctx.invocation_metadata():
                ctx.abort(rpc.StatusCode.PERMISSION_DENIED, "no key")

    class KeyMiddleware(rpc.ClientMiddleware):
        def sending_headers(self, method):
            return [("x-key", "open")]

    class Srv(tfl.FlightServerBase):
        def do_action(self, ctx, action):
            yield tfl.Result(b"in")

    with Srv("grpc://127.0.0.1:0", middleware=[RequireKey()]) as srv:
        uri = f"grpc://127.0.0.1:{srv.port}"
        with tfl.FlightClient(uri) as c:
            with pytest.raises(rpc.RpcError) as e:
                list(c.do_action(tfl.Action("a")))
            assert e.value.code() == rpc.StatusCode.PERMISSION_DENIED
        with tfl.FlightClient(uri, middleware=[KeyMiddleware()]) as c:
            assert [r.body for r in c.do_action(tfl.Action("a"))] == [b"in"]
        j = jfl.FlightClient(uri)
        with pytest.raises(grpc.RpcError) as g:
            list(j.do_action(jfl.Action("a")))
        j.close()
        assert g.value.code() == grpc.StatusCode.PERMISSION_DENIED
    assert seen == ["/arrow.flight.protocol.FlightService/DoAction"] * 3
