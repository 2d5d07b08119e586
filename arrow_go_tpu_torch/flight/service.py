"""Arrow Flight RPC server and client on the port's own gRPC
(flight/rpc.py), after arrow_go_tpu/flight/service.py (reference
arrow/flight server.go:197, client.go:64, record_batch_reader.go /
record_batch_writer.go).

Record batches are HostBatches: a DoGet or DoExchange handler returns a
HostBatch or a (schema, batches) pair, where the JAX handler returns a
Table or a pair, and `FlightDataReader.read_all` gives a Table of the
batches, as the port's IPC readers and the JAX reader do. The FlightData stream carries the IPC
messages of the port's `ipc/` (the schema, dictionary batches sent again
when they change, record batches), each body written once into the
frames (flight/wire.py). Errors reach the client as `rpc.RpcError`
(`code()`, `details()`), where the JAX package raises `grpc.RpcError`;
middleware is the rpc layer's hook (rpc.ClientMiddleware on a client,
objects with `call_started(method, context)` on a server), where the JAX
package takes grpc interceptors.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .. import dtypes as dt
from .. import ipc
from ..array.record import host_batch
from ..compute.errors import ArrowInvalid
from ..device.block import HostBatch
from ..ipc import core as ipc_core, metadata as ipc_md
from ..ipc.fb import Reader as FbReader
from . import messages as fm
from . import rpc
from .wire import (RawFlightData, parse_flight_data, pipeline_frames,
                   serialize_flight_data)

SERVICE = "arrow.flight.protocol.FlightService"


# ---------------------------------------------------------------------------
# descriptors, tickets, endpoints and infos
# ---------------------------------------------------------------------------

class FlightDescriptor:
    def __init__(self, proto):
        self.proto = proto

    @staticmethod
    def for_path(*path: str) -> "FlightDescriptor":
        return FlightDescriptor(fm.FlightDescriptor(
            type=fm.FlightDescriptor.PATH, path=list(path)))

    @staticmethod
    def for_command(cmd) -> "FlightDescriptor":
        if isinstance(cmd, str):
            cmd = cmd.encode()
        return FlightDescriptor(fm.FlightDescriptor(
            type=fm.FlightDescriptor.CMD, cmd=cmd))

    @property
    def path(self) -> List[str]:
        return list(self.proto.path)

    @property
    def command(self) -> bytes:
        return self.proto.cmd

    @property
    def descriptor_type(self) -> str:
        return "path" if self.proto.type == fm.FlightDescriptor.PATH \
            else "cmd"

    def __eq__(self, other):
        return isinstance(other, FlightDescriptor) and \
            self.proto.SerializeToString() == other.proto.SerializeToString()

    def __hash__(self):
        return hash(self.proto.SerializeToString())


class Ticket:
    def __init__(self, ticket):
        if isinstance(ticket, str):
            ticket = ticket.encode()
        self.ticket = ticket

    def to_proto(self):
        return fm.Ticket(ticket=self.ticket)


@dataclass
class FlightEndpoint:
    ticket: Ticket
    locations: List[str] = dc_field(default_factory=list)
    expiration_time: Optional[float] = None          # epoch seconds
    app_metadata: bytes = b""

    def to_proto(self):
        out = fm.FlightEndpoint(
            ticket=self.ticket.to_proto(),
            location=[fm.Location(uri=u) for u in self.locations],
            app_metadata=self.app_metadata)
        if self.expiration_time is not None:
            out.expiration_time = fm.Timestamp(
                seconds=int(self.expiration_time),
                nanos=int((self.expiration_time % 1) * 1e9))
        return out

    @staticmethod
    def from_proto(e) -> "FlightEndpoint":
        exp = None
        if e.HasField("expiration_time"):
            exp = e.expiration_time.seconds + e.expiration_time.nanos / 1e9
        return FlightEndpoint(Ticket(e.ticket.ticket if e.ticket else b""),
                              [loc.uri for loc in e.location], exp,
                              e.app_metadata)


def _schema_to_ipc_bytes(schema: dt.Schema) -> bytes:
    mapper = ipc.DictMapper()
    mapper.assign(schema)
    return ipc_core.frame_message(ipc_core.build_schema_message(
        schema, mapper.field_to_id))


def _unframe(data) -> bytes:
    data = bytes(data)
    if data[:4] == b"\xff\xff\xff\xff":
        (size,) = struct.unpack_from("<i", data, 4)
        return data[8:8 + size]
    if len(data) >= 4:
        head = struct.unpack_from("<I", data, 0)[0]
        if head == len(data) - 4:
            return data[4:]
    return data


def _schema_from_ipc_bytes(data) -> dt.Schema:
    r = FbReader.root(_unframe(data))
    return ipc_md.read_schema(r.table(2), {})


@dataclass
class FlightInfo:
    schema: dt.Schema
    descriptor: FlightDescriptor
    endpoints: List[FlightEndpoint]
    total_records: int = -1
    total_bytes: int = -1
    ordered: bool = False
    app_metadata: bytes = b""

    def to_proto(self):
        return fm.FlightInfo(
            schema=_schema_to_ipc_bytes(self.schema),
            flight_descriptor=self.descriptor.proto,
            endpoint=[e.to_proto() for e in self.endpoints],
            total_records=self.total_records, total_bytes=self.total_bytes,
            ordered=self.ordered, app_metadata=self.app_metadata)

    @staticmethod
    def from_proto(p) -> "FlightInfo":
        return FlightInfo(
            _schema_from_ipc_bytes(p.schema),
            FlightDescriptor(p.flight_descriptor or fm.FlightDescriptor()),
            [FlightEndpoint.from_proto(e) for e in p.endpoint],
            p.total_records, p.total_bytes, p.ordered, p.app_metadata)


@dataclass
class Action:
    type: str
    body: bytes = b""


@dataclass
class Result:
    body: bytes


# ---------------------------------------------------------------------------
# FlightData <-> HostBatches
# ---------------------------------------------------------------------------

class _FlightWriter(ipc.StreamWriter):
    """The IPC stream writer's messages as FlightData: the schema
    message, then each batch's changed dictionaries and the batch, the
    body buffers unjoined."""

    def __init__(self, schema: dt.Schema, descriptor=None):
        super().__init__(None, schema)
        self.out: List[RawFlightData] = []
        self.descriptor = descriptor

    def _message(self, meta: bytes, parts, body_len: int) -> tuple:
        self.out.append(RawFlightData(meta, parts, body_len))
        return 0, 0, body_len

    def _write_schema(self) -> None:
        self.out.append(RawFlightData(
            ipc_core.build_schema_message(self.schema,
                                          self.mapper.field_to_id),
            flight_descriptor=self.descriptor))
        self._wrote_schema = True


def batches_to_flight_data(schema: dt.Schema, batches,
                           descriptor=None) -> Iterator[RawFlightData]:
    """The FlightData messages of `batches` under `schema`: the raw
    Message flatbuffer in data_header (the gRPC message is the frame),
    the body's buffers as parts."""
    w = _FlightWriter(schema, descriptor)
    w._write_schema()
    it = iter(batches)
    try:
        for b in it:
            w.write(host_batch(b))
            yield from w.out
            w.out.clear()
        yield from w.out
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


class FlightDataReader(ipc._Reader):
    """HostBatches of a FlightData stream; `cancel()` resets the call
    that carries it."""

    decompress_concurrency = 0

    def __init__(self, stream, call=None):
        self._stream = iter(stream)
        self._call = call
        self._first_descriptor = None
        for fd in self._stream:
            if fd.HasField("flight_descriptor") and \
                    self._first_descriptor is None:
                self._first_descriptor = fd.flight_descriptor
            if fd.data_header:     # a descriptor-only first message waits
                break
        else:
            raise ArrowInvalid("empty flight data stream")
        r = FbReader.root(_unframe(fd.data_header))
        if r.u8(1) != ipc_md.MSG_SCHEMA or r.table(2) is None:
            raise ArrowInvalid("flight stream must start with schema message")
        self._set_schema(r.table(2))

    @property
    def descriptor(self) -> Optional[FlightDescriptor]:
        return (FlightDescriptor(self._first_descriptor)
                if self._first_descriptor is not None else None)

    def read_next_batch(self) -> Optional[HostBatch]:
        for fd in self._stream:
            if not fd.data_header:           # app_metadata alone
                continue
            r = FbReader.root(_unframe(fd.data_header))
            ht = r.u8(1)
            if ht == ipc_md.MSG_DICTIONARY_BATCH:
                self._load_dictionary(r, fd.data_body)
            elif ht == ipc_md.MSG_RECORD_BATCH:
                return self._load_batch(r, fd.data_body)
            else:
                raise ArrowInvalid(f"unexpected flight message header {ht}")
        return None

    def __iter__(self):
        while True:
            b = self.read_next_batch()
            if b is None:
                return
            yield b

    def cancel(self) -> None:
        if self._call is not None:
            self._call.cancel()


def _batches_of(out) -> Tuple[dt.Schema, Any]:
    out = host_batch(out)
    if isinstance(out, HostBatch):
        return out.schema, [out]
    schema, batches = out
    return schema, batches


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _ser(msg) -> bytes:
    return msg.SerializeToString()


class FlightServerBase:
    """Subclass and override the handlers (reference
    flight.BaseFlightServer)."""

    def __init__(self, location: str = "grpc://0.0.0.0:0",
                 middleware: Optional[List] = None):
        self._location = location
        self._server: Optional[rpc.Server] = None
        self.port: Optional[int] = None
        self._middleware = middleware or []

    # -- overridables ------------------------------------------------------
    def list_flights(self, context, criteria: bytes) -> Iterator[FlightInfo]:
        return iter(())

    def get_flight_info(self, context,
                        descriptor: FlightDescriptor) -> FlightInfo:
        raise NotImplementedError("GetFlightInfo not implemented")

    def poll_flight_info(self, context, descriptor: FlightDescriptor):
        raise NotImplementedError("PollFlightInfo not implemented")

    def get_schema(self, context, descriptor: FlightDescriptor) -> dt.Schema:
        return self.get_flight_info(context, descriptor).schema

    def do_get(self, context, ticket: Ticket):
        """Return a HostBatch or (schema, iterable of HostBatches)."""
        raise NotImplementedError("DoGet not implemented")

    def do_put(self, context, descriptor: FlightDescriptor,
               reader: FlightDataReader) -> Iterator[bytes]:
        raise NotImplementedError("DoPut not implemented")

    def do_exchange(self, context, descriptor: FlightDescriptor,
                    reader: FlightDataReader):
        raise NotImplementedError("DoExchange not implemented")

    def do_action(self, context, action: Action) -> Iterator[Result]:
        raise NotImplementedError(f"action {action.type} not implemented")

    def cancel_flight_info(self, context, info: FlightInfo) -> int:
        """The standard CancelFlightInfo action: a CancelStatus value."""
        raise NotImplementedError("CancelFlightInfo not implemented")

    def renew_flight_endpoint(self, context, endpoint) -> FlightEndpoint:
        """The standard RenewFlightEndpoint action (`endpoint` a
        messages.FlightEndpoint): the renewed endpoint."""
        raise NotImplementedError("RenewFlightEndpoint not implemented")

    def list_actions(self, context) -> Iterator[Tuple[str, str]]:
        return iter(())

    def handshake(self, context, requests):
        """An empty answer to the first request. The JAX server answers
        before it reads one; pyarrow's client, whose request then finds
        the call over, waits for its answer forever."""
        next(iter(requests), None)
        yield fm.HandshakeResponse()

    # -- wiring -------------------------------------------------------------

    def _handlers(self) -> Dict[str, rpc.Handler]:
        me = self

        def handshake(req_iter, ctx):
            return me.handshake(ctx, req_iter)

        def list_flights(req, ctx):
            for info in me.list_flights(ctx, req.expression):
                yield info.to_proto()

        def get_flight_info(req, ctx):
            return me.get_flight_info(ctx, FlightDescriptor(req)).to_proto()

        def poll_flight_info(req, ctx):
            return me.poll_flight_info(ctx, FlightDescriptor(req))

        def get_schema(req, ctx):
            s = me.get_schema(ctx, FlightDescriptor(req))
            return fm.SchemaResult(schema=_schema_to_ipc_bytes(s))

        def do_get(req, ctx):
            schema, batches = _batches_of(me.do_get(ctx, Ticket(req.ticket)))
            return pipeline_frames(batches_to_flight_data(schema, batches))

        def do_put(req_iter, ctx):
            reader = FlightDataReader(req_iter)
            for meta in me.do_put(ctx, reader.descriptor, reader) or ():
                yield fm.PutResult(app_metadata=meta or b"")

        def do_exchange(req_iter, ctx):
            reader = FlightDataReader(req_iter)
            schema, batches = _batches_of(
                me.do_exchange(ctx, reader.descriptor, reader))
            return batches_to_flight_data(schema, batches)

        def do_action(req, ctx):
            # the spec's standard actions, for every server subclass
            if req.type in ("SetSessionOptions", "GetSessionOptions",
                            "CloseSession"):
                mgr = getattr(me, "sessions", None)
                if mgr is not None:
                    yield from _session_options_action(mgr, req, ctx)
                    return
            if req.type == "CancelFlightInfo":
                creq = fm.CancelFlightInfoRequest.FromString(req.body)
                status = me.cancel_flight_info(
                    ctx, FlightInfo.from_proto(creq.info))
                yield fm.Result(body=fm.CancelFlightInfoResult(
                    status=status).SerializeToString())
                return
            if req.type == "RenewFlightEndpoint":
                rreq = fm.RenewFlightEndpointRequest.FromString(req.body)
                ep = me.renew_flight_endpoint(ctx, rreq.endpoint)
                out = ep.to_proto() if isinstance(ep, FlightEndpoint) else ep
                yield fm.Result(body=out.SerializeToString())
                return
            for res in me.do_action(ctx, Action(req.type, req.body)):
                yield fm.Result(body=res.body if isinstance(res, Result)
                                else bytes(res))

        def list_actions(req, ctx):
            for t, d in me.list_actions(ctx):
                yield fm.ActionType(type=t, description=d)

        H = rpc.Handler
        table = {
            "Handshake": H("stream_stream", handshake,
                           fm.HandshakeRequest.FromString, _ser),
            "ListFlights": H("unary_stream", list_flights,
                             fm.Criteria.FromString, _ser),
            "GetFlightInfo": H("unary_unary", get_flight_info,
                               fm.FlightDescriptor.FromString, _ser),
            "PollFlightInfo": H("unary_unary", poll_flight_info,
                                fm.FlightDescriptor.FromString, _ser),
            "GetSchema": H("unary_unary", get_schema,
                           fm.FlightDescriptor.FromString, _ser),
            "DoGet": H("unary_stream", do_get, fm.Ticket.FromString,
                       serialize_flight_data),
            "DoPut": H("stream_stream", do_put, parse_flight_data, _ser),
            "DoExchange": H("stream_stream", do_exchange, parse_flight_data,
                            serialize_flight_data),
            "DoAction": H("unary_stream", do_action, fm.Action.FromString,
                          _ser),
            "ListActions": H("unary_stream", list_actions,
                             fm.Empty.FromString, _ser),
        }
        return {f"/{SERVICE}/{name}": h for name, h in table.items()}

    def serve(self, block: bool = False) -> int:
        self._server = rpc.Server(self._handlers(), max_workers=8,
                                  middleware=self._middleware)
        self.port = self._server.add_insecure_port(self._location)
        self._server.start()
        if block:
            self._server.wait_for_termination()
        return self.port

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)

    def __enter__(self):
        self.serve()
        return self

    def __exit__(self, *exc):
        self.shutdown()


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------

class FlightClient:
    """Reference arrow/flight client.go:64; one connection, which the
    calls share."""

    def __init__(self, location: str, middleware: Optional[List] = None):
        self._channel = rpc.Channel(location, middleware or ())
        m = f"/{SERVICE}/"
        ch = self._channel
        self._get_flight_info = ch.unary_unary(
            m + "GetFlightInfo", _ser, fm.FlightInfo.FromString)
        self._poll_flight_info = ch.unary_unary(
            m + "PollFlightInfo", _ser, fm.PollInfo.FromString)
        self._get_schema = ch.unary_unary(
            m + "GetSchema", _ser, fm.SchemaResult.FromString)
        self._list_flights = ch.unary_stream(
            m + "ListFlights", _ser, fm.FlightInfo.FromString)
        self._do_get = ch.unary_stream(m + "DoGet", _ser, parse_flight_data)
        self._do_put = ch.stream_stream(m + "DoPut", serialize_flight_data,
                                        fm.PutResult.FromString)
        self._do_exchange = ch.stream_stream(
            m + "DoExchange", serialize_flight_data, parse_flight_data)
        self._do_action = ch.unary_stream(m + "DoAction", _ser,
                                          fm.Result.FromString)
        self._list_actions = ch.unary_stream(m + "ListActions", _ser,
                                             fm.ActionType.FromString)
        self._handshake = ch.stream_stream(m + "Handshake", _ser,
                                           fm.HandshakeResponse.FromString)

    def close(self):
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def handshake(self, payload: bytes = b"") -> bytes:
        resp = list(self._handshake(iter([fm.HandshakeRequest(
            payload=payload)])))
        return resp[0].payload if resp else b""

    def list_flights(self, criteria: bytes = b"") -> Iterator[FlightInfo]:
        for p in self._list_flights(fm.Criteria(expression=criteria)):
            yield FlightInfo.from_proto(p)

    def get_flight_info(self, descriptor: FlightDescriptor) -> FlightInfo:
        return FlightInfo.from_proto(self._get_flight_info(descriptor.proto))

    def poll_flight_info(self, descriptor: FlightDescriptor):
        """(FlightInfo | None, retry descriptor | None, progress | None)."""
        p = self._poll_flight_info(descriptor.proto)
        info = FlightInfo.from_proto(p.info) if p.HasField("info") else None
        retry = (FlightDescriptor(p.flight_descriptor)
                 if p.HasField("flight_descriptor") else None)
        return info, retry, p.progress

    def get_schema(self, descriptor: FlightDescriptor) -> dt.Schema:
        return _schema_from_ipc_bytes(
            self._get_schema(descriptor.proto).schema)

    def do_get(self, ticket: Ticket) -> FlightDataReader:
        call = self._do_get(ticket.to_proto())
        return FlightDataReader(call, call)

    def do_put(self, descriptor: FlightDescriptor, schema: dt.Schema,
               batches) -> List[bytes]:
        data = pipeline_frames(
            batches_to_flight_data(schema, batches, descriptor.proto))
        return [r.app_metadata for r in self._do_put(data)]

    def do_exchange(self, descriptor: FlightDescriptor, schema: dt.Schema,
                    batches) -> FlightDataReader:
        call = self._do_exchange(
            batches_to_flight_data(schema, batches, descriptor.proto))
        return FlightDataReader(call, call)

    def do_action(self, action: Action) -> Iterator[Result]:
        for r in self._do_action(fm.Action(type=action.type,
                                           body=action.body)):
            yield Result(r.body)

    def _action(self, name: str, body: bytes) -> bytes:
        return list(self.do_action(Action(name, body)))[0].body

    def set_session_options(self, options: Dict[str, Any]) -> Dict[str, int]:
        """The standard SetSessionOptions action (with CookieMiddleware,
        so that the session cookie is sent again): {name: error value}
        of the rejected options."""
        req = fm.SetSessionOptionsRequest(session_options={
            k: _pb_option_value(v) for k, v in options.items()})
        res = fm.SetSessionOptionsResult.FromString(
            self._action("SetSessionOptions", req.SerializeToString()))
        return {k: e.value for k, e in res.errors.items()}

    def get_session_options(self) -> Dict[str, Any]:
        res = fm.GetSessionOptionsResult.FromString(self._action(
            "GetSessionOptions",
            fm.GetSessionOptionsRequest().SerializeToString()))
        return {k: _py_option_value(v)
                for k, v in res.session_options.items()}

    def close_session(self) -> int:
        """The standard CloseSession action: a CloseSessionResult status."""
        return fm.CloseSessionResult.FromString(self._action(
            "CloseSession",
            fm.CloseSessionRequest().SerializeToString())).status

    def cancel_flight_info(self, info: FlightInfo) -> int:
        """The standard CancelFlightInfo action: a CancelStatus value."""
        req = fm.CancelFlightInfoRequest(info=info.to_proto())
        return fm.CancelFlightInfoResult.FromString(self._action(
            "CancelFlightInfo", req.SerializeToString())).status

    def renew_flight_endpoint(self,
                              endpoint: FlightEndpoint) -> FlightEndpoint:
        """The standard RenewFlightEndpoint action: the renewed endpoint."""
        req = fm.RenewFlightEndpointRequest(endpoint=endpoint.to_proto())
        return FlightEndpoint.from_proto(fm.FlightEndpoint.FromString(
            self._action("RenewFlightEndpoint", req.SerializeToString())))

    def list_actions(self) -> List[Tuple[str, str]]:
        return [(a.type, a.description)
                for a in self._list_actions(fm.Empty())]


# ---------------------------------------------------------------------------
# the standard session-option actions (SetSessionOptions,
# GetSessionOptions, CloseSession; reference flight/session/session.go)
# ---------------------------------------------------------------------------

def _pb_option_value(v):
    if isinstance(v, bool):
        return fm.SessionOptionValue(bool_value=v)
    if isinstance(v, int):
        return fm.SessionOptionValue(int64_value=v)
    if isinstance(v, float):
        return fm.SessionOptionValue(double_value=v)
    if isinstance(v, str):
        return fm.SessionOptionValue(string_value=v)
    if isinstance(v, (list, tuple)):
        return fm.SessionOptionValue(string_list_value=fm.StringListValue(
            values=[str(x) for x in v]))
    if v is None:
        return fm.SessionOptionValue()              # unset = erase
    raise TypeError(f"unsupported session option type {type(v)}")


def _py_option_value(pb):
    kind = pb.WhichOneof("option_value")
    if kind is None:
        return None
    if kind == "string_list_value":
        return list(pb.string_list_value.values)
    return getattr(pb, kind)


def _session_options_action(mgr, req, ctx):
    if req.type == "SetSessionOptions":
        sreq = fm.SetSessionOptionsRequest.FromString(req.body)
        sess = mgr.session(ctx)
        res = fm.SetSessionOptionsResult()
        for name, val in sreq.session_options.items():
            if not name:
                res.errors[name] = fm.SetSessionOptionsError(
                    value=fm.SetSessionOptionsResult.ERROR_VALUE_INVALID_NAME)
                continue
            pyv = _py_option_value(val)
            opts = sess.setdefault("__options__", {})
            if pyv is None:
                opts.pop(name, None)          # an unset value erases it
            else:
                opts[name] = pyv
        yield fm.Result(body=res.SerializeToString())
    elif req.type == "GetSessionOptions":
        sess = mgr.session(ctx)
        res = fm.GetSessionOptionsResult(session_options={
            name: _pb_option_value(val)
            for name, val in sess.get("__options__", {}).items()})
        yield fm.Result(body=res.SerializeToString())
    else:
        res = fm.CloseSessionResult(
            status=fm.CloseSessionResult.STATUS_CLOSED if mgr.close(ctx)
            else fm.CloseSessionResult.STATUS_NOT_CLOSEABLE)
        yield fm.Result(body=res.SerializeToString())
