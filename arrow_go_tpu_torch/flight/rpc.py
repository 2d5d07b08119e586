"""gRPC over the port's HTTP/2 (flight/h2.py): the client channel and the
server that Flight runs on, with no grpc package.

Request headers: `:method POST`, `:scheme http`, `:path /<service>/<Method>`,
`:authority`, `content-type: application/grpc`, `te: trailers`, then the
call's custom metadata (a `-bin` key's value is bytes, sent as base64).
Each message goes with gRPC's 5-byte prefix (a compressed flag, always
0 here, and its length); message sizes are unlimited. A response is its
headers, its messages and trailers of `grpc-status` and a percent-coded
`grpc-message`; an error before any message is one Trailers-Only block.
An unknown method is UNIMPLEMENTED.

The client: a `Channel` keeps one connection that calls reuse (a new
one after the peer closes it or sends GOAWAY) and takes a list of
middleware objects that see each call's outgoing and incoming metadata
(`ClientMiddleware`). A call's error is an `RpcError` with `code()` (a
`StatusCode`, gRPC's 17 names and values) and `details()`. A stream
whose reader is closed early is reset with CANCEL.

The server: `Server` serves on a ThreadPoolExecutor of `max_workers`
threads the four call shapes (`unary_unary`, `unary_stream`,
`stream_unary`, `stream_stream` handlers); each call gets a
`ServerContext` with `abort`, `invocation_metadata`,
`send_initial_metadata`, `set_trailing_metadata` and `is_active`. A
handler's exception is UNKNOWN, as in grpc.
"""
from __future__ import annotations

import base64
import enum
import socket
import struct
import threading
from concurrent import futures
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import h2

Metadata = List[Tuple[str, object]]


class StatusCode(enum.IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str = "",
                 trailing_metadata: Metadata = ()):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details
        self._trailing = tuple(trailing_metadata)

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self) -> tuple:
        return self._trailing


# --------------------------------------------------------------------------
# metadata and messages
# --------------------------------------------------------------------------

_RESERVED = {"content-type", "te", "grpc-status", "grpc-message",
             "grpc-encoding",
             "grpc-accept-encoding", "grpc-timeout"}
_H2_TO_STATUS = {h2.CANCEL: StatusCode.CANCELLED,
                 h2.REFUSED_STREAM: StatusCode.UNAVAILABLE}


def percent_encode(msg: str) -> str:
    """grpc-message's percent-encoding: bytes outside 0x20-0x7E and '%'
    as %XX of their UTF-8 bytes."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else
                   f"%{b:02X}" for b in msg.encode("utf-8"))


def percent_decode(text: str) -> str:
    src = text.encode("utf-8", "surrogateescape")
    raw, i = bytearray(), 0
    while i < len(src):
        if src[i] == 0x25 and i + 3 <= len(src) and \
                all(c in _HEX for c in src[i + 1:i + 3]):
            raw.append(int(src[i + 1:i + 3], 16))
            i += 3
        else:
            raw.append(src[i])
            i += 1
    return raw.decode("utf-8", "replace")


_HEX = frozenset(b"0123456789abcdefABCDEF")
CONNECT_TIMEOUT = 20.0      # seconds to open a channel's connection


def metadata_out(md) -> List[Tuple[str, str]]:
    """Custom metadata as header fields: lower-case keys, a `-bin` key's
    bytes as unpadded base64."""
    out = []
    for k, v in md or ():
        k = k.lower()
        if k.endswith("-bin"):
            v = v.encode() if isinstance(v, str) else bytes(v)
            v = base64.b64encode(v).decode().rstrip("=")
        out.append((k, v))
    return out


def metadata_in(headers) -> Metadata:
    """A header block's custom metadata: no pseudo-headers or reserved
    keys, a `-bin` value base64-decoded to bytes."""
    out: Metadata = []
    for k, v in headers:
        if k.startswith(":") or k in _RESERVED:
            continue
        if k.endswith("-bin"):
            out.append((k, base64.b64decode(v + "=" * (-len(v) % 4))))
        else:
            out.append((k, v))
    return out


def frame_message(parts) -> list:
    """A message's buffers behind its 5-byte gRPC prefix."""
    if isinstance(parts, (bytes, bytearray, memoryview)):
        parts = [parts]
    n = sum(len(p) for p in parts)
    return [struct.pack(">BI", 0, n)] + list(parts)


class _Messages:
    """The gRPC messages of one stream's DATA: a message that lies in one
    DATA payload is a memoryview of it, one that spans payloads is joined
    once."""

    def __init__(self, conn: h2.Connection, stream: h2.Stream):
        self.conn, self.stream = conn, stream
        self.chunks: List[memoryview] = []
        self.avail = 0

    def _fill(self, n: int) -> bool:
        while self.avail < n:
            c = self.conn.read_chunk(self.stream)
            if c is None:
                return False
            self.chunks.append(c)
            self.avail += len(c)
        return True

    def _take(self, n: int) -> memoryview:
        head = self.chunks[0]
        self.avail -= n
        if len(head) >= n:
            if len(head) == n:
                self.chunks.pop(0)
            else:
                self.chunks[0] = head[n:]
            return head[:n]
        out = bytearray(n)
        pos = 0
        while pos < n:
            c = self.chunks[0]
            k = min(len(c), n - pos)
            out[pos:pos + k] = c[:k]
            pos += k
            if k == len(c):
                self.chunks.pop(0)
            else:
                self.chunks[0] = c[k:]
        return memoryview(out)

    def next(self) -> Optional[memoryview]:
        if not self._fill(5):
            if self.avail:
                raise RpcError(StatusCode.INTERNAL,
                               "stream ended inside a message prefix")
            return None
        flag, n = struct.unpack(">BI", bytes(self._take(5)))
        if flag:
            raise RpcError(StatusCode.INTERNAL,
                           "compressed message without an encoding")
        if not self._fill(n):
            raise RpcError(StatusCode.INTERNAL, "stream ended inside a "
                           "message")
        return self._take(n) if n else memoryview(b"")


# --------------------------------------------------------------------------
# the client
# --------------------------------------------------------------------------

class ClientMiddleware:
    """A client middleware: `sending_headers` returns metadata to add to
    a call, `received_headers` sees a response's initial metadata (or a
    Trailers-Only response's)."""

    def sending_headers(self, method: str) -> Metadata:
        return []

    def received_headers(self, method: str, metadata: Metadata) -> None:
        pass


def _status(headers) -> Tuple[StatusCode, str]:
    d = dict(headers)
    if d.get(":status", "200") != "200":
        return StatusCode.UNKNOWN, f"HTTP status {d[':status']}"
    if "grpc-status" not in d:
        return StatusCode.UNKNOWN, "response without grpc-status"
    try:
        code = StatusCode(int(d["grpc-status"]))
    except ValueError:
        code = StatusCode.UNKNOWN
    return code, percent_decode(d.get("grpc-message", ""))


class Call:
    """One client call; iterate it for the responses. The requests go on
    a thread of their own when they are a stream, so that responses can
    arrive meanwhile."""

    def __init__(self, channel: "Channel", method: str, requests,
                 request_streaming: bool, serializer: Callable,
                 deserializer: Callable, metadata: Optional[Metadata]):
        self.method = method
        self._deserialize = deserializer
        self._mw = channel.middleware
        md = list(metadata or [])
        for m in self._mw:
            md += list(m.sending_headers(method))
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", method), (":authority", channel.target),
                   ("content-type", "application/grpc"), ("te", "trailers"),
                   ("user-agent", "arrow_go_tpu_torch-flight")] + \
            metadata_out(md)
        self._initial: Optional[Metadata] = None
        self._done = False
        self._send_error: Optional[BaseException] = None
        try:
            self.conn = channel.connection()
            self.stream = self.conn.request(headers)
            if not request_streaming:
                self.conn.send_data(self.stream,
                                    frame_message(serializer(requests)),
                                    end_stream=True)
            else:
                threading.Thread(target=self._send_all,
                                 args=(requests, serializer),
                                 daemon=True).start()
        except h2.ConnectionClosed as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e)) from e
        self._messages = _Messages(self.conn, self.stream)

    def _send_all(self, requests, serializer) -> None:
        try:
            for r in requests:
                self.conn.send_data(self.stream,
                                    frame_message(serializer(r)))
            self.conn.send_data(self.stream, [], end_stream=True)
        except (h2.StreamReset, h2.ConnectionClosed):
            pass                      # the response tells why
        except BaseException as e:    # the request iterator failed
            self._send_error = e
            self.conn.reset(self.stream, h2.CANCEL)

    def _fail(self, e: BaseException) -> RpcError:
        if self._send_error is not None:
            return RpcError(StatusCode.CANCELLED,
                            f"request iterator failed: {self._send_error}")
        if isinstance(e, h2.StreamReset):
            return RpcError(_H2_TO_STATUS.get(e.code, StatusCode.INTERNAL),
                            str(e))
        return RpcError(StatusCode.UNAVAILABLE, str(e))

    def initial_metadata(self) -> Metadata:
        if self._initial is None:
            try:
                have = self.conn.wait_headers(self.stream, 1)
            except ConnectionError as e:
                raise self._fail(e) from e
            if not have:
                raise RpcError(StatusCode.INTERNAL,
                               "stream ended without headers")
            first = self.stream.headers[0]
            self._initial = metadata_in(first)
            for m in self._mw:
                m.received_headers(self.method, self._initial)
            if any(k == "grpc-status" for k, _ in first):
                self._initial = []              # Trailers-Only
        return self._initial

    def _finish(self):
        """Reads the trailers; raises their error status."""
        self._done = True
        blocks = self.stream.headers
        trailers = blocks[-1] if blocks else []
        code, details = _status(trailers)
        if code != StatusCode.OK:
            raise RpcError(code, details, metadata_in(trailers))

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        self.initial_metadata()
        try:
            msg = self._messages.next()
        except ConnectionError as e:
            self._done = True
            raise self._fail(e) from e
        if msg is None:
            self._finish()
            raise StopIteration
        return self._deserialize(msg)

    def result(self):
        """The one response of a unary call."""
        out = next(self, None)
        if out is None:
            raise RpcError(StatusCode.INTERNAL, "no response message")
        for _ in self:
            raise RpcError(StatusCode.INTERNAL, "more than one response")
        return out

    def cancel(self) -> None:
        """Resets the stream (CANCEL) unless it has ended."""
        if not self._done:
            self._done = True
            self.conn.reset(self.stream, h2.CANCEL)

    def __del__(self):
        try:
            if not self._done and not self.stream.remote_closed:
                self.conn.reset(self.stream, h2.CANCEL)
        except Exception:
            pass


def parse_target(location: str) -> Tuple[str, int]:
    """(host, port) of `grpc://host:port`, `grpc+tcp://host:port` or
    `host:port`."""
    for scheme in ("grpc+tcp://", "grpc://"):
        if location.startswith(scheme):
            location = location[len(scheme):]
    location = location.rstrip("/")
    host, _, port = location.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"not a grpc location: {location!r}")
    return host.strip("[]"), int(port)


class Channel:
    """A client's connection to one server, opened at the first call and
    shared by the calls that follow."""

    def __init__(self, target: str, middleware: Iterable = ()):
        self.host, self.port = parse_target(target)
        self.target = f"{self.host}:{self.port}"
        self.middleware = list(middleware)
        self._lock = threading.Lock()
        self._conn: Optional[h2.Connection] = None

    def connection(self) -> h2.Connection:
        with self._lock:
            if self._conn is None or not self._conn.usable:
                if self._conn is not None:
                    self._conn.close()
                try:
                    sock = socket.create_connection(
                        (self.host, self.port), timeout=CONNECT_TIMEOUT)
                except OSError as e:
                    raise h2.ConnectionClosed(
                        f"failed to connect to {self.target}: {e}") from e
                self._conn = h2.Connection(sock, client=True).start()
            return self._conn

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def _call(self, method, request_streaming, serializer, deserializer):
        def call(request, metadata=None) -> Call:
            return Call(self, method, request, request_streaming,
                        serializer, deserializer, metadata)
        return call

    def unary_unary(self, method, serializer, deserializer):
        call = self._call(method, False, serializer, deserializer)
        return lambda request, metadata=None: call(request, metadata).result()

    def unary_stream(self, method, serializer, deserializer):
        return self._call(method, False, serializer, deserializer)

    def stream_stream(self, method, serializer, deserializer):
        return self._call(method, True, serializer, deserializer)


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------

class Handler:
    """A method's handler: `kind` one of "unary_unary", "unary_stream",
    "stream_unary", "stream_stream"; `fn(request or request iterator,
    context)`; the request decoder and the response encoder (bytes or a
    list of buffers)."""

    def __init__(self, kind: str, fn: Callable, deserializer: Callable,
                 serializer: Callable):
        self.kind, self.fn = kind, fn
        self.deserializer, self.serializer = deserializer, serializer


class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code, self.details = code, details


class ServerContext:
    """What a handler may do with its call."""

    def __init__(self, conn: h2.Connection, stream: h2.Stream):
        self._conn, self._stream = conn, stream
        self._metadata = tuple(metadata_in(stream.headers[0]))
        self._initial: Metadata = []
        self._trailing: Metadata = []
        self._headers_sent = False
        self._finished = False

    def invocation_metadata(self) -> tuple:
        return self._metadata

    def send_initial_metadata(self, metadata) -> None:
        if self._headers_sent:
            raise RuntimeError("initial metadata already sent")
        self._initial += list(metadata)
        self._send_headers()

    def set_trailing_metadata(self, metadata) -> None:
        self._trailing = list(metadata)

    def abort(self, code: StatusCode, details: str = ""):
        raise _Abort(code, details)

    def is_active(self) -> bool:
        return self._stream.reset is None and self._conn.closed is None

    def _send_headers(self) -> None:
        self._headers_sent = True
        self._conn.send_headers(self._stream, [
            (":status", "200"), ("content-type", "application/grpc")] +
            metadata_out(self._initial))

    def _send_message(self, parts) -> None:
        if not self._headers_sent:
            self._send_headers()
        self._conn.send_data(self._stream, frame_message(parts))

    def _finish(self, code: StatusCode, details: str = "") -> None:
        if self._finished:
            return
        status = [("grpc-status", str(int(code)))]
        if details:
            status.append(("grpc-message", percent_encode(details)))
        if self._headers_sent:
            block = status + metadata_out(self._trailing)
        else:                                       # Trailers-Only
            block = [(":status", "200"),
                     ("content-type", "application/grpc")] + status + \
                metadata_out(self._initial + self._trailing)
        self._conn.send_headers(self._stream, block, end_stream=True)
        self._finished = True
        if not self._stream.remote_closed:
            self._conn.discard(self._stream)


class Server:
    """A gRPC server on the port's HTTP/2: `handlers` maps a method's
    path (`/<service>/<Method>`) to its Handler; `middleware` objects'
    `call_started(method, context)` runs before each handler (it may
    abort the call)."""

    def __init__(self, handlers: Dict[str, Handler], max_workers: int = 8,
                 middleware: Iterable = ()):
        self.handlers = dict(handlers)
        self.middleware = list(middleware)
        self._pool = futures.ThreadPoolExecutor(max_workers=max_workers)
        self._listener: Optional[socket.socket] = None
        self._conns: List[h2.Connection] = []
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._accepter: Optional[threading.Thread] = None

    def add_insecure_port(self, address: str) -> int:
        host, port = parse_target(address)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host if host not in ("", "[::]") else "0.0.0.0", port))
        sock.listen(64)
        self._listener = sock
        return sock.getsockname()[1]

    def start(self) -> None:
        self._accepter = threading.Thread(target=self._accept, daemon=True,
                                          name="rpc-accept")
        self._accepter.start()

    def _accept(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = h2.Connection(sock, client=False)
            conn.on_stream = lambda st, c=conn: self._pool.submit(
                self._serve, c, st)
            with self._lock:
                if self._stopped.is_set():
                    sock.close()
                    return
                self._conns = [c for c in self._conns if c.closed is None]
                self._conns.append(conn)
            conn.start()

    def stop(self, grace: Optional[float] = None) -> None:
        self._stopped.set()
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            c.close()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def wait_for_termination(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)

    def _serve(self, conn: h2.Connection, stream: h2.Stream) -> None:
        ctx = ServerContext(conn, stream)
        path = dict(stream.headers[0]).get(":path", "")
        result = None
        what = "Exception calling application"
        try:
            h = self.handlers.get(path)
            if h is None:
                raise _Abort(StatusCode.UNIMPLEMENTED,
                             f"Method not found: {path}")
            for m in self.middleware:
                m.call_started(path, ctx)
            msgs = _Messages(conn, stream)
            if h.kind.startswith("stream"):
                request = _requests(msgs, h.deserializer)
            else:
                raw = _request(msgs)
                if raw is None:
                    raise _Abort(StatusCode.INTERNAL, "no request message")
                request = h.deserializer(raw)
            result = h.fn(request, ctx)
            if h.kind.endswith("stream"):
                what = "Exception iterating responses"
                for r in result:
                    ctx._send_message(h.serializer(r))
            else:
                ctx._send_message(h.serializer(result))
            ctx._finish(StatusCode.OK)
        except _Abort as a:
            _end(ctx, a.code, a.details)
        except Exception as e:
            if ctx.is_active():           # else the client went away
                _end(ctx, StatusCode.UNKNOWN, f"{what}: {e}")
        finally:
            close = getattr(result, "close", None)
            if close is not None:
                close()                       # ends a handler's generator


def _end(ctx: ServerContext, code: StatusCode, details: str) -> None:
    """Ends a call with an error status; resets the stream (INTERNAL)
    when the status cannot be sent, so that no peer waits on it."""
    try:
        ctx._finish(code, details)
    except ConnectionError:
        ctx._conn.reset(ctx._stream, h2.INTERNAL_ERROR)


def _request(msgs: _Messages) -> Optional[memoryview]:
    """The next request message; a malformed one aborts the call."""
    try:
        return msgs.next()
    except RpcError as e:
        raise _Abort(e.code(), e.details()) from e


def _requests(msgs: _Messages, deserializer):
    while True:
        raw = _request(msgs)
        if raw is None:
            return
        yield deserializer(raw)
