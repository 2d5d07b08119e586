"""HTTP/2 over a TCP socket (RFC 9113), with prior knowledge (h2c), as
gRPC runs it: the connection preface, every frame gRPC uses (DATA,
HEADERS and CONTINUATION with their padding and priority fields parsed,
SETTINGS, PING, WINDOW_UPDATE, RST_STREAM, GOAWAY), streams multiplexed
on one connection, and flow control on both sides.

One reader thread a connection reads every frame. It never writes a
body: the control frames it answers (SETTINGS and PING acknowledgements,
window refills of dropped streams) go out at once when the send lock is
free and are otherwise left for the thread that holds it, so the reader
never waits on a writer. Writers of DATA wait on a condition for the
peer's stream and connection windows (C-core opens them at 65,535 bytes
and grows them), cut frames to the peer's SETTINGS_MAX_FRAME_SIZE, and
hand each frame's buffers to one `sendmsg`, so a body is copied once,
into the kernel. This side advertises windows of LOCAL_WINDOW bytes and
refills a stream's and the connection's window as its data is consumed.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import hpack

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, \
    GOAWAY, WINDOW_UPDATE, CONTINUATION = range(10)
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20

SETTINGS_ENABLE_PUSH = 2
SETTINGS_INITIAL_WINDOW_SIZE = 4
SETTINGS_MAX_FRAME_SIZE = 5

# RST_STREAM / GOAWAY error codes
NO_ERROR, INTERNAL_ERROR, REFUSED_STREAM, CANCEL = 0, 2, 7, 8

DEFAULT_WINDOW = 65_535
DEFAULT_MAX_FRAME = 16_384
MAX_WINDOW = (1 << 31) - 1
LOCAL_WINDOW = 1 << 26          # advertised for each stream and the connection
LOCAL_MAX_FRAME = (1 << 24) - 1  # the largest frame this side accepts
REFILL = LOCAL_WINDOW // 4       # consumed bytes that send a WINDOW_UPDATE
TIMEOUT = 300.0                  # seconds one wait for a peer may take
_IOV_MAX = 512


class ConnectionClosed(ConnectionError):
    """The connection ended (the peer closed it, a GOAWAY refused the
    stream, or a protocol error)."""


class StreamReset(ConnectionError):
    """The stream was reset (RST_STREAM); `code` is the HTTP/2 error."""

    def __init__(self, code: int):
        super().__init__(f"stream reset with error code {code}")
        self.code = code


def pack_frame_header(length: int, ftype: int, flags: int,
                      stream_id: int) -> bytes:
    return struct.pack(">I", length)[1:] + bytes([ftype, flags]) + \
        struct.pack(">I", stream_id & 0x7FFFFFFF)


def parse_frame_header(b) -> tuple:
    """(length, type, flags, stream id) of a 9-byte frame header."""
    length = int.from_bytes(bytes(b[:3]), "big")
    return length, b[3], b[4], struct.unpack(">I", bytes(b[5:9]))[0] & \
        0x7FFFFFFF


def frame(ftype: int, flags: int, stream_id: int, payload=b"") -> bytes:
    return pack_frame_header(len(payload), ftype, flags, stream_id) + \
        bytes(payload)


def strip_padding(ftype: int, flags: int, payload) -> memoryview:
    """A DATA or HEADERS payload without its padding (and a HEADERS one
    without its priority fields)."""
    mv = memoryview(payload)
    if flags & PADDED:
        if not len(mv):
            raise ConnectionClosed("padded frame without its pad length")
        pad = mv[0]
        mv = mv[1:]
        if pad > len(mv):
            raise ConnectionClosed("padding longer than the frame")
        mv = mv[:len(mv) - pad]
    if ftype == HEADERS and flags & PRIORITY_FLAG:
        mv = mv[5:]
    return mv


def settings_payload(pairs) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in pairs)


def _sendmsg_all(sock: socket.socket, bufs: List) -> None:
    bufs = [b for b in bufs if len(b)]
    while bufs:
        sent = sock.sendmsg(bufs[:_IOV_MAX])
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if sent:
            bufs[0] = memoryview(bufs[0])[sent:]


class Stream:
    """One stream: the header blocks and DATA received, and the send
    window."""

    def __init__(self, conn: "Connection", sid: int):
        self.conn = conn
        self.id = sid
        self.headers: List[List[tuple]] = []     # each block's (name, value)
        self.chunks: deque = deque()             # DATA payloads not yet read
        self.remote_closed = False               # END_STREAM received
        self.local_closed = False                # END_STREAM sent
        self.reset: Optional[int] = None         # RST_STREAM code, either way
        self.send_window = conn.peer_initial_window
        self.unacked = 0                         # consumed, not yet refilled
        self.discard = False                     # drop what arrives from now


def _header_text(b: bytes) -> str:
    return b.decode("utf-8", "surrogateescape")


class Connection:
    """An HTTP/2 connection on `sock`. A server connection calls
    `on_stream(stream)` from its reader thread when a peer opens a
    stream (its first header block is in `stream.headers`)."""

    def __init__(self, sock: socket.socket, client: bool,
                 on_stream: Optional[Callable[[Stream], None]] = None):
        if sock.family in (socket.AF_INET, socket.AF_INET6):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        self.sock = sock
        self.client = client
        self.on_stream = on_stream
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.send_lock = threading.Lock()
        self.streams: Dict[int, Stream] = {}
        self.next_id = 1 if client else 2
        self.last_peer_stream = 0
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.conn_send_window = DEFAULT_WINDOW
        self.conn_unacked = 0
        self.closed: Optional[BaseException] = None
        self.goaway: Optional[int] = None
        self.decoder = hpack.Decoder()
        self._pending: List[bytes] = []
        self._hblock: Optional[list] = None      # (sid, end_stream, bytes)
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="h2-reader")

    # -- life --------------------------------------------------------------

    def start(self) -> "Connection":
        settings = [(SETTINGS_INITIAL_WINDOW_SIZE, LOCAL_WINDOW),
                    (SETTINGS_MAX_FRAME_SIZE, LOCAL_MAX_FRAME)]
        if self.client:
            settings.insert(0, (SETTINGS_ENABLE_PUSH, 0))
        first = (PREFACE if self.client else b"") + \
            frame(SETTINGS, 0, 0, settings_payload(settings)) + \
            frame(WINDOW_UPDATE, 0, 0,
                  struct.pack(">I", LOCAL_WINDOW - DEFAULT_WINDOW))
        with self.send_lock:
            self.sock.sendall(first)
        self._reader.start()
        return self

    def close(self) -> None:
        with self.lock:
            if self.closed is not None:
                return
            self.closed = ConnectionClosed("connection closed")
            last = self.last_peer_stream
            self.cond.notify_all()
        if self.send_lock.acquire(timeout=1.0):
            try:
                self.sock.sendall(frame(GOAWAY, 0, 0,
                                        struct.pack(">II", last, NO_ERROR)))
            except OSError:
                pass
            finally:
                self.send_lock.release()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    @property
    def usable(self) -> bool:
        return self.closed is None and self.goaway is None

    def _fail(self, exc: BaseException) -> None:
        with self.lock:
            if self.closed is None:
                self.closed = exc if isinstance(exc, ConnectionError) else \
                    ConnectionClosed(str(exc))
            self.cond.notify_all()
        try:
            self.sock.close()
        except OSError:
            pass

    # -- the reader ----------------------------------------------------------

    def _recv_exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        mv = memoryview(buf)
        pos = 0
        while pos < n:
            got = self.sock.recv_into(mv[pos:])
            if not got:
                raise ConnectionClosed("the peer closed the connection")
            pos += got
        return buf

    def _read_loop(self) -> None:
        try:
            if not self.client and \
                    bytes(self._recv_exact(len(PREFACE))) != PREFACE:
                raise ConnectionClosed("not an HTTP/2 connection preface")
            while True:
                length, ftype, flags, sid = parse_frame_header(
                    self._recv_exact(9))
                if length > LOCAL_MAX_FRAME:
                    raise ConnectionClosed(f"frame of {length} bytes")
                payload = self._recv_exact(length) if length else \
                    bytearray()
                self._on_frame(ftype, flags, sid, payload)
        except BaseException as e:          # the connection is over
            self._fail(e)

    def _on_frame(self, ftype: int, flags: int, sid: int,
                  payload: bytearray) -> None:
        if self._hblock is not None and ftype != CONTINUATION:
            raise ConnectionClosed("header block interrupted")
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            block = strip_padding(ftype, flags, payload)
            self._hblock = [sid, bool(flags & END_STREAM), bytes(block)]
            if flags & END_HEADERS:
                self._end_headers()
        elif ftype == CONTINUATION:
            if self._hblock is None or self._hblock[0] != sid:
                raise ConnectionClosed("CONTINUATION out of place")
            self._hblock[2] += bytes(payload)
            if flags & END_HEADERS:
                self._end_headers()
        elif ftype == SETTINGS:
            if not flags & ACK:
                self._on_settings(payload)
        elif ftype == PING:
            if not flags & ACK:
                self._control(frame(PING, ACK, 0, payload))
        elif ftype == WINDOW_UPDATE:
            inc = struct.unpack(">I", bytes(payload[:4]))[0] & 0x7FFFFFFF
            with self.lock:
                if sid == 0:
                    self.conn_send_window += inc
                elif sid in self.streams:
                    self.streams[sid].send_window += inc
                self.cond.notify_all()
        elif ftype == RST_STREAM:
            (code,) = struct.unpack(">I", bytes(payload[:4]))
            with self.lock:
                st = self.streams.pop(sid, None)
                if st is not None:
                    st.reset = code
                self.cond.notify_all()
        elif ftype == GOAWAY:
            last, code = struct.unpack(">II", bytes(payload[:8]))
            last &= 0x7FFFFFFF
            with self.lock:
                self.goaway = last
                for s in list(self.streams):
                    if (s % 2 == 1) == self.client and s > last:
                        self.streams.pop(s).reset = REFUSED_STREAM
                self.cond.notify_all()
        elif ftype == PUSH_PROMISE:
            raise ConnectionClosed("PUSH_PROMISE with push disabled")
        # PRIORITY and unknown frame types are ignored

    def _on_data(self, flags: int, sid: int, payload: bytearray) -> None:
        data = strip_padding(DATA, flags, payload)
        credit = len(payload) - len(data)        # padding is never consumed
        with self.lock:
            st = self.streams.get(sid)
            if st is None or st.reset is not None or st.discard:
                credit = len(payload)            # a dropped stream's data
                if st is not None and flags & END_STREAM:
                    st.remote_closed = True
                    self._forget(st)
            else:
                if len(data):
                    st.chunks.append(data)
                if flags & END_STREAM:
                    st.remote_closed = True
                    self._forget(st)
                self.cond.notify_all()
            self.conn_unacked += credit
            refill = self.conn_unacked >= REFILL
            if refill:
                inc, self.conn_unacked = self.conn_unacked, 0
        if refill:
            self._control(frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", inc)))

    def _end_headers(self) -> None:
        sid, end, block = self._hblock
        self._hblock = None
        headers = [(_header_text(n), _header_text(v))
                   for n, v in self.decoder.decode(block)]
        new = None
        with self.lock:
            st = self.streams.get(sid)
            if st is None and not self.client and sid % 2 == 1 and \
                    sid > self.last_peer_stream and self.closed is None:
                self.last_peer_stream = sid
                st = new = Stream(self, sid)
                self.streams[sid] = st
            if st is not None:
                st.headers.append(headers)
                if end:
                    st.remote_closed = True
                    self._forget(st)
                self.cond.notify_all()
        if new is not None and self.on_stream is not None:
            self.on_stream(new)

    def _on_settings(self, payload) -> None:
        with self.lock:
            for off in range(0, len(payload) - 5, 6):
                k, v = struct.unpack_from(">HI", payload, off)
                if k == SETTINGS_INITIAL_WINDOW_SIZE:
                    if v > MAX_WINDOW:
                        raise ConnectionClosed("window size over 2^31-1")
                    delta = v - self.peer_initial_window
                    self.peer_initial_window = v
                    for st in self.streams.values():
                        st.send_window += delta
                elif k == SETTINGS_MAX_FRAME_SIZE:
                    self.peer_max_frame = v
                # other ids (C-core sends its own) are ignored
            self.cond.notify_all()
        self._control(frame(SETTINGS, ACK, 0))

    def _forget(self, st: Stream) -> None:
        """Drops a stream closed both ways (self.lock held)."""
        if st.remote_closed and st.local_closed:
            self.streams.pop(st.id, None)

    # -- sending -----------------------------------------------------------

    def _control(self, data: bytes) -> None:
        """A control frame from the reader: sent now if the send lock is
        free, else by its holder when it lets go."""
        with self.lock:
            self._pending.append(data)
        if self.send_lock.acquire(blocking=False):
            self._release_send()

    def _release_send(self) -> None:
        """Sends the pending control frames, then lets go of the send lock
        (held); takes it again if more arrived meanwhile."""
        while True:
            try:
                with self.lock:
                    pending, self._pending = self._pending, []
                if pending:
                    self.sock.sendall(b"".join(pending))
            except OSError as e:
                self.send_lock.release()
                self._fail(e)
                return
            self.send_lock.release()
            with self.lock:
                more = bool(self._pending)
            if not more or not self.send_lock.acquire(blocking=False):
                return

    def _send(self, bufs: List) -> None:
        if not self.send_lock.acquire(timeout=TIMEOUT):
            raise ConnectionClosed("send lock not released")
        try:
            _sendmsg_all(self.sock, bufs)
        except OSError as e:
            self.send_lock.release()
            self._fail(e)
            raise ConnectionClosed(str(e)) from e
        self._release_send()

    def _header_frames(self, sid: int, headers, end_stream: bool) -> list:
        block = hpack.encode(headers)
        step = self.peer_max_frame
        parts = [block[i:i + step] for i in range(0, len(block), step)] or \
            [b""]
        out = []
        for i, p in enumerate(parts):
            flags = END_HEADERS if i == len(parts) - 1 else 0
            if i == 0:
                flags |= END_STREAM if end_stream else 0
            out.append(frame(HEADERS if i == 0 else CONTINUATION, flags, sid,
                             p))
        return out

    def request(self, headers, end_stream: bool = False) -> Stream:
        """Opens a stream with its request headers (a client)."""
        if not self.send_lock.acquire(timeout=TIMEOUT):
            raise ConnectionClosed("send lock not released")
        try:
            with self.lock:
                if self.closed is not None:
                    raise ConnectionClosed(str(self.closed))
                if self.goaway is not None:
                    raise ConnectionClosed("the peer sent GOAWAY")
                st = Stream(self, self.next_id)
                self.next_id += 2
                st.local_closed = end_stream
                self.streams[st.id] = st
            _sendmsg_all(self.sock, self._header_frames(st.id, headers,
                                                        end_stream))
        except OSError as e:
            self.send_lock.release()
            self._fail(e)
            raise ConnectionClosed(str(e)) from e
        except BaseException:
            self.send_lock.release()
            raise
        self._release_send()
        return st

    def _check(self, st: Stream) -> None:
        if st.reset is not None:
            raise StreamReset(st.reset)
        if self.closed is not None:
            raise ConnectionClosed(str(self.closed))

    def _wait(self, st: Stream, ready: Callable[[], object],
              what: str) -> None:
        """Waits on the condition (self.lock held) until `ready()`; raises
        when the stream is reset, the connection closes, or TIMEOUT
        seconds pass first."""
        deadline = time.monotonic() + TIMEOUT
        while not ready():
            self._check(st)
            left = deadline - time.monotonic()
            if left <= 0:
                raise ConnectionClosed(f"waited {TIMEOUT:g} s for {what}")
            self.cond.wait(left)

    def _window(self, st: Stream) -> int:
        """The bytes the next DATA frame of `st` may carry (self.lock
        held)."""
        return min(self.conn_send_window, st.send_window,
                   self.peer_max_frame)

    def send_headers(self, st: Stream, headers,
                     end_stream: bool = False) -> None:
        with self.lock:
            self._check(st)
            if end_stream:
                st.local_closed = True
                self._forget(st)
        self._send(self._header_frames(st.id, headers, end_stream))

    def send_data(self, st: Stream, parts, end_stream: bool = False) -> None:
        """Sends the buffers `parts` as DATA frames, each cut to the
        windows and the peer's frame size; the buffers are sliced, not
        joined."""
        queue = deque(memoryview(p).cast("B") for p in parts if len(p))
        remaining = sum(len(p) for p in queue)
        while True:
            with self.lock:
                self._wait(st, lambda: remaining == 0 or
                           self._window(st) > 0, "a flow-control window")
                self._check(st)
                n = min(remaining, max(self._window(st), 0))
                self.conn_send_window -= n
                st.send_window -= n
                last = n == remaining and end_stream
                if last:
                    st.local_closed = True
                    self._forget(st)
            bufs, take = [], n
            while take:
                p = queue[0]
                if len(p) <= take:
                    bufs.append(queue.popleft())
                    take -= len(p)
                else:
                    bufs.append(p[:take])
                    queue[0] = p[take:]
                    take = 0
            remaining -= n
            if n or last:
                self._send([pack_frame_header(
                    n, DATA, END_STREAM if last else 0, st.id)] + bufs)
            if remaining == 0:
                return

    def _drop_chunks(self, st: Stream) -> List[bytes]:
        """Credits the connection window with a stream's unread DATA and
        drops it (self.lock held); the WINDOW_UPDATE frames to send."""
        self.conn_unacked += sum(len(c) for c in st.chunks)
        st.chunks.clear()
        if self.conn_unacked < REFILL:
            return []
        inc, self.conn_unacked = self.conn_unacked, 0
        return [frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", inc))]

    def reset(self, st: Stream, code: int = CANCEL) -> None:
        with self.lock:
            if st.reset is not None or self.closed is not None or \
                    (st.remote_closed and st.local_closed):
                return
            st.reset = code
            self.streams.pop(st.id, None)
            frames = self._drop_chunks(st)
            self.cond.notify_all()
        try:
            self._send(frames + [frame(RST_STREAM, 0, st.id,
                                       struct.pack(">I", code))])
        except ConnectionError:
            pass

    def discard(self, st: Stream) -> None:
        """Drops what the stream has received and will receive, keeping
        it open (a server that answered before its request ended)."""
        with self.lock:
            st.discard = True
            frames = self._drop_chunks(st)
        if frames:
            try:
                self._send(frames)
            except ConnectionError:
                pass

    # -- receiving ---------------------------------------------------------

    def wait_headers(self, st: Stream, count: int) -> bool:
        """Waits for the stream's `count`-th header block; False when the
        stream ended without it."""
        with self.lock:
            self._wait(st, lambda: len(st.headers) >= count or
                       st.remote_closed, "headers")
            return len(st.headers) >= count

    def read_chunk(self, st: Stream) -> Optional[memoryview]:
        """The next DATA payload of the stream, or None at its end."""
        with self.lock:
            self._wait(st, lambda: st.chunks or st.remote_closed, "data")
            if not st.chunks:
                return None
            chunk = st.chunks.popleft()
            st.unacked += len(chunk)
            self.conn_unacked += len(chunk)
            frames = []
            if st.unacked >= REFILL and not st.remote_closed:
                frames.append(frame(WINDOW_UPDATE, 0, st.id,
                                    struct.pack(">I", st.unacked)))
                st.unacked = 0
            if self.conn_unacked >= REFILL:
                frames.append(frame(WINDOW_UPDATE, 0, 0,
                                    struct.pack(">I", self.conn_unacked)))
                self.conn_unacked = 0
        if frames:
            try:
                self._send(frames)
            except ConnectionError:
                pass
        return chunk
