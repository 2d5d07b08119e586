"""The port's HPACK (flight/hpack.py) and HTTP/2 framing (flight/h2.py):
the integer and string codecs, the static table, the dynamic table and
its eviction, the Huffman code of RFC 7541 Appendix B (derived from its
code lengths) with the RFC's examples, `-bin` metadata that grpc C-core
and pyarrow.flight send Huffman-coded, and frame round trips of a
connection against a raw peer on a socket pair. Every raw read has a
timeout."""
import os
import socket
import struct
import threading
import time
from fractions import Fraction

import pytest

from arrow_go_tpu_torch.flight import h2, hpack, rpc


# ---------------------------------------------------------------------------
# integers and strings (RFC 7541 5.1, 5.2, C.1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,prefix,hexed", [
    (10, 5, "0a"), (1337, 5, "1f9a0a"), (42, 8, "2a"), (31, 5, "1f00"),
    (127, 7, "7f00"), (0, 4, "00")])
def test_integer_codec_rfc_examples(value, prefix, hexed):
    assert hpack.encode_int(value, prefix).hex() == hexed
    assert hpack.decode_int(bytes.fromhex(hexed), 0, prefix) == \
        (value, len(hexed) // 2)


def test_integer_round_trip_and_truncation():
    for prefix in range(1, 9):
        for v in (0, 1, 2**prefix - 2, 2**prefix - 1, 2**prefix, 300,
                  2**21 + 7, 2**40):
            b = hpack.encode_int(v, prefix, 0)
            assert hpack.decode_int(b, 0, prefix) == (v, len(b))
            if len(b) > 1:
                with pytest.raises(hpack.HPACKError):
                    hpack.decode_int(b[:-1], 0, prefix)


@pytest.mark.parametrize("huffman", [False, True])
def test_string_codec(huffman):
    for s in (b"", b"a", b"custom-value", bytes(range(256)), os.urandom(999)):
        if huffman:
            h = hpack.huffman_encode(s)
            b = hpack.encode_int(len(h), 7, 0x80) + h
        else:
            b = hpack.encode_str(s)
            assert not b[0] & 0x80
        assert hpack.decode_str(b, 0) == (s, len(b))
    with pytest.raises(hpack.HPACKError):
        hpack.decode_str(hpack.encode_str(b"abcdef")[:-1], 0)


# ---------------------------------------------------------------------------
# the Huffman code (Appendix B)
# ---------------------------------------------------------------------------

def test_huffman_lengths_are_a_complete_prefix_code():
    lengths = hpack.HUFFMAN_LENGTHS
    assert len(lengths) == 257
    assert sum(Fraction(1, 2 ** n) for n in lengths) == 1     # Kraft
    assert lengths[hpack.EOS] == 30
    assert hpack.HUFFMAN_CODES[hpack.EOS] == (1 << 30) - 1     # thirty 1s
    codes = {(c, n) for c, n in zip(hpack.HUFFMAN_CODES, lengths)}
    assert len(codes) == 257
    # canonical: within a length, codes follow symbol order
    for n in set(lengths):
        syms = [s for s in range(257) if lengths[s] == n]
        cs = [hpack.HUFFMAN_CODES[s] for s in syms]
        assert cs == list(range(cs[0], cs[0] + len(cs)))


@pytest.mark.parametrize("text,hexed", [
    (b"www.example.com", "f1e3c2e5f23a6ba0ab90f4ff"),
    (b"no-cache", "a8eb10649cbf"),
    (b"custom-key", "25a849e95ba97d7f"),
    (b"custom-value", "25a849e95bb8e8b4bf"),
    (b"302", "6402"), (b"private", "aec3771a4b"),
    (b"https://www.example.com", "9d29ad171863c78f0b97c8e9ae82ae43d3")])
def test_huffman_rfc_examples(text, hexed):
    assert hpack.huffman_encode(text).hex() == hexed
    assert hpack.huffman_decode(bytes.fromhex(hexed)) == text


def test_huffman_round_trip_and_bad_input():
    for n in range(0, 300, 7):
        data = os.urandom(n)
        assert hpack.huffman_decode(hpack.huffman_encode(data)) == data
    # padding longer than 7 bits, padding not of 1s, EOS in the string
    with pytest.raises(hpack.HPACKError):
        hpack.huffman_decode(hpack.huffman_encode(b"a") + b"\xff")
    with pytest.raises(hpack.HPACKError):
        hpack.huffman_decode(bytes([0x00]))    # '0' then 0-bit padding
    with pytest.raises(hpack.HPACKError):
        hpack.huffman_decode(b"\xff\xff\xff\xff")


# ---------------------------------------------------------------------------
# the tables and the header block (Appendix A, C.3, C.4)
# ---------------------------------------------------------------------------

def test_static_table():
    assert len(hpack.STATIC_TABLE) == 61
    assert hpack.STATIC_TABLE[0] == (b":authority", b"")
    assert hpack.STATIC_TABLE[1] == (b":method", b"GET")
    assert hpack.STATIC_TABLE[7] == (b":status", b"200")
    assert hpack.STATIC_TABLE[30] == (b"content-type", b"")
    assert hpack.STATIC_TABLE[60] == (b"www-authenticate", b"")


_C3 = ["828684410f7777772e6578616d706c652e636f6d",
       "828684be58086e6f2d6361636865",
       "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"]
_C4 = ["828684418cf1e3c2e5f23a6ba0ab90f4ff",
       "828684be5886a8eb10649cbf",
       "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"]
_WANT = [
    [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
     (b":authority", b"www.example.com")],
    [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
     (b":authority", b"www.example.com"), (b"cache-control", b"no-cache")],
    [(b":method", b"GET"), (b":scheme", b"https"),
     (b":path", b"/index.html"), (b":authority", b"www.example.com"),
     (b"custom-key", b"custom-value")]]


@pytest.mark.parametrize("blocks", [_C3, _C4], ids=["raw", "huffman"])
def test_rfc_request_sequence(blocks):
    d = hpack.Decoder()
    sizes = []
    for hexed, want in zip(blocks, _WANT):
        assert d.decode(bytes.fromhex(hexed)) == want
        sizes.append(d.table.size)
    assert sizes == [57, 110, 164]
    assert d.table.entries[0] == (b"custom-key", b"custom-value")


def _indexed_literal(name: bytes, value: bytes) -> bytes:
    return hpack.encode_int(0, 6, 0x40) + hpack.encode_str(name) + \
        hpack.encode_str(value)


def test_dynamic_table_eviction_and_size_updates():
    d = hpack.Decoder(256)
    entries = [(b"k%d" % i, b"v" * 40) for i in range(8)]   # 74 B each
    for i, e in enumerate(entries):
        assert d.decode(_indexed_literal(*e)) == [e]
        held = entries[max(0, i - 2):i + 1][::-1]            # 3 fit in 256
        assert d.table.entries == held
        assert d.table.size == 74 * len(held)
    # index 62 is the newest entry, 64 the oldest held
    assert d.decode(bytes([0x80 | 62, 0x80 | 64])) == [entries[7],
                                                        entries[5]]
    with pytest.raises(hpack.HPACKError):
        d.decode(bytes([0x80 | 65]))
    # a size update evicts; one past the advertised limit is an error
    d.decode(hpack.encode_int(100, 5, 0x20))
    assert d.table.entries == [entries[7]]
    d.decode(hpack.encode_int(0, 5, 0x20))
    assert d.table.entries == [] and d.table.size == 0
    with pytest.raises(hpack.HPACKError):
        d.decode(hpack.encode_int(257, 5, 0x20))
    # an entry larger than the table empties it
    d.decode(hpack.encode_int(256, 5, 0x20))
    d.decode(_indexed_literal(b"big", b"x" * 300))
    assert d.table.entries == [] and d.table.size == 0


def test_literal_forms_and_the_stateless_encoder():
    d = hpack.Decoder()
    never = hpack.encode_int(0, 4, 0x10) + hpack.encode_str(b"a") + \
        hpack.encode_str(b"b")
    without = hpack.encode_int(4, 4, 0) + hpack.encode_str(b"/x")
    assert d.decode(never + without) == [(b"a", b"b"), (b":path", b"/x")]
    assert d.table.entries == []
    headers = [(":method", "POST"), (":path", "/svc/M"), ("te", "trailers"),
               ("content-type", "application/grpc"), ("x-k", "v" * 300),
               ("set-cookie", "a=b")]
    block = hpack.encode(headers)
    assert block[:1] == bytes([0x80 | 3])          # the static POST
    assert d.decode(block) == [(k.encode(), v.encode()) for k, v in headers]
    assert d.table.entries == []                    # nothing indexed


# ---------------------------------------------------------------------------
# -bin metadata from grpc C-core and pyarrow.flight
# ---------------------------------------------------------------------------

BIN = bytes(range(256)) * 3


def _echo_server():
    seen = []

    def echo(req, ctx):
        seen.append(ctx.invocation_metadata())
        return b"ok"
    srv = rpc.Server({"/t.S/Echo": rpc.Handler("unary_unary", echo,
                                               bytes, bytes)})
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    return srv, port, seen


@pytest.fixture
def huffman_count(monkeypatch):
    calls = []
    orig = hpack.huffman_decode

    def counting(data):
        calls.append(len(data))
        return orig(data)
    monkeypatch.setattr(hpack, "huffman_decode", counting)
    return calls


def test_bin_metadata_from_grpc_decodes(huffman_count):
    grpc = pytest.importorskip("grpc")
    srv, port, seen = _echo_server()
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        for k in range(3):            # C-core indexes the repeats
            assert ch.unary_unary("/t.S/Echo")(
                b"", metadata=(("x-blob-bin", BIN[k:]),
                               ("x-text", "plain value"))) == b"ok"
        ch.close()
    finally:
        srv.stop()
    for k, md in enumerate(seen):
        assert ("x-blob-bin", BIN[k:]) in md
        assert ("x-text", "plain value") in md
    assert huffman_count                      # strings came Huffman-coded


def test_bin_metadata_from_pyarrow_decodes(huffman_count):
    pafl = pytest.importorskip("pyarrow.flight")
    from arrow_go_tpu_torch import flight as tfl
    got = []

    class Srv(tfl.FlightServerBase):
        def do_action(self, ctx, action):
            got.append(dict(ctx.invocation_metadata()))
            yield tfl.Result(b"")

    with Srv("grpc://127.0.0.1:0") as srv:
        c = pafl.connect(f"grpc://127.0.0.1:{srv.port}")
        opts = pafl.FlightCallOptions(headers=[(b"x-blob-bin", BIN),
                                               (b"x-text", b"hello")])
        list(c.do_action(pafl.Action("a", b""), options=opts))
        c.close()
    assert got[0]["x-blob-bin"] == BIN and got[0]["x-text"] == "hello"
    assert huffman_count


# ---------------------------------------------------------------------------
# frames (RFC 9113) against a raw peer
# ---------------------------------------------------------------------------

class RawPeer:
    """The client side of a socket pair, speaking raw frames to a server
    Connection; every read times out."""

    def __init__(self, on_stream=None):
        a, b = socket.socketpair()
        b.settimeout(10)
        self.sock = b
        self.streams = []
        self.got = threading.Event()

        def opened(st):
            self.streams.append(st)
            self.got.set()
            if on_stream:
                on_stream(st)
        self.conn = h2.Connection(a, client=False, on_stream=opened).start()
        b.sendall(h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0, h2.settings_payload(
            [(h2.SETTINGS_MAX_FRAME_SIZE, 16384), (0xFE03, 1), (0x99, 7)])))

    def read_frame(self):
        head = self._exact(9)
        length, ftype, flags, sid = h2.parse_frame_header(head)
        return ftype, flags, sid, self._exact(length)

    def _exact(self, n):
        out = b""
        while len(out) < n:
            c = self.sock.recv(n - len(out))
            assert c, "peer closed"
            out += c
        return out

    def frames_until(self, ftype, flags_set=0):
        while True:
            f = self.read_frame()
            if f[0] == ftype and f[1] & flags_set == flags_set:
                return f

    def close(self):
        self.conn.close()
        self.sock.close()


def test_frame_header_round_trip():
    for length, t, fl, sid in [(0, 0, 0, 0), (16384, 1, 5, 1),
                               ((1 << 24) - 1, 9, 0xFF, (1 << 31) - 1)]:
        b = h2.pack_frame_header(length, t, fl, sid)
        assert len(b) == 9 and h2.parse_frame_header(b) == (length, t, fl,
                                                            sid)
    # the reserved bit of the stream id is ignored
    assert h2.parse_frame_header(b"\0\0\0\0\0\x80\0\0\x05")[3] == 5
    padded = bytes([3]) + b"data" + b"\0\0\0"
    assert bytes(h2.strip_padding(h2.DATA, h2.PADDED, padded)) == b"data"
    prio = bytes([1]) + b"\0\0\0\x03\x10" + b"blk" + b"\0"
    assert bytes(h2.strip_padding(h2.HEADERS, h2.PADDED | h2.PRIORITY_FLAG,
                                  prio)) == b"blk"
    with pytest.raises(h2.ConnectionClosed):
        h2.strip_padding(h2.DATA, h2.PADDED, bytes([9]) + b"ab")


def test_settings_ping_and_headers_with_padding_and_continuation():
    peer = RawPeer()
    try:
        ftype, flags, _, payload = peer.read_frame()
        assert (ftype, flags) == (h2.SETTINGS, 0)      # the server's own
        pairs = dict(struct.unpack(">HI", payload[i:i + 6])
                     for i in range(0, len(payload), 6))
        assert pairs[h2.SETTINGS_INITIAL_WINDOW_SIZE] == h2.LOCAL_WINDOW
        assert peer.frames_until(h2.SETTINGS, h2.ACK)[3] == b""
        peer.sock.sendall(h2.frame(h2.PING, 0, 0, b"12345678"))
        assert peer.frames_until(h2.PING, h2.ACK)[3] == b"12345678"
        block = hpack.encode([(":method", "POST"), (":path", "/a/B"),
                              ("x-long", "z" * 100)])
        first, rest = block[:10], block[10:]
        peer.sock.sendall(
            h2.frame(h2.PRIORITY, 0, 1, b"\0\0\0\0\x0f") +
            h2.frame(h2.HEADERS, h2.PADDED | h2.PRIORITY_FLAG, 1,
                     bytes([4]) + b"\0\0\0\0\x0f" + first + b"\0" * 4) +
            h2.frame(h2.CONTINUATION, h2.END_HEADERS, 1, rest) +
            h2.frame(h2.DATA, h2.PADDED | h2.END_STREAM, 1,
                     bytes([2]) + b"body" + b"\0\0"))
        assert peer.got.wait(10)
        st = peer.streams[0]
        assert st.headers[0] == [(":method", "POST"), (":path", "/a/B"),
                                 ("x-long", "z" * 100)]
        assert bytes(peer.conn.read_chunk(st)) == b"body"
        assert peer.conn.read_chunk(st) is None
    finally:
        peer.close()


def test_data_is_cut_to_the_frame_size_and_waits_on_windows():
    peer = RawPeer()
    try:
        peer.sock.sendall(h2.frame(h2.HEADERS, h2.END_HEADERS, 1,
                                   hpack.encode([(":path", "/x")])))
        assert peer.got.wait(10)
        st = peer.streams[0]
        body = os.urandom(200_000)
        sender = threading.Thread(target=peer.conn.send_data,
                                  args=(st, [body[:7], body[7:]], True))
        sender.start()
        got, sizes = b"", []
        while len(got) < 65_535:             # the default windows
            ftype, flags, sid, payload = peer.frames_until(h2.DATA)
            sizes.append(len(payload))
            got += payload
        assert len(got) == 65_535 and max(sizes) <= 16_384
        assert sender.is_alive()             # waiting on the windows
        peer.sock.sendall(h2.frame(h2.WINDOW_UPDATE, 0, 0,
                                   struct.pack(">I", 1 << 20)) +
                          h2.frame(h2.WINDOW_UPDATE, 0, 1,
                                   struct.pack(">I", 1 << 20)))
        end = False
        while not end:
            ftype, flags, sid, payload = peer.frames_until(h2.DATA)
            assert len(payload) <= 16_384
            got += payload
            end = bool(flags & h2.END_STREAM)
        sender.join(10)
        assert got == body
    finally:
        peer.close()


def test_rst_stream_and_goaway():
    peer = RawPeer()
    try:
        peer.sock.sendall(h2.frame(h2.HEADERS, h2.END_HEADERS, 1,
                                   hpack.encode([(":path", "/x")])))
        assert peer.got.wait(10)
        st = peer.streams[0]
        peer.sock.sendall(h2.frame(h2.RST_STREAM, 0, 1,
                                   struct.pack(">I", h2.CANCEL)))
        with pytest.raises(h2.StreamReset) as e:
            peer.conn.read_chunk(st)
        assert e.value.code == h2.CANCEL
        peer.sock.sendall(h2.frame(h2.GOAWAY, 0, 0,
                                   struct.pack(">II", 1, 0)))
        peer.sock.sendall(h2.frame(0xEE, 0, 0, b"an unknown frame type"))
        peer.sock.sendall(h2.frame(h2.PING, 0, 0, b"abcdefgh"))
        assert peer.frames_until(h2.PING, h2.ACK)[3] == b"abcdefgh"
        assert peer.conn.goaway == 1 and not peer.conn.usable
    finally:
        peer.close()


def _open(peer, sid, n):
    """Opens stream `sid` on the peer and waits for the server to see it
    (the n-th stream)."""
    peer.got.clear()
    peer.sock.sendall(h2.frame(h2.HEADERS, h2.END_HEADERS, sid,
                               hpack.encode([(":path", "/x")])))
    assert peer.got.wait(10) and len(peer.streams) == n
    return peer.streams[n - 1]


def _drain(peer, stop):
    """Reads and drops what the server sends until `stop` is set."""
    peer.sock.settimeout(0.2)
    while not stop.is_set():
        try:
            if not peer.sock.recv(1 << 16):
                return
        except socket.timeout:
            pass


@pytest.mark.parametrize("wait", ["data", "headers", "window"])
def test_a_wait_counts_seconds_not_frames_of_other_streams(monkeypatch,
                                                           wait):
    """A stream waits on its data, its trailers or a shut window while
    100 frames, each a wakeup, arrive on another stream of the same
    connection within TIMEOUT's 5 s; it ends when its own frame comes,
    not before."""
    monkeypatch.setattr(h2, "TIMEOUT", 5.0)
    peer = RawPeer()
    stop = threading.Event()
    drain = threading.Thread(target=_drain, args=(peer, stop))
    try:
        st = _open(peer, 1, 1)
        _open(peer, 3, 2)
        out = {}
        body = os.urandom(70_000)            # more than the default window

        def waiter():
            try:
                if wait == "data":
                    out["got"] = bytes(peer.conn.read_chunk(st))
                elif wait == "headers":
                    out["got"] = peer.conn.wait_headers(st, 2)
                else:
                    peer.conn.send_data(st, [body])
                    out["got"] = True
            except Exception as e:           # reported below
                out["error"] = e
        drain.start()
        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.3)
        for _ in range(100):                 # each frame wakes the waiter
            peer.sock.sendall(h2.frame(h2.DATA, 0, 3, b"n"))
            time.sleep(0.003)
        time.sleep(0.3)
        assert t.is_alive() and "error" not in out, out
        if wait == "data":
            peer.sock.sendall(h2.frame(h2.DATA, 0, 1, b"mine"))
        elif wait == "headers":
            peer.sock.sendall(h2.frame(h2.HEADERS,
                                       h2.END_HEADERS | h2.END_STREAM, 1,
                                       hpack.encode([("x-t", "1")])))
        else:
            peer.sock.sendall(h2.frame(h2.WINDOW_UPDATE, 0, 0,
                                       struct.pack(">I", 1 << 20)) +
                              h2.frame(h2.WINDOW_UPDATE, 0, 1,
                                       struct.pack(">I", 1 << 20)))
        t.join(10)
        assert "error" not in out, out
        assert out["got"] == {"data": b"mine", "headers": True,
                              "window": True}[wait]
    finally:
        stop.set()
        if drain.is_alive():
            drain.join(5)
        peer.close()


def test_a_wait_ends_after_timeout_seconds(monkeypatch):
    monkeypatch.setattr(h2, "TIMEOUT", 0.5)
    peer = RawPeer()
    try:
        st = _open(peer, 1, 1)
        t0 = time.monotonic()
        with pytest.raises(h2.ConnectionClosed, match="waited 0.5 s"):
            peer.conn.read_chunk(st)
        assert 0.5 <= time.monotonic() - t0 < 5
    finally:
        peer.close()
