"""HPACK, HTTP/2 header compression (RFC 7541), for the port's own
gRPC transport (flight/h2.py, flight/rpc.py).

The decoder reads every representation a peer may send: indexed fields,
literals with incremental indexing, without indexing and never indexed,
dynamic table size updates, and Huffman-coded strings (gRPC C-core
indexes into its dynamic table and Huffman-codes the base64 of `-bin`
metadata). The encoder is stateless: it sends an exact static-table
match as an index and everything else as a literal without indexing,
its strings raw, so it never needs the peer's table size.

The Huffman code of Appendix B is canonical (the codes of each length
are consecutive, in symbol order), so it is written here as its 257
code lengths and the codes are derived.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Header = Tuple[bytes, bytes]


class HPACKError(Exception):
    """A malformed header block (a COMPRESSION_ERROR of the connection)."""


# --------------------------------------------------------------------------
# the static table (Appendix A)
# --------------------------------------------------------------------------

STATIC_TABLE: List[Header] = [(n.encode(), v.encode()) for n, v in (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""))]
_STATIC_INDEX: Dict[Header, int] = {}
for _i, _h in enumerate(STATIC_TABLE):
    _STATIC_INDEX.setdefault(_h, _i + 1)

ENTRY_OVERHEAD = 32
DEFAULT_TABLE_SIZE = 4096


# --------------------------------------------------------------------------
# the Huffman code (Appendix B): code lengths of symbols 0..256 (EOS)
# --------------------------------------------------------------------------

HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30)
EOS = 256


def _canonical(lengths) -> List[int]:
    """The canonical codes of `lengths`: by (length, symbol), each code
    the previous one plus one, shifted left to its length."""
    codes = [0] * len(lengths)
    code, prev = -1, 0
    for s in sorted(range(len(lengths)), key=lambda s: (lengths[s], s)):
        code = (code + 1) << (lengths[s] - prev)
        prev = lengths[s]
        codes[s] = code
    return codes


HUFFMAN_CODES = _canonical(HUFFMAN_LENGTHS)

# decoding tables: for each length, its first code and its symbols
_FIRST: Dict[int, int] = {}
_SYMS: Dict[int, List[int]] = {}
for _s in sorted(range(257), key=lambda s: (HUFFMAN_LENGTHS[s], s)):
    _SYMS.setdefault(HUFFMAN_LENGTHS[_s], []).append(_s)
    _FIRST.setdefault(HUFFMAN_LENGTHS[_s], HUFFMAN_CODES[_s])
_MIN_LEN = min(HUFFMAN_LENGTHS)


def huffman_encode(data: bytes) -> bytes:
    """`data` in the Huffman code, padded with EOS's leading 1s (the
    tests' reference; the encoder sends raw strings)."""
    acc = nbits = 0
    for c in data:
        acc = (acc << HUFFMAN_LENGTHS[c]) | HUFFMAN_CODES[c]
        nbits += HUFFMAN_LENGTHS[c]
    pad = -nbits % 8
    acc = (acc << pad) | ((1 << pad) - 1)          # EOS's leading 1s
    return acc.to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = length = 0
    ones = True                     # the pending bits are all 1s
    for byte in data:
        for shift in range(7, -1, -1):
            bit = (byte >> shift) & 1
            code = (code << 1) | bit
            length += 1
            ones = ones and bit == 1
            if length < _MIN_LEN:
                continue
            first = _FIRST.get(length)
            if first is not None and 0 <= code - first < len(_SYMS[length]):
                sym = _SYMS[length][code - first]
                if sym == EOS:
                    raise HPACKError("EOS in a Huffman string")
                out.append(sym)
                code = length = 0
                ones = True
            elif length > 30:
                raise HPACKError("bad Huffman code")
    if length > 7 or not ones:
        raise HPACKError("bad Huffman padding")
    return bytes(out)


# --------------------------------------------------------------------------
# integers and strings (5.1, 5.2)
# --------------------------------------------------------------------------

def encode_int(value: int, prefix: int, flags: int = 0) -> bytes:
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([flags | value])
    out = bytearray([flags | limit])
    value -= limit
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(buf, pos: int, prefix: int) -> Tuple[int, int]:
    if pos >= len(buf):
        raise HPACKError("header block ends inside an integer")
    limit = (1 << prefix) - 1
    value = buf[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(buf):
            raise HPACKError("header block ends inside an integer")
        b = buf[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 62:
            raise HPACKError("integer too large")


def encode_str(data: bytes) -> bytes:
    """A raw string literal (the encoder sends no Huffman codes)."""
    return encode_int(len(data), 7) + data


def decode_str(buf, pos: int) -> Tuple[bytes, int]:
    if pos >= len(buf):
        raise HPACKError("header block ends before a string")
    huff = buf[pos] & 0x80
    n, pos = decode_int(buf, pos, 7)
    if pos + n > len(buf):
        raise HPACKError("header block ends inside a string")
    raw = bytes(buf[pos:pos + n])
    return (huffman_decode(raw) if huff else raw), pos + n


# --------------------------------------------------------------------------
# the dynamic table (2.3.2, 4)
# --------------------------------------------------------------------------

class DynamicTable:
    def __init__(self, max_size: int = DEFAULT_TABLE_SIZE):
        self.entries: List[Header] = []          # newest first
        self.size = 0
        self.max_size = max_size

    def _evict(self) -> None:
        while self.size > self.max_size:
            n, v = self.entries.pop()
            self.size -= len(n) + len(v) + ENTRY_OVERHEAD

    def add(self, header: Header) -> None:
        self.entries.insert(0, header)
        self.size += len(header[0]) + len(header[1]) + ENTRY_OVERHEAD
        self._evict()              # an entry larger than the table empties it

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict()

    def get(self, index: int) -> Header:
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        k = index - len(STATIC_TABLE) - 1
        if index < 1 or k >= len(self.entries):
            raise HPACKError(f"header index {index} out of range")
        return self.entries[k]


class Decoder:
    """One connection's header decoder; `settings_max` is the table size
    this side advertised (SETTINGS_HEADER_TABLE_SIZE)."""

    def __init__(self, settings_max: int = DEFAULT_TABLE_SIZE):
        self.table = DynamicTable(settings_max)
        self.settings_max = settings_max

    def decode(self, block) -> List[Header]:
        out: List[Header] = []
        pos, n = 0, len(block)
        while pos < n:
            b = block[pos]
            if b & 0x80:                                  # indexed
                idx, pos = decode_int(block, pos, 7)
                out.append(self.table.get(idx))
                continue
            if b & 0xE0 == 0x20:                          # size update
                size, pos = decode_int(block, pos, 5)
                if size > self.settings_max:
                    raise HPACKError(f"table size {size} over the limit")
                self.table.resize(size)
                continue
            indexing = b & 0xC0 == 0x40
            idx, pos = decode_int(block, pos, 6 if indexing else 4)
            if idx:
                name = self.table.get(idx)[0]
            else:
                name, pos = decode_str(block, pos)
            value, pos = decode_str(block, pos)
            out.append((name, value))
            if indexing:
                self.table.add((name, value))
        return out


def encode(headers) -> bytes:
    """A header block of (name, value) pairs (str or bytes): an exact
    static match as its index, else a literal without indexing (its name
    by static index where the table has it)."""
    out = bytearray()
    for name, value in headers:
        name = name.encode() if isinstance(name, str) else bytes(name)
        value = value.encode() if isinstance(value, str) else bytes(value)
        full = _STATIC_INDEX.get((name, value))
        if full is not None:
            out += encode_int(full, 7, 0x80)
            continue
        name_idx: Optional[int] = _STATIC_INDEX.get((name, b""))
        if name_idx is None:
            name_idx = next((i + 1 for i, (n, _) in enumerate(STATIC_TABLE)
                             if n == name), None)
        if name_idx is not None:
            out += encode_int(name_idx, 4)
        else:
            out += encode_int(0, 4) + encode_str(name)
        out += encode_str(value)
    return bytes(out)
