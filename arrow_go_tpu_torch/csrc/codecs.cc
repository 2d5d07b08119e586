// Host codecs of the port's parquet path, built with g++ into a shared
// library with a plain C interface (arrow_go_tpu_torch/native.py loads it
// with ctypes).
//
// The port's own copy of the snappy and LZ4 raw block codecs of
// arrow_go_tpu/native/codecs.cc (formats from their public
// specifications: snappy format_description.txt, lz4_Block_format.md),
// with copies done by memcpy where source and destination cannot
// overlap; plus the header walks of the RLE/bit-packed hybrid and of
// DELTA_BINARY_PACKED streams, which are sequential (each run's or
// block's place depends on the ones before it) and so are walked here
// rather than one Python step per run or miniblock.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

inline size_t put_varint(uint8_t* dst, uint64_t v) {
    size_t n = 0;
    while (v >= 0x80) { dst[n++] = (uint8_t)(v | 0x80); v >>= 7; }
    dst[n++] = (uint8_t)v;
    return n;
}

// Reads a ULEB128 varint of at most 10 bytes; returns the bytes used, or
// 0 when the stream ends first.
inline size_t get_varint(const uint8_t* src, size_t len, uint64_t* v) {
    uint64_t out = 0;
    int shift = 0;
    size_t n = 0;
    while (n < len && n < 10) {
        uint8_t b = src[n++];
        out |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *v = out; return n; }
        shift += 7;
    }
    return 0;
}

// A back-reference copy of len bytes from off bytes behind dst: memcpy
// when the two ranges do not overlap, else byte by byte (a repeat).
inline void copy_match(uint8_t* dst, size_t off, size_t len) {
    const uint8_t* from = dst - off;
    if (off >= len) {
        memcpy(dst, from, len);
    } else {
        for (size_t k = 0; k < len; k++) dst[k] = from[k];
    }
}

}  // namespace

extern "C" {

// --------------------------------------------------------------------------
// Snappy
// --------------------------------------------------------------------------

size_t agt_snappy_max_compressed_length(size_t n) { return 32 + n + n / 6; }

// Greedy hash-table compressor over 64 KB blocks. Returns the compressed
// length, or -1 when dst_cap is too small.
int64_t agt_snappy_compress(const uint8_t* src, size_t n, uint8_t* dst,
                            size_t dst_cap) {
    if (dst_cap < 16) return -1;
    size_t d = put_varint(dst, n);
    const size_t kBlock = 1 << 16;
    static thread_local uint16_t table[1 << 14];

    for (size_t block = 0; block < n; block += kBlock) {
        size_t blen = n - block < kBlock ? n - block : kBlock;
        const uint8_t* b = src + block;
        memset(table, 0, sizeof(table));
        size_t i = 0, lit_start = 0;

        auto emit_literal = [&](size_t from, size_t count) -> bool {
            while (count > 0) {
                size_t c = count > 65536 ? 65536 : count;
                if (c < 60) {
                    if (d + 1 + c > dst_cap) return false;
                    dst[d++] = (uint8_t)((c - 1) << 2);
                } else if (c - 1 < 256) {
                    if (d + 2 + c > dst_cap) return false;
                    dst[d++] = (60 << 2);
                    dst[d++] = (uint8_t)(c - 1);
                } else {
                    if (d + 3 + c > dst_cap) return false;
                    dst[d++] = (61 << 2);
                    dst[d++] = (uint8_t)((c - 1) & 0xFF);
                    dst[d++] = (uint8_t)(((c - 1) >> 8) & 0xFF);
                }
                memcpy(dst + d, b + from, c);
                d += c;
                from += c;
                count -= c;
            }
            return true;
        };

        if (blen >= 8) {
            while (i + 4 <= blen) {
                uint32_t h;
                memcpy(&h, b + i, 4);
                uint32_t slot = (h * 0x1e35a7bdU) >> 18;
                size_t cand = table[slot];
                table[slot] = (uint16_t)i;
                uint32_t ch;
                if (cand < i) { memcpy(&ch, b + cand, 4); } else { ch = ~h; }
                if (ch == h && i - cand <= 65535) {
                    size_t mlen = 4;
                    while (i + mlen < blen && b[cand + mlen] == b[i + mlen] &&
                           mlen < 64)
                        mlen++;
                    if (!emit_literal(lit_start, i - lit_start)) return -1;
                    size_t off = i - cand;
                    if (mlen <= 11 && off < 2048) {
                        if (d + 2 > dst_cap) return -1;
                        dst[d++] = (uint8_t)(1 | ((mlen - 4) << 2) |
                                             ((off >> 8) << 5));
                        dst[d++] = (uint8_t)(off & 0xFF);
                    } else {
                        if (d + 3 > dst_cap) return -1;
                        dst[d++] = (uint8_t)(2 | ((mlen - 1) << 2));
                        dst[d++] = (uint8_t)(off & 0xFF);
                        dst[d++] = (uint8_t)(off >> 8);
                    }
                    i += mlen;
                    lit_start = i;
                } else {
                    i++;
                }
            }
        }
        if (!emit_literal(lit_start, blen - lit_start)) return -1;
    }
    return (int64_t)d;
}

// The uncompressed length from the stream's preamble, or -1.
int64_t agt_snappy_uncompressed_length(const uint8_t* src, size_t n) {
    uint64_t v;
    if (!get_varint(src, n, &v)) return -1;
    return (int64_t)v;
}

// Returns the decompressed length, or -1 on a malformed stream or one
// that does not fit dst_cap.
int64_t agt_snappy_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                              size_t dst_cap) {
    uint64_t ulen;
    size_t s = get_varint(src, n, &ulen);
    if (!s || ulen > dst_cap) return -1;
    size_t d = 0;
    while (s < n) {
        uint8_t tag = src[s++];
        uint32_t kind = tag & 3;
        if (kind == 0) {  // literal
            size_t len = (tag >> 2) + 1;
            if (len > 60) {
                size_t extra = len - 60;  // 1..4 length bytes
                if (s + extra > n) return -1;
                len = 0;
                for (size_t k = 0; k < extra; k++)
                    len |= (size_t)src[s + k] << (8 * k);
                len += 1;
                s += extra;
            }
            if (s + len > n || d + len > ulen) return -1;
            memcpy(dst + d, src + s, len);
            s += len;
            d += len;
            continue;
        }
        size_t len, off;
        if (kind == 1) {
            if (s >= n) return -1;
            len = ((tag >> 2) & 7) + 4;
            off = ((size_t)(tag >> 5) << 8) | src[s++];
        } else if (kind == 2) {
            if (s + 2 > n) return -1;
            len = (tag >> 2) + 1;
            off = (size_t)src[s] | ((size_t)src[s + 1] << 8);
            s += 2;
        } else {
            if (s + 4 > n) return -1;
            len = (tag >> 2) + 1;
            off = (size_t)src[s] | ((size_t)src[s + 1] << 8) |
                  ((size_t)src[s + 2] << 16) | ((size_t)src[s + 3] << 24);
            s += 4;
        }
        if (off == 0 || off > d || d + len > ulen) return -1;
        copy_match(dst + d, off, len);
        d += len;
    }
    return d == ulen ? (int64_t)d : -1;
}

// --------------------------------------------------------------------------
// LZ4 raw block
// --------------------------------------------------------------------------

size_t agt_lz4_max_compressed_length(size_t n) { return n + n / 255 + 32; }

// Greedy matcher; the last 5 bytes are literals and matches end 12 bytes
// before the block's end, as the block format requires. Returns the
// compressed length, or -1 when dst_cap is too small.
int64_t agt_lz4_compress(const uint8_t* src, size_t n, uint8_t* dst,
                         size_t dst_cap) {
    static thread_local int32_t table[1 << 14];
    memset(table, -1, sizeof(table));
    size_t s = 0, d = 0, anchor = 0;

    auto emit = [&](size_t lit_from, size_t lit_n, size_t off,
                    size_t mlen) -> bool {
        size_t ml = mlen ? mlen - 4 : 0;
        uint8_t token = (uint8_t)(((lit_n >= 15 ? 15 : lit_n) << 4) |
                                  (mlen ? (ml >= 15 ? 15 : ml) : 0));
        if (d + 1 > dst_cap) return false;
        dst[d++] = token;
        if (lit_n >= 15) {
            size_t rest = lit_n - 15;
            while (true) {
                if (d >= dst_cap) return false;
                if (rest >= 255) { dst[d++] = 255; rest -= 255; }
                else { dst[d++] = (uint8_t)rest; break; }
            }
        }
        if (d + lit_n > dst_cap) return false;
        memcpy(dst + d, src + lit_from, lit_n);
        d += lit_n;
        if (mlen) {
            if (d + 2 > dst_cap) return false;
            dst[d++] = (uint8_t)(off & 0xFF);
            dst[d++] = (uint8_t)(off >> 8);
            if (ml >= 15) {
                size_t rest = ml - 15;
                while (true) {
                    if (d >= dst_cap) return false;
                    if (rest >= 255) { dst[d++] = 255; rest -= 255; }
                    else { dst[d++] = (uint8_t)rest; break; }
                }
            }
        }
        return true;
    };

    if (n >= 13) {
        size_t limit = n - 12;
        while (s < limit) {
            uint32_t h;
            memcpy(&h, src + s, 4);
            uint32_t slot = (h * 0x9E3779B1U) >> 18;
            int64_t cand = table[slot];
            table[slot] = (int32_t)s;
            uint32_t ch = 0;
            bool ok = cand >= 0 && s - (size_t)cand <= 65535;
            if (ok) memcpy(&ch, src + cand, 4);
            if (ok && ch == h) {
                size_t mlen = 4;
                while (s + mlen < limit && src[cand + mlen] == src[s + mlen])
                    mlen++;
                if (!emit(anchor, s - anchor, s - (size_t)cand, mlen))
                    return -1;
                s += mlen;
                anchor = s;
            } else {
                s++;
            }
        }
    }
    if (!emit(anchor, n - anchor, 0, 0)) return -1;
    return (int64_t)d;
}

// Returns the decompressed length, or -1 on a malformed stream or one
// that does not fit dst_cap.
int64_t agt_lz4_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                           size_t dst_cap) {
    size_t s = 0, d = 0;
    while (s < n) {
        uint8_t token = src[s++];
        size_t lit = token >> 4;
        if (lit == 15) {
            while (s < n) {
                uint8_t b = src[s++];
                lit += b;
                if (b != 255) break;
            }
        }
        if (s + lit > n || d + lit > dst_cap) return -1;
        memcpy(dst + d, src + s, lit);
        s += lit;
        d += lit;
        if (s >= n) break;  // the last sequence has no match
        if (s + 2 > n) return -1;
        size_t off = (size_t)src[s] | ((size_t)src[s + 1] << 8);
        s += 2;
        size_t mlen = token & 0x0F;
        if (mlen == 15) {
            while (s < n) {
                uint8_t b = src[s++];
                mlen += b;
                if (b != 255) break;
            }
        }
        mlen += 4;
        if (off == 0 || off > d || d + mlen > dst_cap) return -1;
        copy_match(dst + d, off, mlen);
        d += mlen;
    }
    return (int64_t)d;
}

// --------------------------------------------------------------------------
// RLE / bit-packed hybrid header walk
// --------------------------------------------------------------------------

// Walks the run headers of an RLE/bit-packed hybrid stream until n values
// are covered or the stream ends, and writes one row per run: its first
// output index, 1 for an RLE run (else 0), and for an RLE run its value,
// for a bit-packed run the bit offset of its first value in `packed`,
// into which the packed bodies are copied back to back. Returns the
// number of rows (`*packed_len` gets the bytes copied), or -1 when a run
// header runs past the stream or a row would pass cap. With starts ==
// NULL nothing is written but `*packed_len`: a first walk that sizes the
// tables and the buffer of the second.
int64_t agt_rle_parse(const uint8_t* src, size_t len, int64_t n,
                      int32_t bit_width, int64_t cap, int64_t* starts,
                      uint32_t* is_run, int64_t* payload, uint8_t* packed,
                      int64_t* packed_len) {
    const size_t nbytes = ((size_t)bit_width + 7) / 8;
    const bool write = starts != nullptr;
    int64_t got = 0, rows = 0;
    size_t pos = 0, o = 0;
    while (got < n && pos < len) {
        uint64_t header;
        size_t used = get_varint(src + pos, len - pos, &header);
        if (!used || (write && rows >= cap)) return -1;
        pos += used;
        if (write) starts[rows] = got;
        if (header & 1) {  // bit-packed groups of 8 values
            int64_t count = (int64_t)(header >> 1) * 8;
            size_t need = ((size_t)count * bit_width + 7) / 8;
            size_t take = need < len - pos ? need : len - pos;
            if (write) {
                is_run[rows] = 0;
                payload[rows] = (int64_t)o * 8;
                memcpy(packed + o, src + pos, take);
            }
            o += take;
            pos += need;
            got = got + count < n ? got + count : n;
        } else {           // RLE run: one little-endian value
            int64_t count = (int64_t)(header >> 1);
            if (write) {
                uint64_t v = 0;
                for (size_t k = 0; k < nbytes && pos + k < len; k++)
                    v |= (uint64_t)src[pos + k] << (8 * k);
                is_run[rows] = 1;
                payload[rows] = (int64_t)v;
            }
            pos += nbytes;
            got += count < n - got ? count : n - got;
        }
        rows++;
    }
    *packed_len = (int64_t)o;
    return rows;
}

// --------------------------------------------------------------------------
// DELTA_BINARY_PACKED header walk
// --------------------------------------------------------------------------

// From `pos` (just past the stream's four header varints), walks blocks
// of <zigzag min delta><miniblocks width bytes><packed miniblocks> until
// total - 1 deltas are covered, and writes one row per miniblock that
// holds deltas: the index of its first delta, the bit offset of its
// packed values in src, its bit width and its block's min delta. Returns
// the number of rows; -1 when the stream ends early or a row would pass
// cap; -2 when a width passes 32 (`*bad_width` gets it).
int64_t agt_delta_parse(const uint8_t* src, size_t n, size_t pos,
                        int64_t total, int64_t values_per_miniblock,
                        int64_t miniblocks, int64_t cap, int64_t* starts,
                        int64_t* bit0, int32_t* width, int64_t* min_delta,
                        int32_t* bad_width) {
    int64_t got = 1;  // the first value is in the header
    int64_t rows = 0;
    while (got < total) {
        uint64_t z;
        size_t used = get_varint(src + pos, n - pos, &z);
        if (!used) return -1;
        pos += used;
        int64_t mn = (int64_t)(z >> 1) ^ -(int64_t)(z & 1);
        if (pos + (size_t)miniblocks > n) return -1;
        const uint8_t* widths = src + pos;
        pos += (size_t)miniblocks;
        for (int64_t m = 0; m < miniblocks && got < total; m++) {
            int32_t w = widths[m];
            if (w > 32) { *bad_width = w; return -2; }
            size_t nbytes = ((size_t)values_per_miniblock * w + 7) / 8;
            if (rows >= cap || pos + nbytes > n) return -1;
            starts[rows] = got - 1;
            bit0[rows] = (int64_t)pos * 8;
            width[rows] = w;
            min_delta[rows] = mn;
            rows++;
            pos += nbytes;
            got += values_per_miniblock;
        }
    }
    return rows;
}

}  // extern "C"
