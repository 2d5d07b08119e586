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
// rather than one Python step per run or miniblock; XXH64 (the hash of
// parquet bloom filters and of zstd's content checksum), a zstd
// decoder and encoder (RFC 8878) and the byte-array walks of PLAIN,
// DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY pages with a
// first-occurrence memo table over their values.
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

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

// Decodes one LZ4 block into out[start..cap), its matches reaching back
// as far as out[floor] (floor = start for an independent block, 0 for a
// block linked to the output before it, as the LZ4 frame format allows).
// Returns the end of its output, or -1 on a malformed block or one that
// does not fit.
int64_t lz4_block_decode(const uint8_t* src, size_t n, uint8_t* out,
                         size_t floor, size_t start, size_t cap) {
    size_t s = 0, d = start;
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
        if (s + lit > n || d + lit > cap) return -1;
        memcpy(out + d, src + s, lit);
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
        if (off == 0 || off > d - floor || d + mlen > cap) return -1;
        copy_match(out + d, off, mlen);
        d += mlen;
    }
    return (int64_t)d;
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
    return lz4_block_decode(src, n, dst, 0, 0, dst_cap);
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
// cap; -2 when a width passes 64, which no stream of 64-bit deltas has
// (`*bad_width` gets it). Every width from 0 to 64 is walked.
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
            if (w > 64) { *bad_width = w; return -2; }
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

// --------------------------------------------------------------------------
// XXH64 (seed given; the parquet bloom filter and zstd use seed 0)
// --------------------------------------------------------------------------

namespace {

const uint64_t kP1 = 11400714785074694791ULL;
const uint64_t kP2 = 14029467366897019727ULL;
const uint64_t kP3 = 1609587929392839161ULL;
const uint64_t kP4 = 9650029242287828579ULL;
const uint64_t kP5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
    acc += input * kP2;
    acc = rotl64(acc, 31);
    return acc * kP1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
    acc ^= xxh_round(0, v);
    return acc * kP1 + kP4;
}

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed,
                 v4 = seed - kP1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xxh_round(v1, load64(p));
            v2 = xxh_round(v2, load64(p + 8));
            v3 = xxh_round(v3, load64(p + 16));
            v4 = xxh_round(v4, load64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = seed + kP5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= xxh_round(0, load64(p));
        h = rotl64(h, 27) * kP1 + kP4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)load32(p) * kP1;
        h = rotl64(h, 23) * kP2 + kP3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p) * kP5;
        h = rotl64(h, 11) * kP1;
        p++;
    }
    h ^= h >> 33;
    h *= kP2;
    h ^= h >> 29;
    h *= kP3;
    h ^= h >> 32;
    return h;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

// Bits [lo, lo + nb) of the little-endian bit string s[0, len), nb <= 57;
// bits below 0 or past the end read as 0.
inline uint64_t bits_at(const uint8_t* s, size_t len, int64_t lo, int nb) {
    if (nb == 0) return 0;
    if (lo < 0) {
        if (lo + nb <= 0) return 0;
        return bits_at(s, len, 0, (int)(lo + nb)) << (-lo);
    }
    size_t byte = (size_t)(lo >> 3);
    uint64_t w = 0;
    if (byte + 8 <= len) {
        memcpy(&w, s + byte, 8);
    } else {
        for (size_t k = 0; k < 8 && byte + k < len; k++)
            w |= (uint64_t)s[byte + k] << (8 * k);
    }
    w >>= (lo & 7);
    return w & ((1ULL << nb) - 1);
}

// --------------------------------------------------------------------------
// zstd (RFC 8878): decoder
// --------------------------------------------------------------------------

enum { kCorrupt = -1, kDictionary = -2, kTooSmall = -3 };

struct Fail {
    int code;
};

[[noreturn]] inline void fail(int code = kCorrupt) { throw Fail{code}; }

inline void need(bool ok) {
    if (!ok) fail();
}

const size_t kBlockMax = 128 * 1024;
const uint32_t kMagic = 0xFD2FB528U;

// A bitstream read backwards from its last byte's highest set bit: bits
// [0, pos) remain unread; a read takes the top `nb` of them.
struct BackReader {
    const uint8_t* s = nullptr;
    size_t len = 0;
    int64_t pos = 0;

    void init(const uint8_t* src, size_t n) {
        need(n > 0 && src[n - 1] != 0);
        s = src;
        len = n;
        pos = (int64_t)(n - 1) * 8 + highbit32(src[n - 1]);
    }
    uint64_t peek(int nb) const { return bits_at(s, len, pos - nb, nb); }
    uint64_t read(int nb) {
        pos -= nb;
        return bits_at(s, len, pos, nb);
    }
};

struct FseEntry {
    uint16_t base;    // the next state, before the bits read are added
    uint8_t symbol;
    uint8_t nbits;
};

struct FseTable {
    int log = 0;
    std::vector<FseEntry> t;
};

// The decoding table of normalized counts norm[0..nsym) at accuracy log
// `log` (RFC 8878 4.1.1): "less than 1" symbols at the top, the others
// spread by the fixed step, then each state's bits and next-state base.
void fse_build(FseTable& T, const int16_t* norm, int nsym, int log) {
    const uint32_t size = 1u << log;
    T.log = log;
    T.t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(nsym);
    int64_t high = (int64_t)size - 1;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            need(high >= 0);
            T.t[high--].symbol = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint32_t)norm[s];
        }
    }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t position = 0;
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            T.t[position].symbol = (uint8_t)s;
            do {
                position = (position + step) & mask;
            } while ((int64_t)position > high);
        }
    }
    need(position == 0);
    for (uint32_t u = 0; u < size; u++) {
        const uint8_t s = T.t[u].symbol;
        const uint32_t ns = next[s]++;
        const int nb = log - highbit32(ns);
        T.t[u].nbits = (uint8_t)nb;
        T.t[u].base = (uint16_t)((ns << nb) - size);
    }
}

// Reads an FSE table description (normalized counts) from src[0, n):
// returns the bytes it used; `*nsym` gets the symbols described.
size_t fse_read_counts(const uint8_t* src, size_t n, int16_t* norm,
                       int max_sym, int max_log, int* nsym, int* log) {
    need(n > 0);
    int64_t bit = 0;
    auto get = [&](int nb) { return (uint32_t)bits_at(src, n, bit, nb); };
    const int al = (int)get(4) + 5;
    bit += 4;
    need(al <= max_log);
    int32_t remaining = (1 << al) + 1;
    int32_t threshold = 1 << al;
    int nbits = al + 1;
    int s = 0;
    bool prev0 = false;
    while (remaining > 1) {
        if (prev0) {
            // runs of zero-probability symbols: 2-bit repeat flags
            int zeros = 0;
            for (;;) {
                const uint32_t r = get(2);
                bit += 2;
                zeros += (int)r;
                if (r != 3) break;
                need(bit <= (int64_t)n * 8);
            }
            need(s + zeros <= max_sym + 1);
            for (int k = 0; k < zeros; k++) norm[s++] = 0;
        }
        need(s <= max_sym && bit <= (int64_t)n * 8);
        const int32_t max = (2 * threshold - 1) - remaining;
        int32_t count;
        const uint32_t v = get(nbits);
        if ((int32_t)(v & (threshold - 1)) < max) {
            count = (int32_t)(v & (threshold - 1));
            bit += nbits - 1;
        } else {
            count = (int32_t)(v & (2 * threshold - 1));
            if (count >= threshold) count -= max;
            bit += nbits;
        }
        count--;
        remaining -= count < 0 ? -count : count;
        norm[s++] = (int16_t)count;
        prev0 = count == 0;
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
    }
    need(remaining == 1 && bit <= (int64_t)n * 8);
    *nsym = s;
    *log = al;
    return (size_t)((bit + 7) >> 3);
}

struct Huffman {
    int max_bits = 0;
    std::vector<uint16_t> t;   // symbol | nbits << 8, by the next max_bits
};

// The Huffman decoding table of `nw` weights (the last symbol's implied).
void huffman_build(Huffman& H, const uint8_t* w, int nw) {
    need(nw >= 1 && nw <= 255);
    uint32_t sum = 0;
    for (int i = 0; i < nw; i++) {
        need(w[i] <= 11);
        if (w[i]) sum += 1u << (w[i] - 1);
    }
    need(sum > 0);
    const int max_bits = highbit32(sum) + 1;
    need(max_bits <= 11);
    const uint32_t rest = (1u << max_bits) - sum;
    need(rest > 0 && (rest & (rest - 1)) == 0);
    uint8_t weights[256];
    memcpy(weights, w, nw);
    weights[nw] = (uint8_t)(highbit32(rest) + 1);
    const int nsym = nw + 1;
    H.max_bits = max_bits;
    H.t.assign(1u << max_bits, 0);
    uint32_t pos = 0;
    for (int wt = 1; wt <= max_bits; wt++) {
        const uint32_t span = 1u << (wt - 1);
        const uint16_t entry = (uint16_t)((max_bits + 1 - wt) << 8);
        for (int s = 0; s < nsym; s++) {
            if (weights[s] != wt) continue;
            need(pos + span <= H.t.size());
            for (uint32_t k = 0; k < span; k++) H.t[pos + k] = entry | s;
            pos += span;
        }
    }
    need(pos == H.t.size());
}

// The Huffman tree description at src[0, n): returns the bytes used.
size_t huffman_read(Huffman& H, const uint8_t* src, size_t n) {
    need(n >= 1);
    const uint8_t head = src[0];
    uint8_t w[256];
    int nw = 0;
    if (head >= 128) {
        nw = head - 127;
        const size_t bytes = (size_t)(nw + 1) / 2;
        need(1 + bytes <= n);
        for (int i = 0; i < nw; i++)
            w[i] = i % 2 == 0 ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15;
        huffman_build(H, w, nw);
        return 1 + bytes;
    }
    // FSE-compressed weights: two interleaved states over one stream
    const size_t csize = head;
    need(csize > 0 && 1 + csize <= n);
    const uint8_t* p = src + 1;
    int16_t norm[256];
    int nsym, log;
    const size_t used = fse_read_counts(p, csize, norm, 255, 6, &nsym, &log);
    need(used < csize);
    FseTable T;
    fse_build(T, norm, nsym, log);
    BackReader br;
    br.init(p + used, csize - used);
    uint32_t s1 = (uint32_t)br.read(log), s2 = (uint32_t)br.read(log);
    need(br.pos >= 0);
    for (;;) {
        need(nw < 255);
        w[nw++] = T.t[s1].symbol;
        s1 = T.t[s1].base + (uint32_t)br.read(T.t[s1].nbits);
        if (br.pos < 0) {
            need(nw < 255);
            w[nw++] = T.t[s2].symbol;
            break;
        }
        need(nw < 255);
        w[nw++] = T.t[s2].symbol;
        s2 = T.t[s2].base + (uint32_t)br.read(T.t[s2].nbits);
        if (br.pos < 0) {
            need(nw < 255);
            w[nw++] = T.t[s1].symbol;
            break;
        }
    }
    huffman_build(H, w, nw);
    return 1 + csize;
}

void huffman_stream(const Huffman& H, const uint8_t* src, size_t n,
                    uint8_t* out, size_t count) {
    BackReader br;
    br.init(src, n);
    const int mb = H.max_bits;
    for (size_t i = 0; i < count; i++) {
        const uint16_t e = H.t[br.peek(mb)];
        out[i] = (uint8_t)e;
        br.pos -= e >> 8;
    }
    need(br.pos == 0);
}

// RFC 8878 3.1.1.3.2.1: predefined distributions and code tables
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1,
                                -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,
                              10, 11, 12, 13, 14, 15, 16, 18, 20, 22,
                              24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Predefined {
    FseTable ll, ml, of;
    Predefined() {
        fse_build(ll, kLLDefault, 36, 6);
        fse_build(ml, kMLDefault, 53, 6);
        fse_build(of, kOFDefault, 29, 5);
    }
};

const Predefined& predefined() {
    static const Predefined p;
    return p;
}

// Tables that a later block of the same frame may repeat.
struct FrameState {
    FseTable ll, ml, of;
    bool have_ll = false, have_ml = false, have_of = false;
    Huffman huf;
    bool have_huf = false;
    uint64_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lits;
};

// One sequence table by its mode (0 predefined, 1 RLE, 2 FSE, 3 repeat);
// returns the bytes of src it used.
size_t sequence_table(FseTable& T, bool& have, int mode, const uint8_t* src,
                      size_t n, const FseTable& def, int max_sym,
                      int max_log) {
    switch (mode) {
        case 0:
            T = def;
            have = true;
            return 0;
        case 1:
            need(n >= 1 && src[0] <= max_sym);
            T.log = 0;
            T.t.assign(1, FseEntry{0, src[0], 0});
            have = true;
            return 1;
        case 2: {
            int16_t norm[64];
            int nsym, log;
            const size_t used =
                fse_read_counts(src, n, norm, max_sym, max_log, &nsym, &log);
            fse_build(T, norm, nsym, log);
            have = true;
            return used;
        }
        default:
            need(have);
            return 0;
    }
}

// The literals section of a compressed block at src[0, n): sets
// `*lits`/`*nlits` and returns the section's bytes.
size_t read_literals(FrameState& F, const uint8_t* src, size_t n,
                     const uint8_t** lits, size_t* nlits) {
    need(n >= 1);
    const int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
    if (type < 2) {     // raw or RLE
        size_t hsize, regen;
        if (fmt == 0 || fmt == 2) {
            hsize = 1;
            regen = src[0] >> 3;
        } else if (fmt == 1) {
            need(n >= 2);
            hsize = 2;
            regen = (src[0] >> 4) | ((size_t)src[1] << 4);
        } else {
            need(n >= 3);
            hsize = 3;
            regen = (src[0] >> 4) | ((size_t)src[1] << 4) |
                    ((size_t)src[2] << 12);
        }
        need(regen <= kBlockMax);
        *nlits = regen;
        if (type == 0) {
            need(hsize + regen <= n);
            *lits = src + hsize;
            return hsize + regen;
        }
        need(hsize + 1 <= n);
        F.lits.assign(regen, src[hsize]);
        *lits = F.lits.data();
        return hsize + 1;
    }
    // Huffman-coded (type 2) or treeless (type 3, the frame's last table)
    size_t hsize, regen, csize;
    int streams = fmt == 0 ? 1 : 4;
    if (fmt < 2) {
        need(n >= 3);
        const uint32_t h = src[0] | (src[1] << 8) | (src[2] << 16);
        hsize = 3;
        regen = (h >> 4) & 0x3FF;
        csize = (h >> 14) & 0x3FF;
    } else if (fmt == 2) {
        need(n >= 4);
        const uint32_t h = load32(src);
        hsize = 4;
        regen = (h >> 4) & 0x3FFF;
        csize = (h >> 18) & 0x3FFF;
    } else {
        need(n >= 5);
        const uint64_t h = (uint64_t)load32(src) | ((uint64_t)src[4] << 32);
        hsize = 5;
        regen = (h >> 4) & 0x3FFFF;
        csize = (h >> 22) & 0x3FFFF;
    }
    need(regen <= kBlockMax && hsize + csize <= n);
    const uint8_t* p = src + hsize;
    size_t left = csize;
    if (type == 2) {
        const size_t used = huffman_read(F.huf, p, left);
        F.have_huf = true;
        p += used;
        left -= used;
    } else {
        need(F.have_huf);
    }
    F.lits.resize(regen);
    uint8_t* out = F.lits.data();
    if (streams == 1) {
        huffman_stream(F.huf, p, left, out, regen);
    } else {
        need(left >= 10);
        const size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
                     s3 = p[4] | (p[5] << 8);
        need(6 + s1 + s2 + s3 < left);
        const size_t s4 = left - 6 - s1 - s2 - s3;
        const size_t seg = (regen + 3) / 4;
        need(3 * seg <= regen);
        const uint8_t* q = p + 6;
        huffman_stream(F.huf, q, s1, out, seg);
        huffman_stream(F.huf, q + s1, s2, out + seg, seg);
        huffman_stream(F.huf, q + s1 + s2, s3, out + 2 * seg, seg);
        huffman_stream(F.huf, q + s1 + s2 + s3, s4, out + 3 * seg,
                       regen - 3 * seg);
    }
    *lits = out;
    *nlits = regen;
    return hsize + csize;
}

// A compressed block at src[0, n) decoded to dst + *op (frame output
// from dst + fstart); advances *op.
void decode_block(FrameState& F, const uint8_t* src, size_t n, uint8_t* dst,
                  size_t cap, size_t fstart, size_t* op) {
    const uint8_t* lits;
    size_t nlits;
    size_t pos = read_literals(F, src, n, &lits, &nlits);
    need(pos < n);
    size_t nseq = src[pos++];
    if (nseq >= 128) {
        if (nseq < 255) {
            need(pos < n);
            nseq = ((nseq - 128) << 8) + src[pos++];
        } else {
            need(pos + 2 <= n);
            nseq = src[pos] + ((size_t)src[pos + 1] << 8) + 0x7F00;
            pos += 2;
        }
    }
    size_t o = *op;
    const size_t block_end_max = o + kBlockMax;
    if (nseq == 0) {
        need(pos == n);
        if (o + nlits > cap) fail(kTooSmall);
        memcpy(dst + o, lits, nlits);
        *op = o + nlits;
        return;
    }
    need(pos < n);
    const uint8_t modes = src[pos++];
    need((modes & 3) == 0);
    const Predefined& def = predefined();
    pos += sequence_table(F.ll, F.have_ll, modes >> 6, src + pos, n - pos,
                          def.ll, 35, 9);
    need(pos <= n);
    pos += sequence_table(F.of, F.have_of, (modes >> 4) & 3, src + pos,
                          n - pos, def.of, 31, 8);
    need(pos <= n);
    pos += sequence_table(F.ml, F.have_ml, (modes >> 2) & 3, src + pos,
                          n - pos, def.ml, 52, 9);
    need(pos < n);
    BackReader br;
    br.init(src + pos, n - pos);
    uint32_t sl = (uint32_t)br.read(F.ll.log);
    uint32_t so = (uint32_t)br.read(F.of.log);
    uint32_t sm = (uint32_t)br.read(F.ml.log);
    size_t lp = 0;
    uint64_t* rep = F.rep;
    for (size_t i = 0; i < nseq; i++) {
        const FseEntry& eo = F.of.t[so];
        const FseEntry& em = F.ml.t[sm];
        const FseEntry& el = F.ll.t[sl];
        const int ofc = eo.symbol;
        need(ofc <= 31);
        const uint64_t ofv = (1ULL << ofc) + br.read(ofc);
        const size_t ml = kMLBase[em.symbol] + br.read(kMLBits[em.symbol]);
        const size_t ll = kLLBase[el.symbol] + br.read(kLLBits[el.symbol]);
        uint64_t off;
        if (ofv > 3) {
            off = ofv - 3;
            rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = off;
        } else {
            const uint64_t idx = ofv + (ll == 0 ? 1 : 0);   // 1..4
            if (idx == 1) {
                off = rep[0];
            } else if (idx == 2) {
                off = rep[1];
                rep[1] = rep[0];
                rep[0] = off;
            } else {
                off = idx == 3 ? rep[2] : rep[0] - 1;
                need(off != 0);
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = off;
            }
        }
        if (i + 1 < nseq) {
            sl = el.base + (uint32_t)br.read(el.nbits);
            sm = em.base + (uint32_t)br.read(em.nbits);
            so = eo.base + (uint32_t)br.read(eo.nbits);
        }
        need(br.pos >= 0);
        need(lp + ll <= nlits);
        if (o + ll + ml > cap) fail(kTooSmall);
        need(o + ll + ml <= block_end_max);
        memcpy(dst + o, lits + lp, ll);
        lp += ll;
        o += ll;
        need(off <= o - fstart);
        copy_match(dst + o, (size_t)off, ml);
        o += ml;
    }
    need(br.pos == 0);
    const size_t rest = nlits - lp;
    if (o + rest > cap) fail(kTooSmall);
    need(o + rest <= block_end_max);
    memcpy(dst + o, lits + lp, rest);
    *op = o + rest;
}

// One zstd frame (magic already checked) at src[s..n); returns the
// position after it.
size_t decode_frame(const uint8_t* src, size_t n, size_t s, uint8_t* dst,
                    size_t cap, size_t* op) {
    need(s < n);
    const uint8_t fhd = src[s++];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
              checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    need((fhd & 8) == 0);
    if (!single) {
        need(s < n);
        s++;   // window descriptor: every match is checked against the frame
    }
    const int did_bytes = did_flag == 3 ? 4 : did_flag;
    need(s + did_bytes <= n);
    uint64_t did = 0;
    for (int k = 0; k < did_bytes; k++) did |= (uint64_t)src[s + k] << (8 * k);
    s += did_bytes;
    if (did != 0) fail(kDictionary);
    const int fcs_bytes = fcs_flag == 0 ? single : 1 << fcs_flag;
    need(s + fcs_bytes <= n);
    uint64_t fcs = 0;
    for (int k = 0; k < fcs_bytes; k++) fcs |= (uint64_t)src[s + k] << (8 * k);
    if (fcs_bytes == 2) fcs += 256;
    s += fcs_bytes;
    const size_t fstart = *op;
    FrameState F;
    for (;;) {
        need(s + 3 <= n);
        const uint32_t bh = src[s] | (src[s + 1] << 8) | (src[s + 2] << 16);
        s += 3;
        const int last = bh & 1, type = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        need(type != 3 && size <= kBlockMax);
        if (type == 0) {
            need(s + size <= n);
            if (*op + size > cap) fail(kTooSmall);
            memcpy(dst + *op, src + s, size);
            *op += size;
            s += size;
        } else if (type == 1) {
            need(s < n);
            if (*op + size > cap) fail(kTooSmall);
            memset(dst + *op, src[s], size);
            *op += size;
            s += 1;
        } else {
            need(s + size <= n);
            decode_block(F, src + s, size, dst, cap, fstart, op);
            s += size;
        }
        if (last) break;
    }
    if (fcs_bytes) need(*op - fstart == fcs);
    if (checksum) {
        need(s + 4 <= n);
        const uint32_t want = load32(src + s);
        need((uint32_t)xxh64(dst + fstart, *op - fstart, 0) == want);
        s += 4;
    }
    return s;
}

// --------------------------------------------------------------------------
// zstd encoder: greedy hash-chain matches, raw literals, sequences in the
// predefined FSE mode (RFC 8878 3.1.1.3.2.1), single-segment frames
// --------------------------------------------------------------------------

struct FseCTable {
    int log = 0;
    std::vector<uint16_t> state;        // next state by (symbol rank)
    std::vector<int32_t> find;          // per symbol: deltaFindState
    std::vector<uint32_t> dnb;          // per symbol: deltaNbBits
};

void fse_ctable(FseCTable& C, const int16_t* norm, int nsym, int log) {
    const uint32_t size = 1u << log;
    C.log = log;
    C.state.assign(size, 0);
    C.find.assign(nsym, 0);
    C.dnb.assign(nsym, 0);
    std::vector<uint8_t> symbol(size);
    std::vector<uint32_t> cumul(nsym + 1);
    int64_t high = (int64_t)size - 1;
    cumul[0] = 0;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            cumul[s + 1] = cumul[s] + 1;
            symbol[high--] = (uint8_t)s;
        } else {
            cumul[s + 1] = cumul[s] + norm[s];
        }
    }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t position = 0;
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            symbol[position] = (uint8_t)s;
            do {
                position = (position + step) & mask;
            } while ((int64_t)position > high);
        }
    }
    for (uint32_t u = 0; u < size; u++)
        C.state[cumul[symbol[u]]++] = (uint16_t)(size + u);
    uint32_t total = 0;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1 || norm[s] == 1) {
            C.dnb[s] = ((uint32_t)log << 16) - size;
            C.find[s] = (int32_t)total - 1;
            total++;
        } else if (norm[s] > 1) {
            const uint32_t maxb = log - highbit32((uint32_t)norm[s] - 1);
            const uint32_t min_plus = (uint32_t)norm[s] << maxb;
            C.dnb[s] = (maxb << 16) - min_plus;
            C.find[s] = (int32_t)total - norm[s];
            total += norm[s];
        }
    }
}

struct PredefinedC {
    FseCTable ll, ml, of;
    PredefinedC() {
        fse_ctable(ll, kLLDefault, 36, 6);
        fse_ctable(ml, kMLDefault, 53, 6);
        fse_ctable(of, kOFDefault, 29, 5);
    }
};

const PredefinedC& predefined_c() {
    static const PredefinedC p;
    return p;
}

struct BitWriter {
    std::vector<uint8_t>& out;
    uint64_t acc = 0;
    int nbits = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void add(uint64_t v, int nb) {
        if (nb == 0) return;
        acc |= (v & ((1ULL << nb) - 1)) << nbits;
        nbits += nb;
        while (nbits >= 8) {
            out.push_back((uint8_t)acc);
            acc >>= 8;
            nbits -= 8;
        }
    }
    void close() {
        add(1, 1);
        if (nbits) out.push_back((uint8_t)acc);
        acc = 0;
        nbits = 0;
    }
};

struct CState {
    uint32_t value;
    const FseCTable* t;
    void init(const FseCTable& c, int sym) {
        t = &c;
        const uint32_t nb = (c.dnb[sym] + (1u << 15)) >> 16;
        const uint32_t v = (nb << 16) - c.dnb[sym];
        value = c.state[(v >> nb) + c.find[sym]];
    }
    void encode(BitWriter& bw, int sym) {
        const uint32_t nb = (value + t->dnb[sym]) >> 16;
        bw.add(value, nb);
        value = t->state[(value >> nb) + t->find[sym]];
    }
    void flush(BitWriter& bw) { bw.add(value, t->log); }
};

inline int code_of(const uint32_t* base, int n, uint32_t v) {
    return (int)(std::upper_bound(base, base + n, v) - base) - 1;
}

struct Seq {
    uint32_t ll, ml, off;
};

// One block's literals and sequences; false when it would not be
// smaller than the block itself.
bool encode_block(const uint8_t* lit, size_t nlit, const std::vector<Seq>& seqs,
                  size_t block_len, std::vector<uint8_t>& out) {
    out.clear();
    if (nlit < 32) {
        out.push_back((uint8_t)(nlit << 3));
    } else if (nlit < 4096) {
        out.push_back((uint8_t)(4 | ((nlit & 15) << 4)));
        out.push_back((uint8_t)(nlit >> 4));
    } else {
        out.push_back((uint8_t)(12 | ((nlit & 15) << 4)));
        out.push_back((uint8_t)(nlit >> 4));
        out.push_back((uint8_t)(nlit >> 12));
    }
    out.insert(out.end(), lit, lit + nlit);
    const size_t ns = seqs.size();
    if (ns < 128) {
        out.push_back((uint8_t)ns);
    } else if (ns < 0x7F00) {
        out.push_back((uint8_t)((ns >> 8) + 128));
        out.push_back((uint8_t)ns);
    } else {
        out.push_back(255);
        out.push_back((uint8_t)(ns - 0x7F00));
        out.push_back((uint8_t)((ns - 0x7F00) >> 8));
    }
    if (ns) {
        out.push_back(0);   // all three tables predefined
        const PredefinedC& P = predefined_c();
        std::vector<uint8_t> llc(ns), mlc(ns), ofc(ns);
        for (size_t i = 0; i < ns; i++) {
            llc[i] = (uint8_t)code_of(kLLBase, 36, seqs[i].ll);
            mlc[i] = (uint8_t)code_of(kMLBase, 53, seqs[i].ml);
            ofc[i] = (uint8_t)highbit32(seqs[i].off + 3);
        }
        BitWriter bw(out);
        CState sll, sml, sof;
        const size_t last = ns - 1;
        sml.init(P.ml, mlc[last]);
        sof.init(P.of, ofc[last]);
        sll.init(P.ll, llc[last]);
        auto extras = [&](size_t i) {
            bw.add(seqs[i].ll - kLLBase[llc[i]], kLLBits[llc[i]]);
            bw.add(seqs[i].ml - kMLBase[mlc[i]], kMLBits[mlc[i]]);
            bw.add((uint64_t)seqs[i].off + 3 - (1ULL << ofc[i]), ofc[i]);
        };
        extras(last);
        for (size_t i = last; i-- > 0;) {
            sof.encode(bw, ofc[i]);
            sml.encode(bw, mlc[i]);
            sll.encode(bw, llc[i]);
            extras(i);
        }
        sml.flush(bw);
        sof.flush(bw);
        sll.flush(bw);
        bw.close();
    }
    return out.size() < block_len;
}

}  // namespace

extern "C" {

uint64_t agt_xxh64(const uint8_t* src, size_t n, uint64_t seed) {
    return xxh64(src, n, seed);
}

// Decompresses every frame of src (zstd frames and skippable frames,
// back to back) into dst. Returns the bytes written, or kCorrupt (a
// malformed or truncated stream, a failed checksum), kDictionary (a
// frame that names a dictionary) or kTooSmall (more output than
// dst_cap).
int64_t agt_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                            size_t dst_cap) {
    try {
        need(n > 0);
        size_t s = 0, op = 0;
        while (s < n) {
            need(s + 4 <= n);
            const uint32_t magic = load32(src + s);
            s += 4;
            if ((magic & 0xFFFFFFF0U) == 0x184D2A50U) {
                need(s + 4 <= n);
                const size_t skip = load32(src + s);
                s += 4;
                need(skip <= n - s);
                s += skip;
                continue;
            }
            need(magic == kMagic);
            s = decode_frame(src, n, s, dst, dst_cap, &op);
        }
        return (int64_t)op;
    } catch (const Fail& f) {
        return f.code;
    } catch (...) {
        return kCorrupt;
    }
}

// The summed Frame_Content_Size of every zstd frame of src (skippable
// frames count 0), read from the frame headers and the block headers
// that lead past each frame; -4 when a frame's header does not give its
// size, kCorrupt for a malformed or truncated stream.
int64_t agt_zstd_content_size(const uint8_t* src, size_t n) {
    const int64_t kUnknown = -4;
    try {
        need(n > 0);
        size_t s = 0;
        uint64_t total = 0;
        bool known = true;
        while (s < n) {
            need(s + 4 <= n);
            const uint32_t magic = load32(src + s);
            s += 4;
            if ((magic & 0xFFFFFFF0U) == 0x184D2A50U) {
                need(s + 4 <= n);
                const size_t skip = load32(src + s);
                s += 4;
                need(skip <= n - s);
                s += skip;
                continue;
            }
            need(magic == kMagic && s < n);
            const uint8_t fhd = src[s++];
            const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
                      checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
            need((fhd & 8) == 0);
            const int did_bytes = did_flag == 3 ? 4 : did_flag;
            const int fcs_bytes = fcs_flag == 0 ? single : 1 << fcs_flag;
            s += (single ? 0 : 1) + did_bytes;
            need(s + fcs_bytes <= n);
            uint64_t fcs = 0;
            for (int k = 0; k < fcs_bytes; k++)
                fcs |= (uint64_t)src[s + k] << (8 * k);
            if (fcs_bytes == 2) fcs += 256;
            s += fcs_bytes;
            if (fcs_bytes == 0) known = false;
            total += fcs;
            for (;;) {
                need(s + 3 <= n);
                const uint32_t bh =
                    src[s] | (src[s + 1] << 8) | (src[s + 2] << 16);
                s += 3;
                const int type = (bh >> 1) & 3;
                const size_t size = type == 1 ? 1 : bh >> 3;
                need(type != 3 && size <= n - s);
                s += size;
                if (bh & 1) break;
            }
            if (checksum) {
                need(s + 4 <= n);
                s += 4;
            }
        }
        return known ? (int64_t)total : kUnknown;
    } catch (const Fail& f) {
        return f.code;
    } catch (...) {
        return kCorrupt;
    }
}

size_t agt_zstd_compress_bound(size_t n) {
    return n + 3 * (n / kBlockMax + 1) + 32;
}

// One single-segment zstd frame of src (content size in the header, no
// checksum, as the Arrow writers compress pages). `level` sets the search: up to
// 2**((level + 1) / 2) hash-chain candidates per position (one at level
// 1 or below, where positions inside a match are not indexed and a run
// of misses skips ahead faster). Returns the frame's length, or -1 when
// dst_cap is below agt_zstd_compress_bound(n) or n reaches 2**31.
int64_t agt_zstd_compress(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t dst_cap, int32_t level) {
    if (dst_cap < agt_zstd_compress_bound(n) || n >= (1ULL << 31)) return -1;
    try {
        size_t d = 0;
        memcpy(dst, &kMagic, 4);
        d += 4;
        int fcs_flag, fcs_bytes;
        uint64_t fcs = n;
        if (n < 256) {
            fcs_flag = 0;
            fcs_bytes = 1;
        } else if (n < 65536 + 256) {
            fcs_flag = 1;
            fcs_bytes = 2;
            fcs -= 256;
        } else {
            fcs_flag = 2;
            fcs_bytes = 4;
        }
        dst[d++] = (uint8_t)((fcs_flag << 6) | (1 << 5));
        for (int k = 0; k < fcs_bytes; k++) dst[d++] = (uint8_t)(fcs >> (8 * k));

        const int depth = level <= 1 ? 1 : 1 << std::min((level + 1) / 2, 8);
        const int skip_shift = level <= 0 ? 4 : 7;
        const int hash_log = 17;
        const uint32_t kNone = 0xFFFFFFFFU;
        const uint32_t max_dist = (1u << 27);
        std::vector<uint32_t> head(1u << hash_log, kNone);
        std::vector<uint32_t> chain(depth > 1 ? n : 0);
        auto hash4 = [&](size_t i) {
            return (load32(src + i) * 2654435761U) >> (32 - hash_log);
        };
        auto insert = [&](size_t i) {
            const uint32_t h = hash4(i);
            if (depth > 1) chain[i] = head[h];
            head[h] = (uint32_t)i;
        };
        std::vector<Seq> seqs;
        std::vector<uint8_t> lits, block;
        size_t bs = 0;
        do {
            const size_t be = std::min(bs + kBlockMax, n);
            const size_t blen = be - bs;
            const bool last = be == n;
            seqs.clear();
            lits.clear();
            size_t i = bs, anchor = bs;
            while (i + 8 <= be) {
                const uint32_t h = hash4(i);
                uint32_t cand = head[h];
                size_t best = 0, best_off = 0;
                for (int t = 0; t < depth && cand != kNone; t++) {
                    if (i - cand > max_dist) break;
                    if (load32(src + cand) == load32(src + i)) {
                        size_t len = 4;
                        const size_t room = be - i;
                        while (len < room && src[cand + len] == src[i + len])
                            len++;
                        if (len > best) {
                            best = len;
                            best_off = i - cand;
                        }
                    }
                    if (depth == 1) break;
                    cand = chain[cand];
                }
                if (depth > 1) chain[i] = head[h];
                head[h] = (uint32_t)i;
                if (best >= 4) {
                    lits.insert(lits.end(), src + anchor, src + i);
                    seqs.push_back(Seq{(uint32_t)(i - anchor), (uint32_t)best,
                                       (uint32_t)best_off});
                    if (depth > 1)
                        for (size_t k = i + 1; k < i + best && k + 4 <= n; k++)
                            insert(k);
                    i += best;
                    anchor = i;
                } else {
                    i += 1 + ((i - anchor) >> skip_shift);
                }
            }
            lits.insert(lits.end(), src + anchor, src + be);
            bool same = blen > 0;
            for (size_t k = bs + 1; same && k < be; k++)
                same = src[k] == src[bs];
            uint32_t bh;
            if (same && blen > 1) {
                bh = (uint32_t)(last | (1 << 1) | (blen << 3));
                block.assign(1, src[bs]);
            } else if (!seqs.empty() &&
                       encode_block(lits.data(), lits.size(), seqs, blen,
                                    block)) {
                bh = (uint32_t)(last | (2 << 1) | (block.size() << 3));
            } else {
                bh = (uint32_t)(last | (blen << 3));
                block.assign(src + bs, src + be);
            }
            dst[d++] = (uint8_t)bh;
            dst[d++] = (uint8_t)(bh >> 8);
            dst[d++] = (uint8_t)(bh >> 16);
            memcpy(dst + d, block.data(), block.size());
            d += block.size();
            bs = be;
        } while (bs < n);
        return (int64_t)d;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"

// --------------------------------------------------------------------------
// Byte-array pages: PLAIN, DELTA_BINARY_PACKED lengths and prefixes in
// full, DELTA_BYTE_ARRAY rebuilt row by row, and a first-occurrence memo
// table over (offsets, data)
// --------------------------------------------------------------------------

extern "C" {

// PLAIN BYTE_ARRAY: n values of <u32 length><bytes> from src, their bytes
// copied back to back into data (capacity cap) and their ends into
// ends[0..n). Returns the stream bytes used, or -1 when the stream or
// cap ends inside a value.
int64_t agt_plain_byte_array(const uint8_t* src, size_t len, int64_t n,
                             int64_t* ends, uint8_t* data, size_t cap) {
    size_t pos = 0, o = 0;
    for (int64_t i = 0; i < n; i++) {
        if (pos + 4 > len) return -1;
        const size_t ln = load32(src + pos);
        pos += 4;
        if (ln > len - pos || ln > cap - o) return -1;
        memcpy(data + o, src + pos, ln);
        pos += ln;
        o += ln;
        ends[i] = (int64_t)o;
    }
    return (int64_t)pos;
}

// A DELTA_BINARY_PACKED stream decoded in full on the host (every width
// up to 64 bits, deltas wrapping in int64): writes its values to out
// (at most cap) and the stream bytes used to *used. Returns the value
// count, -1 on a malformed or truncated stream, -2 when the count
// passes cap.
int64_t agt_delta_decode(const uint8_t* src, size_t len, int64_t cap,
                         int64_t* out, int64_t* used) {
    uint64_t hdr[4];
    size_t pos = 0;
    for (int k = 0; k < 4; k++) {
        const size_t u = get_varint(src + pos, len - pos, &hdr[k]);
        if (!u) return -1;
        pos += u;
    }
    const uint64_t block = hdr[0], minis = hdr[1], total = hdr[2];
    if (minis == 0 || block == 0 || block % minis || (block / minis) % 8 ||
        block > (1u << 20) || total > (uint64_t)INT64_MAX)
        return -1;
    if ((int64_t)total > cap) return -2;
    const uint64_t vpm = block / minis;
    uint64_t value = (hdr[3] >> 1) ^ (0 - (hdr[3] & 1));
    if (total) out[0] = (int64_t)value;
    uint64_t got = 1;
    while (got < total) {
        uint64_t z;
        const size_t u = get_varint(src + pos, len - pos, &z);
        if (!u) return -1;
        pos += u;
        const uint64_t mn = (z >> 1) ^ (0 - (z & 1));
        if (pos + minis > len) return -1;
        const uint8_t* widths = src + pos;
        pos += minis;
        for (uint64_t m = 0; m < minis && got < total; m++) {
            const int w = widths[m];
            if (w > 64) return -1;
            const size_t nbytes = (vpm * w + 7) / 8;
            if (pos + nbytes > len) return -1;
            const uint64_t take = std::min(vpm, total - got);
            const int64_t bit0 = (int64_t)pos * 8;
            for (uint64_t k = 0; k < take; k++) {
                uint64_t d;
                const int64_t b = bit0 + (int64_t)(k * w);
                if (w <= 56) {
                    d = bits_at(src, len, b, w);
                } else {
                    d = bits_at(src, len, b, 32) |
                        (bits_at(src, len, b + 32, w - 32) << 32);
                }
                value += d + mn;
                out[got + k] = (int64_t)value;
            }
            got += take;
            pos += nbytes;
        }
    }
    *used = (int64_t)pos;
    return (int64_t)total;
}

// DELTA_BYTE_ARRAY rows: value i = the first prefix[i] bytes of value
// i - 1, then suffix i (suffix ends in suf_ends[0..n)). Writes the rows
// back to back into out (capacity cap) and their ends into ends.
// Returns the bytes written, or -1 when a prefix passes the previous
// value or cap is short.
int64_t agt_delta_byte_array_rebuild(const int64_t* prefix,
                                     const int64_t* suf_ends,
                                     const uint8_t* suf, int64_t n,
                                     int64_t* ends, uint8_t* out, size_t cap) {
    size_t o = 0, prev = 0, prev_len = 0, s0 = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t p = prefix[i];
        const size_t s1 = (size_t)suf_ends[i];
        if (p < 0 || (size_t)p > prev_len || s1 < s0) return -1;
        const size_t sl = s1 - s0;
        if ((size_t)p + sl > cap - o) return -1;
        memcpy(out + o, out + prev, (size_t)p);
        memcpy(out + o + p, suf + s0, sl);
        prev = o;
        prev_len = (size_t)p + sl;
        o += prev_len;
        ends[i] = (int64_t)o;
        s0 = s1;
    }
    return (int64_t)o;
}

// The RLE/bit-packed hybrid stream's n values (bit_width <= 32) decoded
// in full into out. Returns n, or -1 when the stream ends first.
int64_t agt_rle_decode(const uint8_t* src, size_t len, int64_t n,
                       int32_t bit_width, uint32_t* out) {
    const size_t nbytes = ((size_t)bit_width + 7) / 8;
    int64_t got = 0;
    size_t pos = 0;
    while (got < n) {
        uint64_t header;
        const size_t u = get_varint(src + pos, len - pos, &header);
        if (!u) return -1;
        pos += u;
        if (header & 1) {
            const int64_t count = (int64_t)(header >> 1) * 8;
            const size_t need_bytes = ((size_t)count * bit_width + 7) / 8;
            const int64_t take = std::min(count, n - got);
            const int64_t bit0 = (int64_t)pos * 8;
            if ((size_t)((take * bit_width + 7) / 8) > len - pos) return -1;
            for (int64_t k = 0; k < take; k++)
                out[got + k] = (uint32_t)bits_at(src, len,
                                                 bit0 + k * bit_width,
                                                 bit_width);
            got += take;
            pos += std::min(need_bytes, len - pos);
        } else {
            const int64_t count = (int64_t)(header >> 1);
            if (pos + nbytes > len) return -1;
            uint32_t v = 0;
            for (size_t k = 0; k < nbytes; k++)
                v |= (uint32_t)src[pos + k] << (8 * k);
            pos += nbytes;
            const int64_t take = std::min(count, n - got);
            for (int64_t k = 0; k < take; k++) out[got + k] = v;
            got += take;
            if (count == 0) return -1;
        }
    }
    return got;
}

// The bytes of rows idx[0..n) of (ends, data) back to back into out
// (row r spans [ends[r - 1], ends[r]), ends[-1] = 0).
void agt_gather_rows(const uint8_t* data, const int64_t* ends,
                     const int32_t* idx, int64_t n, uint8_t* out) {
    size_t o = 0;
    for (int64_t i = 0; i < n; i++) {
        const int32_t r = idx[i];
        const int64_t a = r ? ends[r - 1] : 0, b = ends[r];
        memcpy(out + o, data + a, (size_t)(b - a));
        o += (size_t)(b - a);
    }
}

// The varint at every byte p of an Avro block of L bytes: vlen[p], its
// length (the distance to the first byte under 0x80 at or after p, plus
// one, else to the end plus one; at most 10) and val[p], its zigzag
// value cut to 32 bits (the 7-bit groups of its first five bytes, a byte
// past the end read as 0). Garbage where no varint starts: only field
// positions are read.
void agt_varint_lanes(const uint8_t* buf, int64_t L, int32_t* vlen,
                      int32_t* val) {
    int64_t stop = L;
    for (int64_t p = L - 1; p >= 0; p--) {
        if (buf[p] < 128) stop = p;
        const int64_t n = std::min<int64_t>(stop - p + 1, 10);
        vlen[p] = (int32_t)n;
        uint32_t acc = 0;
        for (int64_t k = 0; k < std::min<int64_t>(n, 5); k++) {
            const uint32_t b = p + k < L ? buf[p + k] : 0;
            acc |= (b & 0x7FU) << (7 * k);
        }
        val[p] = (int32_t)(acc >> 1) ^ -(int32_t)(acc & 1);
    }
}

// The field positions of `count` records of a flat Avro record schema in
// one block, from the block's varint lanes (vlen[p], val[p]: the length
// and the zigzag value cut to 32 bits of the varint at byte p, as
// agt_varint_lanes gives them). Field j
// has kind[j] (0 null, 1 boolean, 2 a varint: int, long, enum, 3 float,
// 4 double, 5 bytes or string) and null_branch[j] (-1: not a union, else
// the union branch that is null). starts[r * nf + j] is where field j of
// record r starts. Positions are clamped to L, a lane read at
// min(pos, L - 1), and a record that starts at L starts the next one
// there too, as the JAX package's record-jump walk does. Returns 0, or
// -1 when a lane must be read from an empty block.
int64_t agt_avro_flat_walk(const int32_t* vlen, const int32_t* val,
                           int64_t L, int64_t count, int32_t nf,
                           const int32_t* kind, const int32_t* null_branch,
                           int64_t* starts) {
    const int64_t last = L ? L - 1 : 0;
    bool empty_read = false;
    auto lane_at = [&](const int32_t* lane, int64_t p) -> int64_t {
        if (L == 0) { empty_read = true; return 0; }
        return lane[p];
    };
    auto size_at = [&](int32_t k, int64_t p) -> int64_t {
        switch (k) {
            case 0: return 0;
            case 1: return 1;
            case 2: return lane_at(vlen, p);
            case 3: return 4;
            case 4: return 8;
            default: {
                const int64_t n = lane_at(val, p);
                return lane_at(vlen, p) + (n > 0 ? n : 0);
            }
        }
    };
    auto advance = [&](int64_t pos, int32_t j) -> int64_t {
        const int64_t safe = std::min(pos, last);
        if (null_branch[j] < 0)
            return std::min(pos + size_at(kind[j], safe), L);
        const int64_t branch = lane_at(val, safe);
        const int64_t inner = std::min(pos + lane_at(vlen, safe), L);
        const bool is_null = (branch == 0) == (null_branch[j] == 0);
        if (is_null) return inner;
        return std::min(inner + size_at(kind[j], std::min(inner, last)), L);
    };
    int64_t p = 0;
    for (int64_t r = 0; r < count; r++) {
        int64_t q = p;
        for (int32_t j = 0; j < nf; j++) {
            starts[r * nf + j] = q;
            q = advance(q, j);
        }
        if (p < L) p = q;
    }
    return empty_read ? -1 : 0;
}

// First-occurrence codes of the n rows of (ends, data): codes[i] is the
// rank of row i's value among the distinct values in order of first
// appearance, first[k] the row where value k first appears. Returns the
// number of distinct values, or -1 when memory runs out.
int64_t agt_factorize(const uint8_t* data, const int64_t* ends, int64_t n,
                      int32_t* codes, int64_t* first) {
    size_t cap = 1024;
    std::vector<int32_t> slots;
    std::vector<uint64_t> hashes;
    try {
        slots.assign(cap, -1);
        hashes.reserve(1024);
    } catch (...) {
        return -1;
    }
    int64_t k = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t a = i ? ends[i - 1] : 0, len = ends[i] - a;
        const uint8_t* p = data + a;
        const uint64_t h = xxh64(p, (size_t)len, 0);
        size_t s = h & (cap - 1);
        int32_t code = -1;
        for (;;) {
            const int32_t j = slots[s];
            if (j < 0) break;
            const int64_t r = first[j];
            const int64_t ra = r ? ends[r - 1] : 0;
            if (hashes[j] == h && ends[r] - ra == len &&
                memcmp(data + ra, p, (size_t)len) == 0) {
                code = j;
                break;
            }
            s = (s + 1) & (cap - 1);
        }
        if (code < 0) {
            code = (int32_t)k;
            first[k] = i;
            try {
                hashes.push_back(h);
            } catch (...) {
                return -1;
            }
            slots[s] = code;
            k++;
            if ((size_t)k * 2 > cap) {   // grow and rehash at half full
                cap <<= 1;
                try {
                    slots.assign(cap, -1);
                } catch (...) {
                    return -1;
                }
                for (int64_t j = 0; j < k; j++) {
                    size_t t = hashes[j] & (cap - 1);
                    while (slots[t] >= 0) t = (t + 1) & (cap - 1);
                    slots[t] = (int32_t)j;
                }
            }
        }
        codes[i] = code;
    }
    return k;
}

}  // extern "C"

extern "C" {

// XXH64 (seed 0) of each row of (ends, data) into out[0..n).
void agt_xxh64_rows(const uint8_t* data, const int64_t* ends, int64_t n,
                    uint64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        const int64_t a = i ? ends[i - 1] : 0;
        out[i] = xxh64(data + a, (size_t)(ends[i] - a), 0);
    }
}

}  // extern "C"

// --------------------------------------------------------------------------
// XXH32 and the LZ4 frame format (Arrow IPC body compression; the frame's
// header checksum byte is XXH32 of its descriptor; lz4_Frame_format.md)
// --------------------------------------------------------------------------

namespace {

const uint32_t kQ1 = 2654435761U;
const uint32_t kQ2 = 2246822519U;
const uint32_t kQ3 = 3266489917U;
const uint32_t kQ4 = 668265263U;
const uint32_t kQ5 = 374761393U;

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t xxh32_round(uint32_t acc, uint32_t input) {
    acc += input * kQ2;
    acc = rotl32(acc, 13);
    return acc * kQ1;
}

uint32_t xxh32(const uint8_t* p, size_t len, uint32_t seed) {
    const uint8_t* end = p + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + kQ1 + kQ2, v2 = seed + kQ2, v3 = seed,
                 v4 = seed - kQ1;
        const uint8_t* limit = end - 16;
        do {
            v1 = xxh32_round(v1, load32(p));
            v2 = xxh32_round(v2, load32(p + 4));
            v3 = xxh32_round(v3, load32(p + 8));
            v4 = xxh32_round(v4, load32(p + 12));
            p += 16;
        } while (p <= limit);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + kQ5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h += load32(p) * kQ3;
        h = rotl32(h, 17) * kQ4;
        p += 4;
    }
    while (p < end) {
        h += (uint32_t)(*p) * kQ5;
        h = rotl32(h, 11) * kQ1;
        p++;
    }
    h ^= h >> 15;
    h *= kQ2;
    h ^= h >> 13;
    h *= kQ3;
    h ^= h >> 16;
    return h;
}

const uint32_t kLz4FrameMagic = 0x184D2204U;
const uint8_t kFrameFlg = 0x40;   // version 01, no checksums, no size
const uint8_t kFrameBd = 0x70;    // 4 MB maximum block size

inline void put32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }

}  // namespace

extern "C" {

uint32_t agt_xxh32(const uint8_t* src, size_t n, uint32_t seed) {
    return xxh32(src, n, seed);
}

size_t agt_lz4_frame_bound(size_t n, size_t block) {
    size_t blocks = n / block + 1;
    return 7 + blocks * (4 + agt_lz4_max_compressed_length(block)) + 4;
}

// One LZ4 frame of src, as the JAX package's lz4_frame_compress writes
// it: the descriptor FLG 0x40 / BD 0x70 and its XXH32 byte, then blocks
// of `block` bytes each compressed alone (stored raw, the high bit of
// their size set, when that does not shrink them), then the end mark.
// Returns the frame's length, or -1 when dst_cap is too small.
int64_t agt_lz4_frame_compress(const uint8_t* src, size_t n, size_t block,
                               uint8_t* dst, size_t dst_cap) {
    if (dst_cap < 11 || block == 0) return -1;
    put32(dst, kLz4FrameMagic);
    dst[4] = kFrameFlg;
    dst[5] = kFrameBd;
    dst[6] = (uint8_t)((xxh32(dst + 4, 2, 0) >> 8) & 0xFF);
    size_t d = 7;
    for (size_t i = 0; i < n; i += block) {
        size_t len = std::min(block, n - i);
        if (d + 4 > dst_cap) return -1;
        int64_t c = agt_lz4_compress(src + i, len, dst + d + 4,
                                     dst_cap - d - 4);
        if (c >= 0 && (size_t)c < len) {
            put32(dst + d, (uint32_t)c);
            d += 4 + (size_t)c;
        } else {
            if (d + 4 + len > dst_cap) return -1;
            put32(dst + d, (uint32_t)len | 0x80000000U);
            memcpy(dst + d + 4, src + i, len);
            d += 4 + len;
        }
    }
    if (d + 4 > dst_cap) return -1;
    put32(dst + d, 0);
    return (int64_t)(d + 4);
}

// Decodes every block of one LZ4 frame into dst, independent or linked
// (a linked block's matches reach into the output before it), skipping
// block and content checksums. Returns the bytes written, or -1 on a
// bad magic, a truncated or malformed frame, or more output than
// dst_cap.
int64_t agt_lz4_frame_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                                 size_t dst_cap) {
    if (n < 7 || load32(src) != kLz4FrameMagic) return -1;
    uint8_t flg = src[4];
    size_t s = 6 + ((flg & 0x08) ? 8 : 0) + ((flg & 0x01) ? 4 : 0) + 1;
    bool independent = flg & 0x20, block_sum = flg & 0x10;
    size_t d = 0;
    while (true) {
        if (s + 4 > n) return -1;
        uint32_t size = load32(src + s);
        s += 4;
        if (size == 0) break;
        bool raw = size & 0x80000000U;
        size &= 0x7FFFFFFFU;
        if (s + size > n) return -1;
        if (raw) {
            if (d + size > dst_cap) return -1;
            memcpy(dst + d, src + s, size);
            d += size;
        } else {
            int64_t e = lz4_block_decode(src + s, size, dst,
                                         independent ? d : 0, d, dst_cap);
            if (e < 0) return -1;
            d = (size_t)e;
        }
        s += size + (block_sum ? 4 : 0);
    }
    return (int64_t)d;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// AES (FIPS-197) in CTR and GCM (NIST SP 800-38D) modes, the cipher of
// parquet modular encryption. The rounds run on AES-NI, eight CTR blocks
// in flight, and GHASH on PCLMULQDQ (the carry-less multiply and
// reduction of Intel's white paper "Carry-Less Multiplication and Its
// Usage for Computing the GCM Mode"), four blocks folded per reduction
// with H, H^2, H^3 and H^4, so no step looks up a table indexed by key
// or data. A CPU without those instructions gets kAesNoCpu and nothing
// else: there is no table-driven fallback.
// ---------------------------------------------------------------------------

#include <immintrin.h>

#define AGT_AES __attribute__((target("aes,pclmul,sse4.1")))

namespace {

constexpr int64_t kAesBadKey = -1;
constexpr int64_t kAesNoCpu = -2;
constexpr int64_t kAesBadTag = -3;
constexpr int64_t kAesShort = -4;

bool aes_cpu() {
    __builtin_cpu_init();
    return __builtin_cpu_supports("aes") && __builtin_cpu_supports("pclmul")
        && __builtin_cpu_supports("sse4.1");
}

struct AesKey {
    __m128i rk[15];
    int rounds;
};

// SubWord of one 32-bit word (the S-box on each byte) through
// AESKEYGENASSIST, whose first dword is SubWord of the second input dword.
AGT_AES inline uint32_t sub_word(uint32_t w) {
    return (uint32_t)_mm_cvtsi128_si32(
        _mm_aeskeygenassist_si128(_mm_set_epi32(0, 0, (int)w, 0), 0));
}

// The key expansion of FIPS-197 section 5.2 for 16, 24 or 32 byte keys,
// word by word; a word's bytes sit little-endian in a uint32, so RotWord
// is a right rotation by 8 bits. Returns false on another key length.
AGT_AES bool aes_expand(const uint8_t* key, size_t len, AesKey* k) {
    if (len != 16 && len != 24 && len != 32) return false;
    static const uint8_t rcon[10] = {0x01, 0x02, 0x04, 0x08, 0x10,
                                     0x20, 0x40, 0x80, 0x1b, 0x36};
    const int nk = (int)(len / 4);
    k->rounds = nk + 6;
    const int total = 4 * (k->rounds + 1);
    uint32_t w[60];
    memcpy(w, key, len);
    for (int i = nk; i < total; i++) {
        uint32_t t = w[i - 1];
        if (i % nk == 0) {
            t = sub_word((t >> 8) | (t << 24)) ^ rcon[i / nk - 1];
        } else if (nk > 6 && i % nk == 4) {
            t = sub_word(t);
        }
        w[i] = w[i - nk] ^ t;
    }
    for (int r = 0; r <= k->rounds; r++)
        k->rk[r] = _mm_loadu_si128((const __m128i*)(w + 4 * r));
    return true;
}

AGT_AES inline __m128i aes_block(const AesKey& k, __m128i x) {
    x = _mm_xor_si128(x, k.rk[0]);
    for (int r = 1; r < k.rounds; r++) x = _mm_aesenc_si128(x, k.rk[r]);
    return _mm_aesenclast_si128(x, k.rk[k.rounds]);
}

// The 12 bytes of iv with a zero count: the counter blocks' base.
AGT_AES inline __m128i counter_base(const uint8_t* iv) {
    alignas(16) uint8_t b[16] = {0};
    memcpy(b, iv, 12);
    return _mm_load_si128((const __m128i*)b);
}

// A counter block: the base, then the big-endian 32-bit count.
AGT_AES inline __m128i counter_block(__m128i base, uint32_t c) {
    return _mm_insert_epi32(base, (int)__builtin_bswap32(c), 3);
}

// CTR: dst = src xor the keystream of counters iv[0..12) || c, c + 1, ...
// (the count incremented mod 2^32), eight blocks at a time so the AES
// rounds of independent blocks overlap in the pipeline.
AGT_AES void aes_ctr_run(const AesKey& k, const uint8_t* iv, uint32_t c,
                         const uint8_t* src, size_t n, uint8_t* dst) {
    const __m128i base = counter_base(iv);
    size_t i = 0;
    for (; i + 128 <= n; i += 128) {
        __m128i x[8];
        for (int j = 0; j < 8; j++)
            x[j] = _mm_xor_si128(counter_block(base, c + j), k.rk[0]);
        for (int r = 1; r < k.rounds; r++)
            for (int j = 0; j < 8; j++) x[j] = _mm_aesenc_si128(x[j], k.rk[r]);
        for (int j = 0; j < 8; j++) {
            x[j] = _mm_aesenclast_si128(x[j], k.rk[k.rounds]);
            __m128i p = _mm_loadu_si128((const __m128i*)(src + i + 16 * j));
            _mm_storeu_si128((__m128i*)(dst + i + 16 * j),
                             _mm_xor_si128(p, x[j]));
        }
        c += 8;
    }
    for (; i < n; i += 16, c++) {
        alignas(16) uint8_t ks[16];
        _mm_store_si128((__m128i*)ks, aes_block(k, counter_block(base, c)));
        size_t m = std::min((size_t)16, n - i);
        for (size_t j = 0; j < m; j++) dst[i + j] = src[i + j] ^ ks[j];
    }
}

AGT_AES inline __m128i bswap128(__m128i x) {
    return _mm_shuffle_epi8(x, _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                            10, 11, 12, 13, 14, 15));
}

// The 256-bit carry-less product of a and b as (lo, hi): four
// PCLMULQDQs (the white paper's Algorithm 5 up to its shift).
struct Wide {
    __m128i lo, hi;
};

AGT_AES inline Wide clmul(__m128i a, __m128i b) {
    __m128i t3 = _mm_clmulepi64_si128(a, b, 0x00);
    __m128i t4 = _mm_clmulepi64_si128(a, b, 0x10);
    __m128i t5 = _mm_clmulepi64_si128(a, b, 0x01);
    __m128i t6 = _mm_clmulepi64_si128(a, b, 0x11);
    t4 = _mm_xor_si128(t4, t5);
    t5 = _mm_slli_si128(t4, 8);
    t4 = _mm_srli_si128(t4, 8);
    return {_mm_xor_si128(t3, t5), _mm_xor_si128(t6, t4)};
}

AGT_AES inline Wide wide_xor(Wide a, Wide b) {
    return {_mm_xor_si128(a.lo, b.lo), _mm_xor_si128(a.hi, b.hi)};
}

// A 256-bit product of byte-reflected operands to its GF(2^128) value:
// the shift left by one bit and the reduction modulo x^128 + x^7 + x^2
// + x + 1 (the rest of Algorithm 5). Both are linear, so the sum of
// several products reduces once.
AGT_AES inline __m128i gf_reduce(Wide w) {
    __m128i t3 = w.lo, t6 = w.hi, t4, t5;
    __m128i t7 = _mm_srli_epi32(t3, 31);
    __m128i t8 = _mm_srli_epi32(t6, 31);
    t3 = _mm_slli_epi32(t3, 1);
    t6 = _mm_slli_epi32(t6, 1);
    __m128i t9 = _mm_srli_si128(t7, 12);
    t8 = _mm_slli_si128(t8, 4);
    t7 = _mm_slli_si128(t7, 4);
    t3 = _mm_or_si128(t3, t7);
    t6 = _mm_or_si128(t6, t8);
    t6 = _mm_or_si128(t6, t9);
    t7 = _mm_slli_epi32(t3, 31);
    t8 = _mm_slli_epi32(t3, 30);
    t9 = _mm_slli_epi32(t3, 25);
    t7 = _mm_xor_si128(t7, t8);
    t7 = _mm_xor_si128(t7, t9);
    t8 = _mm_srli_si128(t7, 4);
    t7 = _mm_slli_si128(t7, 12);
    t3 = _mm_xor_si128(t3, t7);
    __m128i t2 = _mm_srli_epi32(t3, 1);
    t4 = _mm_srli_epi32(t3, 2);
    t5 = _mm_srli_epi32(t3, 7);
    t2 = _mm_xor_si128(t2, t4);
    t2 = _mm_xor_si128(t2, t5);
    t2 = _mm_xor_si128(t2, t8);
    t3 = _mm_xor_si128(t3, t2);
    return _mm_xor_si128(t6, t3);
}

// a * b in GCM's GF(2^128), both byte-reflected (bswap128 of the block).
AGT_AES inline __m128i gf_mul(__m128i a, __m128i b) {
    return gf_reduce(clmul(a, b));
}

// GHASH's key H and its powers, byte-reflected: hp[j] = H^(j + 1).
struct GhashKey {
    __m128i hp[4];
};

AGT_AES GhashKey ghash_key(const AesKey& k) {
    GhashKey g;
    g.hp[0] = bswap128(aes_block(k, _mm_setzero_si128()));
    for (int j = 1; j < 4; j++) g.hp[j] = gf_mul(g.hp[j - 1], g.hp[0]);
    return g;
}

AGT_AES inline __m128i load_block(const uint8_t* p) {
    return bswap128(_mm_loadu_si128((const __m128i*)p));
}

// Folds n bytes into the GHASH state y (byte-reflected), the last
// partial block zero-padded: four blocks at a time as
// (y + x0) H^4 + x1 H^3 + x2 H^2 + x3 H, one reduction per four.
AGT_AES __m128i ghash(const GhashKey& g, __m128i y, const uint8_t* p,
                      size_t n) {
    size_t i = 0;
    for (; i + 64 <= n; i += 64) {
        Wide w = clmul(_mm_xor_si128(y, load_block(p + i)), g.hp[3]);
        w = wide_xor(w, clmul(load_block(p + i + 16), g.hp[2]));
        w = wide_xor(w, clmul(load_block(p + i + 32), g.hp[1]));
        w = wide_xor(w, clmul(load_block(p + i + 48), g.hp[0]));
        y = gf_reduce(w);
    }
    const __m128i h = g.hp[0];
    for (; i + 16 <= n; i += 16)
        y = gf_mul(_mm_xor_si128(y, load_block(p + i)), h);
    if (i < n) {
        alignas(16) uint8_t b[16] = {0};
        memcpy(b, p + i, n - i);
        y = gf_mul(_mm_xor_si128(y, bswap128(_mm_load_si128(
                       (const __m128i*)b))), h);
    }
    return y;
}

// The GCM tag of (aad, ciphertext) under a 12-byte nonce: E(K, J0) xor
// GHASH(aad || ct || bitlen(aad) || bitlen(ct)), J0 = nonce || 1.
AGT_AES void gcm_tag(const AesKey& k, const uint8_t* nonce,
                     const uint8_t* aad, size_t aad_len, const uint8_t* ct,
                     size_t n, uint8_t* tag) {
    const GhashKey g = ghash_key(k);
    __m128i y = ghash(g, _mm_setzero_si128(), aad, aad_len);
    y = ghash(g, y, ct, n);
    alignas(16) uint8_t lens[16];
    uint64_t bits[2] = {(uint64_t)aad_len * 8, (uint64_t)n * 8};
    for (int half = 0; half < 2; half++)
        for (int j = 0; j < 8; j++)
            lens[8 * half + j] = (uint8_t)(bits[half] >> (56 - 8 * j));
    y = ghash(g, y, lens, 16);
    __m128i t = _mm_xor_si128(bswap128(y),
                              aes_block(k, counter_block(counter_base(nonce),
                                                         1)));
    _mm_storeu_si128((__m128i*)tag, t);
}

}  // namespace

extern "C" {

// AES-CTR of n bytes under a 16/24/32-byte key: iv16 is the first
// counter block (its last four bytes the big-endian count). Returns n,
// kAesBadKey or kAesNoCpu.
AGT_AES int64_t agt_aes_ctr(const uint8_t* key, size_t key_len,
                            const uint8_t* iv16, const uint8_t* src,
                            size_t n, uint8_t* dst) {
    if (!aes_cpu()) return kAesNoCpu;
    AesKey k;
    if (!aes_expand(key, key_len, &k)) return kAesBadKey;
    uint32_t c = ((uint32_t)iv16[12] << 24) | ((uint32_t)iv16[13] << 16)
        | ((uint32_t)iv16[14] << 8) | iv16[15];
    aes_ctr_run(k, iv16, c, src, n, dst);
    return (int64_t)n;
}

// AES-GCM encryption under a 12-byte nonce: dst gets the n ciphertext
// bytes, then the 16-byte tag. Returns n + 16, kAesBadKey or kAesNoCpu.
AGT_AES int64_t agt_aes_gcm_encrypt(const uint8_t* key, size_t key_len,
                                    const uint8_t* nonce, const uint8_t* aad,
                                    size_t aad_len, const uint8_t* src,
                                    size_t n, uint8_t* dst) {
    if (!aes_cpu()) return kAesNoCpu;
    AesKey k;
    if (!aes_expand(key, key_len, &k)) return kAesBadKey;
    aes_ctr_run(k, nonce, 2, src, n, dst);
    gcm_tag(k, nonce, aad, aad_len, dst, n, dst + n);
    return (int64_t)n + 16;
}

// AES-GCM decryption of src = ciphertext || 16-byte tag (n bytes in all)
// under a 12-byte nonce: the tag is checked first, in constant time, and
// the plaintext written to dst only when it holds. Returns n - 16,
// kAesShort (n < 16), kAesBadTag, kAesBadKey or kAesNoCpu.
AGT_AES int64_t agt_aes_gcm_decrypt(const uint8_t* key, size_t key_len,
                                    const uint8_t* nonce, const uint8_t* aad,
                                    size_t aad_len, const uint8_t* src,
                                    size_t n, uint8_t* dst) {
    if (!aes_cpu()) return kAesNoCpu;
    AesKey k;
    if (!aes_expand(key, key_len, &k)) return kAesBadKey;
    if (n < 16) return kAesShort;
    size_t m = n - 16;
    uint8_t tag[16];
    gcm_tag(k, nonce, aad, aad_len, src, m, tag);
    uint8_t diff = 0;
    for (int j = 0; j < 16; j++) diff |= tag[j] ^ src[m + j];
    if (diff) return kAesBadTag;
    aes_ctr_run(k, nonce, 2, src, m, dst);
    return (int64_t)m;
}

}  // extern "C"
