// Native host runtime of pinot_tpu_torch: hot scalar loops the Python/numpy
// layer delegates to. The port's own copy of the JAX package's
// native/pinot_native.cpp, entry point for entry point.
//
// Reference analogue (SURVEY.md §2.9): the effectively-native Java machinery
// Pinot relies on — FixedBitIntReader's unrolled bit-unpacking
// (pinot-segment-local/.../io/reader/impl/FixedBitIntReader.java:27,
// readUnchecked:44, read32:50), PinotDataBitSet, and the dict-id hashing
// inside DictionaryBasedGroupKeyGenerator. Compiled with g++ -O3 -shared
// -fPIC into pinot_tpu_torch/_build/ at first use and loaded with ctypes
// (segment/native_bridge.py). A build or load failure raises there; only
// PINOT_TPU_DISABLE_NATIVE selects the plain Python versions.
//
// Format contract: LSB-first packed bitstream, identical to
// segment/bitpack.py's plain pack()/unpack() — round-trip tests enforce
// parity.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Unpack `count` values of `num_bits` (1..32) from an LSB-first bitstream.
// `data` must have at least (count*num_bits+7)/8 + 8 readable bytes when
// padded=1 (the loader over-allocates); with padded=0 a safe tail loop runs.
void unpack_bits(const uint8_t* data, int num_bits, int64_t count,
                 int32_t* out, int padded) {
    if (num_bits == 8) {
        for (int64_t i = 0; i < count; i++) out[i] = data[i];
        return;
    }
    if (num_bits == 16) {
        const uint16_t* p = (const uint16_t*)data;
        for (int64_t i = 0; i < count; i++) out[i] = p[i];
        return;
    }
    if (num_bits == 32) {
        memcpy(out, data, (size_t)count * 4);
        return;
    }
    const uint64_t mask = (num_bits == 64) ? ~0ULL : ((1ULL << num_bits) - 1);
    int64_t fast = count;
    if (!padded) {
        // last values whose 8-byte window read would overrun run in the
        // byte-exact tail loop below
        int64_t total_bytes = ((count * num_bits) + 7) / 8;
        int64_t safe_bits = (total_bytes - 8) * 8;  // window start must fit
        fast = safe_bits > 0 ? safe_bits / num_bits : 0;
        if (fast > count) fast = count;
    }
    for (int64_t i = 0; i < fast; i++) {
        int64_t bit = i * (int64_t)num_bits;
        uint64_t window;
        memcpy(&window, data + (bit >> 3), 8);  // little-endian load
        out[i] = (int32_t)((window >> (bit & 7)) & mask);
    }
    int64_t total_bytes = ((count * (int64_t)num_bits) + 7) / 8;
    for (int64_t i = fast; i < count; i++) {
        int64_t bit = i * (int64_t)num_bits;
        uint64_t acc = 0;
        int got = 0;
        for (int64_t b = bit >> 3; got < num_bits + 8 && b < total_bytes;
             b++, got += 8)
            acc |= (uint64_t)data[b] << got;
        out[i] = (int32_t)((acc >> (bit & 7)) & mask);
    }
}

// Pack `n` non-negative values (< 2^num_bits) into an LSB-first bitstream.
// `out` must hold (n*num_bits+7)/8 bytes, zero-initialized.
void pack_bits(const uint32_t* values, int64_t n, int num_bits, uint8_t* out) {
    if (num_bits == 8) {
        for (int64_t i = 0; i < n; i++) out[i] = (uint8_t)values[i];
        return;
    }
    if (num_bits == 16) {
        uint16_t* p = (uint16_t*)out;
        for (int64_t i = 0; i < n; i++) p[i] = (uint16_t)values[i];
        return;
    }
    if (num_bits == 32) {
        memcpy(out, values, (size_t)n * 4);
        return;
    }
    for (int64_t i = 0; i < n; i++) {
        int64_t bit = i * (int64_t)num_bits;
        uint64_t v = (uint64_t)values[i] << (bit & 7);
        uint8_t* p = out + (bit >> 3);
        // write ≤ 5 bytes (num_bits<32 + shift<8 → ≤ 39 bits)
        for (int b = 0; v; b++, v >>= 8) p[b] |= (uint8_t)(v & 0xFF);
    }
}

// Dense bool (uint8 0/1) → packed LSB-first bitmap.
void pack_bitmap(const uint8_t* bools, int64_t n, uint8_t* out) {
    memset(out, 0, (size_t)((n + 7) / 8));
    for (int64_t i = 0; i < n; i++)
        out[i >> 3] |= (uint8_t)((bools[i] & 1) << (i & 7));
}

void unpack_bitmap(const uint8_t* data, int64_t count, uint8_t* out) {
    for (int64_t i = 0; i < count; i++)
        out[i] = (data[i >> 3] >> (i & 7)) & 1;
}

// Factorize int64 keys → dense codes in first-occurrence order.
// Open-addressing hash table; returns the number of distinct keys.
// uniques[] receives the distinct keys (caller sizes it to n).
int64_t factorize_i64(const int64_t* keys, int64_t n, int64_t* codes,
                      int64_t* uniques) {
    if (n == 0) return 0;
    // table size: next power of two ≥ 2n
    uint64_t cap = 16;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    std::vector<int64_t> slot_key(cap);
    std::vector<int64_t> slot_code(cap, -1);
    uint64_t hmask = cap - 1;
    int64_t next = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t h = (uint64_t)keys[i] * 0x9E3779B97F4A7C15ULL;
        uint64_t s = (h ^ (h >> 29)) & hmask;
        while (true) {
            if (slot_code[s] < 0) {
                slot_key[s] = keys[i];
                slot_code[s] = next;
                uniques[next] = keys[i];
                codes[i] = next++;
                break;
            }
            if (slot_key[s] == keys[i]) {
                codes[i] = slot_code[s];
                break;
            }
            s = (s + 1) & hmask;
        }
    }
    return next;
}

// Grouped aggregation over float64 values with precomputed dense codes:
// one pass computing sum/count/min/max per group (the host fallback's
// aggregateGroupBySV analogue).
void group_agg_f64(const int64_t* codes, const double* vals, int64_t n,
                   int64_t num_groups, double* sums, int64_t* counts,
                   double* mins, double* maxs) {
    for (int64_t g = 0; g < num_groups; g++) {
        sums[g] = 0.0;
        counts[g] = 0;
        mins[g] = 1.0 / 0.0;
        maxs[g] = -1.0 / 0.0;
    }
    for (int64_t i = 0; i < n; i++) {
        int64_t g = codes[i];
        double v = vals[i];
        sums[g] += v;
        counts[g]++;
        if (v < mins[g]) mins[g] = v;
        if (v > maxs[g]) maxs[g] = v;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Chunk compression codecs (reference: ChunkCompressionType —
// pinot-segment-spi/.../compression/ChunkCompressionType.java:22 — backed
// there by JNI lz4/snappy/zstd libraries). Clean-room implementations of the
// public LZ4 block format and Snappy format specs; ZSTD/GZIP ride Python's
// zstandard/zlib on the host side (segment/compression.py).
// ---------------------------------------------------------------------------

extern "C" {

// ---- LZ4 block format -----------------------------------------------------
// Layout per sequence: token (hi nibble literal len, lo nibble match len-4,
// 15 = continued in 255-run bytes), literals, 2-byte LE offset, ext match
// len. Final sequence is literals-only. Spec constraints honored: last 5
// bytes are literals, no match starts within the last 12 bytes.

int64_t lz4_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                       int64_t dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        memcpy(op, ip, (size_t)lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // final literals-only sequence
        if (ip + 2 > iend) return -1;
        int64_t offset = (int64_t)ip[0] | ((int64_t)ip[1] << 8);
        ip += 2;
        if (offset == 0 || op - dst < offset) return -1;
        int64_t mlen = token & 15;
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (op + mlen > oend) return -1;
        const uint8_t* match = op - offset;
        for (int64_t i = 0; i < mlen; i++) op[i] = match[i];  // overlap-safe
        op += mlen;
    }
    return op - dst;
}

static bool lz4_emit(uint8_t*& op, uint8_t* oend, const uint8_t* src,
                     int64_t lit_start, int64_t lit_len, int64_t offset,
                     int64_t mlen) {
    uint8_t* token = op;
    if (op >= oend) return false;
    op++;
    int64_t l = lit_len;
    *token = (uint8_t)((l >= 15 ? 15 : l) << 4);
    if (l >= 15) {
        l -= 15;
        while (l >= 255) {
            if (op >= oend) return false;
            *op++ = 255;
            l -= 255;
        }
        if (op >= oend) return false;
        *op++ = (uint8_t)l;
    }
    if (op + lit_len > oend) return false;
    memcpy(op, src + lit_start, (size_t)lit_len);
    op += lit_len;
    if (offset) {
        int64_t ml = mlen - 4;
        if (op + 2 > oend) return false;
        *op++ = (uint8_t)(offset & 0xFF);
        *op++ = (uint8_t)(offset >> 8);
        if (ml >= 15) {
            *token |= 15;
            ml -= 15;
            while (ml >= 255) {
                if (op >= oend) return false;
                *op++ = 255;
                ml -= 255;
            }
            if (op >= oend) return false;
            *op++ = (uint8_t)ml;
        } else {
            *token |= (uint8_t)ml;
        }
    }
    return true;
}

// Greedy hash-chain-free LZ4 compressor (single-probe table, the classic
// fast-mode design). dst_cap must be >= n + n/255 + 16.
int64_t lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                     int64_t dst_cap) {
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    const int HASH_LOG = 16;
    std::vector<int64_t> table((size_t)1 << HASH_LOG, -1);
    int64_t anchor = 0;
    const int64_t mflimit = n - 12;
    int64_t i = 0;
    while (i < mflimit) {
        uint32_t v;
        memcpy(&v, src + i, 4);
        uint32_t h = (v * 2654435761u) >> (32 - HASH_LOG);
        int64_t cand = table[h];
        table[h] = i;
        uint32_t w;
        if (cand >= 0 && i - cand <= 65535) {
            memcpy(&w, src + cand, 4);
            if (v == w) {
                int64_t maxm = (n - 5) - i;  // keep last 5 bytes literal
                int64_t mlen = 4;
                while (mlen < maxm && src[cand + mlen] == src[i + mlen]) mlen++;
                if (!lz4_emit(op, oend, src, anchor, i - anchor, i - cand, mlen))
                    return -1;
                i += mlen;
                anchor = i;
                continue;
            }
        }
        i++;
    }
    if (!lz4_emit(op, oend, src, anchor, n - anchor, 0, 0)) return -1;
    return op - dst;
}

// ---- Snappy format --------------------------------------------------------
// Preamble: uncompressed length as varint. Elements: tag low 2 bits —
// 00 literal (len-1 in tag>>2, 60..63 → that many extra LE length bytes),
// 01 copy len 4..11 / 11-bit offset, 10 copy len 1..64 / 16-bit LE offset,
// 11 copy with 32-bit offset.

int64_t snappy_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                          int64_t dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + src_len;
    // varint preamble
    uint64_t expect = 0;
    int shift = 0;
    while (true) {
        if (ip >= iend || shift > 63) return -1;
        uint8_t b = *ip++;
        expect |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if ((int64_t)expect > dst_cap) return -1;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    while (ip < iend) {
        uint8_t tag = *ip++;
        int kind = tag & 3;
        if (kind == 0) {  // literal
            int64_t len = (tag >> 2) + 1;
            if (len > 60) {
                int extra = (int)len - 60;
                if (ip + extra > iend) return -1;
                len = 0;
                for (int b = 0; b < extra; b++)
                    len |= (int64_t)ip[b] << (8 * b);
                len += 1;
                ip += extra;
            }
            if (ip + len > iend || op + len > oend) return -1;
            memcpy(op, ip, (size_t)len);
            ip += len;
            op += len;
            continue;
        }
        int64_t len, offset;
        if (kind == 1) {
            len = ((tag >> 2) & 0x7) + 4;
            if (ip >= iend) return -1;
            offset = ((int64_t)(tag >> 5) << 8) | *ip++;
        } else if (kind == 2) {
            len = (tag >> 2) + 1;
            if (ip + 2 > iend) return -1;
            offset = (int64_t)ip[0] | ((int64_t)ip[1] << 8);
            ip += 2;
        } else {
            len = (tag >> 2) + 1;
            if (ip + 4 > iend) return -1;
            offset = (int64_t)ip[0] | ((int64_t)ip[1] << 8) |
                     ((int64_t)ip[2] << 16) | ((int64_t)ip[3] << 24);
            ip += 4;
        }
        if (offset == 0 || op - dst < offset || op + len > oend) return -1;
        const uint8_t* match = op - offset;
        for (int64_t b = 0; b < len; b++) op[b] = match[b];
        op += len;
    }
    return (op - dst) == (int64_t)expect ? (op - dst) : -1;
}

static bool snappy_emit_literal(uint8_t*& op, uint8_t* oend,
                                const uint8_t* src, int64_t start,
                                int64_t len) {
    while (len > 0) {
        int64_t chunk = len;  // literal lengths are unbounded via extra bytes
        int64_t l = chunk - 1;
        if (l < 60) {
            if (op + 1 + chunk > oend) return false;
            *op++ = (uint8_t)(l << 2);
        } else if (l < (1 << 8)) {
            if (op + 2 + chunk > oend) return false;
            *op++ = (uint8_t)(60 << 2);
            *op++ = (uint8_t)l;
        } else if (l < (1 << 16)) {
            if (op + 3 + chunk > oend) return false;
            *op++ = (uint8_t)(61 << 2);
            *op++ = (uint8_t)(l & 0xFF);
            *op++ = (uint8_t)(l >> 8);
        } else if (l < (1LL << 24)) {
            if (op + 4 + chunk > oend) return false;
            *op++ = (uint8_t)(62 << 2);
            *op++ = (uint8_t)(l & 0xFF);
            *op++ = (uint8_t)((l >> 8) & 0xFF);
            *op++ = (uint8_t)(l >> 16);
        } else {
            if (op + 5 + chunk > oend) return false;
            *op++ = (uint8_t)(63 << 2);
            *op++ = (uint8_t)(l & 0xFF);
            *op++ = (uint8_t)((l >> 8) & 0xFF);
            *op++ = (uint8_t)((l >> 16) & 0xFF);
            *op++ = (uint8_t)((l >> 24) & 0xFF);
        }
        memcpy(op, src + start, (size_t)chunk);
        op += chunk;
        start += chunk;
        len -= chunk;
    }
    return true;
}

static bool snappy_emit_copy(uint8_t*& op, uint8_t* oend, int64_t offset,
                             int64_t len) {
    // 16-bit-offset copies, 1..64 bytes each
    while (len > 0) {
        int64_t chunk = len > 64 ? 64 : len;
        if (len - chunk > 0 && len - chunk < 4) chunk = len - 4;  // keep ≥4 tail
        if (op + 3 > oend) return false;
        *op++ = (uint8_t)(((chunk - 1) << 2) | 2);
        *op++ = (uint8_t)(offset & 0xFF);
        *op++ = (uint8_t)(offset >> 8);
        len -= chunk;
    }
    return true;
}

// Greedy snappy compressor (16-bit offsets only; matches within 65535).
// dst_cap must be >= 32 + n + n/6.
int64_t snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t dst_cap) {
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    // varint preamble
    uint64_t v = (uint64_t)n;
    do {
        if (op >= oend) return -1;
        uint8_t b = (uint8_t)(v & 0x7F);
        v >>= 7;
        *op++ = v ? (b | 0x80) : b;
    } while (v);
    const int HASH_LOG = 16;
    std::vector<int64_t> table((size_t)1 << HASH_LOG, -1);
    int64_t anchor = 0, i = 0;
    while (i + 4 <= n) {
        uint32_t x;
        memcpy(&x, src + i, 4);
        uint32_t h = (x * 2654435761u) >> (32 - HASH_LOG);
        int64_t cand = table[h];
        table[h] = i;
        uint32_t y;
        if (cand >= 0 && i - cand <= 65535) {
            memcpy(&y, src + cand, 4);
            if (x == y) {
                int64_t mlen = 4;
                while (i + mlen < n && src[cand + mlen] == src[i + mlen]) mlen++;
                if (!snappy_emit_literal(op, oend, src, anchor, i - anchor))
                    return -1;
                if (!snappy_emit_copy(op, oend, i - cand, mlen)) return -1;
                i += mlen;
                anchor = i;
                continue;
            }
        }
        i++;
    }
    if (!snappy_emit_literal(op, oend, src, anchor, n - anchor)) return -1;
    return op - dst;
}

}  // extern "C"
