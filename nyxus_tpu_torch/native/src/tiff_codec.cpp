// TIFF LZW codec and horizontal differencing (Predictor 2) for the port's
// libtiff-free TIFF reader and writer (nyxus_tpu_torch/io/tiff.py).
//
// LZW is the TIFF 6.0 variant that libtiff reads and writes: codes packed
// MSB-first, ClearCode 256, EndOfInformation 257, the first free code 258,
// widths from 9 to 12 bits switched one code early (the decoder widens
// when the next free code reaches 2^w - 1).  Every strip or tile is its
// own stream and starts with a fresh dictionary.  The encoder emits a
// ClearCode first, and again when the table is full (free code 4094), as
// libtiff does; it does not reset on libtiff's compression-ratio check,
// which no decoder needs.
//
// Predictor 2 differences whole samples along a row, per channel, modulo
// 2^bits, with the samples in the file's byte order.
//
// All functions are extern "C" for ctypes binding; none allocates memory
// visible to the caller.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxBits = 12;
constexpr int kTableSize = 1 << kMaxBits;   // 4096 codes

struct BitWriter {
    uint8_t* out;
    int64_t cap;
    int64_t pos = 0;
    uint32_t acc = 0;
    int nacc = 0;
    bool overflow = false;

    void put(int code, int nbits) {
        acc = (acc << nbits) | (uint32_t)code;
        nacc += nbits;
        while (nacc >= 8) {
            nacc -= 8;
            if (pos < cap) out[pos++] = (uint8_t)(acc >> nacc);
            else overflow = true;
        }
        acc &= (1u << nacc) - 1u;
    }
    void flush() {
        if (nacc > 0) {
            if (pos < cap) out[pos++] = (uint8_t)(acc << (8 - nacc));
            else overflow = true;
            nacc = 0;
            acc = 0;
        }
    }
};

// Open-addressed (prefix code, byte) -> code table of the encoder; a
// reset clears it in one memset.
constexpr int kHashSize = 1 << 14;

struct EncodeTable {
    int32_t key[kHashSize];
    uint16_t code[kHashSize];
    void clear() { std::memset(key, 0xff, sizeof(key)); }
    static uint32_t slot(int32_t k) {
        return ((uint32_t)k * 2654435761u) >> (32 - 14);
    }
    int find(int32_t k) const {
        for (uint32_t s = slot(k);; s = (s + 1) & (kHashSize - 1)) {
            if (key[s] == k) return code[s];
            if (key[s] < 0) return -1;
        }
    }
    void insert(int32_t k, int c) {
        uint32_t s = slot(k);
        while (key[s] >= 0) s = (s + 1) & (kHashSize - 1);
        key[s] = k;
        code[s] = (uint16_t)c;
    }
};

template <typename T>
T load(const uint8_t* p, bool big) {
    T v = 0;
    if (big) {
        for (size_t b = 0; b < sizeof(T); b++) v = (T)((v << 8) | p[b]);
    } else {
        for (size_t b = sizeof(T); b-- > 0;) v = (T)((v << 8) | p[b]);
    }
    return v;
}

template <typename T>
void store(uint8_t* p, T v, bool big) {
    for (size_t b = 0; b < sizeof(T); b++) {
        size_t at = big ? sizeof(T) - 1 - b : b;
        p[at] = (uint8_t)(v & 0xff);
        v = (T)(v >> 8);
    }
}

// undo (accumulate) or apply (difference) Predictor 2 over ``rows`` rows
// of ``width`` pixels of ``spp`` samples of type T
template <typename T>
void hdiff(uint8_t* buf, int64_t rows, int64_t width, int spp, bool big,
           bool undo) {
    const int64_t stride = width * spp;
    const size_t sz = sizeof(T);
    for (int64_t r = 0; r < rows; r++) {
        uint8_t* row = buf + (size_t)(r * stride) * sz;
        if (undo) {
            for (int64_t i = spp; i < stride; i++) {
                T prev = load<T>(row + (size_t)(i - spp) * sz, big);
                T cur = load<T>(row + (size_t)i * sz, big);
                store<T>(row + (size_t)i * sz, (T)(cur + prev), big);
            }
        } else {
            for (int64_t i = stride - 1; i >= spp; i--) {
                T prev = load<T>(row + (size_t)(i - spp) * sz, big);
                T cur = load<T>(row + (size_t)i * sz, big);
                store<T>(row + (size_t)i * sz, (T)(cur - prev), big);
            }
        }
    }
}

int hdiff_dispatch(uint8_t* buf, int64_t rows, int64_t width, int spp,
                   int bytes_per_sample, int big_endian, bool undo) {
    if (rows < 0 || width < 0 || spp < 1) return -1;
    bool big = big_endian != 0;
    switch (bytes_per_sample) {
        case 1: hdiff<uint8_t>(buf, rows, width, spp, big, undo); return 0;
        case 2: hdiff<uint16_t>(buf, rows, width, spp, big, undo); return 0;
        case 4: hdiff<uint32_t>(buf, rows, width, spp, big, undo); return 0;
        case 8: hdiff<uint64_t>(buf, rows, width, spp, big, undo); return 0;
    }
    return -1;
}

}  // namespace

extern "C" {

// Decode one LZW strip or tile.  Returns the bytes written to ``out``
// (at most ``cap``: decoding stops once ``out`` is full, at
// EndOfInformation or at the end of the input), or -1 when the stream
// holds a code that is not yet in the table.
int64_t nyx_lzw_decode(const uint8_t* in, int64_t n_in, uint8_t* out,
                       int64_t cap) {
    std::vector<uint16_t> prefix(kTableSize);
    std::vector<uint8_t> suffix(kTableSize), first(kTableSize);
    std::vector<uint32_t> length(kTableSize);
    for (int c = 0; c < 256; c++) {
        prefix[c] = 0;
        suffix[c] = first[c] = (uint8_t)c;
        length[c] = 1;
    }
    int64_t ip = 0, op = 0;
    uint32_t acc = 0;
    int nacc = 0;
    int nbits = 9;
    int free_code = kFirst;
    int old = -1;   // previous code; -1 right after a ClearCode
    while (op < cap) {
        while (nacc < nbits && ip < n_in) {
            acc = (acc << 8) | in[ip++];
            nacc += 8;
        }
        if (nacc < nbits) break;            // input exhausted, no EOI
        int code = (int)((acc >> (nacc - nbits)) & ((1u << nbits) - 1u));
        nacc -= nbits;
        acc &= (1u << nacc) - 1u;
        if (code == kEoi) break;
        if (code == kClear) {
            nbits = 9;
            free_code = kFirst;
            old = -1;
            continue;
        }
        if (old < 0) {
            if (code > 255) return -1;
            out[op++] = (uint8_t)code;
            old = code;
            continue;
        }
        if (code > free_code) return -1;
        // the string of ``code`` (or, when code is the next free code, the
        // previous string and its own first byte)
        uint8_t head = code < free_code ? first[code] : first[old];
        if (free_code < kTableSize) {
            prefix[free_code] = (uint16_t)old;
            suffix[free_code] = head;
            first[free_code] = first[old];
            length[free_code] = length[old] + 1;
            free_code++;
        }
        int64_t len = length[code];
        int64_t end = op + len;
        int c = code;
        // write the string back to front, dropping what passes ``cap``
        for (int64_t k = end - 1; k >= op; k--) {
            if (k < cap) out[k] = suffix[c];
            c = prefix[c];
        }
        op = end < cap ? end : cap;
        old = code;
        if (free_code + 1 >= (1 << nbits) && nbits < kMaxBits) nbits++;
    }
    return op;
}

// Encode ``n_in`` bytes as one LZW strip or tile.  Returns the bytes
// written to ``out``, or -1 when ``cap`` is too small.
int64_t nyx_lzw_encode(const uint8_t* in, int64_t n_in, uint8_t* out,
                       int64_t cap) {
    std::vector<EncodeTable> holder(1);
    EncodeTable& tab = holder[0];
    tab.clear();
    BitWriter bw{out, cap};
    int nbits = 9;
    int free_code = kFirst;
    bw.put(kClear, nbits);
    if (n_in > 0) {
        int ent = in[0];
        for (int64_t i = 1; i < n_in; i++) {
            int c = in[i];
            int32_t k = (ent << 8) | c;
            int hit = tab.find(k);
            if (hit >= 0) {
                ent = hit;
                continue;
            }
            bw.put(ent, nbits);
            ent = c;
            tab.insert(k, free_code++);
            if (free_code == kTableSize - 2) {
                bw.put(kClear, nbits);
                tab.clear();
                free_code = kFirst;
                nbits = 9;
            } else if (free_code > (1 << nbits) - 1) {
                nbits++;
            }
        }
        bw.put(ent, nbits);
        free_code++;
        if (free_code == kTableSize - 2) {
            bw.put(kClear, nbits);
            nbits = 9;
        } else if (free_code > (1 << nbits) - 1) {
            nbits++;
        }
    }
    bw.put(kEoi, nbits);
    bw.flush();
    return bw.overflow ? -1 : bw.pos;
}

// Undo Predictor 2 in place: rows of ``width`` pixels of ``spp`` samples of
// ``bytes_per_sample`` (1, 2, 4 or 8) bytes in the given byte order.
// Returns 0, or -1 for an unsupported sample size.
int nyx_hdiff_decode(uint8_t* buf, int64_t rows, int64_t width, int spp,
                     int bytes_per_sample, int big_endian) {
    return hdiff_dispatch(buf, rows, width, spp, bytes_per_sample, big_endian,
                          true);
}

// Apply Predictor 2 in place (the inverse of nyx_hdiff_decode).
int nyx_hdiff_encode(uint8_t* buf, int64_t rows, int64_t width, int spp,
                     int bytes_per_sample, int big_endian) {
    return hdiff_dispatch(buf, rows, width, spp, bytes_per_sample, big_endian,
                          false);
}

}  // extern "C"
