// Copied from nyxus_tpu/native/src/zarr_codec.cpp less zlib: no <zlib.h>; a blosc block coded with zlib (codec 3) returns -4 and the caller inflates the container in Python (native/__init__.py blosc_decompress).
// Chunk codecs for the OME-Zarr reader: LZ4 block format and the c-blosc1
// container (byte-shuffle filter; lz4/zlib/memcpy codecs).
//
// The reference reads OME-Zarr through z5+blosc (reference: src/nyx/
// omezarr.h:10-48, CMake gate USE_Z5).  The TPU build keeps chunk decoding
// native but self-contained: numcodecs' default chunk encoding is
// Blosc(cname='lz4', shuffle=SHUFFLE), whose formats are small and stable.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// LZ4 block format

int nyx_lz4_decompress(const uint8_t* src, int srclen, uint8_t* dst,
                       int dstcap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + srclen;
    uint8_t* op = dst;
    uint8_t* oend = dst + dstcap;
    while (ip < iend) {
        uint8_t token = *ip++;
        // literals
        int lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        std::memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // last sequence has no match part
        // match
        if (ip + 2 > iend) return -1;
        int offset = ip[0] | (ip[1] << 8);
        ip += 2;
        if (offset == 0 || op - dst < offset) return -1;
        int mlen = (token & 0xF) + 4;
        if ((token & 0xF) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if (op + mlen > oend) return -1;
        const uint8_t* match = op - offset;
        for (int i = 0; i < mlen; i++) op[i] = match[i];  // may overlap
        op += mlen;
    }
    return (int)(op - dst);
}

// greedy hash-table compressor (valid LZ4 block stream; favors simplicity)
int nyx_lz4_compress(const uint8_t* src, int n, uint8_t* dst, int dstcap) {
    const int MINMATCH = 4, LASTLITERALS = 5;
    uint8_t* op = dst;
    uint8_t* oend = dst + dstcap;
    int anchor = 0, i = 0;
    std::vector<int> htab(1 << 16, -1);

    auto hash4 = [&](int p) {
        uint32_t v;
        std::memcpy(&v, src + p, 4);
        return (v * 2654435761u) >> 16;
    };
    auto emit = [&](int lit_start, int lit_len, int offset, int mlen) -> bool {
        int tok_extra = (lit_len >= 15 ? 1 + (lit_len - 15) / 255 : 0) +
                        (mlen >= 0 && mlen - 4 >= 15 ?
                         1 + (mlen - 4 - 15) / 255 : 0);
        if (op + 1 + tok_extra + lit_len + (mlen >= 0 ? 2 : 0) + 16 > oend)
            return false;
        uint8_t* tok = op++;
        int l = lit_len;
        *tok = (uint8_t)((l >= 15 ? 15 : l) << 4);
        if (l >= 15) {
            l -= 15;
            while (l >= 255) { *op++ = 255; l -= 255; }
            *op++ = (uint8_t)l;
        }
        std::memcpy(op, src + lit_start, lit_len);
        op += lit_len;
        if (mlen >= 0) {
            *op++ = (uint8_t)(offset & 0xFF);
            *op++ = (uint8_t)(offset >> 8);
            int m = mlen - MINMATCH;
            *tok |= (uint8_t)(m >= 15 ? 15 : m);
            if (m >= 15) {
                m -= 15;
                while (m >= 255) { *op++ = 255; m -= 255; }
                *op++ = (uint8_t)m;
            }
        }
        return true;
    };

    while (i + MINMATCH + LASTLITERALS <= n) {
        uint32_t h = hash4(i);
        int cand = htab[h];
        htab[h] = i;
        if (cand >= 0 && i - cand <= 65535 &&
            std::memcmp(src + cand, src + i, MINMATCH) == 0) {
            int mlen = MINMATCH;
            while (i + mlen < n - LASTLITERALS &&
                   src[cand + mlen] == src[i + mlen])
                mlen++;
            if (!emit(anchor, i - anchor, i - cand, mlen)) return -1;
            i += mlen;
            anchor = i;
        } else {
            i++;
        }
    }
    if (!emit(anchor, n - anchor, 0, -1)) return -1;  // trailing literals
    return (int)(op - dst);
}

// ---------------------------------------------------------------------------
// byte shuffle (blosc filter): out[j*len/ts + k] = in[k*ts + j]

static void unshuffle(const uint8_t* in, uint8_t* out, int nbytes, int ts) {
    if (ts <= 1 || nbytes % ts != 0) {
        std::memcpy(out, in, nbytes);
        return;
    }
    int ne = nbytes / ts;
    for (int j = 0; j < ts; j++)
        for (int k = 0; k < ne; k++)
            out[k * ts + j] = in[j * ne + k];
}

static void shuffle_bytes(const uint8_t* in, uint8_t* out, int nbytes,
                          int ts) {
    if (ts <= 1 || nbytes % ts != 0) {
        std::memcpy(out, in, nbytes);
        return;
    }
    int ne = nbytes / ts;
    for (int j = 0; j < ts; j++)
        for (int k = 0; k < ne; k++)
            out[j * ne + k] = in[k * ts + j];
}

// ---------------------------------------------------------------------------
// c-blosc1 container

static int32_t rd32(const uint8_t* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only (x86/TPU VM)
}

// returns decompressed byte count or -1
int nyx_blosc_decompress(const uint8_t* src, int srclen, uint8_t* dst,
                         int dstcap) {
    if (srclen < 16) return -1;
    uint8_t flags = src[2];
    int typesize = src[3];
    int32_t nbytes = rd32(src + 4);
    int32_t blocksize = rd32(src + 8);
    if (nbytes == 0) return 0;
    if (nbytes < 0 || nbytes > dstcap || blocksize <= 0) return -1;
    bool shuffled = flags & 0x1;
    bool memcpyed = flags & 0x2;
    if (flags & 0x4) return -2;  // bitshuffle unsupported
    int codec = (flags >> 5) & 0x7;  // 0 blosclz, 1 lz4/lz4hc, 3 zlib

    if (memcpyed) {
        if (srclen < 16 + nbytes) return -1;
        if (shuffled)
            unshuffle(src + 16, dst, nbytes, typesize);
        else
            std::memcpy(dst, src + 16, nbytes);
        return nbytes;
    }

    int nblocks = (nbytes + blocksize - 1) / blocksize;
    if (srclen < 16 + 4 * nblocks) return -1;
    std::vector<uint8_t> tmp(blocksize);
    for (int b = 0; b < nblocks; b++) {
        int32_t bstart = rd32(src + 16 + 4 * b);
        if (bstart < 0 || bstart + 4 > srclen) return -1;
        int32_t cbytes = rd32(src + bstart);
        const uint8_t* bsrc = src + bstart + 4;
        int neblock = (b == nblocks - 1) ? nbytes - b * blocksize : blocksize;
        uint8_t* bout = shuffled ? tmp.data() : dst + b * blocksize;
        if (cbytes == neblock) {           // stored uncompressed
            if (bstart + 4 + cbytes > srclen) return -1;
            std::memcpy(bout, bsrc, neblock);
        } else if (codec == 1) {           // lz4
            if (nyx_lz4_decompress(bsrc, cbytes, bout, neblock) != neblock)
                return -1;
        } else if (codec == 3) {           // zlib
            return -4;                     // inflated by the caller
        } else {
            return -3;                     // blosclz/snappy/zstd unsupported
        }
        if (shuffled)
            unshuffle(tmp.data(), dst + b * blocksize, neblock, typesize);
    }
    return nbytes;
}

// single-block blosc1+lz4 writer (mechanics tests & write_zarr)
int nyx_blosc_compress_lz4(const uint8_t* src, int n, int typesize,
                           int doshuffle, uint8_t* dst, int dstcap) {
    if (dstcap < 16 + 4 + n + n / 128 + 64) return -1;
    if (n == 0) {                     // header-only container
        std::memset(dst, 0, 16);
        dst[0] = 2;
        dst[1] = 1;
        dst[3] = (uint8_t)typesize;
        int32_t total = 16;
        std::memcpy(dst + 12, &total, 4);
        return total;
    }
    dst[0] = 2;                       // format version
    dst[1] = 1;
    dst[2] = (uint8_t)((doshuffle ? 0x1 : 0) | (1 << 5));  // lz4
    dst[3] = (uint8_t)typesize;
    std::memcpy(dst + 4, &n, 4);
    std::memcpy(dst + 8, &n, 4);      // one block
    std::vector<uint8_t> buf(n);
    const uint8_t* payload = src;
    if (doshuffle) {
        shuffle_bytes(src, buf.data(), n, typesize);
        payload = buf.data();
    }
    int32_t bstart = 20;
    std::memcpy(dst + 16, &bstart, 4);
    int cb = nyx_lz4_compress(payload, n, dst + 24, dstcap - 24);
    if (cb < 0 || cb >= n) {          // incompressible: store
        std::memcpy(dst + 24, payload, n);
        cb = n;
    }
    std::memcpy(dst + 20, &cb, 4);
    int32_t total = 24 + cb;
    std::memcpy(dst + 12, &total, 4);
    return total;
}

}  // extern "C"
