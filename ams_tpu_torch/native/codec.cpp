// Native model-delta codec (the PyTorch port's copy of ams_tpu/native).
//
// Replaces the reference's host-side payload path (run.py:316-333:
// np.packbits per var + fp16 cast + a `gzip -9` subprocess) with a single
// streaming pass: bit-packing, IEEE half conversion and DEFLATE (gzip
// container, level 9) happen in one traversal with no intermediate file and
// no process fork.
//
// Build: ams_tpu_torch/native/build.py, at first use (g++ -O3 -shared -fPIC
// -std=c++17 codec.cpp -lz)

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

// Round-to-nearest-even float32 -> float16, matching numpy's astype (any
// NaN -> the quiet NaN 0x7E00 with its sign).  The rounding is branch-free
// (F. Giesen's float_to_half_fast3_rtne): the subnormal range rounds by a
// float add of a magic constant, the normal range by an integer bias.
inline uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    const uint32_t sign = x & 0x80000000u;
    x ^= sign;
    uint32_t h;
    if (x >= (143u << 23)) {                    // >= 65536, inf or nan
        h = x > (255u << 23) ? 0x7E00u : 0x7C00u;
    } else if (x < (113u << 23)) {              // fp16 subnormal or zero
        const uint32_t magic_bits = 126u << 23;  // 0.5f
        float magic, y;
        std::memcpy(&magic, &magic_bits, 4);
        std::memcpy(&y, &x, 4);
        y += magic;
        std::memcpy(&h, &y, 4);
        h -= magic_bits;
    } else {
        const uint32_t mant_odd = (x >> 13) & 1u;
        x += (uint32_t)((15 - 127) << 23) + 0xFFFu + mant_odd;
        h = x >> 13;
    }
    return (uint16_t)(h | (sign >> 16));
}

struct GzWriter {
    z_stream zs{};
    uint8_t* out;
    long cap;
    long written = 0;
    bool error = false;
    uint8_t chunk[1 << 16];

    explicit GzWriter(uint8_t* out_, long cap_) : out(out_), cap(cap_) {
        // windowBits 15+16 selects the gzip container, level 9 = `gzip -9`.
        if (deflateInit2(&zs, 9, Z_DEFLATED, 15 + 16, 9,
                         Z_DEFAULT_STRATEGY) != Z_OK)
            error = true;
    }
    ~GzWriter() { deflateEnd(&zs); }

    void push(const uint8_t* data, size_t n, bool finish = false) {
        zs.next_in = const_cast<uint8_t*>(data);
        zs.avail_in = (uInt)n;
        do {
            zs.next_out = chunk;
            zs.avail_out = sizeof(chunk);
            int rc = deflate(&zs, finish ? Z_FINISH : Z_NO_FLUSH);
            if (rc == Z_STREAM_ERROR) { error = true; return; }
            long got = (long)(sizeof(chunk) - zs.avail_out);
            if (written + got > cap) { error = true; return; }
            std::memcpy(out + written, chunk, got);
            written += got;
        } while (zs.avail_out == 0 || (finish && zs.avail_in > 0));
        if (finish) {  // drain
            int rc;
            do {
                zs.next_out = chunk;
                zs.avail_out = sizeof(chunk);
                rc = deflate(&zs, Z_FINISH);
                long got = (long)(sizeof(chunk) - zs.avail_out);
                if (written + got > cap) { error = true; return; }
                std::memcpy(out + written, chunk, got);
                written += got;
            } while (rc != Z_STREAM_END && !error);
        }
    }
};

}  // namespace

extern "C" {

// Compress `n` bytes with gzip -9 semantics; returns compressed size or -1.
long ams_gzip9(const uint8_t* in, long n, uint8_t* out, long out_cap) {
    GzWriter w(out, out_cap);
    if (w.error) return -1;
    w.push(in, (size_t)n, true);
    return w.error ? -1 : w.written;
}

// Encode a full delta payload:
//   mask_bools: concatenated per-var boolean masks (1 byte per element)
//   values:     concatenated per-var float32 parameter values (same layout)
//   var_sizes:  element count per var, n_vars entries
//   tail:       raw bytes appended inside the same gzip stream after the
//               values section (the BN stats annex, stream/codec.py
//               STATS_MAGIC); tail_len 0 = no annex
// Layout matches run.py:316-333: all packed bitmasks first (byte-aligned per
// var, big-endian bit order like np.packbits), then all masked fp16 values.
// The raw payload is assembled in one buffer and deflated in one call:
// DEFLATE's output does not depend on how its input is chunked, so the
// bytes are those of a per-var streaming pass, without ~2 deflate calls
// per variable.
// Returns compressed byte count, or -1 on error/overflow.
long ams_encode_delta2(const uint8_t* mask_bools, const float* values,
                       const long* var_sizes, int n_vars,
                       const uint8_t* tail, long tail_len,
                       uint8_t* out, long out_cap) {
    long total = 0, mask_bytes = 0, n_set = 0;
    for (int v = 0; v < n_vars; ++v) {
        mask_bytes += (var_sizes[v] + 7) / 8;
        total += var_sizes[v];
    }
    for (long i = 0; i < total; ++i) n_set += mask_bools[i] != 0;
    const size_t raw_len = (size_t)(mask_bytes + 2 * n_set + tail_len);
    // 2 bytes of slack: every element's half is stored, and only the
    // masked ones advance the cursor (no branch on the mask)
    std::vector<uint8_t> raw(raw_len + 2);

    uint8_t* dst = raw.data();
    long off = 0;
    for (int v = 0; v < n_vars; ++v) {
        long n = var_sizes[v];
        const uint8_t* m = mask_bools + off;
        long i = 0;
        for (; i + 8 <= n; i += 8, m += 8)
            *dst++ = (uint8_t)(((m[0] != 0) << 7) | ((m[1] != 0) << 6) |
                               ((m[2] != 0) << 5) | ((m[3] != 0) << 4) |
                               ((m[4] != 0) << 3) | ((m[5] != 0) << 2) |
                               ((m[6] != 0) << 1) | (m[7] != 0));
        if (i < n) {
            uint8_t last = 0;
            for (int b = 0; i < n; ++i, ++b, ++m)
                last |= (uint8_t)((*m != 0) << (7 - b));
            *dst++ = last;
        }
        off += n;
    }

    for (long i = 0; i < total; ++i) {
        const uint16_t h = f32_to_f16(values[i]);
        std::memcpy(dst, &h, 2);
        dst += mask_bools[i] != 0 ? 2 : 0;
    }
    if (tail_len > 0) std::memcpy(dst, tail, (size_t)tail_len);
    return ams_gzip9(raw.data(), (long)raw_len, out, out_cap);
}

// Pre-annex entry point, kept so a stale caller against a rebuilt library
// still links; equivalent to ams_encode_delta2 with an empty tail.
long ams_encode_delta(const uint8_t* mask_bools, const float* values,
                      const long* var_sizes, int n_vars,
                      uint8_t* out, long out_cap) {
    return ams_encode_delta2(mask_bools, values, var_sizes, n_vars,
                             nullptr, 0, out, out_cap);
}

}  // extern "C"
