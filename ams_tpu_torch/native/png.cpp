// PNG row unfiltering (the PyTorch port's data layer).
//
// Undoes the five per-row filters of a decompressed, non-interlaced 8-bit
// image (PNG spec, section 9): None, Sub, Up, Average and Paeth, each row
// against the reconstructed row above it.  data/image.py::_unfilter is the
// plain numpy version, which runs Average and Paeth rows byte by byte.
//
// Build: ams_tpu_torch/native/build.py, at first use, into one library
// with codec.cpp.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// data: h rows of (1 filter byte + stride bytes); out: h * stride bytes.
// Returns 0, or -1 - r for row r whose filter byte is above 4.
long ams_png_unfilter(const uint8_t* data, long h, long stride, int bpp,
                      uint8_t* out) {
    for (long r = 0; r < h; ++r) {
        const uint8_t kind = data[r * (stride + 1)];
        const uint8_t* f = data + r * (stride + 1) + 1;
        uint8_t* o = out + r * stride;
        const uint8_t* up = r ? o - stride : nullptr;
        switch (kind) {
            case 0:
                for (long x = 0; x < stride; ++x) o[x] = f[x];
                break;
            case 1:
                for (long x = 0; x < stride; ++x)
                    o[x] = f[x] + (x >= bpp ? o[x - bpp] : 0);
                break;
            case 2:
                for (long x = 0; x < stride; ++x)
                    o[x] = f[x] + (up ? up[x] : 0);
                break;
            case 3:
                for (long x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? o[x - bpp] : 0;
                    const int b = up ? up[x] : 0;
                    o[x] = static_cast<uint8_t>(f[x] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (long x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? o[x - bpp] : 0;
                    const int b = up ? up[x] : 0;
                    const int c = (up && x >= bpp) ? up[x - bpp] : 0;
                    o[x] = static_cast<uint8_t>(f[x] + paeth(a, b, c));
                }
                break;
            default:
                return -1 - r;
        }
    }
    return 0;
}

}  // extern "C"
