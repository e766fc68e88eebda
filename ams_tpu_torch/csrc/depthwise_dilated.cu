// Dilated depthwise 3x3 convolution, stride 1, bf16 channels-last, sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves its depthwise convolutions
// to XLA (ams_tpu/models/layers.py depthwise_conv2d), and so did the port,
// through F.conv2d(groups=C) and cuDNN.  On an H100 cuDNN's grouped direct
// kernel for bf16 NHWC is 24x slower at rate 2 than at rate 1 (8.63 ms
// against 0.359 ms at 8x728x129x257, 2.7% of its bound by bytes), and the
// teacher at output stride 8 runs 57 dilated depthwise convolutions per
// chunk.  For x (N, H, W, C) bf16, w (3, 3, C) bf16, rate r and a
// symmetric zero padding (ph, pw) it computes
//
//     y[n, oy, ox, c] = sum_{ky, kx} w[ky, kx, c]
//                       * x[n, oy - ph + ky r, ox - pw + kx r, c]
//
// (zero outside x), summed in f32 and rounded to bf16 once, at the store.
// An optional epilogue adds a per-channel f32 bias b[c] and then, if asked,
// takes the ReLU, both in f32 before that one rounding: the teacher's inference BN,
// folded into w, leaves its offset here (models/xception_deeplab.py).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): bytes.  Each output needs 9 multiply-adds (18 operations) and
// 4 bytes of traffic (its input read once, itself written once, bf16), so
// the kernel needs 4.5 operations per byte against the card's 20: at the
// teacher's 57 shapes per OS8 chunk, 50.6 GB, 15.1 ms, against 3.4 ms of
// operations.  The aim is to read each input element from device memory
// about once, whatever the rate.
//
// Design.
//   - Sub-lattices.  A rate-r 3x3 convolution is r^2 independent rate-1
//     3x3 convolutions: the outputs with oy = py (mod r), ox = px (mod r)
//     read only the inputs of one residue class in each axis, with the
//     same taps and the same zero padding.  blockIdx.y is the sub-lattice
//     (py, px); the kernel indexes it in place, no space-to-batch copy.
//   - One thread, one channel pair, kCols output columns of its
//     sub-lattice (kCols + 2 input columns), down a strip of the sub-lattice's rows.  It
//     keeps three input rows in registers as f32 (a ring, indexed
//     statically by unrolling the row loop six times) and reads each new
//     row once: no input is read twice by one thread, across rows or
//     columns.  Rows and columns outside the input are zeros, never read:
//     any symmetric padding, e.g. (r, r) for TF's SAME at stride 1 and
//     (r, 0) on a width shard's column window, with no F.pad copy.
//   - Loads.  A thread loads 4 bytes (two bf16 channels); neighbouring
//     threads take neighbouring channel pairs of one pixel, so a warp reads
//     128 contiguous bytes whatever the rate, and the r-pixel stride
//     between a thread's columns costs nothing in coalescing.  Two rows
//     are in flight ahead of the row being computed.
//   - Weights.  The thread's 9 taps of its two channels, in registers as
//     f32 for the whole strip.
//   - Epilogue.  A template parameter each for the bias and the ReLU, so
//     the bias-free instantiation (the student's) is the kernel as it was
//     (three instantiations: none, bias, bias and ReLU);
//     with a bias, the thread's two channels' values sit in registers for
//     the whole strip.
//   - Filling the card.  blockIdx.x cuts the (column group, channel pair)
//     pairs of a sub-lattice into blocks of kThreads; blockIdx.z is the
//     image and the row strip.  The host's plan cuts the rows into strips
//     only where the grid would otherwise leave SMs idle.
//
// Plain C interface (no PyTorch header): the caller passes raw device
// pointers and PyTorch's current stream, and reads cudaGetLastError() back
// as the return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 128 threads, five blocks an SM (96 registers a thread), 4 output
// columns a thread: the fastest of threads 64/128/256, blocks 4/5/6 and
// columns 2/4/8 at every cell shape on an H100 (PERF.md).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 5;
constexpr int kCols = 4;

__device__ __forceinline__ float lo_bf16(uint32_t p) {
    return __uint_as_float(p << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t p) {
    return __uint_as_float(p & 0xffff0000u);
}

// Round both to bf16 (to nearest, ties to even), a in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}

struct Walk {
    const uint32_t* xn;      // the image's input, in channel pairs
    int iy0, r, h, rowlen;   // input row of sub-lattice row 0; row length
    int m_end;               // rows at and past it are not needed
    int cofs[kCols + 2];     // column offsets within a row
    unsigned cmask;          // columns inside the input

    __device__ __forceinline__ void load(int m,
                                         uint32_t (&raw)[kCols + 2]) const {
        const int iy = iy0 + r * m;
        const bool rv = m < m_end && iy >= 0 && iy < h;
        const uint32_t* row = xn + (size_t)(rv ? iy : 0) * rowlen;
#pragma unroll
        for (int q = 0; q < kCols + 2; ++q)
            raw[q] = (rv && ((cmask >> q) & 1u)) ? __ldg(row + cofs[q]) : 0u;
    }
};

__device__ __forceinline__ void widen(const uint32_t (&raw)[kCols + 2],
                                      float (&row)[kCols + 2][2]) {
#pragma unroll
    for (int q = 0; q < kCols + 2; ++q) {
        row[q][0] = lo_bf16(raw[q]);
        row[q][1] = hi_bf16(raw[q]);
    }
}

template <bool kBias, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
depthwise_dilated_kernel(const uint32_t* __restrict__ x,
                         const uint32_t* __restrict__ wt,
                         const float2* __restrict__ bias,
                         uint32_t* __restrict__ y, int h, int w, int c2,
                         int ho, int wo, int r, int ph, int pw, int strips,
                         int strip_rows) {
    const int f = blockIdx.x * kThreads + threadIdx.x;
    const int g = f / c2;
    const int v = f - g * c2;
    const int py = blockIdx.y / r;
    const int px = blockIdx.y - py * r;
    const int n = blockIdx.z / strips;
    const int i0 = (blockIdx.z - n * strips) * strip_rows;
    const int hs = (ho - py + r - 1) / r;      // this sub-lattice's rows
    const int ws = (wo - px + r - 1) / r;      // ... and columns
    const int j0 = g * kCols;
    const int i1 = min(hs, i0 + strip_rows);
    if (j0 >= ws || i0 >= i1) return;

    float k[9][2];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        const uint32_t p = __ldg(wt + t * c2 + v);
        k[t][0] = lo_bf16(p);
        k[t][1] = hi_bf16(p);
    }
    float2 b = make_float2(0.f, 0.f);
    if (kBias) b = __ldg(bias + v);

    Walk walk;
    walk.rowlen = w * c2;
    walk.xn = x + (size_t)n * h * walk.rowlen;
    walk.iy0 = py - ph;
    walk.r = r;
    walk.h = h;
    walk.m_end = i1 + 2;
    walk.cmask = 0;
#pragma unroll
    for (int q = 0; q < kCols + 2; ++q) {
        const int ix = px - pw + r * (j0 + q);
        const bool ok = ix >= 0 && ix < w;
        walk.cofs[q] = ok ? ix * c2 + v : 0;
        walk.cmask |= (unsigned)ok << q;
    }
    const int outlen = wo * c2;
    uint32_t* yn = y + (size_t)n * ho * outlen;
    const int ofs0 = (px + r * j0) * c2 + v;
    const int nout = min(kCols, ws - j0);

    // Input row m of the sub-lattice (iy = py - ph + r m) is ring slot
    // (m - i0) % 3; rows i0 + 2 and i0 + 3 wait in raw[0] and raw[1].
    float ring[3][kCols + 2][2];
    uint32_t raw[2][kCols + 2];
    walk.load(i0, raw[0]);
    walk.load(i0 + 1, raw[1]);
    widen(raw[0], ring[0]);
    widen(raw[1], ring[1]);
    walk.load(i0 + 2, raw[0]);
    walk.load(i0 + 3, raw[1]);

    for (int i = i0; i < i1; i += 6) {
#pragma unroll
        for (int s = 0; s < 6; ++s) {
            if (i + s < i1) {
                // row i + s + 2 has arrived; fetch row i + s + 4 in its place
                widen(raw[s % 2], ring[(s + 2) % 3]);
                walk.load(i + s + 4, raw[s % 2]);
                const float (&r0)[kCols + 2][2] = ring[s % 3];
                const float (&r1)[kCols + 2][2] = ring[(s + 1) % 3];
                const float (&r2)[kCols + 2][2] = ring[(s + 2) % 3];
                uint32_t* yrow = yn + (size_t)(py + r * (i + s)) * outlen
                                 + ofs0;
#pragma unroll
                for (int jj = 0; jj < kCols; ++jj) {
                    float a[2];
#pragma unroll
                    for (int ch = 0; ch < 2; ++ch) {
                        float acc = 0.f;
#pragma unroll
                        for (int kx = 0; kx < 3; ++kx)
                            acc = fmaf(k[kx][ch], r0[jj + kx][ch], acc);
#pragma unroll
                        for (int kx = 0; kx < 3; ++kx)
                            acc = fmaf(k[3 + kx][ch], r1[jj + kx][ch], acc);
#pragma unroll
                        for (int kx = 0; kx < 3; ++kx)
                            acc = fmaf(k[6 + kx][ch], r2[jj + kx][ch], acc);
                        if (kBias) acc += ch ? b.y : b.x;
                        // NaN stays NaN, as torch.relu leaves it
                        if (kRelu) acc = acc < 0.f ? 0.f : acc;
                        a[ch] = acc;
                    }
                    if (jj < nout) yrow[jj * r * c2] = pack_bf16(a[0], a[1]);
                }
            }
        }
    }
}

template <bool kBias, bool kRelu>
void launch(const dim3& grid, cudaStream_t stream, const void* x,
            const void* w, const void* bias, void* y, int h, int wdt, int c2,
            int ho, int wo, int r, int ph, int pw, int strips,
            int strip_rows) {
    depthwise_dilated_kernel<kBias, kRelu><<<grid, kThreads, 0, stream>>>(
        (const uint32_t*)x, (const uint32_t*)w, (const float2*)bias,
        (uint32_t*)y, h, wdt, c2, ho, wo, r, ph, pw, strips, strip_rows);
}

}  // namespace

// x: (n, h, wdt, c) bf16, contiguous; w: (3, 3, c) bf16, contiguous;
// bias: (c,) f32 on an 8-byte boundary, or null for none; relu: nonzero
// for a ReLU after the bias (only with one); y: (n, ho, wo, c) bf16 with ho = h + 2 ph - 2 r,
// wo = wdt + 2 pw - 2 r.
// c even; the rows of each sub-lattice cut into `strips` strips of
// `strip_rows`.  The host checks the sizes (ops/depthwise_dilated.py):
// grid.y = r^2 and grid.z = n * strips below 65536, one image below 2^31
// elements.
extern "C" int depthwise_dilated_launch(const void* x, const void* w,
                                        const void* bias, void* y, int n,
                                        int c, int h, int wdt, int ho,
                                        int wo, int r, int ph, int pw,
                                        int strips, int strip_rows, int relu,
                                        void* stream) {
    if (c < 2 || c % 2 || r < 1 || ph < 0 || pw < 0 || strips < 1
        || strip_rows < 1 || (relu && !bias))
        return (int)cudaErrorInvalidValue;
    if ((long long)n * ho * wo == 0) return 0;
    const int c2 = c / 2;
    const long long ws = (wo + r - 1) / r;     // the widest sub-lattice
    const long long pairs = (ws + kCols - 1) / kCols * c2;
    const dim3 grid((unsigned)((pairs + kThreads - 1) / kThreads),
                    (unsigned)(r * r), (unsigned)(n * strips));
    const cudaStream_t s = (cudaStream_t)stream;
    if (!bias)
        launch<false, false>(grid, s, x, w, bias, y, h, wdt, c2, ho, wo, r,
                             ph, pw, strips, strip_rows);
    else if (relu)
        launch<true, true>(grid, s, x, w, bias, y, h, wdt, c2, ho, wo, r, ph,
                           pw, strips, strip_rows);
    else
        launch<true, false>(grid, s, x, w, bias, y, h, wdt, c2, ho, wo, r,
                            ph, pw, strips, strip_rows);
    return (int)cudaGetLastError();
}
