// Fused align-corners bilinear upsample + per-pixel class argmax, sm_90a.
//
// Replaces the Pallas TPU kernel ams_tpu/ops/fused_resize_argmax.py::_kernel
// (launched by fused_resize_argmax there).  For grid logits L (B, C, gh,
// gw) and an optional class table cls (n_sel ids into C) it computes
//
//     out[b, y, x] = argmax_k resize_bilinear_ac(L)[b, cls[k], y, x]
//
// without writing the full-resolution logits: only int32 ids leave the
// kernel.  Ties keep the lowest k (a strict `>`), as _kernel and
// torch.argmax do.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), reckoned from shapes, at the client's B=8, C=19, 33x65 ->
// 512x1024: 1.30 MB of f32 grid read, 16.8 MB of int32 ids written, 5.4
// us; the separable lerp (3 operations per grid-row sample and per pixel,
// each class) and a compare per pixel and class, 0.45 G operations, 6.7
// us at the f32 peak counted that way.  Built with --fmad=false (so the
// values round as the plain version's do) each multiply and add issues on
// its own, and the floor of this design is its instruction count: per
// pixel and class a multiply, an add, a compare and two selects, ~0.4 G
// thread instructions at full width, the last three on the half-rate
// integer/logic pipe.  It takes 0.031 ms on an H100 80GB HBM3 at 700 W,
// 5.7x the bound (chip_smoke.py; PERF.md).
//
// Design.  The TPU kernel runs two MXU matmuls per class and row tile; a
// GPU thread does better with the direct form, laid out so that nothing
// is computed twice:
//   - Bands.  Output rows with one ylo form a band (contiguous; empty when
//     H < gh; one row where ylo == yhi).  Every row of a band lerps between
//     the same two grid rows, so their horizontal lerps are shared.  The
//     host's plan lists the non-empty bands, cut into runs of at most 32
//     rows (so a small gh still gives many blocks), as (top grid row,
//     bottom grid row, first row, end row).
//   - One block per (column tile, band run, image), from blockIdx; one
//     thread per output column.  No division and no 64-bit index math per
//     pixel.
//   - Per class the thread loads its column's four taps once and keeps
//     top = left + (right - left) xw and d = (the same on the bottom row)
//     - top in registers, the operation order of the port's
//     models/resize.py (as K2's lerp_rows), so top + d yw is the plain
//     version's value bit for bit.  Then it walks the band's rows: per
//     class a multiply, an add and the compare/select of a running
//     (best, idx), and one streaming int32 store per row (a warp's stores
//     are 128 contiguous bytes).  No loads in the row loop but yw[y].
//   - Classes.  A compile-time bound (4, 8, ..., 32) sizes the register
//     arrays; the classes past n_sel get top = -inf, d = 0, which never
//     win a strict `>`, so the row loop has no branch per class.  Above 32
//     classes the same kernel walks the classes in chunks of 32, each
//     row's running (best, idx) kept between chunks in the thread's own
//     column of shared memory (2 x 32 rows x threads words; no bank
//     conflicts, no barrier): the same comparisons in the same order, so
//     the same ids, for any class count.
//   - The grid as the forward leaves it: float32 or bfloat16 (widened
//     exactly), read through its four strides (NCHW or channels-last in
//     place), with the class table applied at the load.  So the caller
//     launches no cast, gather or copy before this kernel.
//
// Plain C interface (no PyTorch header): the caller passes raw device
// pointers and PyTorch's current stream, and reads cudaGetLastError() back
// as the return value.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kChunk = 32;        // classes per chunk above 32
constexpr int kMaxRows = 32;      // rows of a band run: the host plan's
                                  // MAX_BAND_ROWS

__device__ __forceinline__ float tap(const float* p) { return __ldg(p); }

// bfloat16 is the top half of a float32: widening is a shift, exact.
__device__ __forceinline__ float tap(const unsigned short* p) {
    return __uint_as_float((unsigned)__ldg(p) << 16);
}

// The two horizontal lerps of one class at one column: top on the band's
// top grid row, d = (the same on the bottom row) - top.
template <typename T>
__device__ __forceinline__ void lerp_rows(const T* r0, const T* r1, int o0,
                                          int o1, float wx, float& top,
                                          float& d) {
    const float tl = tap(r0 + o0), tr = tap(r0 + o1);
    const float bl = tap(r1 + o0), br = tap(r1 + o1);
    top = tl + (tr - tl) * wx;
    d = (bl + (br - bl) * wx) - top;
}

// Registers top[k], d[k] for classes k0 .. k0 + N - 1 (padding past n_sel).
template <int N, typename T>
__device__ __forceinline__ void load_classes(const T* r0, const T* r1,
                                             int o0, int o1, float wx,
                                             const int* cls, int sc, int k0,
                                             int n_sel, float* top,
                                             float* d) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const int kk = k0 + k;
        if (kk < n_sel) {
            const int off = (cls ? __ldg(cls + kk) : kk) * sc;
            lerp_rows(r0 + off, r1 + off, o0, o1, wx, top[k], d[k]);
        } else {
            top[k] = -INFINITY;
            d[k] = 0.f;
        }
    }
}

// bands: 4 ints per band run (top grid row, bottom grid row, ys, ye);
// strides in elements; cls: n_sel class ids into C, or NULL for 0 ..
// n_sel - 1.  MAXC: the register bound on n_sel, or 0 for chunks of 32.
template <typename T, int MAXC>
__global__ void __launch_bounds__(kMaxThreads)
resize_argmax_band(const T* __restrict__ grid, long long sb, int sc, int sy,
                   int sx, const int* __restrict__ cls, int n_sel,
                   const int* __restrict__ bands,
                   const int* __restrict__ xlo, const int* __restrict__ xhi,
                   const float* __restrict__ xw,
                   const float* __restrict__ yw, int* __restrict__ out,
                   int H, int W) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= W) return;              // no barrier below
    const int* band = bands + 4 * blockIdx.y;
    const int ys = band[2], ye = band[3];
    const T* g = grid + blockIdx.z * sb;
    const T* r0 = g + band[0] * sy;
    const T* r1 = g + band[1] * sy;
    const int o0 = __ldg(xlo + x) * sx, o1 = __ldg(xhi + x) * sx;
    const float wx = __ldg(xw + x);
    int* o = out + (long long)blockIdx.z * H * W + x;

    if constexpr (MAXC > 0) {
        float top[MAXC], d[MAXC];
        load_classes<MAXC>(r0, r1, o0, o1, wx, cls, sc, 0, n_sel, top, d);
        for (int y = ys; y < ye; ++y) {
            const float wy = __ldg(yw + y);
            float best = top[0] + d[0] * wy;
            int idx = 0;
#pragma unroll
            for (int k = 1; k < MAXC; ++k) {
                const float v = top[k] + d[k] * wy;
                if (v > best) {  // strict: ties keep the lowest class
                    best = v;
                    idx = k;
                }
            }
            __stcs(o + y * W, idx);
        }
    } else {
        extern __shared__ float smem[];
        float* sbest = smem;                                // rows x T
        int* sidx = (int*)(smem + kMaxRows * blockDim.x);  // rows x T
        const int col = threadIdx.x;
        for (int k0 = 0; k0 < n_sel; k0 += kChunk) {
            float top[kChunk], d[kChunk];
            load_classes<kChunk>(r0, r1, o0, o1, wx, cls, sc, k0, n_sel, top,
                                 d);
            const bool last = k0 + kChunk >= n_sel;
            for (int y = ys; y < ye; ++y) {
                const float wy = __ldg(yw + y);
                const int s = (y - ys) * blockDim.x + col;
                float best;
                int idx;
                if (k0 == 0) {
                    best = top[0] + d[0] * wy;
                    idx = 0;
                } else {
                    best = sbest[s];
                    idx = sidx[s];
                }
#pragma unroll
                for (int k = 0; k < kChunk; ++k) {
                    const float v = top[k] + d[k] * wy;
                    if (v > best) {
                        best = v;
                        idx = k0 + k;
                    }
                }
                if (last) {
                    __stcs(o + y * W, idx);
                } else {
                    sbest[s] = best;
                    sidx[s] = idx;
                }
            }
        }
    }
}

template <typename T, int MAXC>
cudaError_t launch(dim3 blocks, int threads, cudaStream_t s, const void* grid,
                   long long sb, int sc, int sy, int sx, const int* cls,
                   int n_sel, const int* bands, const int* xlo,
                   const int* xhi, const float* xw, const float* yw,
                   int* out, int H, int W) {
    const size_t smem = MAXC > 0 ? 0
                                 : (size_t)2 * kMaxRows * threads * 4;
    resize_argmax_band<T, MAXC><<<blocks, threads, smem, s>>>(
        (const T*)grid, sb, sc, sy, sx, cls, n_sel, bands, xlo, xhi, xw, yw,
        out, H, W);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bound(dim3 blocks, int threads, cudaStream_t s,
                         const void* grid, long long sb, int sc, int sy,
                         int sx, const int* cls, int n_sel, const int* bands,
                         const int* xlo, const int* xhi, const float* xw,
                         const float* yw, int* out, int H, int W) {
#define RESIZE_ARGMAX(MAXC)                                                 \
    launch<T, MAXC>(blocks, threads, s, grid, sb, sc, sy, sx, cls, n_sel,   \
                    bands, xlo, xhi, xw, yw, out, H, W)
    switch ((n_sel + 3) / 4) {
        case 1: return RESIZE_ARGMAX(4);
        case 2: return RESIZE_ARGMAX(8);
        case 3: return RESIZE_ARGMAX(12);
        case 4: return RESIZE_ARGMAX(16);
        case 5: return RESIZE_ARGMAX(20);
        case 6: return RESIZE_ARGMAX(24);
        case 7: return RESIZE_ARGMAX(28);
        case 8: return RESIZE_ARGMAX(32);
        default: return RESIZE_ARGMAX(0);
    }
#undef RESIZE_ARGMAX
}

}  // namespace

// grid: (B, C, gh, gw) float32 (bf16 == 0) or bfloat16 (bf16 == 1) with
// strides sb, sc, sy, sx in elements; cls: n_sel int32 class ids into C, or
// NULL for classes 0 .. n_sel - 1; itab: the band runs (4 ints each,
// n_bands of them), then xlo (W), then xhi (W); ftab: yw (H), then xw (W);
// out: (B, H, W) int32.  threads: a multiple of 32, at most 128; n_tiles
// column tiles of `threads` columns cover W.
extern "C" int resize_argmax_launch(const void* grid, int bf16, long long sb,
                                    long long sc, long long sy, long long sx,
                                    const int* cls, int n_sel,
                                    const int* itab, const float* ftab,
                                    int* out, int B, int H, int W,
                                    int n_bands, int n_tiles, int threads,
                                    void* stream) {
    if (threads < 32 || threads > kMaxThreads || threads % 32 || n_sel < 1)
        return (int)cudaErrorInvalidValue;
    if ((long long)B * n_bands * n_tiles == 0) return 0;
    const dim3 blocks(n_tiles, n_bands, B);
    const int* bands = itab;
    const int* xlo = itab + 4 * n_bands;
    const int* xhi = xlo + W;
    const float* yw = ftab;
    const float* xw = ftab + H;
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err =
        bf16 ? launch_bound<unsigned short>(blocks, threads, s, grid, sb,
                                            (int)sc, (int)sy, (int)sx, cls,
                                            n_sel, bands, xlo, xhi, xw, yw,
                                            out, H, W)
             : launch_bound<float>(blocks, threads, s, grid, sb, (int)sc,
                                   (int)sy, (int)sx, cls, n_sel, bands, xlo,
                                   xhi, xw, yw, out, H, W);
    return (int)err;
}
