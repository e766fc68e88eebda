// Fused align-corners bilinear upsample + masked softmax cross-entropy,
// loss and grid gradient in one pass, sm_90a.
//
// Replaces the Pallas TPU kernel ams_tpu/ops/fused_resize_ce.py::_make_kernel
// (driven by _fused_parts there, wrapped in the fused_resize_ce custom_vjp).
// For grid logits L (B, C, gh, gw), reduced labels (B, H, W) and validity
// weights v (B, H, W) it computes
//
//     U        = resize_bilinear_ac(L, (H, W))                (never stored)
//     ce[p]    = log sum_k exp(U_k[p]) - U_label[p]
//     loss     = sum_p ce[p] v[p] / max(sum_p v[p], 1)
//     dL/dL_k  = R^T G_k C^T,  G_k = (softmax(U)_k - 1[label == k]) v
//                                                  (unnormalized: the
//                                                   wrapper scales by
//                                                   g / max(sum v, 1))
//
// without writing the full-resolution logits or their cotangent (at the
// server round's 10x19x256x512 each would be 100 MB).  A label outside
// [0, C) gives CE 0 and no gradient; its weight still counts in sum v.
// As JAX's _fwd does, one launch computes the loss and the gradient; the
// autograd backward only scales the saved gradient.  A loss-only variant
// of the same kernel serves calls that need no gradient.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 without tensor cores),
// reckoned from shapes, at the server round's B=10, C=19, 17x33 -> 256x512:
//   reads 0.43 MB of grid, 5.2 MB of int32 labels and 5.2 MB of f32
//   weights, writes 0.43 MB of gradient: ~11.3 MB, 3.4 us (10.9 MB and
//   3.3 us for the loss alone).  The separable lerp plus max/exp/sum is
//   ~1.8e8 operations (2.7 us); the softmax gradient and the transposed
//   lerp add ~1.8e8 (5.5 us in all): loss+grad is bound by operations.
//
// Design.  The TPU kernel runs a per-class pair of MXU matmuls per row
// tile and carries the gradient across tiles in VMEM; neither carries over
// to a GPU.  Here:
//   - Bands.  Output rows with one ylo form a band (contiguous, since ylo
//     never decreases; empty when H < gh; one row where ylo == yhi).  All
//     rows of a band lerp between the same two grid rows gy, min(gy+1,
//     gh-1), so their horizontal lerps are shared.
//   - Tiles.  A tile is a run of whole grid intervals: the x with xlo in
//     [g0, g1); it touches grid columns g0 .. min(g1, gw-1).  The host
//     packs intervals into tiles of at most `threads` columns.
//   - One block per (b, band, tile), one thread per column x.  The thread
//     lerps both grid rows horizontally for its column once per class, in
//     registers (top, and bot - top), in the operation order of the port's
//     models/resize.py: left + (right - left) * xw on both rows, then
//     top + (bot - top) * yw per row.  Built with --fmad=false, the
//     upsampled values equal the plain version's bit for bit.  Then it
//     walks the band's rows in order: softmax over the classes in
//     registers, CE into the loss sums, and G_k into two per-class sums,
//     sum_y G_k (1 - yw) for the top grid row and sum_y G_k yw for the
//     bottom one (the vertical half of R^T G C^T, in registers for a
//     compile-time bound on C: 8, 16, 24 or 32 classes).  Above 32 classes
//     a variant of the same kernel recomputes each class's two horizontal
//     lerps from the (L1-cached) grid where it needs them and keeps the
//     two sums in the thread's own column of shared memory, in the same
//     order, so it gives the same bits; its shared memory grows with C
//     (2C rows of threads + 1, plus the partial).  So the host's planner
//     asks resize_ce_smem_bytes and resize_ce_smem_limit and steps down
//     to 64 or 32 threads, then to fewer grid intervals per tile, until a
//     block fits: at 32 threads and one interval per tile, 64 + 70 C
//     floats, so up to 829 classes on an H100 (227 KB a block).
//   - The x half.  The block writes its columns' sums to shared memory as
//     2C rows of threads + 1 floats (odd stride, so neighbouring classes of
//     one column fall in distinct banks), then one thread per (class, side,
//     grid column) contracts its x range in order into the tile's partial:
//     at most 2 x C x (g1 - g0 + 1) floats per block.  An interval wider
//     than the block is walked in chunks of `threads` columns, each chunk
//     adding to the same partial in order.
//   - Finish.  One launch sums, in a fixed order, each grid cell's
//     contributions (band gy top, band gy-1 bottom, band gh-1 bottom at the
//     last grid row; within each, the tile to the left first), and in one
//     more block sums the blocks' (sum ce v, sum v) in double into (loss,
//     total).
//   - Groups.  The B images may be G equal groups, each with its own mean
//     (the videos of the batched multi-video round, whose students each
//     take their own loss): G finishing blocks, one per group, each sum
//     their group's band blocks in the order a launch over that group
//     alone would, so one launch gives each group's (loss, total) with the
//     bits of G separate launches.  The gradient is per image already.
// So a training iteration costs two launches and one pass over the labels
// and weights, with the upsample and softmax computed once; the
// horizontal lerp runs once per band column and class, not once per
// pixel (3 operations per pixel and class where 9 were); the x contraction
// runs in parallel over (class, side, grid column) without bank conflicts,
// and the partials it writes are 0.93 MB at the server shape, with no
// scratch of B x C x H x gw floats; no buffer grows with W, so any width
// is taken.  No atomics and fixed summation orders: two runs give the
// same bits, which coord_desc_auto's quantile cut needs.
//
// Plain C interface (no PyTorch header): the caller passes raw device
// pointers and PyTorch's current stream, and reads cudaGetLastError() back
// as the return value.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 128;     // columns (threads) of a band block
constexpr int kFinishThreads = 256;

// Fixed-order tree sum of one value per thread over the block; the result
// is valid in every thread.  blockDim.x is a power of two; scratch holds
// blockDim.x values.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
    scratch[threadIdx.x] = v;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) scratch[threadIdx.x] += scratch[threadIdx.x + s];
        __syncthreads();
    }
    return scratch[0];
}

// The two horizontal lerps of one class at column x, in the operation order
// of models/resize.py: top = left + (right - left) xw on grid row r0, and
// d = (the same on r1) - top, so that top + d yw is the upsampled value.
__device__ __forceinline__ void lerp_rows(const float* r0, const float* r1,
                                          int x0, int x1, float wx,
                                          float& top, float& d) {
    const float tl = __ldg(r0 + x0), tr = __ldg(r0 + x1);
    const float bl = __ldg(r1 + x0), br = __ldg(r1 + x1);
    top = tl + (tr - tl) * wx;
    d = (bl + (br - bl) * wx) - top;
}

// Dynamic shared memory of a band block, in floats: the block sum's
// scratch; with the gradient also the chunk's xw, its column sums (2C rows
// of threads + 1) and the tile's partial (2C x ncol_max).
size_t band_smem_floats(int C, int threads, int ncol_max, bool grad) {
    size_t n = threads;
    if (grad)
        n += threads + (size_t)2 * C * (threads + 1) +
             (size_t)2 * C * ncol_max;
    return n;
}

// One block per (b, band, tile); see the header.  bands: [start, end) rows
// of each grid row's band; tiles: (g0, g1, xs, xe, poff) per tile, x in
// [xs, xe) and its partial's first column poff; xr: per grid column
// [start, end) of the x with xlo == gx, then of those with xhi == gx.
// lpart[2 blk] = sum ce v, lpart[2 blk + 1] = sum v; with GRAD,
// part[((b gh + band) 2 + side) C + k][poff + j] = the tile's contribution
// to grid row (band + side, clamped) and column g0 + j.  MAXC: the bound on
// C of the classes held in registers, or 0 for any C (see the header).
template <int MAXC, bool GRAD>
__global__ void __launch_bounds__(kMaxThreads)
resize_ce_band(const float* __restrict__ grid,
               const int* __restrict__ labels,
               const float* __restrict__ weights,
               const float* __restrict__ yw,
               const int* __restrict__ xlo,
               const int* __restrict__ xhi,
               const float* __restrict__ xw,
               const int* __restrict__ bands,
               const int* __restrict__ tiles,
               const int* __restrict__ xr,
               float* __restrict__ lpart,
               float* __restrict__ part,
               int C, int gh, int gw, int H, int W, int n_tiles,
               int sumcol) {
    extern __shared__ float smem[];
    const int T = blockDim.x;
    const int S = T + 1;                 // odd row stride of the column sums
    const int tid = threadIdx.x;
    constexpr int R = MAXC > 0 ? MAXC : 1;   // register arrays' length
    float* red = smem;                   // T
    float* sxw = red + T;                // T            (GRAD)
    float* sacc = sxw + T;               // 2C rows of S  (GRAD)

    const int blk = blockIdx.x;
    const int t = blk % n_tiles;
    const int band = (blk / n_tiles) % gh;
    const int b = blk / (n_tiles * gh);
    const int* tl5 = tiles + 5 * t;
    const int g0 = tl5[0], g1 = tl5[1], xs = tl5[2], xe = tl5[3];
    const int ncol = min(g1, gw - 1) - g0 + 1;
    const int n_items = 2 * C * ncol;
    float* spart = sacc + 2 * C * S;     // n_items       (GRAD)
    const int ys = bands[2 * band], ye = bands[2 * band + 1];
    const float* row_top = grid + ((long long)b * C * gh + band) * gw;
    const float* row_bot = row_top + (min(band + 1, gh - 1) - band) * gw;
    const long long plane = (long long)gh * gw;
    const long long img = (long long)b * H * W;

    if (GRAD)
        for (int i = tid; i < n_items; i += T) spart[i] = 0.f;

    float num = 0.f, den = 0.f;
    for (int cx0 = xs; cx0 < xe; cx0 += T) {
        const int cx1 = min(cx0 + T, xe);
        const int x = cx0 + tid;
        float at[R], ab[R];
#pragma unroll
        for (int k = 0; k < R; ++k) at[k] = ab[k] = 0.f;
        if (GRAD && MAXC == 0)       // the sums live in the thread's column
            for (int k = 0; k < 2 * C; ++k) sacc[k * S + tid] = 0.f;
        float wx = 0.f;
        if (x < cx1 && ys < ye) {
            const int x0 = xlo[x], x1 = xhi[x];
            wx = xw[x];
            float top[R], d[R], e[R];
#pragma unroll
            for (int k = 0; k < MAXC; ++k)
                if (k < C)
                    lerp_rows(row_top + k * plane, row_bot + k * plane, x0,
                              x1, wx, top[k], d[k]);
            for (int y = ys; y < ye; ++y) {
                const float wy = yw[y];
                const long long p = img + (long long)y * W + x;
                const int lab = labels[p];
                const float v = weights[p];
                float m = -INFINITY, s = 0.f, ulab = 0.f;
                if (MAXC > 0) {
#pragma unroll
                    for (int k = 0; k < MAXC; ++k) {
                        if (k < C) {
                            e[k] = top[k] + d[k] * wy;
                            m = fmaxf(m, e[k]);
                        }
                    }
#pragma unroll
                    for (int k = 0; k < MAXC; ++k) {
                        if (k < C) {
                            if (k == lab) ulab = e[k];
                            e[k] = expf(e[k] - m);
                            s += e[k];
                        }
                    }
                } else {
                    for (int k = 0; k < C; ++k) {
                        float t0, d0;
                        lerp_rows(row_top + k * plane, row_bot + k * plane,
                                  x0, x1, wx, t0, d0);
                        m = fmaxf(m, t0 + d0 * wy);
                    }
                    for (int k = 0; k < C; ++k) {
                        float t0, d0;
                        lerp_rows(row_top + k * plane, row_bot + k * plane,
                                  x0, x1, wx, t0, d0);
                        const float u = t0 + d0 * wy;
                        if (k == lab) ulab = u;
                        s += expf(u - m);
                    }
                }
                const bool in_range = lab >= 0 && lab < C;
                num += (in_range ? logf(s) - (ulab - m) : 0.f) * v;
                den += v;
                if (GRAD) {
                    const float inv = 1.f / s;
                    const float vg = in_range ? v : 0.f;
                    const float w_top = 1.f - wy;
                    if (MAXC > 0) {
#pragma unroll
                        for (int k = 0; k < MAXC; ++k) {
                            if (k < C) {
                                const float g =
                                    (e[k] * inv - (k == lab ? 1.f : 0.f))
                                    * vg;
                                at[k] += g * w_top;
                                ab[k] += g * wy;
                            }
                        }
                    } else {
                        for (int k = 0; k < C; ++k) {
                            float t0, d0;
                            lerp_rows(row_top + k * plane,
                                      row_bot + k * plane, x0, x1, wx, t0,
                                      d0);
                            const float g =
                                (expf(t0 + d0 * wy - m) * inv
                                 - (k == lab ? 1.f : 0.f)) * vg;
                            sacc[k * S + tid] += g * w_top;
                            sacc[(C + k) * S + tid] += g * wy;
                        }
                    }
                }
            }
        }
        if (GRAD) {
            sxw[tid] = wx;
#pragma unroll
            for (int k = 0; k < MAXC; ++k) {
                if (k < C) {
                    sacc[k * S + tid] = at[k];
                    sacc[(C + k) * S + tid] = ab[k];
                }
            }
            __syncthreads();
            // neighbouring threads take neighbouring classes of one grid
            // column and side; each sums its x range in order
            for (int i = tid; i < n_items; i += T) {
                const int k = i % C, side = (i / C) & 1, j = i / (2 * C);
                const int* r = xr + 4 * (g0 + j);
                const float* col = sacc + (side * C + k) * S;
                float acc = 0.f;
                for (int xx = max(r[0], cx0); xx < min(r[1], cx1); ++xx)
                    acc += col[xx - cx0] * (1.f - sxw[xx - cx0]);
                for (int xx = max(r[2], cx0); xx < min(r[3], cx1); ++xx)
                    acc += col[xx - cx0] * sxw[xx - cx0];
                spart[i] += acc;
            }
            __syncthreads();
        }
    }

    if (GRAD) {
        const int poff = tl5[4];
        for (int i = tid; i < n_items; i += T) {
            const int k = i % C, side = (i / C) & 1, j = i / (2 * C);
            const long long row = ((long long)(b * gh + band) * 2 + side) * C
                                  + k;
            part[row * sumcol + poff + j] = spart[i];
        }
    }
    num = block_sum(num, red);
    if (tid == 0) lpart[2 * blk] = num;
    __syncthreads();
    den = block_sum(den, red);
    if (tid == 0) lpart[2 * blk + 1] = den;
}

// Blocks 0 .. n_cell_blocks - 1: one thread per grid cell (b, k, gy, gx)
// sums its contributions in a fixed order (see the header).  Block
// n_cell_blocks + g, for each of the `groups` groups of images:
// out[2 g] = loss, out[2 g + 1] = total = max(sum v, 1), summing the
// group's band blocks' partials in order in double.
__global__ void resize_ce_finish(const float* __restrict__ lpart,
                                 int n_band_blocks,
                                 const float* __restrict__ part,
                                 const int* __restrict__ tiles,
                                 const int* __restrict__ tile_of,
                                 float* __restrict__ grad,
                                 float* __restrict__ out,
                                 int B, int C, int gh, int gw, int sumcol,
                                 int n_cell_blocks, int groups) {
    if ((int)blockIdx.x >= n_cell_blocks) {
        __shared__ double red[kFinishThreads];
        const int g = (int)blockIdx.x - n_cell_blocks;
        const int per = n_band_blocks / groups;   // band blocks are b-major
        const float* lp = lpart + 2 * (long long)g * per;
        double num = 0.0, den = 0.0;
        for (int i = threadIdx.x; i < per; i += blockDim.x) {
            num += (double)lp[2 * i];
            den += (double)lp[2 * i + 1];
        }
        num = block_sum(num, red);
        __syncthreads();
        den = block_sum(den, red);
        if (threadIdx.x == 0) {
            const float total = fmaxf((float)den, 1.f);
            out[2 * g] = (float)num / total;
            out[2 * g + 1] = total;
        }
        return;
    }
    const long long n = (long long)B * C * gh * gw;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int gx = (int)(p % gw);
    const int gy = (int)((p / gw) % gh);
    const long long bk = p / ((long long)gw * gh);
    const int k = (int)(bk % C), b = (int)(bk / C);
    const int t = tile_of[gx];
    const int* tl5 = tiles + 5 * t;
    const int col1 = tl5[4] + gx - tl5[0];
    // the tile to the left ends on this column (its last partial column)
    const int col0 = (gx == tl5[0] && t > 0)
                         ? tl5[-1] + tl5[-4] - tl5[-5] : -1;
    float acc = 0.f;
    for (int q = 0; q < 3; ++q) {
        int band, side;
        if (q == 0) {
            band = gy, side = 0;             // rows below grid row gy
        } else if (q == 1) {
            if (gy == 0) continue;
            band = gy - 1, side = 1;         // rows above it
        } else {
            if (gy != gh - 1) continue;
            band = gy, side = 1;             // ylo == yhi == gh - 1
        }
        const float* row =
            part + (((long long)(b * gh + band) * 2 + side) * C + k) * sumcol;
        if (col0 >= 0) acc += row[col0];
        acc += row[col1];
    }
    grad[p] = acc;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

template <int MAXC>
cudaError_t launch_band(bool want_grad, int blocks, int threads, size_t smem,
                        cudaStream_t s, const float* grid, const int* labels,
                        const float* weights, const float* yw,
                        const int* xlo, const int* xhi, const float* xw,
                        const int* bands, const int* tiles, const int* xr,
                        float* lpart, float* part, int C, int gh, int gw,
                        int H, int W, int n_tiles, int sumcol) {
    auto kernel = want_grad ? resize_ce_band<MAXC, true>
                            : resize_ce_band<MAXC, false>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, s>>>(grid, labels, weights, yw, xlo, xhi,
                                         xw, bands, tiles, xr, lpart, part, C,
                                         gh, gw, H, W, n_tiles, sumcol);
    return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one band block, in bytes.
extern "C" size_t resize_ce_smem_bytes(int C, int threads, int ncol_max,
                                       int want_grad) {
    return sizeof(float) * band_smem_floats(C, threads, ncol_max,
                                            want_grad != 0);
}

// The most dynamic shared memory a block may use on ``device``, in bytes
// (232,448 on an H100), or -1 if the device cannot be asked.
extern "C" int resize_ce_smem_limit(int device) {
    int bytes = 0;
    if (cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device) != cudaSuccess)
        return -1;
    return bytes;
}

// Loss, and with grad != NULL the unnormalized grid gradient (B, C, gh,
// gw).  Tables as resize_ce_band reads them (built by the host's plan);
// lpart: 2 * B * gh * n_tiles floats of scratch; part: B * gh * 2 * C *
// sumcol floats of scratch (unused without grad); out: 2 * groups floats,
// (loss, total) of each group of B / groups images (see the header).
// threads: a power of two, at most 128.  A block that needs more shared
// memory than the card gives one, or groups that do not divide B, return
// cudaErrorInvalidValue.
extern "C" int resize_ce_launch(const float* grid, const int* labels,
                                const float* weights, const float* yw,
                                const int* xlo, const int* xhi,
                                const float* xw, const int* bands,
                                const int* tiles, const int* tile_of,
                                const int* xr, float* lpart, float* part,
                                float* grad, float* out,
                                int B, int C, int gh, int gw, int H, int W,
                                int n_tiles, int ncol_max, int sumcol,
                                int threads, int groups, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (threads < 32 || threads > kMaxThreads || (threads & (threads - 1)))
        return (int)cudaErrorInvalidValue;
    if (groups < 1 || B % groups) return (int)cudaErrorInvalidValue;
    const bool want_grad = grad != nullptr;
    const int blocks = B * gh * n_tiles;
    const size_t smem = resize_ce_smem_bytes(C, threads, ncol_max, want_grad);
    cudaError_t err;
#define RESIZE_CE_BAND(MAXC)                                                 \
    launch_band<MAXC>(want_grad, blocks, threads, smem, s, grid, labels,     \
                      weights, yw, xlo, xhi, xw, bands, tiles, xr, lpart,    \
                      part, C, gh, gw, H, W, n_tiles, sumcol)
    if (C <= 8) err = RESIZE_CE_BAND(8);
    else if (C <= 16) err = RESIZE_CE_BAND(16);
    else if (C <= 24) err = RESIZE_CE_BAND(24);
    else if (C <= 32) err = RESIZE_CE_BAND(32);
    else err = RESIZE_CE_BAND(0);
#undef RESIZE_CE_BAND
    if (err != cudaSuccess) return (int)err;
    const long long cells = want_grad ? (long long)B * C * gh * gw : 0;
    const int cell_blocks = (int)((cells + kFinishThreads - 1)
                                  / kFinishThreads);
    resize_ce_finish<<<cell_blocks + groups, kFinishThreads, 0, s>>>(
        lpart, blocks, part, tiles, tile_of, grad, out, B, C, gh, gw, sumcol,
        cell_blocks, groups);
    return (int)cudaGetLastError();
}
