// Fused align-corners bilinear upsample + masked softmax cross-entropy,
// forward and backward, sm_90a.
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
// server round's 10x19x256x512 each would be 100 MB).
//
// Design.  The TPU kernel runs a per-class pair of MXU matmuls per row tile
// and carries the gradient across tiles in VMEM; neither carries over to a
// GPU.  Here one block owns one output row (b, y):
//   - it stages the two grid rows ylo[y], yhi[y] of every class in shared
//     memory, then each thread lerps the 4 taps of each class for its
//     pixels in the operation order of the port's models/resize.py
//     (left + (right - left) * xw on both rows, then top + (bot - top) * yw);
//     built with --fmad=false, the upsampled values equal the plain
//     version's bit for bit;
//   - the row's upsampled logits (C x W floats) stay in shared memory for
//     the softmax: 39 KB at C=19, W=512; above 48 KB the launcher raises
//     the block's dynamic shared-memory limit.
// Forward: per-row partial sums of ce*v and v, then one block sums the
// rows in a fixed order (in double) into (loss, total).
// Backward, deterministic and separable, with no atomics:
//   pass A (one block per row): G for the row in shared memory, then one
//     thread per (class, gx) sums its contiguous range of x in order into
//     h[b, k, y, gx] = sum_x G_k[y, x] C[x, gx];
//   pass B (one thread per (b, k, gy, gx)): sums the rows y whose ylo or
//     yhi is gy, in order: grad[b, k, gy, gx] = sum_y R[y, gy] h[b, k, y, gx].
// So two runs give the same bits, which coord_desc_auto's quantile cut
// needs (a selection on |delta| near a dense tie cluster).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 without tensor cores),
// reckoned from shapes, at the server round's B=10, C=19, 17x33 -> 256x512:
//   forward reads 0.43 MB of grid, 5.2 MB of int32 labels and 5.2 MB of f32
//   weights (~10.9 MB, 3.3 us); the separable lerp plus max/exp/sum is
//   ~1.8e8 operations (2.7 us): bound by bytes.  The backward adds the
//   softmax gradient and the transposed lerp, ~3.6e8 operations (5.4 us).
// This first form repeats the horizontal lerp of both grid rows for every
// pixel (9 unfused operations per pixel and class) and keeps one row per
// block; it is not near the bound.  chip_smoke.py times it.
//
// Plain C interface (no PyTorch header): the caller passes raw device
// pointers and PyTorch's current stream, and reads cudaGetLastError() back
// as the return value.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

// Stage the block's two grid rows of every class in shared memory: for
// class c, grid row ylo[y] at rows[(2c) * gw] and row yhi[y] at
// rows[(2c + 1) * gw].
__device__ __forceinline__ void stage_rows(const float* __restrict__ grid_b,
                                           int C, int gh, int gw, int y0,
                                           int y1, float* rows) {
    const int n = 2 * C * gw;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int gx = i % gw;
        const int r = (i / gw) & 1;
        const int c = i / (2 * gw);
        rows[i] = grid_b[((long long)c * gh + (r ? y1 : y0)) * gw + gx];
    }
}

// Upsampled logits of pixel x for every class into u[c * W + x]; returns
// their max.
__device__ __forceinline__ float lerp_pixel(const float* rows, int C, int gw,
                                            int W, int x0, int x1, float wx,
                                            float wy, float* u, int x) {
    float m = -INFINITY;
    for (int c = 0; c < C; ++c) {
        const float* top_row = rows + (2 * c) * gw;
        const float* bot_row = top_row + gw;
        const float tl = top_row[x0], tr = top_row[x1];
        const float bl = bot_row[x0], br = bot_row[x1];
        const float top = tl + (tr - tl) * wx;
        const float bot = bl + (br - bl) * wx;
        const float v = top + (bot - top) * wy;
        u[c * W + x] = v;
        m = fmaxf(m, v);
    }
    return m;
}

// Fixed-order tree sum of one value per thread over the block; the result
// is valid in thread 0.  scratch holds blockDim.x floats.
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

// One block per output row (b, y): partial[2 * row] = sum ce * v,
// partial[2 * row + 1] = sum v.
__global__ void resize_ce_fwd_rows(const float* __restrict__ grid,
                                   const int* __restrict__ labels,
                                   const float* __restrict__ weights,
                                   const int* __restrict__ ylo,
                                   const int* __restrict__ yhi,
                                   const float* __restrict__ yw,
                                   const int* __restrict__ xlo,
                                   const int* __restrict__ xhi,
                                   const float* __restrict__ xw,
                                   float* __restrict__ partial,
                                   int C, int gh, int gw, int H, int W) {
    extern __shared__ float smem[];
    float* rows = smem;                 // 2 * C * gw
    float* u = rows + 2 * C * gw;       // C * W
    __shared__ float red[kThreads];

    const int row = blockIdx.x;         // b * H + y
    const int b = row / H, y = row % H;
    stage_rows(grid + (long long)b * C * gh * gw, C, gh, gw, ylo[y], yhi[y],
               rows);
    __syncthreads();

    const float wy = yw[y];
    const long long base = (long long)row * W;
    float num = 0.f, den = 0.f;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
        const float m = lerp_pixel(rows, C, gw, W, xlo[x], xhi[x], xw[x], wy,
                                   u, x);
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += expf(u[c * W + x] - m);
        const int lab = labels[base + x];
        const float v = weights[base + x];
        // a label outside [0, C) has an all-zero one-hot row: ce = 0
        const float ce = (lab >= 0 && lab < C)
                             ? logf(s) - (u[lab * W + x] - m) : 0.f;
        num += ce * v;
        den += v;
    }
    num = block_sum(num, red);
    if (threadIdx.x == 0) partial[2 * row] = num;
    __syncthreads();
    den = block_sum(den, red);
    if (threadIdx.x == 0) partial[2 * row + 1] = den;
}

// One block: out[0] = loss, out[1] = total = max(sum v, 1), summing the
// rows' partials in a fixed order in double.
__global__ void resize_ce_fwd_finish(const float* __restrict__ partial,
                                     int n_rows, float* __restrict__ out) {
    __shared__ double red[kReduceThreads];
    double num = 0.0, den = 0.0;
    for (int i = threadIdx.x; i < n_rows; i += blockDim.x) {
        num += (double)partial[2 * i];
        den += (double)partial[2 * i + 1];
    }
    num = block_sum(num, red);
    __syncthreads();
    den = block_sum(den, red);
    if (threadIdx.x == 0) {
        const float total = fmaxf((float)den, 1.f);
        out[0] = (float)num / total;
        out[1] = total;
    }
}

// Backward pass A, one block per output row (b, y):
// h[b, k, y, gx] = sum over x of G_k[y, x] C[x, gx], in x order.
// xr[4 gx .. 4 gx + 3] = [start, end) of the x with xlo == gx, then
// [start, end) of the x with xhi == gx.
__global__ void resize_ce_bwd_rows(const float* __restrict__ grid,
                                   const int* __restrict__ labels,
                                   const float* __restrict__ weights,
                                   const int* __restrict__ ylo,
                                   const int* __restrict__ yhi,
                                   const float* __restrict__ yw,
                                   const int* __restrict__ xlo,
                                   const int* __restrict__ xhi,
                                   const float* __restrict__ xw,
                                   const int* __restrict__ xr,
                                   float* __restrict__ h,
                                   int C, int gh, int gw, int H, int W) {
    extern __shared__ float smem[];
    float* rows = smem;
    float* u = rows + 2 * C * gw;

    const int row = blockIdx.x;
    const int b = row / H, y = row % H;
    stage_rows(grid + (long long)b * C * gh * gw, C, gh, gw, ylo[y], yhi[y],
               rows);
    __syncthreads();

    const float wy = yw[y];
    const long long base = (long long)row * W;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
        const float m = lerp_pixel(rows, C, gw, W, xlo[x], xhi[x], xw[x], wy,
                                   u, x);
        float s = 0.f;
        for (int c = 0; c < C; ++c) {
            const float e = expf(u[c * W + x] - m);
            u[c * W + x] = e;
            s += e;
        }
        const float inv = 1.f / s;
        const int lab = labels[base + x];
        const bool in_range = lab >= 0 && lab < C;
        const float v = in_range ? weights[base + x] : 0.f;
        for (int c = 0; c < C; ++c) {
            const float onehot = (c == lab) ? 1.f : 0.f;
            u[c * W + x] = (u[c * W + x] * inv - onehot) * v;
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < C * gw; i += blockDim.x) {
        const int c = i / gw, gx = i % gw;
        const float* g = u + c * W;
        float acc = 0.f;
        for (int x = xr[4 * gx]; x < xr[4 * gx + 1]; ++x)
            acc += g[x] * (1.f - xw[x]);
        for (int x = xr[4 * gx + 2]; x < xr[4 * gx + 3]; ++x)
            acc += g[x] * xw[x];
        h[(((long long)b * C + c) * H + y) * gw + gx] = acc;
    }
}

// Backward pass B, one thread per (b, k, gy, gx):
// grad[b, k, gy, gx] = sum over y of R[y, gy] h[b, k, y, gx], in y order.
__global__ void resize_ce_bwd_cols(const float* __restrict__ h,
                                   const float* __restrict__ yw,
                                   const int* __restrict__ yr,
                                   float* __restrict__ grad,
                                   int BC, int gh, int gw, int H) {
    const long long total = (long long)BC * gh * gw;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= total) return;
    const int gx = (int)(p % gw);
    const int gy = (int)((p / gw) % gh);
    const long long bc = p / ((long long)gw * gh);
    const float* hb = h + bc * H * gw + gx;
    float acc = 0.f;
    for (int y = yr[4 * gy]; y < yr[4 * gy + 1]; ++y)
        acc += hb[(long long)y * gw] * (1.f - yw[y]);
    for (int y = yr[4 * gy + 2]; y < yr[4 * gy + 3]; ++y)
        acc += hb[(long long)y * gw] * yw[y];
    grad[p] = acc;
}

size_t row_smem_bytes(int C, int gw, int W) {
    return sizeof(float) * ((size_t)2 * C * gw + (size_t)C * W);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace

// partial: 2 * B * H floats of scratch; out: 2 floats (loss, total).
extern "C" int resize_ce_fwd_launch(const float* grid, const int* labels,
                                    const float* weights,
                                    const int* ylo, const int* yhi,
                                    const float* yw,
                                    const int* xlo, const int* xhi,
                                    const float* xw,
                                    float* partial, float* out,
                                    int B, int C, int gh, int gw,
                                    int H, int W, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int n_rows = B * H;
    const size_t smem = row_smem_bytes(C, gw, W);
    cudaError_t err = allow_smem(resize_ce_fwd_rows, smem);
    if (err != cudaSuccess) return (int)err;
    resize_ce_fwd_rows<<<n_rows, kThreads, smem, s>>>(
        grid, labels, weights, ylo, yhi, yw, xlo, xhi, xw, partial, C, gh, gw,
        H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    resize_ce_fwd_finish<<<1, kReduceThreads, 0, s>>>(partial, n_rows, out);
    return (int)cudaGetLastError();
}

// h: B * C * H * gw floats of scratch; grad: B * C * gh * gw floats, the
// unnormalized grid gradient.  yr: 4 * gh ints, xr: 4 * gw ints (see
// resize_ce_bwd_rows).
extern "C" int resize_ce_bwd_launch(const float* grid, const int* labels,
                                    const float* weights,
                                    const int* ylo, const int* yhi,
                                    const float* yw,
                                    const int* xlo, const int* xhi,
                                    const float* xw,
                                    const int* yr, const int* xr,
                                    float* h, float* grad,
                                    int B, int C, int gh, int gw,
                                    int H, int W, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = row_smem_bytes(C, gw, W);
    cudaError_t err = allow_smem(resize_ce_bwd_rows, smem);
    if (err != cudaSuccess) return (int)err;
    resize_ce_bwd_rows<<<B * H, kThreads, smem, s>>>(
        grid, labels, weights, ylo, yhi, yw, xlo, xhi, xw, xr, h, C, gh, gw,
        H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)B * C * gh * gw;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    resize_ce_bwd_cols<<<(unsigned)blocks, threads, 0, s>>>(
        h, yw, yr, grad, B * C, gh, gw, H);
    return (int)cudaGetLastError();
}
