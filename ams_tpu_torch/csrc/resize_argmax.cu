// Fused align-corners bilinear upsample + per-pixel class argmax, sm_90a.
//
// Replaces the Pallas TPU kernel ams_tpu/ops/fused_resize_argmax.py::_kernel
// (launched by fused_resize_argmax there).  Computes
//
//     out[b, y, x] = argmax_c resize_bilinear_ac(grid)[b, c, y, x]
//
// without writing the full-resolution logits: only int32 class ids leave
// the kernel.  The TPU kernel runs two MXU matmuls per class
// (R_tile . L_c . C); on Hopper the direct form is simpler and exact: one
// thread per output pixel walks the C classes, lerps the 4 grid taps of
// each class and keeps a running (best_val, best_idx) with a strict `>`,
// so ties keep the lowest class id like torch.argmax.
//
// Numerics: the lerps use the operation order of the port's
// models/resize.py::resize_bilinear_ac (left + (right - left) * xw on both
// rows, then top + (bot - top) * yw).  Built with --fmad=false, no
// multiply-add is contracted, so every value is rounded exactly as the
// plain PyTorch version rounds it and the ids equal its argmax bit for bit.
// The lerp tables (ylo, yhi, yw, xlo, xhi, xw) come from the host
// (_lerp_weights, float64 source coordinates cast to float32).
//
// Bound on an H100 SXM (3.35 TB/s), reckoned from shapes, not measured, at
// the client's full width B=8, C=19, grid 33x65 -> 512x1024:
//   reads   8*19*33*65*4 B = 1,304,160 B of grid logits,
//   writes  8*512*1024*4 B = 16,777,216 B of ids,
//   ~18.1 MB in all -> ~5.4 us; the function is memory-bound.
// This simple form is not: it repeats the horizontal lerp of both grid rows
// for every output pixel, 9 unfused f32 operations per pixel and class
// (~717 M at full width), which is more than the memory time at the card's
// non-FMA f32 rate.  Sharing the horizontal lerps of a grid row across the
// threads of a block is the obvious next step; correctness comes first.
//
// Plain C interface (no PyTorch header): the caller passes raw device
// pointers and PyTorch's current stream, and reads cudaGetLastError() back
// as the return value.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void resize_argmax_kernel(const float* __restrict__ grid,
                                     const int* __restrict__ ylo,
                                     const int* __restrict__ yhi,
                                     const float* __restrict__ yw,
                                     const int* __restrict__ xlo,
                                     const int* __restrict__ xhi,
                                     const float* __restrict__ xw,
                                     int* __restrict__ out,
                                     int B, int C, int gh, int gw,
                                     int H, int W) {
    const long long total = (long long)B * H * W;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= total) return;
    const int x = (int)(p % W);
    const int y = (int)((p / W) % H);
    const int b = (int)(p / ((long long)W * H));

    const int y0 = ylo[y], y1 = yhi[y];
    const int x0 = xlo[x], x1 = xhi[x];
    const float wy = yw[y], wx = xw[x];

    const long long plane = (long long)gh * gw;
    const float* g = grid + (long long)b * C * plane;
    const int r0 = y0 * gw, r1 = y1 * gw;

    float best_val = -INFINITY;
    int best_idx = 0;
    for (int c = 0; c < C; ++c) {
        const float* gc = g + c * plane;
        const float tl = gc[r0 + x0], tr = gc[r0 + x1];
        const float bl = gc[r1 + x0], br = gc[r1 + x1];
        const float top = tl + (tr - tl) * wx;
        const float bot = bl + (br - bl) * wx;
        const float v = top + (bot - top) * wy;
        if (v > best_val) {  // strict: ties keep the lowest class id
            best_val = v;
            best_idx = c;
        }
    }
    out[p] = best_idx;
}

}  // namespace

extern "C" int resize_argmax_launch(const float* grid,
                                    const int* ylo, const int* yhi,
                                    const float* yw,
                                    const int* xlo, const int* xhi,
                                    const float* xw,
                                    int* out,
                                    int B, int C, int gh, int gw,
                                    int H, int W,
                                    void* stream) {
    const long long total = (long long)B * H * W;
    if (total == 0) return 0;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    resize_argmax_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        grid, ylo, yhi, yw, xlo, xhi, xw, out, B, C, gh, gw, H, W);
    return (int)cudaGetLastError();
}
