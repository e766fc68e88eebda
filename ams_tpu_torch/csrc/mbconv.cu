// Fused MobileNetV2 inverted-residual (MBConv) block, bf16, sm_90a.
//
// Replaces two Pallas TPU kernels with one:
//   K3 ams_tpu/ops/fused_mbconv.py:60 _mbconv_kernel (stride 1, rate 1 or 2,
//      on a zero-padded flat layout; pallas_call :150);
//   K4 ams_tpu/ops/fused_mbconv_banded.py:67 _s1_kernel and :112 _s2_kernel
//      (row bands, stride 1 or 2 through parity planes; pallas_call :275).
// It computes what they compute, not how:
//
//   mid = bf16(relu6(x . w_expand + b_expand))      zero outside the image
//   y   = bf16(relu6(depthwise3x3(mid; stride, rate) + b_dw))   f32 weights
//   out = bf16(y . w_proj + b_proj (+ x))
//
// with f32 accumulation everywhere and TF-'SAME' padding (asymmetric for an
// even stride-2 input).  A block without expand (the student's first) runs
// the depthwise on x itself.
//
// Design.  One thread block (256 threads) owns one output tile of
// tile_h x tile_w pixels of one image.  It copies the tile's input window
// with its halo, ((tile_h-1)*s + 2r + 1) x ((tile_w-1)*s + 2r + 1)
// positions of all Cin channels, into shared memory once (cp.async, zero
// filled outside the image).  Then, for each chunk of the Cmid mid channels:
//   0. the next chunk's weights start to land (cp.async into the second of
//      two buffers) while this chunk computes;
//   1. expand: (window x Cin) . (Cin x chunk) on the tensor cores (mma.sync
//      m16n8k16 bf16, f32 accumulation), + bias, relu6, every position
//      outside the image set to 0, bf16 into shared memory.  The folded bias
//      makes relu6(bias) != 0 at a padding position; the TPU kernels mask it
//      the same way (fused_mbconv.py:84-87, fused_mbconv_banded.py:89-92,
//      156-162);
//   2. depthwise: one thread per (pixel, channel pair), the nine taps summed
//      in f32 in row-major order (--fmad=false: the products and sums round
//      as PyTorch's do), + bias, relu6, bf16 into shared memory;
//   3. project: (pixels x chunk) . (chunk x Cout) on the tensor cores into
//      accumulators that stay in registers for the whole chunk loop: each
//      warp owns MT x NT tiles of 16 pixels x 8 channels (a template
//      argument, so the accumulator array is indexed statically).
// A chunk is 16 to 64 mid channels in steps of 16, or 8 where 16 does not
// divide Cmid: its project then runs at k = 16 over zero columns (packed
// weights and depthwise output), which leaves every f32 sum as it was.
// The epilogue adds the bias and the residual (from the input window) to
// the registers and stores bf16 pairs.
//
// What bounds it.  The block moves little: its input and output once and
// the weights (e.g. expanded_conv_2 at 8x24x129x257: 12.7 MB in and out,
// 3.8 us at 3.35 TB/s); the two 1x1 products are 1.8 GFLOP (1.8 us on the
// bf16 tensor cores), and the depthwise and elementwise work in f32 on the
// CUDA cores is 0.5 GFLOP (7 us at 67 TFLOP/s), so the f32 depthwise bounds
// it, ~10 us (chip_smoke.py computes the exact figures).  Keeping the 6x mid
// tensor in shared memory is the point: unfused it is written and read
// twice (~230 MB for that block).  What the first version lost on, and what
// this one does about it:
//   - weights restaged element by element (a 2-byte load, two integer
//     divisions and a transposed store each) in every chunk of every block:
//     the host packs them once in this kernel's layout (ops/fused_mbconv.py
//     pack_weights: per chunk, expand and project n-major, k contiguous, the
//     depthwise weights and biases beside them), so a chunk is staged by
//     16-byte cp.async copies, double-buffered behind the compute;
//   - an f32 project accumulator read and written in shared memory on every
//     tile of every chunk (84-86 KB at the tail, one block per SM): it lives
//     in registers now, and the shared memory it took is gone;
//   - fragments loaded as 32-bit words, six loads per mma: ldmatrix.x4 for
//     A, .x2/.x4 for B, row strides of 8 mod 16 elements (conflict free);
//     index maps (window row in the image, a pixel's window offset) are
//     tables built once per block, and the divisions left in the loops are
//     multiplications by a reciprocal (fdiv);
//   - a tile taken by size, not by waste: ops/fused_mbconv.py::stage_tile
//     now picks (tile, chunk, threads) by the window positions expanded plus
//     the pixels projected (ragged edge included), over the blocks resident
//     per SM, among tiles of width 8, 13, 16 and 32.  The residency is this
//     binary's own: mbconv_tilings gives the compiled tilings and their
//     registers, mbconv_resident CUDA's occupancy at a plan's shared memory.
// Still open (later work): wgmma and TMA, thread-block clusters sharing a
// window's expand between neighbouring tiles, persistent blocks.  The halo
// is still expanded again by each tile that reads it.
//
// Plain C interface (no PyTorch header): raw device pointers and PyTorch's
// current stream in, cudaGetLastError() out.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // 227 KB: the most a Hopper block may use

int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Plan {
    int cin_p, chunk_p;             // the 1x1 depths, rounded up to 16
    int halo_h, halo_w, halo_n, halo_np;
    int pix;                        // tile_h * tile_w, a multiple of 16
    int ld_x, ld_c;                 // row strides: window; mid, y, w_proj
    int off_in, off_pix, off_we, off_mid, off_y, off_wp, off_f;  // bytes
    int we_bytes, wp_bytes, f_bytes;   // one buffer each; the second follows
    int bytes;
};

// The shared-memory layout; ops/fused_mbconv.py::smem_bytes sums the same.
Plan make_plan(int Cin, int Cout, int stride, int rate, int has_expand,
               int tile_h, int tile_w, int chunk) {
    Plan p;
    p.cin_p = round_up(Cin, 16);
    p.chunk_p = round_up(chunk, 16);
    p.halo_h = (tile_h - 1) * stride + 2 * rate + 1;
    p.halo_w = (tile_w - 1) * stride + 2 * rate + 1;
    p.halo_n = p.halo_h * p.halo_w;
    p.halo_np = round_up(p.halo_n, 16);
    p.pix = tile_h * tile_w;
    // bf16 strides of 8 mod 16 elements put the 8 rows of an ldmatrix
    // phase on 8 different 16-byte bank groups
    p.ld_x = p.cin_p + 8;
    p.ld_c = p.chunk_p + 8;
    int off = round_up(p.halo_np * p.ld_x * 2, 16);          // window
    p.off_in = off;                                           // in-image flag
    off += round_up(p.halo_np, 16);
    p.off_pix = off;                                          // pixel offsets
    off += round_up(p.pix * 4, 16);
    p.we_bytes = has_expand ? round_up(chunk * p.ld_x * 2, 16) : 0;
    p.off_we = off;                                           // expand w x2
    off += 2 * p.we_bytes;
    p.off_mid = off;                                          // mid tile
    if (has_expand) off += round_up(p.halo_np * p.ld_c * 2, 16);
    p.off_y = off;                                            // depthwise out
    off += round_up(p.pix * p.ld_c * 2, 16);
    p.wp_bytes = round_up(Cout * p.ld_c * 2, 16);
    p.off_wp = off;                                           // project w x2
    off += 2 * p.wp_bytes;
    p.f_bytes = round_up(11 * chunk * 4, 16);
    p.off_f = off;                                            // f32 w, b x2
    off += 2 * p.f_bytes;
    p.bytes = off;
    return p;
}

struct Args {
    const __nv_bfloat16* x;
    const __nv_bfloat16* we;   // (Cmid, cin_p), zero beyond Cin; or null
    const __nv_bfloat16* wp;   // (Cmid/chunk, Cout, chunk_p), zero beyond
    const float* f;            // (Cmid/chunk, 11, chunk): 9 taps, b_dw, b_exp
    const float* bp;           // (Cout)
    __nv_bfloat16* out;
    int H, W, Cin, Cmid, Cout, Ho, Wo, stride, rate, pad_top, pad_left;
    int residual, has_expand, tile_h, tile_w, chunk, tiles_w;
    int warps_m;               // warps along the pixels in the project
    // reciprocals (fdiv) of cin_p/8, chunk_p/8, halo_w, tile_w and chunk/2
    uint64_t m_kv, m_cv, m_hw, m_tw, m_pairs;
    Plan p;
};

// n / d as a multiplication: m = ceil(2^32 / d), exact while n * d < 2^32
// (every index here is below 2^20 and every divisor below 2^10)
uint64_t reciprocal(int d) {
    return (0x100000000ull + (uint64_t)d - 1) / (uint64_t)d;
}

__device__ __forceinline__ int fdiv(int n, uint64_t m) {
    return (int)(((uint64_t)(uint32_t)n * m) >> 32);
}

__device__ __forceinline__ float relu6(float v) {
    return fminf(fmaxf(v, 0.0f), 6.0f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and lane l receives row l/4, columns 2(l%4), +1 of each
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p)));
}

// c[16x8] += A[16x16] . B[16x8]; a as ldsm_x4 gives it for a row-major A,
// b0/b1 as ldsm_x2 gives them for B stored n-major (k contiguous)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the copies of chunk c's weights into buffer buf, as one group.
__device__ __forceinline__ void stage_chunk(const Args& a, unsigned char* smem,
                                            int c, int buf, int tid) {
    const Plan& p = a.p;
    const int chunk = a.chunk;
    if (a.has_expand) {
        const int kv = p.cin_p / 8;
        const __nv_bfloat16* src = a.we + (size_t)c * chunk * p.cin_p;
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
            smem + p.off_we + buf * p.we_bytes);
        for (int v = tid; v < chunk * kv; v += kThreads) {
            const int n = fdiv(v, a.m_kv);
            cp_async16(dst + n * p.ld_x + (v - n * kv) * 8, src + v * 8, 16);
        }
    }
    {
        const int cv = p.chunk_p / 8;
        const __nv_bfloat16* src = a.wp + (size_t)c * a.Cout * p.chunk_p;
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
            smem + p.off_wp + buf * p.wp_bytes);
        for (int v = tid; v < a.Cout * cv; v += kThreads) {
            const int n = fdiv(v, a.m_cv);
            cp_async16(dst + n * p.ld_c + (v - n * cv) * 8, src + v * 8, 16);
        }
    }
    {
        const float* src = a.f + (size_t)c * 11 * chunk;
        float* dst = reinterpret_cast<float*>(smem + p.off_f + buf * p.f_bytes);
        for (int v = tid; v < 11 * chunk / 4; v += kThreads)
            cp_async16(dst + v * 4, src + v * 4, 16);
    }
    cp_async_commit();
}

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads)
mbconv_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Plan& p = a.p;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    uint8_t* inside = smem + p.off_in;
    int* pixoff = reinterpret_cast<int*>(smem + p.off_pix);
    __nv_bfloat16* mid_s = reinterpret_cast<__nv_bfloat16*>(smem + p.off_mid);
    __nv_bfloat16* y_s = reinterpret_cast<__nv_bfloat16*>(smem + p.off_y);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y;
    const int tile_y = blockIdx.x / a.tiles_w;
    const int tile_x = blockIdx.x - tile_y * a.tiles_w;
    const int oy0 = tile_y * a.tile_h, ox0 = tile_x * a.tile_w;
    const int iy0 = oy0 * a.stride - a.pad_top;
    const int ix0 = ox0 * a.stride - a.pad_left;
    const int H = a.H, W = a.W, Cin = a.Cin, chunk = a.chunk;
    const int kv = p.cin_p / 8;
    const uint64_t m_kv = a.m_kv, m_hw = a.m_hw, m_tw = a.m_tw;

    // the input window, zero outside the image and beyond Cin; with it, the
    // first chunk's weights, and the block's index tables
    {
        const __nv_bfloat16* xb = a.x + (size_t)b * H * W * Cin;
        for (int v = tid; v < p.halo_np * kv; v += kThreads) {
            const int pos = fdiv(v, m_kv), c = (v - pos * kv) * 8;
            const int hy = fdiv(pos, m_hw), hx = pos - hy * p.halo_w;
            const int iy = iy0 + hy, ix = ix0 + hx;
            const bool ok = pos < p.halo_n && iy >= 0 && iy < H && ix >= 0 &&
                            ix < W && c < Cin;
            cp_async16(xs + pos * p.ld_x + c,
                       ok ? xb + ((size_t)iy * W + ix) * Cin + c : xb,
                       ok ? 16 : 0);
        }
        for (int pos = tid; pos < p.halo_np; pos += kThreads) {
            const int hy = fdiv(pos, m_hw), hx = pos - hy * p.halo_w;
            const int iy = iy0 + hy, ix = ix0 + hx;
            inside[pos] = pos < p.halo_n && iy >= 0 && iy < H && ix >= 0 &&
                          ix < W;
        }
        // window position of each output pixel's first tap
        for (int q = tid; q < p.pix; q += kThreads) {
            const int qy = fdiv(q, m_tw), qx = q - qy * a.tile_w;
            pixoff[q] = qy * a.stride * p.halo_w + qx * a.stride;
        }
        // a chunk of 8 projects at k = 16: the depthwise output's columns
        // 8-15 stay zero (as the packed project weights' are)
        if (chunk < p.chunk_p)
            for (int q = tid; q < p.pix; q += kThreads)
                *reinterpret_cast<uint4*>(y_s + q * p.ld_c + chunk) =
                    make_uint4(0, 0, 0, 0);
    }
    stage_chunk(a, smem, 0, 0, tid);

    // the project tiles this warp owns for the whole chunk loop
    const int pm = p.pix / 16, pn = a.Cout / 8;
    const int warps_n = (pn + NT - 1) / NT;
    const bool owner = warp < a.warps_m * warps_n;
    const int wm = warp % a.warps_m;
    const int mt0 = wm * MT, nt0 = (warp / a.warps_m) * NT;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.0f;

    // ldmatrix address maps: A (x4) rows lane%16, k half lane/16; B (x2)
    // rows lane%8, k half (lane/8)%2; B (x4, two n-tiles) adds 8 rows for
    // lanes 16-31
    const int a_row = lane & 15, a_k = (lane >> 4) * 8;
    const int b_row = lane & 7, b_k = ((lane >> 3) & 1) * 8;
    const int b4_row = b_row + ((lane >> 4) << 3);
    const int g = lane >> 2, t = lane & 3;
    const int pairs = chunk / 2;
    const uint64_t m_pairs = a.m_pairs;
    const int nchunks = a.Cmid / chunk;

    for (int c = 0; c < nchunks; ++c) {
        const int buf = c & 1;
        cp_async_wait_all();
        __syncthreads();     // chunk c landed; chunk c-1 is done with buf^1
        if (c + 1 < nchunks) stage_chunk(a, smem, c + 1, buf ^ 1, tid);
        const float* fs = reinterpret_cast<const float*>(
            smem + p.off_f + buf * p.f_bytes);

        // 1. expand the whole window for this chunk: a warp per 16 rows,
        // all of the chunk's columns
        const __nv_bfloat16* src = xs + c * chunk;
        int ld_src = p.ld_x;
        if (a.has_expand) {
            const __nv_bfloat16* we_s = reinterpret_cast<const __nv_bfloat16*>(
                smem + p.off_we + buf * p.we_bytes);
            const int nt_n = chunk / 8;
            for (int mt = warp; mt < p.halo_np / 16; mt += kWarps) {
                float e[8][4];
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int u = 0; u < 4; ++u) e[j][u] = 0.0f;
                const __nv_bfloat16* ap = xs + (mt * 16 + a_row) * p.ld_x + a_k;
                const __nv_bfloat16* bq = we_s + b4_row * p.ld_x + b_k;
                const __nv_bfloat16* bq2 = we_s + b_row * p.ld_x + b_k;
                for (int k = 0; k < p.cin_p; k += 16) {
                    uint32_t af[4];
                    ldsm_x4(af, ap + k);
#pragma unroll
                    for (int jp = 0; jp < 4; ++jp) {
                        if (2 * jp + 1 < nt_n) {
                            uint32_t bf[4];
                            ldsm_x4(bf, bq + jp * 16 * p.ld_x + k);
                            mma_bf16(e[2 * jp], af, bf[0], bf[1]);
                            mma_bf16(e[2 * jp + 1], af, bf[2], bf[3]);
                        } else if (2 * jp < nt_n) {     // a chunk of 8
                            uint32_t bf[2];
                            ldsm_x2(bf, bq2 + jp * 16 * p.ld_x + k);
                            mma_bf16(e[2 * jp], af, bf[0], bf[1]);
                        }
                    }
                }
                const int r0 = mt * 16 + g;
                const bool in0 = inside[r0], in1 = inside[r0 + 8];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j < nt_n) {
                        const int col = j * 8 + 2 * t;
                        const float2 be = *reinterpret_cast<const float2*>(
                            fs + 10 * chunk + col);
                        *reinterpret_cast<__nv_bfloat162*>(
                            mid_s + r0 * p.ld_c + col) = __floats2bfloat162_rn(
                            in0 ? relu6(e[j][0] + be.x) : 0.0f,
                            in0 ? relu6(e[j][1] + be.y) : 0.0f);
                        *reinterpret_cast<__nv_bfloat162*>(
                            mid_s + (r0 + 8) * p.ld_c + col) =
                            __floats2bfloat162_rn(
                                in1 ? relu6(e[j][2] + be.x) : 0.0f,
                                in1 ? relu6(e[j][3] + be.y) : 0.0f);
                    }
                }
            }
            __syncthreads();
            src = mid_s;
            ld_src = p.ld_c;
        }

        // 2. depthwise 3x3 at (stride, rate), f32, taps in row-major order
        {
            const int cstep = a.rate * ld_src, rstep = p.halo_w * cstep;
            for (int i = tid; i < p.pix * pairs; i += kThreads) {
                const int q = fdiv(i, m_pairs), cp = (i - q * pairs) * 2;
                const __nv_bfloat16* mp = src + pixoff[q] * ld_src + cp;
                float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
                for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
                    for (int kx = 0; kx < 3; ++kx) {
                        const int tap = ky * 3 + kx;
                        const __nv_bfloat162 m =
                            *reinterpret_cast<const __nv_bfloat162*>(
                                mp + ky * rstep + kx * cstep);
                        const float2 w = *reinterpret_cast<const float2*>(
                            fs + tap * chunk + cp);
                        const float t0 = __low2float(m) * w.x;
                        const float t1 = __high2float(m) * w.y;
                        if (tap == 0) {
                            acc0 = t0;
                            acc1 = t1;
                        } else {
                            acc0 = acc0 + t0;
                            acc1 = acc1 + t1;
                        }
                    }
                }
                const float2 bd = *reinterpret_cast<const float2*>(
                    fs + 9 * chunk + cp);
                *reinterpret_cast<__nv_bfloat162*>(y_s + q * p.ld_c + cp) =
                    __floats2bfloat162_rn(relu6(acc0 + bd.x),
                                          relu6(acc1 + bd.y));
            }
        }
        __syncthreads();

        // 3. project this chunk into the registers
        if (owner) {
            const __nv_bfloat16* wp_s = reinterpret_cast<const __nv_bfloat16*>(
                smem + p.off_wp + buf * p.wp_bytes);
#pragma unroll 2
            for (int k = 0; k < p.chunk_p; k += 16) {
                uint32_t af[MT][4];
#pragma unroll
                for (int i = 0; i < MT; ++i)
                    if (mt0 + i < pm)
                        ldsm_x4(af[i], y_s + ((mt0 + i) * 16 + a_row) * p.ld_c +
                                           a_k + k);
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    if (nt0 + j < pn) {
                        uint32_t bf[2];
                        ldsm_x2(bf, wp_s + ((nt0 + j) * 8 + b_row) * p.ld_c +
                                        b_k + k);
#pragma unroll
                        for (int i = 0; i < MT; ++i)
                            if (mt0 + i < pm) mma_bf16(acc[i][j], af[i], bf[0],
                                                       bf[1]);
                    }
                }
            }
        }
    }

    // epilogue: + bias (+ residual) on the registers, bf16 pairs out
    if (!owner) return;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        if (mt0 + i >= pm) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int q = (mt0 + i) * 16 + g + 8 * h;
            const int qy = fdiv(q, m_tw), qx = q - qy * a.tile_w;
            const int oy = oy0 + qy, ox = ox0 + qx;
            if (oy >= a.Ho || ox >= a.Wo) continue;
            __nv_bfloat16* op =
                a.out + (((size_t)b * a.Ho + oy) * a.Wo + ox) * a.Cout;
            // stride 1: output (oy, ox) is window position (qy+pt, qx+pl)
            const __nv_bfloat16* xr =
                xs + ((qy + a.pad_top) * p.halo_w + qx + a.pad_left) * p.ld_x;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (nt0 + j >= pn) continue;
                const int n = (nt0 + j) * 8 + 2 * t;
                const float2 bias = __ldg(
                    reinterpret_cast<const float2*>(a.bp + n));
                float v0 = acc[i][j][2 * h] + bias.x;
                float v1 = acc[i][j][2 * h + 1] + bias.y;
                if (a.residual) {
                    const __nv_bfloat162 r =
                        *reinterpret_cast<const __nv_bfloat162*>(xr + n);
                    v0 = v0 + __low2float(r);
                    v1 = v1 + __high2float(r);
                }
                *reinterpret_cast<__nv_bfloat162*>(op + n) =
                    __floats2bfloat162_rn(v0, v1);
            }
        }
    }
}

// The (MT, NT) project tilings compiled.  ops/fused_mbconv.py reads them,
// with the registers each takes, through mbconv_tilings.
#define MBCONV_WARP_TILES(X) X(2, 2) X(2, 3) X(2, 4) X(3, 4) X(3, 5)

struct Tiling {
    int mt, nt;
    const void* fn;
};

#define MBCONV_TILING(M, N) {M, N, (const void*)mbconv_kernel<M, N>},
const Tiling kTilings[] = {MBCONV_WARP_TILES(MBCONV_TILING)};
#undef MBCONV_TILING
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);

const Tiling* find_tiling(int mt, int nt) {
    for (const Tiling& t : kTilings)
        if (t.mt == mt && t.nt == nt) return &t;
    return nullptr;
}

}  // namespace

// Bytes of dynamic shared memory one block takes for this plan.
extern "C" int mbconv_smem_bytes(int Cin, int Cout, int stride, int rate,
                                 int has_expand, int tile_h, int tile_w,
                                 int chunk) {
    return make_plan(Cin, Cout, stride, rate, has_expand, tile_h, tile_w,
                     chunk).bytes;
}

// The compiled tilings, up to cap of them: (mt, nt), the registers per
// thread and the local memory (spilled) bytes per thread of each.
// Returns how many there are, or -(CUDA error).
extern "C" int mbconv_tilings(int* mt, int* nt, int* regs, int* local_bytes,
                              int cap) {
    for (int i = 0; i < kNumTilings && i < cap; ++i) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kTilings[i].fn);
        if (err != cudaSuccess) return -(int)err;
        mt[i] = kTilings[i].mt;
        nt[i] = kTilings[i].nt;
        regs[i] = attr.numRegs;
        local_bytes[i] = (int)attr.localSizeBytes;
    }
    return kNumTilings;
}

// Blocks of tiling (mt, nt) resident per SM of the current device, each
// with smem_bytes of dynamic shared memory; -(CUDA error) on failure.
extern "C" int mbconv_resident(int mt, int nt, int smem_bytes) {
    const Tiling* t = find_tiling(mt, nt);
    if (t == nullptr || smem_bytes > kSmemLimit)
        return -(int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        t->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, t->fn, kThreads, smem_bytes);
    return err == cudaSuccess ? blocks : -(int)err;
}

// we, wp, f: the weights as ops/fused_mbconv.py::pack_weights lays them
// out for this chunk; we null for a block without expand.  (mt, nt): the
// warps' project tiling, one of MBCONV_WARP_TILES (ops/fused_mbconv.py
// warp_tiles); the block has 256 threads.  A chunk is 16 to 64 mid
// channels in steps of 16, or 8.
extern "C" int mbconv_launch(const __nv_bfloat16* x, const __nv_bfloat16* we,
                             const __nv_bfloat16* wp, const float* f,
                             const float* bp, __nv_bfloat16* out,
                             int B, int H, int W, int Cin, int Cmid, int Cout,
                             int Ho, int Wo, int stride, int rate,
                             int pad_top, int pad_left, int residual,
                             int tile_h, int tile_w, int chunk, int mt,
                             int nt, void* stream) {
    const int has_expand = we != nullptr;
    const int pm = tile_h * tile_w / 16, pn = Cout / 8;
    const Tiling* tiling = find_tiling(mt, nt);
    if (Cin % 8 || Cmid % 8 || Cout % 8 || chunk % 8 ||
        (chunk > 8 && chunk % 16) || chunk > 64 ||
        Cmid % chunk || tile_h < 1 || tile_w < 1 ||
        (tile_h * tile_w) % 16 || (stride != 1 && stride != 2) || rate < 1 ||
        (!has_expand && Cmid != Cin) ||
        (residual && (stride != 1 || Cin != Cout)) || tiling == nullptr ||
        ((pm + mt - 1) / mt) * ((pn + nt - 1) / nt) > kWarps)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || Ho == 0 || Wo == 0) return 0;
    Args a;
    a.x = x; a.we = we; a.wp = wp; a.f = f; a.bp = bp; a.out = out;
    a.H = H; a.W = W; a.Cin = Cin; a.Cmid = Cmid; a.Cout = Cout;
    a.Ho = Ho; a.Wo = Wo; a.stride = stride; a.rate = rate;
    a.pad_top = pad_top; a.pad_left = pad_left; a.residual = residual;
    a.has_expand = has_expand; a.tile_h = tile_h; a.tile_w = tile_w;
    a.chunk = chunk;
    a.tiles_w = (Wo + tile_w - 1) / tile_w;
    a.warps_m = (pm + mt - 1) / mt;
    a.m_kv = reciprocal(round_up(Cin, 16) / 8);
    a.m_cv = reciprocal(round_up(chunk, 16) / 8);
    a.m_tw = reciprocal(tile_w);
    a.m_pairs = reciprocal(chunk / 2);
    a.p = make_plan(Cin, Cout, stride, rate, has_expand, tile_h, tile_w,
                    chunk);
    if (a.p.bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
    a.m_hw = reciprocal(a.p.halo_w);
    const int tiles_h = (Ho + tile_h - 1) / tile_h;
    dim3 grid((unsigned)(a.tiles_w * tiles_h), (unsigned)B);
    cudaError_t err = cudaFuncSetAttribute(
        tiling->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.bytes);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&a};
    err = cudaLaunchKernel(tiling->fn, grid, dim3(kThreads), args, a.p.bytes,
                           (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
