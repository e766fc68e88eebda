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
// tile_h x tile_w pixels of one image.  It loads the tile's input window with
// its halo, ((tile_h-1)*s + 2r + 1) x ((tile_w-1)*s + 2r + 1) positions of all
// Cin channels, into shared memory once, out-of-image positions as zeros.
// Then, for each chunk of the Cmid mid channels:
//   1. expand: an (window x Cin) . (Cin x chunk) product on the tensor cores
//      (mma.sync m16n8k16 bf16, f32 accumulation), + bias, relu6, every
//      position outside the image set to 0, bf16 into shared memory.  The
//      folded bias makes relu6(bias) != 0 at a padding position; the TPU
//      kernels mask it the same way (fused_mbconv.py:84-87,
//      fused_mbconv_banded.py:89-92,156-162);
//   2. depthwise: one thread per (pixel, channel pair), the nine taps summed
//      in f32 in row-major order (--fmad=false: the products and sums round
//      as PyTorch's do), + bias, relu6, bf16 into shared memory;
//   3. project: (pixels x chunk) . (chunk x Cout) on the tensor cores, added
//      into an f32 accumulator for the tile in shared memory.
// The epilogue adds the bias and the residual (from the input tile) and
// writes bf16, 16 bytes per thread.  The host picks tile and chunk
// (ops/fused_mbconv.py::stage_tile) so that shared memory stays under
// 227 KB; make_plan below computes the same layout and refuses more.
//
// What bounds it.  The block moves little: its input and output once and
// the weights (e.g. expanded_conv_2 at 8x24x129x257: 12.7 MB in and out,
// 3.8 us at 3.35 TB/s); the two 1x1 products are 1.8 GFLOP (1.8 us on the
// bf16 tensor cores), and the depthwise and elementwise work in f32 on the
// CUDA cores is 0.5 GFLOP (7 us at 67 TFLOP/s), so the f32 depthwise bounds
// it, ~10 us (chip_smoke.py computes the exact figures).  Keeping the 6x mid
// tensor in shared memory is the point: unfused it is written and read
// twice (~230 MB for that block).  This first version is simple rather than
// fast: one block per SM at the large tiles, no overlap of loads with
// compute, weights restaged every chunk, the halo's expand recomputed by
// neighbouring tiles.  wgmma, TMA and a pipelined chunk loop are later work.
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
    int cin_p, chunk_p;            // GEMM depths rounded up to 16
    int halo_h, halo_w, halo_n, halo_np;
    int pix;                        // tile_h * tile_w, a multiple of 16
    int ld_x, ld_we, ld_mid, ld_y, ld_acc;   // shared-memory row strides
    int off_we, off_mid, off_y, off_wp, off_acc, off_f;   // byte offsets
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
    // bf16 strides of 8 mod 16 elements keep the mma fragment loads free
    // of bank conflicts; the f32 stride of 8 mod 32 does the same for the
    // accumulator's float2 accesses
    p.ld_x = p.cin_p + 8;
    p.ld_we = p.cin_p + 8;
    p.ld_mid = chunk + 8;
    p.ld_y = p.chunk_p + 8;
    p.ld_acc = (Cout + 23) / 32 * 32 + 8;
    int off = round_up(p.halo_np * p.ld_x * 2, 16);
    p.off_we = off;
    if (has_expand) off += round_up(chunk * p.ld_we * 2, 16);
    p.off_mid = off;
    if (has_expand) off += round_up(p.halo_np * p.ld_mid * 2, 16);
    p.off_y = off;
    off += round_up(p.pix * p.ld_y * 2, 16);
    p.off_wp = off;
    off += round_up(Cout * p.ld_y * 2, 16);
    p.off_acc = off;
    off += round_up(p.pix * p.ld_acc * 4, 16);
    p.off_f = off;
    off += round_up(11 * chunk * 4, 16);
    p.bytes = off;
    return p;
}

struct Args {
    const __nv_bfloat16* x;
    const __nv_bfloat16* we;   // (Cin, Cmid) or null
    const float* be;           // (Cmid) or null
    const float* wd;           // (9, Cmid)
    const float* bd;           // (Cmid)
    const __nv_bfloat16* wp;   // (Cmid, Cout)
    const float* bp;           // (Cout)
    __nv_bfloat16* out;
    int H, W, Cin, Cmid, Cout, Ho, Wo, stride, rate, pad_top, pad_left;
    int residual, has_expand, tile_h, tile_w, chunk, tiles_w;
    Plan p;
};

__device__ __forceinline__ float relu6(float v) {
    return fminf(fmaxf(v, 0.0f), 6.0f);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c[16x8] (+)= A[16xK] . B[Kx8], A row-major at a (stride lda), B stored
// n-major at b (stride ldb: b[n*ldb + k]), K a multiple of 16.  Fragment
// layout of mma.m16n8k16: g = lane/4 picks the row (A, C) or column (B),
// t = lane%4 the pair of k (A, B) or of columns (C).
__device__ __forceinline__ void mma_tile(float* c, const __nv_bfloat16* a,
                                         int lda, const __nv_bfloat16* b,
                                         int ldb, int K, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* a0 = a + g * lda + 2 * t;
    const __nv_bfloat16* a1 = a0 + 8 * lda;
    const __nv_bfloat16* b0 = b + g * ldb + 2 * t;
    for (int k = 0; k < K; k += 16) {
        mma_bf16(c, ld32(a0 + k), ld32(a1 + k), ld32(a0 + k + 8),
                 ld32(a1 + k + 8), ld32(b0 + k), ld32(b0 + k + 8));
    }
}

__global__ void __launch_bounds__(kThreads)
mbconv_kernel(const Args args) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Plan p = args.p;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* we_s = reinterpret_cast<__nv_bfloat16*>(smem + p.off_we);
    __nv_bfloat16* mid_s = reinterpret_cast<__nv_bfloat16*>(smem + p.off_mid);
    __nv_bfloat16* y_s = reinterpret_cast<__nv_bfloat16*>(smem + p.off_y);
    __nv_bfloat16* wp_s = reinterpret_cast<__nv_bfloat16*>(smem + p.off_wp);
    float* acc_s = reinterpret_cast<float*>(smem + p.off_acc);
    float* wd_s = reinterpret_cast<float*>(smem + p.off_f);   // [9][chunk]
    float* bd_s = wd_s + 9 * args.chunk;
    float* be_s = bd_s + args.chunk;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y;
    const int tile_y = blockIdx.x / args.tiles_w;
    const int tile_x = blockIdx.x - tile_y * args.tiles_w;
    const int oy0 = tile_y * args.tile_h, ox0 = tile_x * args.tile_w;
    const int iy0 = oy0 * args.stride - args.pad_top;
    const int ix0 = ox0 * args.stride - args.pad_left;
    const int H = args.H, W = args.W, Cin = args.Cin, Cout = args.Cout;
    const int chunk = args.chunk, s = args.stride, r = args.rate;

    // the input window, zero outside the image and beyond Cin
    {
        const int vecs = p.cin_p / 8;
        const __nv_bfloat16* xb = args.x + (size_t)b * H * W * Cin;
        for (int i = tid; i < p.halo_np * vecs; i += kThreads) {
            const int pos = i / vecs, c = (i - pos * vecs) * 8;
            const int hy = pos / p.halo_w, hx = pos - hy * p.halo_w;
            const int iy = iy0 + hy, ix = ix0 + hx;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (pos < p.halo_n && iy >= 0 && iy < H && ix >= 0 && ix < W &&
                c < Cin) {
                v = *reinterpret_cast<const uint4*>(
                    xb + ((size_t)iy * W + ix) * Cin + c);
            }
            *reinterpret_cast<uint4*>(xs + pos * p.ld_x + c) = v;
        }
        // the depthwise never writes y_s's k-padding; the project reads it
        for (int i = tid; i < p.pix * (p.chunk_p - chunk); i += kThreads) {
            const int q = i / (p.chunk_p - chunk);
            y_s[q * p.ld_y + chunk + (i - q * (p.chunk_p - chunk))] =
                __float2bfloat16_rn(0.0f);
        }
    }

    for (int c0 = 0; c0 < args.Cmid; c0 += chunk) {
        // this chunk's weights: expand and project n-major (k contiguous)
        if (args.has_expand) {
            for (int i = tid; i < p.cin_p * chunk; i += kThreads) {
                const int k = i / chunk, n = i - k * chunk;
                we_s[n * p.ld_we + k] = k < Cin
                    ? args.we[(size_t)k * args.Cmid + c0 + n]
                    : __float2bfloat16_rn(0.0f);
            }
            for (int i = tid; i < chunk; i += kThreads)
                be_s[i] = args.be[c0 + i];
        }
        for (int i = tid; i < p.chunk_p * Cout; i += kThreads) {
            const int k = i / Cout, n = i - k * Cout;
            wp_s[n * p.ld_y + k] = k < chunk
                ? args.wp[(size_t)(c0 + k) * Cout + n]
                : __float2bfloat16_rn(0.0f);
        }
        for (int i = tid; i < 9 * chunk; i += kThreads) {
            const int tap = i / chunk, n = i - tap * chunk;
            wd_s[i] = args.wd[tap * args.Cmid + c0 + n];
        }
        for (int i = tid; i < chunk; i += kThreads)
            bd_s[i] = args.bd[c0 + i];
        __syncthreads();

        // 1. expand the whole window for this chunk
        const __nv_bfloat16* src = xs + c0;
        int ld_src = p.ld_x;
        if (args.has_expand) {
            const int nt_n = chunk / 8, tiles = (p.halo_np / 16) * nt_n;
            const int g = lane >> 2, t = lane & 3;
            for (int tile = warp; tile < tiles; tile += kWarps) {
                const int mt = tile / nt_n, nt = tile - mt * nt_n;
                float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_tile(c, xs + mt * 16 * p.ld_x, p.ld_x,
                         we_s + nt * 8 * p.ld_we, p.ld_we, p.cin_p, lane);
                const int col = nt * 8 + 2 * t;
                const float bias0 = be_s[col], bias1 = be_s[col + 1];
                for (int half = 0; half < 2; ++half) {
                    const int row = mt * 16 + g + 8 * half;
                    const int hy = row / p.halo_w, hx = row - hy * p.halo_w;
                    const int iy = iy0 + hy, ix = ix0 + hx;
                    const bool inside = row < p.halo_n && iy >= 0 && iy < H &&
                                        ix >= 0 && ix < W;
                    const float v0 = inside ? relu6(c[2 * half] + bias0) : 0.0f;
                    const float v1 = inside ? relu6(c[2 * half + 1] + bias1)
                                            : 0.0f;
                    *reinterpret_cast<__nv_bfloat162*>(
                        mid_s + row * p.ld_mid + col) =
                        __floats2bfloat162_rn(v0, v1);
                }
            }
            __syncthreads();
            src = mid_s;
            ld_src = p.ld_mid;
        }

        // 2. depthwise 3x3 at (stride, rate), f32, taps in row-major order
        {
            const int pairs = chunk / 2;
            for (int i = tid; i < p.pix * pairs; i += kThreads) {
                const int q = i / pairs, cp = (i - q * pairs) * 2;
                const int qy = q / args.tile_w, qx = q - qy * args.tile_w;
                float acc0 = 0.0f, acc1 = 0.0f;
                for (int ky = 0; ky < 3; ++ky) {
                    for (int kx = 0; kx < 3; ++kx) {
                        const int pos = (qy * s + ky * r) * p.halo_w +
                                        qx * s + kx * r;
                        const __nv_bfloat162 m =
                            *reinterpret_cast<const __nv_bfloat162*>(
                                src + pos * ld_src + cp);
                        const int tap = ky * 3 + kx;
                        const float t0 = __low2float(m) * wd_s[tap * chunk + cp];
                        const float t1 = __high2float(m) *
                                         wd_s[tap * chunk + cp + 1];
                        if (tap == 0) {
                            acc0 = t0;
                            acc1 = t1;
                        } else {
                            acc0 = acc0 + t0;
                            acc1 = acc1 + t1;
                        }
                    }
                }
                *reinterpret_cast<__nv_bfloat162*>(y_s + q * p.ld_y + cp) =
                    __floats2bfloat162_rn(relu6(acc0 + bd_s[cp]),
                                          relu6(acc1 + bd_s[cp + 1]));
            }
        }
        __syncthreads();

        // 3. project this chunk into the f32 accumulator
        {
            const int nt_n = Cout / 8, tiles = (p.pix / 16) * nt_n;
            const int g = lane >> 2, t = lane & 3;
            for (int tile = warp; tile < tiles; tile += kWarps) {
                const int mt = tile / nt_n, nt = tile - mt * nt_n;
                float* c01 = acc_s + (mt * 16 + g) * p.ld_acc + nt * 8 + 2 * t;
                float* c23 = c01 + 8 * p.ld_acc;
                float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                if (c0 > 0) {
                    const float2 u = *reinterpret_cast<float2*>(c01);
                    const float2 v = *reinterpret_cast<float2*>(c23);
                    c[0] = u.x; c[1] = u.y; c[2] = v.x; c[3] = v.y;
                }
                mma_tile(c, y_s + mt * 16 * p.ld_y, p.ld_y,
                         wp_s + nt * 8 * p.ld_y, p.ld_y, p.chunk_p, lane);
                *reinterpret_cast<float2*>(c01) = make_float2(c[0], c[1]);
                *reinterpret_cast<float2*>(c23) = make_float2(c[2], c[3]);
            }
        }
        __syncthreads();
    }

    // epilogue: + bias (+ residual), bf16, 8 channels per thread
    const int vecs = Cout / 8;
    for (int i = tid; i < p.pix * vecs; i += kThreads) {
        const int q = i / vecs, co = (i - q * vecs) * 8;
        const int qy = q / args.tile_w, qx = q - qy * args.tile_w;
        const int oy = oy0 + qy, ox = ox0 + qx;
        if (oy >= args.Ho || ox >= args.Wo) continue;
        const float4 lo = *reinterpret_cast<const float4*>(
            acc_s + q * p.ld_acc + co);
        const float4 hi = *reinterpret_cast<const float4*>(
            acc_s + q * p.ld_acc + co + 4);
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        for (int j = 0; j < 8; ++j) v[j] = v[j] + args.bp[co + j];
        if (args.residual) {
            // stride 1: output (oy, ox) is window position (qy+pt, qx+pl)
            const int pos = (qy + args.pad_top) * p.halo_w + qx + args.pad_left;
            const uint4 xr = *reinterpret_cast<const uint4*>(
                xs + pos * p.ld_x + co);
            const __nv_bfloat162* xp =
                reinterpret_cast<const __nv_bfloat162*>(&xr);
            for (int j = 0; j < 4; ++j) {
                v[2 * j] = v[2 * j] + __low2float(xp[j]);
                v[2 * j + 1] = v[2 * j + 1] + __high2float(xp[j]);
            }
        }
        uint4 o;
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
        for (int j = 0; j < 4; ++j)
            op[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(
            args.out + (((size_t)b * args.Ho + oy) * args.Wo + ox) * Cout +
            co) = o;
    }
}

}  // namespace

// Bytes of dynamic shared memory one block takes for this plan.
extern "C" int mbconv_smem_bytes(int Cin, int Cout, int stride, int rate,
                                 int has_expand, int tile_h, int tile_w,
                                 int chunk) {
    return make_plan(Cin, Cout, stride, rate, has_expand, tile_h, tile_w,
                     chunk).bytes;
}

extern "C" int mbconv_launch(const __nv_bfloat16* x, const __nv_bfloat16* we,
                             const float* be, const float* wd, const float* bd,
                             const __nv_bfloat16* wp, const float* bp,
                             __nv_bfloat16* out,
                             int B, int H, int W, int Cin, int Cmid, int Cout,
                             int Ho, int Wo, int stride, int rate,
                             int pad_top, int pad_left, int residual,
                             int tile_h, int tile_w, int chunk,
                             void* stream) {
    const int has_expand = we != nullptr;
    if (Cin % 8 || Cmid % 8 || Cout % 8 || chunk % 8 || Cmid % chunk ||
        (tile_h * tile_w) % 16 || (!has_expand && Cmid != Cin) ||
        (residual && (stride != 1 || Cin != Cout)))
        return (int)cudaErrorInvalidValue;
    if (B == 0 || Ho == 0 || Wo == 0) return 0;
    Args a;
    a.x = x; a.we = we; a.be = be; a.wd = wd; a.bd = bd; a.wp = wp; a.bp = bp;
    a.out = out;
    a.H = H; a.W = W; a.Cin = Cin; a.Cmid = Cmid; a.Cout = Cout;
    a.Ho = Ho; a.Wo = Wo; a.stride = stride; a.rate = rate;
    a.pad_top = pad_top; a.pad_left = pad_left; a.residual = residual;
    a.has_expand = has_expand; a.tile_h = tile_h; a.tile_w = tile_w;
    a.chunk = chunk;
    a.tiles_w = (Wo + tile_w - 1) / tile_w;
    a.p = make_plan(Cin, Cout, stride, rate, has_expand, tile_h, tile_w,
                    chunk);
    if (a.p.bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
    const int tiles_h = (Ho + tile_h - 1) / tile_h;
    cudaError_t err = cudaFuncSetAttribute(
        mbconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.p.bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)(a.tiles_w * tiles_h), (unsigned)B);
    mbconv_kernel<<<grid, kThreads, a.p.bytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
