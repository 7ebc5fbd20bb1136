// Fused residual MLP block on the tensor cores (bfloat16), CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/fused_block.py::_kernel on the
// bfloat16 path, prefill and decode; fused_block.cu keeps float32.  It
// computes, with the TPU kernel's rounding points
// (fused_block.py:48 and :58) and float32 accumulation,
//
//     n = bf16(rmsnorm(x) * (1 + scale))
//     h = bf16(act(n @ Wg) * (n @ Wu))     (gated; act(n @ Wu) ungated)
//     y = h @ Wd
//     out = bf16(x + [rmsnorm(y) * (1 + post)])      (sandwich)
//
// What bounds it on the card: at recurrentgemma-2b's prefill (M 6,144,
// d 2,560, F 7,680) the three products, 2 * M * d * F * 3 = 725 G operations
// against 149 MB of inputs and outputs, at the bfloat16 tensor-core rate; at
// its decode (M 2) the 118 MB of weights.  At decode one row tile computes
// 126 rows of zeros, and the down product has only d / 128 = 20 blocks: the
// tiles are sized for the prefill.
//
// Design.  The TPU kernel's shape (a row tile owning its whole [bm, d]
// accumulator while all of F streams past) makes a block of a few rows read
// every weight on Hopper.  Here the block is four passes, each a kernel on
// the same stream:
//
//   1. norm  -- a warp a row: n to a [M, d] bfloat16 scratch.
//   2. up    -- tiles of 128 rows x 64 columns of F; the gate and up
//               products share one A tile of n (two float32 accumulators;
//               ungated: 128 columns of n @ Wu).  The epilogue writes h to a
//               [M, F] bfloat16 scratch.
//   3. down  -- tiles of 128 rows x 128 columns of d of h @ Wd.  The
//               epilogue writes bf16(x + y), or with the sandwich norm y in
//               float32 to a [M, d] scratch, because the norm needs a row's
//               whole y.
//   4. post  -- (sandwich only) a warp a row: x + rmsnorm(y) * (1 + post).
//
// The partial form (tensor parallelism over F, models/layers.py::
// mlp_apply) stops after pass 3 with y in float32 as the output: the
// ranks' partial sums are added before the norm and the residual.
//
// The two products are one main loop: 8 warps, each 32 rows x 64 output
// columns (2 x 8 m16n8k16 tiles, 64 float32 accumulators); K in steps of
// 64 through a 3-stage ring of cp.async copies into shared memory (rows
// padded by 16 bytes, so ldmatrix reads without bank conflicts); A by
// ldmatrix, the [K, N] row-major weights as the B operand by ldmatrix.trans.
// Blocks are ordered in groups of 16 row tiles, so the weight columns in
// flight are read from device memory once per group and the row tiles stay
// in L2.  Ragged M, N and K are masked: copies past an edge are zero-filled
// (cp.async with 0 source bytes) and stores past it are skipped.
//
// Alignment: every copy is 16 bytes, so d and F must be multiples of 8 and
// every pointer 16-byte aligned.  The wrapper routes anything else (F = 333,
// say) to fused_block.cu by a fixed rule (kernels/fused_block.py::
// fused_block_variant); this entry point refuses it.
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;              // threads per block: 8 warps, 4 x 2
constexpr int BM = 128;              // rows of a tile
constexpr int BN = 128;              // output columns of a tile (all B's)
constexpr int BK = 64;               // K per stage
constexpr int STAGES = 3;
constexpr int A_LD = BK + 8;         // padded row strides, in elements
constexpr int GROUP_M = 16;          // row tiles per group of blocks
constexpr int ROWS_PER_BLOCK = NT / 32;   // norm passes: a warp a row

// NB = 2: gate and up, 64 columns each; NB = 1: one B of 128 columns
template <int NB>
struct Tile {
    static constexpr int BNB = BN / NB;          // columns of one B tile
    static constexpr int B_LD = BNB + 8;
    static constexpr int NTW = BNB / 16;         // n8 tiles a warp, per B
    static constexpr int A_ELEMS = BM * A_LD;
    static constexpr int B_ELEMS = BK * B_LD;
    static constexpr int STAGE = A_ELEMS + NB * B_ELEMS;
    static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(bf16);
};

__device__ __forceinline__ float act(float x, int gelu) {
    if (gelu) {          // tanh approximation, jax.nn.gelu(approximate=True)
        const float k0 = 0.7978845608028654f;            // sqrt(2 / pi)
        return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
    }
    return x / (1.f + expf(-x));                         // silu
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// the tile (tm, tn) of block `bid`: groups of GROUP_M row tiles, the row
// tile fastest inside a group
__device__ __forceinline__ void tile_of(int bid, int m_tiles, int n_tiles,
                                        int& tm, int& tn) {
    const int per_group = GROUP_M * n_tiles;
    const int first = (bid / per_group) * GROUP_M;
    const int size = min(m_tiles - first, GROUP_M);
    const int in = bid % per_group;
    tm = first + in % size;
    tn = in / size;
}

// one stage of the ring: A [BM x BK] at (m0, k0) and each B [BK x BNB] at
// (k0, n0); zero-filled past M, N and K
template <int NB>
__device__ __forceinline__ void load_stage(
        bf16* st, const bf16* __restrict__ A, int lda,
        const bf16* __restrict__ B0, const bf16* __restrict__ B1, int ldb,
        int M, int N, int K, int m0, int n0, int k0) {
    using TL = Tile<NB>;
    constexpr int A_CHUNKS = BK / 8;                 // 16-byte chunks a row
#pragma unroll
    for (int it = 0; it < BM * A_CHUNKS / NT; ++it) {
        const int i = threadIdx.x + it * NT;
        const int r = i / A_CHUNKS, c = (i % A_CHUNKS) * 8;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        tc::cp_async16(st + r * A_LD + c,
                       ok ? A + (long long)gm * lda + gk : A, ok);
    }
    constexpr int B_CHUNKS = TL::BNB / 8;
    static_assert((BM * A_CHUNKS) % NT == 0 && (BK * B_CHUNKS) % NT == 0,
                  "a stage is a whole number of copies a thread");
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        bf16* bs = st + TL::A_ELEMS + b * TL::B_ELEMS;
        const bf16* Bg = b == 0 ? B0 : B1;
#pragma unroll
        for (int it = 0; it < BK * B_CHUNKS / NT; ++it) {
            const int i = threadIdx.x + it * NT;
            const int r = i / B_CHUNKS, c = (i % B_CHUNKS) * 8;
            const int gk = k0 + r, gn = n0 + c;
            const bool ok = gk < K && gn < N;
            tc::cp_async16(bs + r * TL::B_LD + c,
                           ok ? Bg + (long long)gk * ldb + gn : Bg, ok);
        }
    }
}

// acc[b] += A[m0:m0+BM, :K] @ B_b[:K, n0:n0+BNB] for this warp's part of
// the tile: rows 32 * (warp % 4) .., columns (BNB / 2) * (warp / 4) ..
template <int NB>
__device__ __forceinline__ void mainloop(
        const bf16* __restrict__ A, int lda, const bf16* __restrict__ B0,
        const bf16* __restrict__ B1, int ldb, int M, int N, int K, int m0,
        int n0, float (&acc)[NB][2][Tile<NB>::NTW][4], bf16* smem) {
    using TL = Tile<NB>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wr = (warp % 4) * 32, wc = (warp / 4) * (TL::BNB / 2);
    const int k_tiles = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < k_tiles)
            load_stage<NB>(smem + s * TL::STAGE, A, lda, B0, B1, ldb, M, N,
                           K, m0, n0, s * BK);
        tc::cp_async_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
        tc::cp_async_wait<STAGES - 2>();     // stage kt has landed
        __syncthreads();                     // ... and stage kt - 1 is free
        const int next = kt + STAGES - 1;
        if (next < k_tiles)
            load_stage<NB>(smem + (next % STAGES) * TL::STAGE, A, lda, B0,
                           B1, ldb, M, N, K, m0, n0, next * BK);
        tc::cp_async_commit();
        const bf16* as = smem + (kt % STAGES) * TL::STAGE;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
                tc::ldmatrix_x4(a[mi], as + (wr + mi * 16 + lane % 16) * A_LD
                                           + kk + (lane / 16) * 8);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                const bf16* bs = as + TL::A_ELEMS + b * TL::B_ELEMS;
#pragma unroll
                for (int nj = 0; nj < TL::NTW / 2; ++nj) {
                    uint32_t r[4];
                    tc::ldmatrix_x4_trans(
                        r, bs + (kk + lane % 16) * TL::B_LD + wc + nj * 16
                               + (lane / 16) * 8);
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi) {
                        tc::mma_bf16(acc[b][mi][2 * nj], a[mi], r[0], r[1]);
                        tc::mma_bf16(acc[b][mi][2 * nj + 1], a[mi], r[2],
                                     r[3]);
                    }
                }
            }
        }
    }
    tc::cp_async_wait<0>();
}

// ---- pass 1: n = bf16(rmsnorm(x) * (1 + scale)), a warp a row
__global__ void __launch_bounds__(NT) fused_block_norm_kernel(
        const bf16* __restrict__ x, const float* __restrict__ scale,
        bf16* __restrict__ n, int M, int d, float eps) {
    const int lane = threadIdx.x % 32;
    const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
    if (row >= M) return;
    const bf16* xr = x + (long long)row * d;
    float sq = 0.f;
    for (int c = lane * 8; c < d; c += 256) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = tc::unpack_bf16(w[i]);
            sq += f.x * f.x + f.y * f.y;
        }
    }
    const float inv = rsqrtf(warp_sum(sq) / (float)d + eps);
    bf16* nr = n + (long long)row * d;
    for (int c = lane * 8; c < d; c += 256) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = tc::unpack_bf16(w[i]);
            o[i] = tc::pack_bf16(f.x * inv * (1.f + scale[c + 2 * i]),
                                 f.y * inv * (1.f + scale[c + 2 * i + 1]));
        }
        *reinterpret_cast<uint4*>(nr + c) = make_uint4(o[0], o[1], o[2],
                                                       o[3]);
    }
}

// ---- pass 2: h = bf16(act(n @ Wg) * (n @ Wu))  (NB 2; NB 1: act(n @ Wu))
template <int NB>
__global__ void __launch_bounds__(NT, 2) fused_block_up_kernel(
        const bf16* __restrict__ n, const bf16* __restrict__ w0,
        const bf16* __restrict__ w1, bf16* __restrict__ h, int M, int d,
        int F, int gelu) {
    using TL = Tile<NB>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int tm, tn;
    tile_of(blockIdx.x, (M + BM - 1) / BM, (F + TL::BNB - 1) / TL::BNB, tm,
            tn);
    const int m0 = tm * BM, n0 = tn * TL::BNB;
    float acc[NB][2][TL::NTW][4];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < TL::NTW; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[b][mi][j][e] = 0.f;
    mainloop<NB>(n, d, w0, w1, F, M, F, d, m0, n0, acc,
                 reinterpret_cast<bf16*>(smem_raw));

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = m0 + (warp % 4) * 32 + lane / 4;
    const int c0 = n0 + (warp / 4) * (TL::BNB / 2) + 2 * (lane % 4);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = r0 + mi * 16 + half * 8;
            if (row >= M) continue;
#pragma unroll
            for (int j = 0; j < TL::NTW; ++j) {
                const int col = c0 + j * 8;
                if (col >= F) continue;
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float a = acc[0][mi][j][2 * half + e];
                    v[e] = NB == 2 ? act(a, gelu)
                                         * acc[NB - 1][mi][j][2 * half + e]
                                   : act(a, gelu);
                }
                *reinterpret_cast<uint32_t*>(h + (long long)row * F + col) =
                    tc::pack_bf16(v[0], v[1]);
            }
        }
}

// ---- pass 3: y = h @ Wd; out = bf16(x + y), or y in float32 (sandwich)
__global__ void __launch_bounds__(NT, 2) fused_block_down_kernel(
        const bf16* __restrict__ h, const bf16* __restrict__ wd,
        const bf16* __restrict__ x, bf16* __restrict__ out,
        float* __restrict__ y, int M, int d, int F) {
    using TL = Tile<1>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int tm, tn;
    tile_of(blockIdx.x, (M + BM - 1) / BM, (d + BN - 1) / BN, tm, tn);
    const int m0 = tm * BM, n0 = tn * BN;
    float acc[1][2][TL::NTW][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < TL::NTW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][mi][j][e] = 0.f;
    mainloop<1>(h, F, wd, nullptr, d, M, d, F, m0, n0, acc,
                reinterpret_cast<bf16*>(smem_raw));

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = m0 + (warp % 4) * 32 + lane / 4;
    const int c0 = n0 + (warp / 4) * (BN / 2) + 2 * (lane % 4);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = r0 + mi * 16 + half * 8;
            if (row >= M) continue;
#pragma unroll
            for (int j = 0; j < TL::NTW; ++j) {
                const int col = c0 + j * 8;
                if (col >= d) continue;
                const long long at = (long long)row * d + col;
                const float y0 = acc[0][mi][j][2 * half];
                const float y1 = acc[0][mi][j][2 * half + 1];
                if (y != nullptr) {
                    *reinterpret_cast<float2*>(y + at) = make_float2(y0, y1);
                } else {
                    const float2 xv = tc::unpack_bf16(
                        *reinterpret_cast<const uint32_t*>(x + at));
                    *reinterpret_cast<uint32_t*>(out + at) =
                        tc::pack_bf16(xv.x + y0, xv.y + y1);
                }
            }
        }
}

// ---- pass 4 (sandwich): out = bf16(x + rmsnorm(y) * (1 + post)), a warp
// a row
__global__ void __launch_bounds__(NT) fused_block_post_kernel(
        const bf16* __restrict__ x, const float* __restrict__ y,
        const float* __restrict__ post, bf16* __restrict__ out, int M, int d,
        float eps) {
    const int lane = threadIdx.x % 32;
    const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
    if (row >= M) return;
    const float* yr = y + (long long)row * d;
    float sq = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
        const float4 v = *reinterpret_cast<const float4*>(yr + c);
        sq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    const float inv = rsqrtf(warp_sum(sq) / (float)d + eps);
    const bf16* xr = x + (long long)row * d;
    bf16* orow = out + (long long)row * d;
    for (int c = lane * 4; c < d; c += 128) {
        const float4 v = *reinterpret_cast<const float4*>(yr + c);
        const uint2 u = *reinterpret_cast<const uint2*>(xr + c);
        const float2 xa = tc::unpack_bf16(u.x), xb = tc::unpack_bf16(u.y);
        *reinterpret_cast<uint2*>(orow + c) = make_uint2(
            tc::pack_bf16(xa.x + v.x * inv * (1.f + post[c]),
                          xa.y + v.y * inv * (1.f + post[c + 1])),
            tc::pack_bf16(xb.x + v.z * inv * (1.f + post[c + 2]),
                          xb.y + v.w * inv * (1.f + post[c + 3])));
    }
}

bool aligned16(const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int NB>
int launch_up(const bf16* n, const bf16* w0, const bf16* w1, bf16* h, int M,
              int d, int F, int gelu, cudaStream_t s) {
    using TL = Tile<NB>;
    cudaError_t err = cudaFuncSetAttribute(
        fused_block_up_kernel<NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)(((M + BM - 1) / BM)
                                       * ((F + TL::BNB - 1) / TL::BNB));
    fused_block_up_kernel<NB><<<blocks, NT, TL::SMEM, s>>>(n, w0, w1, h, M,
                                                            d, F, gelu);
    return (int)cudaGetLastError();
}

}  // namespace

// x, out: [M, d] bfloat16; scale, post: [d] float32 (post may be null when
// sandwich is 0); wg (null when gated is 0), wu: [d, F]; wd: [F, d],
// bfloat16, row-major and contiguous.  Scratch, allocated by the caller:
// n [M, d] and h [M, F] bfloat16, y [M, d] float32 (null unless sandwich).
// partial: y is the output, the float32 product h @ Wd of this F slice,
// and the block stops there (no residual, no post-norm; out unused).
// d and F must be multiples of 8 and every pointer 16-byte aligned.
extern "C" int fused_block_tc_launch(const void* x, const void* scale,
                                     const void* wg, const void* wu,
                                     const void* wd, const void* post,
                                     void* out, void* n, void* h, void* y,
                                     int M, int d, int F, int gated,
                                     int gelu, int sandwich, int partial,
                                     float eps, int device, void* stream) {
    if (M <= 0) return 0;
    const void* ptrs[] = {x, wg, wu, wd, out, n, h, y};   // 16-byte access
    for (const void* p : ptrs)
        if (!aligned16(p)) return (int)cudaErrorInvalidValue;
    if (partial) sandwich = 0;
    if (d <= 0 || F <= 0 || d % 8 || F % 8 || (gated && wg == nullptr)
        || (sandwich && (post == nullptr || y == nullptr))
        || (partial && y == nullptr) || (!partial && out == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned row_blocks = (unsigned)((M + ROWS_PER_BLOCK - 1)
                                           / ROWS_PER_BLOCK);
    fused_block_norm_kernel<<<row_blocks, NT, 0, s>>>(
        (const bf16*)x, (const float*)scale, (bf16*)n, M, d, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int e = gated
        ? launch_up<2>((const bf16*)n, (const bf16*)wg, (const bf16*)wu,
                       (bf16*)h, M, d, F, gelu, s)
        : launch_up<1>((const bf16*)n, (const bf16*)wu, nullptr, (bf16*)h,
                       M, d, F, gelu, s);
    if (e != 0) return e;
    err = cudaFuncSetAttribute(fused_block_down_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tile<1>::SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned down_blocks = (unsigned)(((M + BM - 1) / BM)
                                            * ((d + BN - 1) / BN));
    fused_block_down_kernel<<<down_blocks, NT, Tile<1>::SMEM, s>>>(
        (const bf16*)h, (const bf16*)wd, (const bf16*)x, (bf16*)out,
        sandwich || partial ? (float*)y : nullptr, M, d, F);
    err = cudaGetLastError();
    if (err != cudaSuccess || !sandwich) return (int)err;
    fused_block_post_kernel<<<row_blocks, NT, 0, s>>>(
        (const bf16*)x, (const float*)y, (const float*)post, (bf16*)out, M,
        d, eps);
    return (int)cudaGetLastError();
}
