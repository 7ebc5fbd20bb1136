// Fused residual MLP block, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fused_block.py::_kernel.  For a tile
// of rows of x [M, d] it computes
//
//     n = rmsnorm(x) * (1 + scale)                   rounded to the input type
//     h = act(n @ Wg) * (n @ Wu)    (gated)          rounded to the input type
//       = act(n @ Wu)               (ungated)
//     y = h @ Wd                    (f32 accumulation)
//     out = x + [rmsnorm(y) * (1 + post)]            (sandwich)
//
// with the rounding points of the TPU kernel (fused_block.py:48 and :58).
// What bounds it on the card: at prefill (M = 6,144, d = 2,560, F = 7,680)
// the products, 2*M*d*F*3 operations against 118 MB of bf16 weights; at
// decode (M = 2) the weights' bytes.  This kernel is a first, right version:
// the products are SIMT float32 fused multiply-adds, not tensor-core
// instructions, so at prefill it runs far from the bound (PERF.md).
//
// Design.  The TPU kernel keeps the whole [bm, d] float32 accumulator in
// VMEM; on Hopper a block's 227 KB of shared memory holds [8, 2560] of it at
// most next to the normalised tile, so the accumulator lives in registers:
// a block of 256 threads owns BM = 8 rows, and thread t owns columns
// t, t + 256, ... (J of them, J = ceil(d / 256)), 8*J registers.  The
// normalised tile stays in shared memory, stored column-major ([d][BM]) so
// that the 8 rows of one column are one vector load.  F is walked in slabs
// of `bf` columns: the up projection puts one thread on each slab column
// (and, when bf < 256, splits d among 256 / bf thread groups whose partial
// sums are added in a fixed order), the slab of h goes to shared memory,
// and the down projection adds h_slab @ Wd_slab into the registers.
//
// Decode has M = 2, one row tile: a block per row tile would leave all SMs
// but one idle.  So F can be split across blocks (gridDim.y): each split
// writes its partial accumulator to a float32 scratch [splits, M, d], and a
// second kernel adds the splits in order and applies the epilogue.  With
// one split the first kernel applies the epilogue itself.
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int BM = 8;              // rows of x per block
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// the 8 values at p (16- or 32-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float out[BM]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[BM]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(v[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

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

// v[r] summed over the block for each of the BM rows; every thread gets the
// sums.  red holds NWARP * BM floats.
__device__ __forceinline__ void block_row_sums(float v[BM], float* red) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
        const float s = warp_sum(v[r]);
        if (lane == 0) red[warp * BM + r] = s;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BM; ++r) {
        float s = 0.f;
        for (int w = 0; w < NWARP; ++w) s += red[w * BM + r];
        v[r] = s;
    }
    __syncthreads();
}

// out = x + [rmsnorm(acc) * (1 + post)] for the block's rows and the
// thread's columns
template <typename T, int J>
__device__ void epilogue(float (&acc)[BM][J], const T* __restrict__ x,
                         const float* __restrict__ post, T* __restrict__ out,
                         int m0, int M, int d, int sandwich, float eps,
                         float* red) {
    const int t = threadIdx.x;
    if (sandwich) {
        float sq[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r) {
            sq[r] = 0.f;
#pragma unroll
            for (int j = 0; j < J; ++j)
                if (t + NT * j < d) sq[r] += acc[r][j] * acc[r][j];
        }
        block_row_sums(sq, red);
#pragma unroll
        for (int r = 0; r < BM; ++r) {
            const float inv = rsqrtf(sq[r] / (float)d + eps);
#pragma unroll
            for (int j = 0; j < J; ++j) {
                const int c = t + NT * j;
                if (c < d) acc[r][j] = acc[r][j] * inv * (1.f + post[c]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
        const int row = m0 + r;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int c = t + NT * j;
            if (c < d) {
                const long long at = (long long)row * d + c;
                out[at] = from_f<T>(to_f(x[at]) + acc[r][j]);
            }
        }
    }
}

// dynamic shared memory of the first kernel, in bytes
template <typename T>
size_t smem_bytes(int d, int bf) {
    return (size_t)d * BM * sizeof(T) + (size_t)bf * BM * sizeof(T)
           + (size_t)NT * BM * 2 * sizeof(float)
           + (size_t)NWARP * BM * sizeof(float);
}

template <typename T, int J>
__global__ void __launch_bounds__(NT) fused_block_kernel(
        const T* __restrict__ x, const float* __restrict__ scale,
        const T* __restrict__ wg, const T* __restrict__ wu,
        const T* __restrict__ wd, const float* __restrict__ post,
        T* __restrict__ out, float* __restrict__ part,
        int M, int d, int F, int bf, int slabs_per_split,
        int gated, int gelu, int sandwich, float eps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* nT = reinterpret_cast<T*>(smem_raw);                   // [d][BM]
    T* hT = nT + (size_t)d * BM;                              // [bf][BM]
    float* red = reinterpret_cast<float*>(hT + (size_t)bf * BM);
    float* rowred = red + NT * BM * 2;                        // [NWARP][BM]

    const int t = threadIdx.x;
    const int m0 = blockIdx.x * BM;
    const int n_slabs = (F + bf - 1) / bf;
    const int s_lo = blockIdx.y * slabs_per_split;
    const int s_hi = min(n_slabs, s_lo + slabs_per_split);

    // ---- the normalised tile, rounded to the input type
    {
        float sq[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r) {
            sq[r] = 0.f;
            if (m0 + r < M)
                for (int c = t; c < d; c += NT) {
                    const float v = to_f(x[(long long)(m0 + r) * d + c]);
                    sq[r] += v * v;
                }
        }
        block_row_sums(sq, rowred);
        for (int c = t; c < d; c += NT) {
            const float s1 = 1.f + scale[c];
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                float n = 0.f;
                if (m0 + r < M) {
                    const float v = to_f(x[(long long)(m0 + r) * d + c]);
                    n = v * rsqrtf(sq[r] / (float)d + eps) * s1;
                }
                nT[(size_t)c * BM + r] = from_f<T>(n);
            }
        }
    }
    __syncthreads();

    float acc[BM][J];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[r][j] = 0.f;

    const int kgroups = NT / bf;              // bf divides NT
    const int col = t % bf, kg = t / bf;
    const int kc = (d + kgroups - 1) / kgroups;
    const int k_lo = kg * kc, k_hi = min(d, k_lo + kc);

    for (int s = s_lo; s < s_hi; ++s) {
        const int f0 = s * bf;
        // ---- up (and gate) projection of this slab: partial sums over
        // this thread group's share of d
        {
            float u[BM], g[BM];
#pragma unroll
            for (int r = 0; r < BM; ++r) u[r] = g[r] = 0.f;
            const int f = f0 + col;
            if (f < F) {
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k) {
                    float n8[BM];
                    load8(nT + (size_t)k * BM, n8);
                    const float wuv = to_f(wu[(long long)k * F + f]);
                    const float wgv = gated ? to_f(wg[(long long)k * F + f])
                                            : 0.f;
#pragma unroll
                    for (int r = 0; r < BM; ++r) {
                        u[r] += n8[r] * wuv;
                        g[r] += n8[r] * wgv;
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                red[((kg * 2 + 0) * BM + r) * bf + col] = u[r];
                red[((kg * 2 + 1) * BM + r) * bf + col] = g[r];
            }
        }
        __syncthreads();
        // ---- h = act(g) * u, rounded to the input type (partials added in
        // thread-group order)
        for (int i = t; i < BM * bf; i += NT) {
            const int r = i / bf, c = i % bf;
            float uu = 0.f, gg = 0.f;
            for (int q = 0; q < kgroups; ++q) {
                uu += red[((q * 2 + 0) * BM + r) * bf + c];
                gg += red[((q * 2 + 1) * BM + r) * bf + c];
            }
            const float h = f0 + c < F ? (gated ? act(gg, gelu) * uu
                                                : act(uu, gelu))
                                       : 0.f;
            hT[(size_t)c * BM + r] = from_f<T>(h);
        }
        __syncthreads();
        // ---- down projection: acc += h_slab @ Wd_slab
        const int nf = min(bf, F - f0);
#pragma unroll 2
        for (int ff = 0; ff < nf; ++ff) {
            float h8[BM];
            load8(hT + (size_t)ff * BM, h8);
            const T* wrow = wd + (long long)(f0 + ff) * d;
#pragma unroll
            for (int j = 0; j < J; ++j) {
                const int c = t + NT * j;
                const float w = c < d ? to_f(wrow[c]) : 0.f;
#pragma unroll
                for (int r = 0; r < BM; ++r) acc[r][j] += h8[r] * w;
            }
        }
        __syncthreads();                 // red / hT are rewritten next slab
    }

    if (part == nullptr) {
        epilogue<T, J>(acc, x, post, out, m0, M, d, sandwich, eps, rowred);
        return;
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
        const int row = m0 + r;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int c = t + NT * j;
            if (c < d)
                part[((long long)blockIdx.y * M + row) * d + c] = acc[r][j];
        }
    }
}

// second pass when F was split across blocks: the splits' partial
// accumulators added in split order, then the epilogue
template <typename T, int J>
__global__ void __launch_bounds__(NT) fused_block_reduce_kernel(
        const T* __restrict__ x, const float* __restrict__ post,
        const float* __restrict__ part, T* __restrict__ out,
        int M, int d, int splits, int sandwich, float eps) {
    __shared__ float rowred[NWARP * BM];
    const int t = threadIdx.x;
    const int m0 = blockIdx.x * BM;
    float acc[BM][J];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int c = t + NT * j;
            float s = 0.f;
            if (m0 + r < M && c < d)
                for (int q = 0; q < splits; ++q)
                    s += part[((long long)q * M + m0 + r) * d + c];
            acc[r][j] = s;
        }
    epilogue<T, J>(acc, x, post, out, m0, M, d, sandwich, eps, rowred);
}

template <typename T, int J>
int launch(const void* x, const void* scale, const void* wg, const void* wu,
           const void* wd, const void* post, void* out, void* part, int M,
           int d, int F, int bf, int splits, int gated, int gelu,
           int sandwich, float eps, cudaStream_t stream) {
    const size_t smem = smem_bytes<T>(d, bf);
    cudaError_t err = cudaFuncSetAttribute(
        fused_block_kernel<T, J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_slabs = (F + bf - 1) / bf;
    const int per = (n_slabs + splits - 1) / splits;
    const int used = (n_slabs + per - 1) / per;
    const unsigned m_tiles = (unsigned)((M + BM - 1) / BM);
    float* scratch = used > 1 ? (float*)part : nullptr;
    fused_block_kernel<T, J><<<dim3(m_tiles, used), NT, smem, stream>>>(
        (const T*)x, (const float*)scale, (const T*)wg, (const T*)wu,
        (const T*)wd, (const float*)post, (T*)out, scratch, M, d, F, bf, per,
        gated, gelu, sandwich, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess || used == 1) return (int)err;
    fused_block_reduce_kernel<T, J><<<m_tiles, NT, 0, stream>>>(
        (const T*)x, (const float*)post, scratch, (T*)out, M, d, used,
        sandwich, eps);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_j(int j, const void* x, const void* scale, const void* wg,
             const void* wu, const void* wd, const void* post, void* out,
             void* part, int M, int d, int F, int bf, int splits, int gated,
             int gelu, int sandwich, float eps, cudaStream_t s) {
#define FB_CASE(JJ)                                                         \
    if (j <= JJ)                                                            \
        return launch<T, JJ>(x, scale, wg, wu, wd, post, out, part, M, d, F, \
                             bf, splits, gated, gelu, sandwich, eps, s);
    FB_CASE(1) FB_CASE(2) FB_CASE(4) FB_CASE(8) FB_CASE(10)
#undef FB_CASE
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: [M, d] (is_bf16: bfloat16, else float32); scale, post: [d]
// float32 (post may be null when sandwich is 0); wg (null when gated is 0),
// wu: [d, F]; wd: [F, d], all of x's type, row-major and contiguous.  bf is
// the slab width (64, 128 or 256); splits the number of blocks F is split
// across; part a float32 scratch of [splits, M, d] (unused, may be null,
// when splits is 1).  d may be at most 2,560 (10 columns per thread).
extern "C" int fused_block_launch(const void* x, const void* scale,
                                  const void* wg, const void* wu,
                                  const void* wd, const void* post, void* out,
                                  void* part, int M, int d, int F, int bf,
                                  int splits, int gated, int gelu,
                                  int sandwich, float eps, int is_bf16,
                                  int device, void* stream) {
    if (M <= 0) return 0;
    if (d <= 0 || F <= 0 || d > NT * 10 || (bf != 64 && bf != 128
                                             && bf != 256) || splits < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int j = (d + NT - 1) / NT;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return launch_j<__nv_bfloat16>(j, x, scale, wg, wu, wd, post, out,
                                       part, M, d, F, bf, splits, gated, gelu,
                                       sandwich, eps, s);
    return launch_j<float>(j, x, scale, wg, wu, wd, post, out, part, M, d, F,
                           bf, splits, gated, gelu, sandwich, eps, s);
}
