// Flash attention (online softmax over key tiles), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel.  For
// q [B, S, NH, hd] and k, v [B, T, NKV, hd] (the JAX package's layout, read
// in place through their strides) it computes, for each query position i
// and head h with kv head h / (NH / NKV),
//
//     s_ij = softcap(q_i . k_j / sqrt(hd)),  masked where j > i (causal) or
//            i - j >= window (window > 0), or j >= T
//     o_i  = sum_j softmax_j(s_ij) v_j
//
// with queries and keys both at positions 0, 1, ... (a prefill from
// position 0).  Scores, the running maximum m, the running sum l and the
// accumulator are float32; p is rounded to v's type before p @ v, as the
// TPU kernel does.  Whole key tiles that the mask empties for every query
// of the block are skipped, by the TPU kernel's condition
// (flash_attention.py:43-47).  S and T need not be multiples of the tiles:
// the ragged last tiles are masked.
//
// What bounds it on the card: at recurrentgemma-2b's prefill (B = 2,
// S = T = 3,072, NH = 10, NKV = 1, hd = 256, window 2,048) the products,
// 4 * hd operations per unmasked (query, key) pair.  This first version
// does them as SIMT float32 fused multiply-adds out of shared memory, not
// on the tensor cores, so it runs well above that bound (PERF.md).
//
// Design.  One block of 256 threads per (batch * head, tile of BQ = 64
// queries); it walks the key tiles of BK = 32 keys.  The query tile is in
// shared memory transposed ([hd][BQ + 4]: the 8 queries of a warp at one
// feature are two vector loads), the key tile padded to hd + 1 floats a
// row (the 32 lanes read 32 keys without a bank conflict) and the value
// tile as it is; everything is converted to float32 as it is loaded.
// Warp w owns queries 8w .. 8w + 7 and lane l owns key l of the tile, so a
// row's maximum and sum are warp shuffles and m, l stay in registers; the
// accumulator [8 queries][hd] of a warp lives in its lanes' registers
// (lane l holds features l, l + 32, ...: 8 * hd / 32 floats).  Shared
// memory at hd = 256: 143.5 KB, one block per SM.
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int BQ = 64;                 // queries per block
constexpr int BK = 32;                 // keys per tile (one per lane)
constexpr int RW = 8;                  // queries per warp
constexpr int QLD = BQ + 4;            // row stride of the transposed q tile
constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

size_t smem_bytes(int hd) {
    return sizeof(float) * ((size_t)hd * QLD + (size_t)BK * (hd + 1)
                            + (size_t)BK * hd + (size_t)(NT / 32) * BK * RW);
}

// CJ = features per lane, ceil(hd / 32)
template <typename T, int CJ>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o, int S, int T_, int NH,
        int NKV, int hd, float scale, int causal, int window, float cap,
        int qoff) {
    extern __shared__ __align__(16) float smem[];
    float* qT = smem;                          // [hd][QLD]
    float* ks = qT + (size_t)hd * QLD;         // [BK][hd + 1]
    float* vs = ks + (size_t)BK * (hd + 1);    // [BK][hd]
    float* ps = vs + (size_t)BK * hd;          // [warp][BK][RW]

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
    const int kvh = h / (NH / NKV);
    const int q0 = blockIdx.x * BQ;
    const int r0 = warp * RW;                  // this warp's first query
    const int p0 = qoff + q0;                  // the block's first position

    for (int i = tid; i < BQ * hd; i += NT) {
        const int r = i / hd, c = i % hd, s = q0 + r;
        qT[(size_t)c * QLD + r] =
            s < S ? to_f(q[(((long long)b * S + s) * NH + h) * hd + c]) : 0.f;
    }

    float m[RW], l[RW], acc[RW][CJ];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[r][j] = 0.f;
    }

    const int n_k = (T_ + BK - 1) / BK;
    for (int jt = 0; jt < n_k; ++jt) {
        const int k0 = jt * BK;
        // the TPU kernel's tile-level skip: max q vs min k (causal), min q
        // vs max k (window)
        if (causal && p0 + BQ - 1 - k0 < 0) continue;
        if (window && p0 - (k0 + BK - 1) >= window) continue;
        __syncthreads();                       // the last tile is consumed
        for (int i = tid; i < BK * hd; i += NT) {
            const int t = i / hd, c = i % hd, kp = k0 + t;
            float kv = 0.f, vv = 0.f;
            if (kp < T_) {
                const long long at = (((long long)b * T_ + kp) * NKV + kvh)
                                     * hd + c;
                kv = to_f(k[at]);
                vv = to_f(v[at]);
            }
            ks[(size_t)t * (hd + 1) + c] = kv;
            vs[(size_t)t * hd + c] = vv;
        }
        __syncthreads();

        // scores of the warp's 8 queries against key `lane`
        float s[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) s[r] = 0.f;
        const float* krow = ks + (size_t)lane * (hd + 1);
#pragma unroll 4
        for (int c = 0; c < hd; ++c) {
            const float kk = krow[c];
            const float4 qa = *reinterpret_cast<const float4*>(
                qT + (size_t)c * QLD + r0);
            const float4 qb = *reinterpret_cast<const float4*>(
                qT + (size_t)c * QLD + r0 + 4);
            s[0] += qa.x * kk; s[1] += qa.y * kk;
            s[2] += qa.z * kk; s[3] += qa.w * kk;
            s[4] += qb.x * kk; s[5] += qb.y * kk;
            s[6] += qb.z * kk; s[7] += qb.w * kk;
        }
        const int kp = k0 + lane;
        float* pw = ps + (size_t)warp * BK * RW;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            float val = s[r] * scale;
            if (cap != 0.f) val = cap * tanhf(val / cap);
            const int delta = p0 + r0 + r - kp;
            bool ok = kp < T_;
            if (causal) ok = ok && delta >= 0;
            if (window) ok = ok && delta < window;
            val = ok ? val : NEG_INF;
            const float m_new = fmaxf(m[r], warp_max(val));
            const float p = expf(val - m_new);
            const float alpha = expf(m[r] - m_new);
            l[r] = l[r] * alpha + warp_sum(p);
            m[r] = m_new;
            pw[lane * RW + r] = to_f(from_f<T>(p));
#pragma unroll
            for (int j = 0; j < CJ; ++j) acc[r][j] *= alpha;
        }
        __syncwarp();

        // acc += p @ v_tile
#pragma unroll 2
        for (int t = 0; t < BK; ++t) {
            const float4 pa = *reinterpret_cast<const float4*>(pw + t * RW);
            const float4 pb = *reinterpret_cast<const float4*>(pw + t * RW
                                                               + 4);
            const float p8[RW] = {pa.x, pa.y, pa.z, pa.w,
                                  pb.x, pb.y, pb.z, pb.w};
            const float* vrow = vs + (size_t)t * hd;
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const int c = lane + 32 * j;
                const float vv = c < hd ? vrow[c] : 0.f;
#pragma unroll
                for (int r = 0; r < RW; ++r) acc[r][j] += p8[r] * vv;
            }
        }
        __syncwarp();
    }

#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int s_pos = q0 + r0 + r;
        if (s_pos >= S) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        T* orow = o + (((long long)b * S + s_pos) * NH + h) * hd;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
            const int c = lane + 32 * j;
            if (c < hd) orow[c] = from_f<T>(acc[r][j] / denom);
        }
    }
}

template <typename T, int CJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_, int NH, int NKV, int hd, float scale, int causal,
           int window, float cap, int qoff, cudaStream_t stream) {
    const size_t smem = smem_bytes(hd);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, CJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * NH));
    flash_attention_kernel<T, CJ><<<grid, NT, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, S, T_, NH, NKV, hd,
        scale, causal, window, cap, qoff);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_cj(const void* q, const void* k, const void* v, void* o, int B,
              int S, int T_, int NH, int NKV, int hd, float scale,
              int causal, int window, float cap, int qoff, cudaStream_t s) {
    const int cj = (hd + 31) / 32;
    if (cj <= 1)
        return launch<T, 1>(q, k, v, o, B, S, T_, NH, NKV, hd, scale, causal,
                            window, cap, qoff, s);
    if (cj <= 2)
        return launch<T, 2>(q, k, v, o, B, S, T_, NH, NKV, hd, scale, causal,
                            window, cap, qoff, s);
    if (cj <= 4)
        return launch<T, 4>(q, k, v, o, B, S, T_, NH, NKV, hd, scale, causal,
                            window, cap, qoff, s);
    return launch<T, 8>(q, k, v, o, B, S, T_, NH, NKV, hd, scale, causal,
                        window, cap, qoff, s);
}

}  // namespace

// q, o: [B, S, NH, hd]; k, v: [B, T, NKV, hd]; all contiguous, bfloat16
// (is_bf16) or float32.  hd <= 256, NH a multiple of NKV.  scale is
// 1 / sqrt(hd); cap 0 disables the soft cap; window 0 disables the window.
// Query i is at position qoff + i (keys from 0): a context-parallel slice.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int NH, int NKV, int hd,
                                      float scale, int causal, int window,
                                      float cap, int qoff, int is_bf16,
                                      int device, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if (T <= 0 || hd <= 0 || hd > 256 || NKV <= 0 || NH % NKV != 0
        || qoff < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return launch_cj<__nv_bfloat16>(q, k, v, o, B, S, T, NH, NKV, hd,
                                        scale, causal, window, cap, qoff, s);
    return launch_cj<float>(q, k, v, o, B, S, T, NH, NKV, hd, scale, causal,
                            window, cap, qoff, s);
}
