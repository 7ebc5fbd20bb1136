// Flash attention on the tensor cores (bfloat16), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel on the
// bfloat16 path; flash_attention.cu keeps float32.  The same function: for
// q [B, S, NH, hd] and k, v [B, T, NKV, hd] (the JAX package's layout, read
// in place), query i and head h with kv head h / (NH / NKV),
//
//     s_ij = softcap(q_i . k_j / sqrt(hd)),  masked where j > i (causal) or
//            i - j >= window (window > 0), or j >= T
//     o_i  = sum_j softmax_j(s_ij) v_j
//
// with the TPU kernel's numbers: scores, running maximum and sum and the
// accumulator in float32, p rounded to bfloat16 unnormalised before p @ v
// (flash_attention.py, the `p.astype(v.dtype)` of its P.V product).  Whole
// key tiles that the mask empties for every query of the block are not
// visited, by the TPU kernel's condition (flash_attention.py:43-47); a warp
// also passes over a tile that the mask empties for its 16 queries.
//
// What bounds it on the card: at recurrentgemma-2b's prefill (B 2,
// S = T 3,072, NH 10, NKV 1, hd 256, window 2,048) the two products,
// 4 * hd operations per (query, key) pair the mask keeps, at the bfloat16
// tensor-core rate.
//
// Design (FlashAttention-2 on mma.sync).  A block of 4 warps owns 64
// queries of one (batch, head), 16 rows a warp, and walks key tiles of BKV
// keys (64; 32 at hd 256, to keep two blocks an SM).  The query tile and a
// ring of two K/V tiles are bfloat16 in shared memory, filled by cp.async
// with the next key tile in flight while this one is computed (rows padded
// by 16 bytes: ldmatrix reads them without bank conflicts).  S = Q K^T on
// m16n8k16: Q by ldmatrix, K [key][hd] as the column-major B operand by
// plain ldmatrix.  Scale, soft cap, mask and the online softmax run on the
// accumulators in registers (a row's maximum and sum over the 4 lanes that
// hold it: two shuffles); only a tile that the mask cuts for the warp's
// rows is masked element by element.  P, rounded to bfloat16 in registers,
// is the A fragment of P V directly (the C layout of two n8 tiles is the A
// layout of one k16 step); V [key][hd] is the B operand by ldmatrix.trans.  The
// output accumulator, 16 x HD float32 a warp, stays in registers (HD / 2
// a thread).  Head dims are compiled for HD 64, 128 and 256; a smaller hd
// runs on the next size up, its features zero-filled at and above hd.
// MQA/GQA: the head -> kv head map is read as it is; blocks of heads that
// share a kv head each load it (from L2), nothing is shared across blocks.
//
// hd must be a multiple of 8 and every pointer 16-byte aligned (16-byte
// copies); the wrapper routes anything else to flash_attention.cu by a
// fixed rule (kernels/flash_attention.py::flash_attention_variant), and
// this entry point refuses it.
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

constexpr int NT = 128;                // 4 warps
constexpr int BQ = 64;                 // queries a block, 16 a warp
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Shape {
    static constexpr int BKV = HD == 256 ? 32 : 64;    // keys a tile
    static constexpr int LD = HD + 8;                  // padded row stride
    static constexpr int KV_TILE = BKV * LD;
    static constexpr size_t SMEM =
        sizeof(bf16) * ((size_t)BQ * LD + 4 * (size_t)KV_TILE);
};

// rows [0, n_rows) of a [n_rows x HD] tile from `src` (row stride `ld_src`
// elements, hd valid features a row); rows at or past `valid_rows`, and
// features at or past hd, zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld_src, int n_rows,
                                          int valid_rows, int hd) {
    constexpr int CHUNKS = HD / 8;
    for (int i = threadIdx.x; i < n_rows * CHUNKS; i += NT) {
        const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
        const bool ok = r < valid_rows && c < hd;
        tc::cp_async16(dst + r * Shape<HD>::LD + c,
                       ok ? src + r * ld_src + c : src, ok);
    }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_attention_tc_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T,
        int NH, int NKV, int hd, float scale, int causal, int window,
        float cap) {
    using SH = Shape<HD>;
    constexpr int BKV = SH::BKV, LD = SH::LD;
    constexpr int NS = BKV / 8;            // n8 tiles of scores a warp
    constexpr int NO = HD / 8;             // n8 tiles of the output a warp
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);         // [BQ][LD]
    bf16* kvs = qs + BQ * LD;        // K0, V0, K1, V1: [BKV][LD] each

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
    const int kvh = h / (NH / NKV);
    const int q0 = blockIdx.x * BQ;
    const int wq = q0 + warp * 16;         // this warp's first query
    const long long q_ld = (long long)NH * hd, kv_ld = (long long)NKV * hd;
    const bf16* kb = k + ((long long)b * T * NKV + kvh) * hd;
    const bf16* vb = v + ((long long)b * T * NKV + kvh) * hd;

    // the key tiles the block visits: the TPU kernel's tile-level skip,
    // max q against min k (causal), min q against max k (window)
    const int n_k = (T + BKV - 1) / BKV;
    int lo = 0, hi = n_k;
    if (causal) hi = min(n_k, (q0 + BQ - 1) / BKV + 1);
    if (window)
        while (lo < hi && q0 - (lo * BKV + BKV - 1) >= window) ++lo;

    load_rows<HD>(qs, q + ((long long)b * S + q0) * q_ld + (long long)h * hd,
                  q_ld, BQ, S - q0, hd);
    if (lo < hi) {
        load_rows<HD>(kvs, kb + (long long)lo * BKV * kv_ld, kv_ld, BKV,
                      T - lo * BKV, hd);
        load_rows<HD>(kvs + SH::KV_TILE, vb + (long long)lo * BKV * kv_ld,
                      kv_ld, BKV, T - lo * BKV, hd);
    }
    tc::cp_async_commit();

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int jt = lo; jt < hi; ++jt) {
        const int stage = (jt - lo) & 1;
        if (jt + 1 < hi) {             // the next tile, into the other slot
            const int k1 = (jt + 1) * BKV;
            bf16* nxt = kvs + (stage ^ 1) * 2 * SH::KV_TILE;
            load_rows<HD>(nxt, kb + (long long)k1 * kv_ld, kv_ld, BKV,
                          T - k1, hd);
            load_rows<HD>(nxt + SH::KV_TILE, vb + (long long)k1 * kv_ld,
                          kv_ld, BKV, T - k1, hd);
        }
        tc::cp_async_commit();
        tc::cp_async_wait<1>();            // this tile (and q) have landed
        __syncthreads();
        const bf16* ks = kvs + stage * 2 * SH::KV_TILE;
        const bf16* vs = ks + SH::KV_TILE;
        const int k0 = jt * BKV;
        const bool skip = (causal && wq + 15 < k0)
                          || (window && wq - (k0 + BKV - 1) >= window);
        if (!skip) {
            // ---- S = Q K^T for the warp's 16 queries
            float s[NS][4];
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < HD; kk += 16) {
                uint32_t a[4];
                tc::ldmatrix_x4(a, qs + (warp * 16 + lane % 16) * LD + kk
                                       + (lane / 16) * 8);
#pragma unroll
                for (int j = 0; j < NS / 2; ++j) {
                    uint32_t r[4];
                    tc::ldmatrix_x4(r, ks + (j * 16 + lane % 8
                                             + (lane / 16) * 8) * LD
                                           + kk + ((lane / 8) % 2) * 8);
                    tc::mma_bf16(s[2 * j], a, r[0], r[1]);
                    tc::mma_bf16(s[2 * j + 1], a, r[2], r[3]);
                }
            }
            // ---- scale, soft cap, mask; online softmax by rows g, g + 8.
            // Only a tile that the mask cuts for the warp's rows is masked
            // element by element.
            const bool cut = k0 + BKV > T || (causal && wq < k0 + BKV - 1)
                             || (window && wq + 15 - k0 >= window);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int qi = wq + g + 8 * half;
                float mx = NEG_INF;
#pragma unroll
                for (int j = 0; j < NS; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float val = s[j][2 * half + e] * scale;
                        if (cap != 0.f) val = cap * tanhf(val / cap);
                        if (cut) {
                            const int kp = k0 + j * 8 + 2 * t + e;
                            bool ok = kp < T;
                            if (causal) ok = ok && qi >= kp;
                            if (window) ok = ok && qi - kp < window;
                            val = ok ? val : NEG_INF;
                        }
                        s[j][2 * half + e] = val;
                        mx = fmaxf(mx, val);
                    }
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                const float m_new = fmaxf(m[half], mx);
                const float alpha = expf(m[half] - m_new);
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < NS; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float p = expf(s[j][2 * half + e] - m_new);
                        s[j][2 * half + e] = p;
                        sum += p;
                    }
                l[half] = l[half] * alpha + sum;   // the lane's columns
                m[half] = m_new;
#pragma unroll
                for (int j = 0; j < NO; ++j) {
                    acc[j][2 * half] *= alpha;
                    acc[j][2 * half + 1] *= alpha;
                }
            }
            // ---- acc += bf16(P) V, 16 keys a step
#pragma unroll
            for (int kk = 0; kk < NS / 2; ++kk) {
                const uint32_t a[4] = {
                    tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                    tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                    tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                    tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
                for (int j = 0; j < NO / 2; ++j) {
                    uint32_t r[4];
                    tc::ldmatrix_x4_trans(r, vs + (kk * 16 + lane % 16) * LD
                                                 + j * 16 + (lane / 16) * 8);
                    tc::mma_bf16(acc[2 * j], a, r[0], r[1]);
                    tc::mma_bf16(acc[2 * j + 1], a, r[2], r[3]);
                }
            }
        }
        __syncthreads();                   // the slot is free for jt + 2
    }
    tc::cp_async_wait<0>();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float sum = l[half];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / fmaxf(sum, 1e-30f);
        const int qi = wq + g + 8 * half;
        if (qi >= S) continue;
        bf16* orow = o + ((long long)b * S + qi) * q_ld + (long long)h * hd;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
            const int c = j * 8 + 2 * t;
            if (c < hd)
                *reinterpret_cast<uint32_t*>(orow + c) = tc::pack_bf16(
                    acc[j][2 * half] * inv, acc[j][2 * half + 1] * inv);
        }
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T, int NH, int NKV, int hd, float scale, int causal,
           int window, float cap, cudaStream_t stream) {
    const size_t smem = Shape<HD>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * NH));
    flash_attention_tc_kernel<HD><<<grid, NT, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, T, NH,
        NKV, hd, scale, causal, window, cap);
    return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// q, o: [B, S, NH, hd]; k, v: [B, T, NKV, hd]; bfloat16, contiguous,
// 16-byte aligned.  hd a multiple of 8, at most 256; NH a multiple of NKV.
// scale is 1 / sqrt(hd); cap 0 disables the soft cap; window 0 the window.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int S, int T, int NH, int NKV,
                                         int hd, float scale, int causal,
                                         int window, float cap, int device,
                                         void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if (T <= 0 || hd <= 0 || hd > 256 || hd % 8 || NKV <= 0 || NH % NKV
        || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (hd <= 64)
        return launch<64>(q, k, v, o, B, S, T, NH, NKV, hd, scale, causal,
                          window, cap, s);
    if (hd <= 128)
        return launch<128>(q, k, v, o, B, S, T, NH, NKV, hd, scale, causal,
                           window, cap, s);
    return launch<256>(q, k, v, o, B, S, T, NH, NKV, hd, scale, causal,
                       window, cap, s);
}
