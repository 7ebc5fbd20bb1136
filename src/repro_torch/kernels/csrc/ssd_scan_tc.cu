// Mamba-2 SSD chunked scan on the tensor cores (bfloat16 x, B, C), CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_kernel on the
// bfloat16 path; ssd_scan.cu keeps float32.  The same function as
// ssd_scan.cu (read its header): for x [B, S, H, P] and Bm, Cm [B, S, G, N]
// bfloat16 (read in place at the projection's stride), dt [B, S, H], A, D
// [H] and h0 [B, H, P, N] (or none) float32, chunk by chunk of Q tokens,
//
//     y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//              + exp(cum_i) C_i . state + D x_i
//     state' = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j
//
// writing y in bfloat16 (rounded once, after the D x term) and the final
// state in float32.  cum is summed in float64 and rounded once a position,
// exp(cum_i - cum_j) is formed only for i >= j, and a ragged last chunk is
// masked in place (dt = 0, x = B = C = 0), all as in ssd_scan.cu.
//
// What bounds it on the card: at mamba2-2.7b's prefill (B 4, S 2,048, H
// 80, P 64, G 1, N 128, Q 256) the function's 16.3 G multiply-adds take
// 0.033 ms at the bfloat16 tensor-core rate, its ~196 MB 0.058 ms at the
// memory rate: the bytes.
//
// Design: the chunked SSD of the Mamba-2 paper (arXiv:2405.21060, section
// 6) in two launches, every product on mma.sync.m16n8k16 (bfloat16 in,
// float32 accumulators; tensor_core.cuh), key tiles of 32 streamed through
// a three-stage cp.async ring:
//
//   1. chunk_state, a block of 4 warps per (batch, head, chunk): the
//      chunk's own state from zero, (w x)^T B with w_j = dt_j exp(cum_last
//      - cum_j), 16 rows of P a warp.  Then the chunks of a (batch, head)
//      chain their states in order, a decoupled look-back: a block waits
//      for its predecessor's flag, reads the state the chunk starts from
//      (L2), writes exp(cum_last) that + its own, and raises its flag.
//      Blocks take their (batch, head, chunk) from a ticket in the order
//      they start, so a block only ever waits on one that runs.  The last
//      chunk writes the final state.
//   2. output, a block of 8 warps per (batch, head, chunk, 256 rows): the
//      state the chunk starts from, as bfloat16 hi + lo, and the rows' C
//      load once; warp w owns row tiles w and 15 - w (equal causal work).
//      exp(cum_i) C_i . state, then over the key tiles up to the rows: the
//      scores C B^T, masked and weighted in registers into M = (C B^T)
//      exp(cum_i - cum_j) dt_j, then M x; y = that + D x, rounded once.  A
//      row tile skips a key tile past its 16 rows.
//
// C, B and x are bfloat16 already, so as operands they are exact and every
// product of them equals the float32 one up to summation order.  The
// float32 operands -- M, the state, w x -- are split into a bfloat16 high
// part and the bfloat16 rounding of the rest (v = hi + lo to ~2^-17 of v),
// each product taken twice and summed in float32: no rounding point the
// function does not have, so the state holds to the float32 tolerance.
// exp(cum_i) stays outside the product: (exp(cum_i) C_i) . state =
// exp(cum_i) (C_i . state).  C B^T is recomputed by every head of a group
// (10.8 G multiply-adds at the serve, ~0.02 ms at the tensor-core rate):
// sharing it through scratch would read the 256 KB of float32 scores of a
// (batch row, chunk) once per head, ~670 MB of L2 reads at the serve,
// over three times the function's own bytes (PERF.md).
// 2,560 blocks in each launch at the serve, 43 KB of shared memory each in
// the first (four an SM, by registers), 111 KB in the second (two an SM).
// Both epilogues stage their rows in shared memory and write them whole,
// with every load of a batch issued before its first store: a chain link
// is one round trip, and the chains are what the first launch waits on.
//
// P <= 64, N <= 128, 0 < Q <= 4096, H a multiple of G.  Rows are copied 16
// bytes at a time where x, or B and C, are 16-byte aligned with rows of a
// multiple of 8 elements, else element by element.
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing (the wrapper passes the scratch and the zeroed tickets and flags)
// and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int PMAX = 64;               // head dim P at most
constexpr int NMAX = 128;              // state dim N at most
constexpr int QMAX = 4096;
constexpr int STATE_NT = 128;          // chunk_state: 4 warps, 16 rows of P
constexpr int OUT_NT = 256;            // output: 8 warps
constexpr int RG = 256;                // rows of an output block
constexpr int BK = 32;                 // keys of a tile
constexpr int STAGES = 3;              // key tiles in flight
constexpr int BATCH = 8;               // loads issued ahead of their stores
constexpr int LDN = NMAX + 8;          // bf16 row strides, padded by 16
constexpr int LDP = PMAX + 8;          // bytes: ldmatrix without conflicts
constexpr int LDY = PMAX + 4;          // float row stride of staged y rows
constexpr int KEY_TILE = BK * LDN + BK * LDP;      // B and x of a key tile
constexpr int STATE_HL = 2 * PMAX * LDN;           // a state's hi and lo
constexpr int REGION = STATE_HL > STAGES * KEY_TILE ? STATE_HL
                                                    : STAGES * KEY_TILE;
// the staged rows of the epilogues fit where they are put: a chunk's own
// state over the ring, the rows' y over their C
static_assert(PMAX * NMAX * sizeof(float)
                  <= STAGES * KEY_TILE * sizeof(__nv_bfloat16), "ring");
static_assert(LDY * sizeof(float) <= LDN * sizeof(__nv_bfloat16), "cs");

// a chunk's float rows, each padded to whole key tiles
__host__ __device__ int padded(int Q) { return (Q + BK - 1) / BK * BK; }
size_t chunk_state_smem(int Q) {
    return sizeof(bf16) * STAGES * (size_t)KEY_TILE
           + 3 * sizeof(float) * (size_t)padded(Q);
}
size_t output_smem(int Q) {
    return sizeof(bf16) * ((size_t)RG * LDN + REGION)
           + 2 * sizeof(float) * (size_t)padded(Q);
}

// rows [0, rows) x columns [0, cols) of a tile (cols a multiple of 16) from
// src (row stride ld_src elements) into dst (row stride ld_dst); rows at or
// past vr and columns at or past vc zero-filled.  16-byte cp.async when vec
// (the caller's cp_async_wait makes them land), else plain element copies.
__device__ __forceinline__ void load_tile(bf16* dst, int ld_dst,
                                          const bf16* src, long long ld_src,
                                          int rows, int vr, int cols, int vc,
                                          bool vec) {
    if (vec) {
        const int chunks = cols / 8;
        for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
            const int r = i / chunks, c = (i % chunks) * 8;
            const bool ok = r < vr && c < vc;
            tc::cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c
                                                    : src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
            const int r = i / cols, c = i % cols;
            dst[r * ld_dst + c] = r < vr && c < vc ? src[r * ld_src + c]
                                                   : __float2bfloat16(0.f);
        }
    }
}

// dts[0, Q) (0 past L) and cum[0, Q): one warp's scan of the float32
// products dt A, summed in float64 and rounded once a position (as
// ssd_scan.cu and the plain version do)
__device__ void chunk_cum(float* dts, float* cum, const float* dtb, int H,
                          int L, int Q, float a_h) {
    for (int i = threadIdx.x; i < Q; i += blockDim.x)
        dts[i] = i < L ? dtb[(long long)i * H] : 0.f;
    __syncthreads();
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        const int per = (Q + 31) / 32;
        const int lo = min(Q, lane * per), hi = min(Q, lo + per);
        double total = 0.0;
        for (int i = lo; i < hi; ++i) total += (double)__fmul_rn(dts[i], a_h);
        double incl = total;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const double v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
        }
        double run = incl - total;
        for (int i = lo; i < hi; ++i) {
            run += (double)__fmul_rn(dts[i], a_h);
            cum[i] = (float)run;
        }
    }
    __syncthreads();
}

// v as bfloat16 hi + lo (hi the rounding of v, lo the rounding of v - hi),
// two values a register
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
    hi = tc::pack_bf16(v0, v1);
    const float2 h = tc::unpack_bf16(hi);
    lo = tc::pack_bf16(v0 - h.x, v1 - h.y);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;\n"
                 :: "l"(p), "r"(v) : "memory");
}

struct Args {
    const bf16* x;
    const float* dt;
    const float* A;
    const bf16* Bm;
    const bf16* Cm;
    const float* D;
    const float* h0;       // or null: 0
    bf16* y;
    float* hout;
    float* incl;           // [B * H][nc][P][N]: the state after each chunk
    int* sync;             // [1 + B * H * nc], zeroed: ticket, then flags
    int S, H, G, P, N, Q, nc;
    long long bc_stride;
    bool vec_x, vec_bc;
};

// the pointers of one (batch, head, chunk)
struct Chunk {
    int b, h, c, t0, L;
    long long bh;
    const bf16* xb;        // x of the chunk's first token, head h
    const bf16* Bb;        // B and C of the chunk's first token, h's group
    const bf16* Cb;
    const float* dtb;
};

__device__ __forceinline__ Chunk chunk_of(const Args& a, long long bh,
                                          int c) {
    Chunk k;
    k.bh = bh;
    k.b = (int)(bh / a.H);
    k.h = (int)(bh % a.H);
    k.c = c;
    k.t0 = c * a.Q;
    k.L = min(a.Q, a.S - k.t0);
    const long long tok = (long long)k.b * a.S + k.t0;
    k.xb = a.x + tok * a.H * a.P + (long long)k.h * a.P;
    const long long bc = tok * a.bc_stride
                         + (long long)(k.h / (a.H / a.G)) * a.N;
    k.Bb = a.Bm + bc;
    k.Cb = a.Cm + bc;
    k.dtb = a.dt + tok * a.H + k.h;
    return k;
}

// key tile kt of a chunk (B [key][n], x [key][p]) into ring slot `stage`
__device__ __forceinline__ void load_keys(const Args& a, const Chunk& k,
                                          bf16* ring, int kt, int stage) {
    const int k0 = kt * BK;
    const int N16 = (a.N + 15) / 16 * 16, P16 = (a.P + 15) / 16 * 16;
    bf16* bs = ring + stage * KEY_TILE;
    load_tile(bs, LDN, k.Bb + (long long)k0 * a.bc_stride, a.bc_stride, BK,
              k.L - k0, N16, a.N, a.vec_bc);
    const long long xrow = (long long)a.H * a.P;
    load_tile(bs + BK * LDN, LDP, k.xb + (long long)k0 * xrow, xrow, BK,
              k.L - k0, P16, a.P, a.vec_x);
}

// ---- 1: the chunk's own state from zero, sum_j w_j x_j B_j^T, then the
// chain: state after the chunk = exp(cum_last) state before + its own
__global__ void __launch_bounds__(STATE_NT) ssd_tc_chunk_state_kernel(
        Args a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ring = reinterpret_cast<bf16*>(smem_raw);
    const int Qp = padded(a.Q);
    float* dts = reinterpret_cast<float*>(ring + STAGES * KEY_TILE);
    float* cum = dts + Qp;
    float* ws = cum + Qp;                  // [Qp]: 0 past L
    __shared__ int ticket;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    if (threadIdx.x == 0) ticket = atomicAdd(a.sync, 1);
    __syncthreads();
    const Chunk k = chunk_of(a, ticket / a.nc, ticket % a.nc);
    const int P16 = (a.P + 15) / 16 * 16, N16 = (a.N + 15) / 16 * 16;
    const int p0 = warp * 16;              // this warp's rows of P

    chunk_cum(dts, cum, k.dtb, a.H, k.L, a.Q, a.A[k.h]);
    const float c_last = cum[a.Q - 1];
    for (int i = threadIdx.x; i < Qp; i += STATE_NT)
        ws[i] = i < k.L ? dts[i] * expf(c_last - cum[i]) : 0.f;

    float acc[NMAX / 8][4];
#pragma unroll
    for (int j = 0; j < NMAX / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    const int nkt = (k.L + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nkt) load_keys(a, k, ring, s, s);
        tc::cp_async_commit();
    }
    for (int kt = 0; kt < nkt; ++kt) {
        if (kt + STAGES - 1 < nkt)
            load_keys(a, k, ring, kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
        tc::cp_async_commit();
        tc::cp_async_wait<STAGES - 1>();
        __syncthreads();                   // ws too, on the first tile
        const bf16* bs = ring + (kt % STAGES) * KEY_TILE;
        const bf16* xs = bs + BK * LDN;
        if (p0 < P16) {
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                // A = (w x)^T [16 rows of P x 16 keys] from x [key][p] by
                // ldmatrix.trans, weighted by w and split into hi + lo
                uint32_t xa[4], ahi[4], alo[4];
                tc::ldmatrix_x4_trans(xa, xs + (kk + lane % 8 + (lane / 16) * 8)
                                                   * LDP
                                              + p0 + ((lane / 8) % 2) * 8);
                const float* w = ws + kt * BK + kk + 2 * t;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float2 v = tc::unpack_bf16(xa[r]);
                    const int o = r < 2 ? 0 : 8;
                    split2(v.x * w[o], v.y * w[o + 1], ahi[r], alo[r]);
                }
                // B [key][n] is the [k][n] operand: ldmatrix.trans
#pragma unroll
                for (int jn = 0; jn < NMAX / 16; ++jn) {
                    if (jn * 16 >= N16) break;
                    uint32_t r[4];
                    tc::ldmatrix_x4_trans(r, bs + (kk + lane % 16) * LDN
                                                 + jn * 16 + (lane / 16) * 8);
                    tc::mma_bf16(acc[2 * jn], ahi, r[0], r[1]);
                    tc::mma_bf16(acc[2 * jn + 1], ahi, r[2], r[3]);
                    tc::mma_bf16(acc[2 * jn], alo, r[0], r[1]);
                    tc::mma_bf16(acc[2 * jn + 1], alo, r[2], r[3]);
                }
            }
        }
        __syncthreads();                   // the slot is free for a reload
    }
    tc::cp_async_wait<0>();

    // ---- the chunk's own state into shared memory (the ring is free),
    // dense [P][N] as the state rows are, so that the chain reads and writes
    // whole rows
    float* own = reinterpret_cast<float*>(ring);
    if (p0 < P16) {
#pragma unroll
        for (int j = 0; j < NMAX / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int p = p0 + g + (e / 2) * 8, n = j * 8 + 2 * t + e % 2;
                if (p < a.P && n < a.N) own[p * a.N + n] = acc[j][e];
            }
    }

    // ---- the chain, in chunk order within the (batch, head)
    const long long pn = (long long)a.P * a.N;
    const float decay = expf(c_last);
    const long long at = k.bh * a.nc + k.c;
    if (k.c > 0 && threadIdx.x == 0)
        while (ld_acquire(a.sync + at) == 0) __nanosleep(32);
    __syncthreads();                       // own has landed too
    const float* before = k.c > 0 ? a.incl + (at - 1) * pn
                          : a.h0 != nullptr ? a.h0 + k.bh * pn : nullptr;
    float* after = k.c + 1 < a.nc ? a.incl + at * pn : a.hout + k.bh * pn;
    // every load of the link issues before its first store (the two rows
    // may alias for the compiler): one round trip a link, which is what
    // each chain of chunks waits on
    constexpr int LINK = PMAX * NMAX / STATE_NT;
    const int pn_i = a.P * a.N;
    float s0[LINK];
#pragma unroll
    for (int u = 0; u < LINK; ++u) {
        const int i = threadIdx.x + u * STATE_NT;
        s0[u] = before != nullptr && i < pn_i ? __ldcg(before + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LINK; ++u) {
        const int i = threadIdx.x + u * STATE_NT;
        if (i < pn_i) after[i] = s0[u] * decay + own[i];
    }
    if (k.c + 1 < a.nc) {
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) st_release(a.sync + 1 + at, 1);
    }
}

// 16 rows of M x for one key tile: the scores C B^T of rows [i0, i0 + 16)
// (C by ldmatrix from cs, B [key][n] the column-major operand), masked and
// weighted into M in registers, then acc += M x with M as hi + lo (the C
// layout of two n8 tiles is the A layout of one k16 step; x [key][p] by
// ldmatrix.trans)
__device__ __forceinline__ void rows_times_keys(
        float (&acc)[PMAX / 8][4], const bf16* crow, const bf16* bs,
        const bf16* xs, const float* dts, const float* cum,
        const float (&cum_i)[2], int i0, int k0, int L, int N16, int P16) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < N16; kk += 16) {
        uint32_t ca[4];
        tc::ldmatrix_x4(ca, crow + (lane % 16) * LDN + kk + (lane / 16) * 8);
#pragma unroll
        for (int jj = 0; jj < BK / 16; ++jj) {
            uint32_t r[4];
            tc::ldmatrix_x4(r, bs + (jj * 16 + lane % 8 + (lane / 16) * 8) * LDN
                                   + kk + ((lane / 8) % 2) * 8);
            tc::mma_bf16(s[2 * jj], ca, r[0], r[1]);
            tc::mma_bf16(s[2 * jj + 1], ca, r[2], r[3]);
        }
    }
    // M = S exp(cum_i - cum_j) dt_j where j <= i < L, else 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int i = i0 + g + 8 * half;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kj = k0 + j * 8 + 2 * t + e;
                float m = 0.f;
                if (kj <= i && i < L)
                    m = s[j][2 * half + e] * expf(cum_i[half] - cum[kj])
                        * dts[kj];
                s[j][2 * half + e] = m;
            }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ahi[4], alo[4];
        split2(s[2 * kk][0], s[2 * kk][1], ahi[0], alo[0]);
        split2(s[2 * kk][2], s[2 * kk][3], ahi[1], alo[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ahi[2], alo[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ahi[3], alo[3]);
#pragma unroll
        for (int jp = 0; jp < PMAX / 16; ++jp) {
            if (jp * 16 >= P16) break;
            uint32_t r[4];
            tc::ldmatrix_x4_trans(r, xs + (kk * 16 + lane % 16) * LDP
                                         + jp * 16 + (lane / 16) * 8);
            tc::mma_bf16(acc[2 * jp], ahi, r[0], r[1]);
            tc::mma_bf16(acc[2 * jp + 1], ahi, r[2], r[3]);
            tc::mma_bf16(acc[2 * jp], alo, r[0], r[1]);
            tc::mma_bf16(acc[2 * jp + 1], alo, r[2], r[3]);
        }
    }
}

// acc = exp(cum_i) C_i . state for 16 rows: the state [p][n], hi and lo,
// is the column-major B operand (plain ldmatrix)
__device__ __forceinline__ void rows_times_state(
        float (&acc)[PMAX / 8][4], const bf16* crow, const bf16* state_hl,
        const float (&cum_i)[2], const bool (&valid)[2], int N16, int P16) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kk = 0; kk < N16; kk += 16) {
        uint32_t ca[4];
        tc::ldmatrix_x4(ca, crow + (lane % 16) * LDN + kk + (lane / 16) * 8);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
            const bf16* sp = state_hl + part * PMAX * LDN;
#pragma unroll
            for (int jp = 0; jp < PMAX / 16; ++jp) {
                if (jp * 16 >= P16) break;
                uint32_t r[4];
                tc::ldmatrix_x4(r, sp + (jp * 16 + lane % 8 + (lane / 16) * 8)
                                            * LDN
                                       + kk + ((lane / 8) % 2) * 8);
                tc::mma_bf16(acc[2 * jp], ca, r[0], r[1]);
                tc::mma_bf16(acc[2 * jp + 1], ca, r[2], r[3]);
            }
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const float e = valid[half] ? expf(cum_i[half]) : 0.f;
#pragma unroll
        for (int j = 0; j < PMAX / 8; ++j) {
            acc[j][2 * half] *= e;
            acc[j][2 * half + 1] *= e;
        }
    }
}

// 16 rows of acc, from row r of the block, into the staged rows ys
__device__ __forceinline__ void stage_rows(float* ys,
                                           const float (&acc)[PMAX / 8][4],
                                           int r) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(ys + (r + g + 8 * half) * LDY + j * 8
                                       + 2 * t) =
                make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
}

// ---- 2: y of up to 256 rows of a chunk
__global__ void __launch_bounds__(OUT_NT, 2) ssd_tc_output_kernel(Args a,
                                                                 int n_rg) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* cs = reinterpret_cast<bf16*>(smem_raw);      // [RG][LDN]: C rows
    bf16* region = cs + RG * LDN;    // the state's hi, lo [PMAX][LDN] each;
                                     // then the key ring
    const int Qp = padded(a.Q);
    float* dts = reinterpret_cast<float*>(region + REGION);
    float* cum = dts + Qp;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4;
    // the heaviest row groups of a chunk first
    const int rg = n_rg - 1 - (int)(blockIdx.x % n_rg);
    const long long cb = blockIdx.x / n_rg;
    const Chunk k = chunk_of(a, cb / a.nc, (int)(cb % a.nc));
    const int r0 = rg * RG;
    if (r0 >= k.L) return;                 // past a ragged chunk's end
    const int P16 = (a.P + 15) / 16 * 16, N16 = (a.N + 15) / 16 * 16;

    load_tile(cs, LDN, k.Cb + (long long)r0 * a.bc_stride, a.bc_stride, RG,
              k.L - r0, N16, a.N, a.vec_bc);
    tc::cp_async_commit();
    {   // the state the chunk starts from, as bfloat16 hi + lo, [p][n]
        const long long pn = (long long)a.P * a.N;
        const float* st = k.c > 0 ? a.incl + (k.bh * a.nc + k.c - 1) * pn
                          : a.h0 != nullptr ? a.h0 + k.bh * pn : nullptr;
        bf16* sth = region;
        bf16* stl = region + PMAX * LDN;
        for (int i0 = threadIdx.x; i0 < P16 * N16; i0 += OUT_NT * BATCH) {
            float v[BATCH];                // loads ahead of the stores
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int i = i0 + u * OUT_NT, p = i / N16, n = i % N16;
                v[u] = st != nullptr && p < a.P && n < a.N
                           ? st[p * a.N + n] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int i = i0 + u * OUT_NT, p = i / N16, n = i % N16;
                if (i >= P16 * N16) break;
                const bf16 hi = __float2bfloat16_rn(v[u]);
                sth[p * LDN + n] = hi;
                stl[p * LDN + n] =
                    __float2bfloat16_rn(v[u] - __bfloat162float(hi));
            }
        }
    }
    chunk_cum(dts, cum, k.dtb, a.H, k.L, a.Q, a.A[k.h]);   // its barriers
                                                           // cover sth, stl
    tc::cp_async_wait<0>();
    __syncthreads();                       // cs has landed

    // warp w: row tiles w and 15 - w of the group, equal causal work
    const int ia = r0 + 16 * warp, ib = r0 + 16 * (RG / 16 - 1 - warp);
    const bf16* ca = cs + (ia - r0) * LDN;
    const bf16* cb_ = cs + (ib - r0) * LDN;
    float cum_a[2], cum_b[2];
    bool val_a[2], val_b[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int i = ia + g + 8 * half, j = ib + g + 8 * half;
        val_a[half] = i < k.L;
        val_b[half] = j < k.L;
        cum_a[half] = val_a[half] ? cum[i] : 0.f;
        cum_b[half] = val_b[half] ? cum[j] : 0.f;
    }
    float acc_a[PMAX / 8][4], acc_b[PMAX / 8][4];
    rows_times_state(acc_a, ca, region, cum_a, val_a, N16, P16);
    rows_times_state(acc_b, cb_, region, cum_b, val_b, N16, P16);
    __syncthreads();                       // sth, stl are read: the ring

    const int kend = min(r0 + RG, k.L);
    const int nkt = (kend + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nkt) load_keys(a, k, region, s, s);
        tc::cp_async_commit();
    }
    for (int kt = 0; kt < nkt; ++kt) {
        if (kt + STAGES - 1 < nkt)
            load_keys(a, k, region, kt + STAGES - 1,
                      (kt + STAGES - 1) % STAGES);
        tc::cp_async_commit();
        tc::cp_async_wait<STAGES - 1>();
        __syncthreads();
        const bf16* bs = region + (kt % STAGES) * KEY_TILE;
        const bf16* xs = bs + BK * LDN;
        const int k0 = kt * BK;
        if (ia + 15 >= k0 && ia < k.L)
            rows_times_keys(acc_a, ca, bs, xs, dts, cum, cum_a, ia, k0, k.L,
                            N16, P16);
        if (ib + 15 >= k0 && ib < k.L)
            rows_times_keys(acc_b, cb_, bs, xs, dts, cum, cum_b, ib, k0, k.L,
                            N16, P16);
        __syncthreads();                   // the slot is free for a reload
    }
    tc::cp_async_wait<0>();

    // ---- y = acc + D x, rounded once: acc staged in shared memory (over
    // cs, free now), then whole rows of y written 16 bytes a thread
    float* ys = reinterpret_cast<float*>(cs);           // [RG][LDY]
    stage_rows(ys, acc_a, ia - r0);
    stage_rows(ys, acc_b, ib - r0);
    __syncthreads();
    const float d_h = a.D[k.h];
    const long long xrow = (long long)a.H * a.P;
    const bf16* xr0 = k.xb + r0 * xrow;
    bf16* yr0 = a.y + (long long)(k.xb - a.x) + r0 * xrow;
    const int rows = kend - r0;
    // a batch's loads of x all issue before its stores of y, as above
    if (a.vec_x) {
        const int per = a.P / 8, total = rows * per;
        for (int i0 = threadIdx.x; i0 < total; i0 += OUT_NT * BATCH) {
            uint4 xv[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int i = i0 + u * OUT_NT;
                if (i < total)
                    xv[u] = *reinterpret_cast<const uint4*>(
                        xr0 + (i / per) * xrow + (i % per) * 8);
            }
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int i = i0 + u * OUT_NT;
                if (i >= total) continue;
                const int r = i / per, p = (i % per) * 8;
                const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[u]);
                const float* acc = ys + r * LDY + p;
                uint4 out;
                uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float2 xf = tc::unpack_bf16(xw[q]);
                    ow[q] = tc::pack_bf16(acc[2 * q] + xf.x * d_h,
                                          acc[2 * q + 1] + xf.y * d_h);
                }
                *reinterpret_cast<uint4*>(yr0 + r * xrow + p) = out;
            }
        }
    } else {
        const int total = rows * a.P;
        for (int i0 = threadIdx.x; i0 < total; i0 += OUT_NT * BATCH) {
            float xv[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int i = i0 + u * OUT_NT;
                xv[u] = i < total ? __bfloat162float(
                                        xr0[(i / a.P) * xrow + i % a.P])
                                  : 0.f;
            }
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int i = i0 + u * OUT_NT;
                if (i < total)
                    yr0[(i / a.P) * xrow + i % a.P] = __float2bfloat16_rn(
                        ys[(i / a.P) * LDY + i % a.P] + xv[u] * d_h);
            }
        }
    }
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, y: [B, S, H, P] bfloat16, contiguous; Bm, Cm: [B, S, G, N] bfloat16
// with [G, N] contiguous and bc_stride elements from one token to the next;
// dt [B, S, H], A, D [H], h0 (or null) and hout [B, H, P, N] float32,
// contiguous.  Scratch: incl [B * H * ceil(S / Q) * P * N] float32, and
// sync [1 + B * H * ceil(S / Q)] int32, zeroed.  P <= 64, N <= 128,
// 0 < Q <= 4096, H a multiple of G.
extern "C" int ssd_scan_tc_launch(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* D,
                                  const void* h0, void* y, void* hout,
                                  void* incl, void* sync, int B, int S,
                                  int H, int G, int P, int N, int Q,
                                  long long bc_stride, int device,
                                  void* stream) {
    if (B <= 0 || S <= 0 || H <= 0) return 0;
    if (P <= 0 || P > PMAX || N <= 0 || N > NMAX || G <= 0 || H % G != 0
            || Q <= 0 || Q > QMAX)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    Args a;
    a.x = (const bf16*)x;
    a.dt = (const float*)dt;
    a.A = (const float*)A;
    a.Bm = (const bf16*)Bm;
    a.Cm = (const bf16*)Cm;
    a.D = (const float*)D;
    a.h0 = (const float*)h0;
    a.y = (bf16*)y;
    a.hout = (float*)hout;
    a.incl = (float*)incl;
    a.sync = (int*)sync;
    a.S = S; a.H = H; a.G = G; a.P = P; a.N = N; a.Q = Q;
    a.nc = (S + Q - 1) / Q;
    a.bc_stride = bc_stride;
    a.vec_x = P % 8 == 0 && aligned16(x);
    a.vec_bc = N % 8 == 0 && bc_stride % 8 == 0 && aligned16(Bm)
               && aligned16(Cm);
    const long long chunks = (long long)B * H * a.nc;

    size_t smem = chunk_state_smem(Q);
    err = cudaFuncSetAttribute(ssd_tc_chunk_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_tc_chunk_state_kernel<<<(unsigned)chunks, STATE_NT, smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int n_rg = (Q + RG - 1) / RG;
    smem = output_smem(Q);
    err = cudaFuncSetAttribute(ssd_tc_output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_tc_output_kernel<<<(unsigned)(chunks * n_rg), OUT_NT, smem, s>>>(
        a, n_rg);
    return (int)cudaGetLastError();
}
