// Mamba-2 SSD chunked scan, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_kernel.  For x
// [B, S, H, P] and Bm, Cm [B, S, G, N] (the model's layout, read in place;
// head h reads group h / (H / G)), dt [B, S, H] float32, A, D [H] float32
// and an initial state h0 [B, H, P, N] float32 (or none: 0) it computes,
// chunk by chunk of Q tokens,
//
//     cum_i   = sum_{t <= i} dt_t A                    (within the chunk)
//     y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//               + exp(cum_i) C_i . state + D x_i
//     state'  = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j
//
// and writes y [B, S, H, P] in x's type (rounded once, after the D x term)
// and the final state [B, H, P, N] float32.  Every input is taken to
// float32; cum is summed in float64 and rounded once a position (a float32
// running sum reaches |cum| ~ 600 at Q = 256, where its rounding alone
// moves the differences cum_i - cum_j that matter by ~6e-5).  The TPU
// kernel starts from a zero state, keeps it in VMEM and never writes it
// out, and asserts S % Q == 0; here the state starts from h0 and is
// written at the end (decode continues from it), and a ragged
// last chunk is masked in place: positions past S count as dt = 0, x = B =
// C = 0 (no state change, no contribution), as models/mamba2.py::
// ssd_chunked pads.  exp(cum_i - cum_j) is formed only for i >= j, where
// the exponent is <= 0: exp(-cum_j) alone overflows float32 at Q = 256.
//
// What bounds it on the card: the operations.  At mamba2-2.7b's prefill
// (B 4, S 2,048, H 80, P 64, G 1, N 128, Q 256) the function needs about
// 16 G multiply-adds a launch (the causal halves of C B^T, once per group,
// and of the scores times x, and the state's two products), against 195 MB
// of bytes.  This first version does them as SIMT float32 fused
// multiply-adds out of shared memory, not on the tensor cores, and computes
// C B^T once per head rather than once per group, so it runs well above
// that bound (PERF.md).
//
// Design.  One block of 256 threads per (batch, head); it walks the chunks
// in order with the state on chip, as the TPU kernel walks its sequential
// grid axis.  The state lives in shared memory transposed, st[n][p].
// Within a chunk the rows are cut into tiles of BQ = 64 and the keys into
// tiles of BK = 64; a row tile visits the key tiles up to its own
// (the diagonal tile is masked, the ones above it are skipped).  The
// threads form a 16 x 16 grid, thread (ty, tx) owning rows ty + 16a and
// columns tx + 16c (a, c < 4) of each 64 x 64 tile, so every shared load of
// an inner loop is one broadcast or 16 neighbouring words (tile rows are
// padded to an odd stride).  Per row tile: acc = exp(cum_i) C_i . st; per
// key tile: the score tile S = C B^T, then M = S exp(cum_i - cum_j) dt_j
// into shared memory, then acc += M x.  The last row tile of a chunk visits
// every key tile, so its pass also accumulates the state increment
// (32 values a thread: rows n = ty + 16a, a < 8; columns p = tx + 16c),
// which is added to the decayed state once every row tile has read it.
// Shared memory: 132.6 KB of tiles and 16 bytes a chunk position (136.7 KB
// at Q = 256), so one block an SM; 320 blocks at the serve, 2.4 waves.
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int BQ = 64;                 // rows of a tile
constexpr int BK = 64;                 // keys of a tile
constexpr int PMAX = 64;               // head dim P at most
constexpr int NMAX = 128;              // state dim N at most
constexpr int LDP = PMAX + 1;          // row strides of the shared tiles:
constexpr int LDN = NMAX + 1;          // odd, so 16 rows at one column
constexpr int LDM = BK + 1;            // fall in 16 banks
constexpr int QMAX = 4096;

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

size_t smem_bytes(int Q) {
    return sizeof(float) * ((size_t)NMAX * LDP + (size_t)BQ * LDN
                            + (size_t)BK * LDN + (size_t)BK * LDP
                            + (size_t)BQ * LDM + 4 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
        const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, const float* __restrict__ Dv,
        const float* __restrict__ h0, T* __restrict__ y,
        float* __restrict__ hout, int S, int H, int G, int P, int N, int Q,
        long long bc_stride) {
    extern __shared__ __align__(16) float smem[];
    float* st = smem;                          // [NMAX][LDP]: state^T
    float* cs = st + NMAX * LDP;               // [BQ][LDN]: C of the rows
    float* bs = cs + BQ * LDN;                 // [BK][LDN]: B of the keys
    float* xs = bs + BK * LDN;                 // [BK][LDP]: x of the keys
    float* ms = xs + BK * LDP;                 // [BQ][LDM]: the masked scores
    float* dts = ms + BQ * LDM;                // [Q]: dt, 0 past S
    float* cum = dts + Q;                      // [Q]: cumulative dt A
    float* wk = cum + Q;                       // [Q]: dt_j exp(cum_Q - cum_j)
    float* ecum = wk + Q;                      // [Q]: exp(cum_i)

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int lane = tid % 32;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int grp = h / (H / G);
    const float a_h = A[h], d_h = Dv[h];
    const long long xrow = (long long)H * P;   // elements a token in x, y
    const T* xb = x + (long long)b * S * xrow + (long long)h * P;
    T* yb = y + (long long)b * S * xrow + (long long)h * P;
    const float* dtb = dt + (long long)b * S * H + h;
    const long long bcb = (long long)b * S * bc_stride + (long long)grp * N;
    const T* Bb = Bm + bcb;
    const T* Cb = Cm + bcb;

    // every tile starts at 0, so the columns past P and N stay 0
    for (int e = tid; e < BQ * LDM + NMAX * LDP + BQ * LDN + BK * LDN
                          + BK * LDP; e += NT)
        smem[e] = 0.f;
    __syncthreads();
    if (h0 != nullptr) {
        const float* h0b = h0 + (long long)bh * P * N;
        for (int e = tid; e < P * N; e += NT)
            st[(e % N) * LDP + e / N] = h0b[e];
    }

    const int n_chunks = (S + Q - 1) / Q;
    for (int c = 0; c < n_chunks; ++c) {
        const int t0 = c * Q, L = min(Q, S - t0);
        __syncthreads();                       // the last chunk is done
        for (int i = tid; i < Q; i += NT)
            dts[i] = i < L ? dtb[(long long)(t0 + i) * H] : 0.f;
        __syncthreads();
        if (tid < 32) {
            // cum: one warp's scan of the float32 products dt A, summed in
            // float64 and rounded once a position, as the plain version
            // does: both hold the same float32 cum, whatever the order
            const int per = (Q + 31) / 32;
            const int lo = min(Q, lane * per), hi = min(Q, lo + per);
            double total = 0.0;
            for (int i = lo; i < hi; ++i)
                total += (double)__fmul_rn(dts[i], a_h);
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
        const float c_last = cum[Q - 1];
        for (int i = tid; i < Q; i += NT) {
            wk[i] = dts[i] * expf(c_last - cum[i]);
            ecum[i] = expf(cum[i]);
        }

        float inc[8][4];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) inc[a][q] = 0.f;

        const int n_rt = (L + BQ - 1) / BQ;
        for (int rt = 0; rt < n_rt; ++rt) {
            const int r0 = rt * BQ;
            const bool last = rt == n_rt - 1;
            __syncthreads();                   // cs of the last tile is read
            for (int e = tid; e < BQ * N; e += NT) {
                const int i = e / N, n = e % N;
                cs[i * LDN + n] = r0 + i < L
                    ? to_f(Cb[(long long)(t0 + r0 + i) * bc_stride + n])
                    : 0.f;
            }
            __syncthreads();

            // the state's part: acc = exp(cum_i) C_i . st
            float acc[4][4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
            for (int n = 0; n < N; ++n) {
                float cv[4], sv[4];
#pragma unroll
                for (int a = 0; a < 4; ++a)
                    cv[a] = cs[(ty + 16 * a) * LDN + n];
#pragma unroll
                for (int q = 0; q < 4; ++q) sv[q] = st[n * LDP + tx + 16 * q];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[a][q] += cv[a] * sv[q];
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int i = r0 + ty + 16 * a;
                const float e = i < L ? ecum[i] : 0.f;
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[a][q] *= e;
            }

            for (int kt = 0; kt <= rt; ++kt) {
                const int k0 = kt * BK;
                __syncthreads();               // bs, xs, ms are read
                for (int e = tid; e < BK * N; e += NT) {
                    const int j = e / N, n = e % N;
                    bs[j * LDN + n] = k0 + j < L
                        ? to_f(Bb[(long long)(t0 + k0 + j) * bc_stride + n])
                        : 0.f;
                }
                for (int e = tid; e < BK * P; e += NT) {
                    const int j = e / P, p = e % P;
                    xs[j * LDP + p] = k0 + j < L
                        ? to_f(xb[(long long)(t0 + k0 + j) * xrow + p])
                        : 0.f;
                }
                __syncthreads();

                // scores C B^T of the tile, masked and weighted into ms
                float s[4][4];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int q = 0; q < 4; ++q) s[a][q] = 0.f;
                for (int n = 0; n < N; ++n) {
                    float cv[4], bv[4];
#pragma unroll
                    for (int a = 0; a < 4; ++a)
                        cv[a] = cs[(ty + 16 * a) * LDN + n];
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        bv[q] = bs[(tx + 16 * q) * LDN + n];
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int q = 0; q < 4; ++q) s[a][q] += cv[a] * bv[q];
                }
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const int i = r0 + ty + 16 * a;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int j = k0 + tx + 16 * q;
                        ms[(ty + 16 * a) * LDM + tx + 16 * q] =
                            (i < L && j <= i)
                                ? s[a][q] * expf(cum[i] - cum[j]) * dts[j]
                                : 0.f;
                    }
                }
                __syncthreads();

                // acc += M x
                for (int j = 0; j < BK; ++j) {
                    float mv[4], xv[4];
#pragma unroll
                    for (int a = 0; a < 4; ++a)
                        mv[a] = ms[(ty + 16 * a) * LDM + j];
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        xv[q] = xs[j * LDP + tx + 16 * q];
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int q = 0; q < 4; ++q) acc[a][q] += mv[a] * xv[q];
                }
                // the state increment, on the pass that sees every key
                if (last) {
                    const int jn = min(BK, L - k0);
                    for (int j = 0; j < jn; ++j) {
                        const float w = wk[k0 + j];
                        float bv[8], xv[4];
#pragma unroll
                        for (int a = 0; a < 8; ++a)
                            bv[a] = bs[j * LDN + ty + 16 * a];
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            xv[q] = w * xs[j * LDP + tx + 16 * q];
#pragma unroll
                        for (int a = 0; a < 8; ++a)
#pragma unroll
                            for (int q = 0; q < 4; ++q)
                                inc[a][q] += bv[a] * xv[q];
                    }
                }
            }

            // y = acc + D x, rounded once
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int i = r0 + ty + 16 * a;
                if (i >= L) continue;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int p = tx + 16 * q;
                    if (p >= P) continue;
                    const long long at = (long long)(t0 + i) * xrow + p;
                    yb[at] = from_f<T>(acc[a][q] + to_f(xb[at]) * d_h);
                }
            }
        }

        // state = exp(cum_last) state + increment, once every row has read it
        __syncthreads();
        const float decay = expf(c_last);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float* sp = st + (ty + 16 * a) * LDP + tx + 16 * q;
                *sp = *sp * decay + inc[a][q];
            }
    }

    __syncthreads();
    float* hb = hout + (long long)bh * P * N;
    for (int e = tid; e < P * N; e += NT) hb[e] = st[(e % N) * LDP + e / N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* h0, void* y,
           void* hout, int B, int S, int H, int G, int P, int N, int Q,
           long long bc_stride, cudaStream_t stream) {
    const size_t smem = smem_bytes(Q);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_scan_kernel<T><<<(unsigned)(B * H), NT, smem, stream>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
        (const T*)Cm, (const float*)D, (const float*)h0, (T*)y,
        (float*)hout, S, H, G, P, N, Q, bc_stride);
    return (int)cudaGetLastError();
}

}  // namespace

// x, y: [B, S, H, P] contiguous; Bm, Cm: [B, S, G, N] with [G, N]
// contiguous and bc_stride elements from one token to the next (G * N when
// contiguous); dt [B, S, H], A, D [H], h0 (or null) and hout [B, H, P, N]
// float32, contiguous.  x, Bm, Cm bfloat16 (is_bf16) or float32.  P <= 64,
// N <= 128, 0 < Q <= 4096, H a multiple of G.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* h0, void* y, void* hout, int B,
                               int S, int H, int G, int P, int N, int Q,
                               long long bc_stride, int is_bf16, int device,
                               void* stream) {
    if (B <= 0 || S <= 0 || H <= 0) return 0;
    if (P <= 0 || P > PMAX || N <= 0 || N > NMAX || G <= 0 || H % G != 0
            || Q <= 0 || Q > QMAX)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S,
                                     H, G, P, N, Q, bc_stride, s);
    return launch<float>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, H, G, P, N,
                         Q, bc_stride, s);
}
