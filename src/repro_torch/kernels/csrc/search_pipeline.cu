// The three remaining stages of the fused cut search, CUDA C++ for sm_90a:
// candidate enumeration, the float64 cost reduction with a per-block argmin,
// and the lexicographic argmin over rows.
//
// THIS FILE MUST BE COMPILED WITH -fmad=false AND WITHOUT --use_fast_math.
// The cost stage has to reproduce the host's IEEE float64 arithmetic bit for
// bit -- a multiply-add contraction or a reciprocal in place of the division
// changes the last bit of a latency total and with it the winner of a tie.
//
// All matrices are lane-major ([G][B]: one row per group), the layout the
// allocator kernel reads and writes, so a warp's 32 candidates touch 32
// neighbouring addresses.
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing and does not synchronise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;       // threads per block in the two reductions

// A candidate's objective key and linear index; the order is lexicographic.
struct Key {
    double infeas, primary, secondary, idx;
};

__device__ __forceinline__ Key pad_key() {
    // greater than any real key: never wins
    return Key{INFINITY, INFINITY, INFINITY, INFINITY};
}

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
    if (a.infeas != b.infeas) return a.infeas < b.infeas;
    if (a.primary != b.primary) return a.primary < b.primary;
    if (a.secondary != b.secondary) return a.secondary < b.secondary;
    return a.idx < b.idx;
}

// Block-wide first lexicographic minimum; the result is valid in thread 0.
__device__ Key block_argmin(Key k) {
    __shared__ double sh[4][BLOCK];
    const int t = threadIdx.x;
    sh[0][t] = k.infeas;
    sh[1][t] = k.primary;
    sh[2][t] = k.secondary;
    sh[3][t] = k.idx;
    __syncthreads();
    for (int step = BLOCK / 2; step > 0; step >>= 1) {
        if (t < step) {
            const Key a{sh[0][t], sh[1][t], sh[2][t], sh[3][t]};
            const Key o{sh[0][t + step], sh[1][t + step], sh[2][t + step],
                        sh[3][t + step]};
            if (key_less(o, a)) {
                sh[0][t] = o.infeas;
                sh[1][t] = o.primary;
                sh[2][t] = o.secondary;
                sh[3][t] = o.idx;
            }
        }
        __syncthreads();
    }
    return Key{sh[0][0], sh[1][0], sh[2][0], sh[3][0]};
}

// ---------------------------------------------------------------- enumerate
// Linear index lo + b -> cut per run (a fixed prefix cut, or the mixed-radix
// digit (j / stride) % dim, last run fastest) -> frame bit per group.
// digits is [3][nr] int64: fixed cut, stride (0 marks a fixed run), dim.
// The groups of a run are contiguous, so the digit is recomputed only when
// the run changes along g.
__global__ void __launch_bounds__(BLOCK)
enum_frames_kernel(const long long* __restrict__ digits,
                   const int* __restrict__ run_of,
                   const int* __restrict__ pos_of,
                   const uint8_t* __restrict__ dir_neg,
                   uint8_t* __restrict__ frame,          // [n][B]
                   long long lo, long long B, int n, int nr) {
    const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (b >= B) return;
    const long long j = lo + b;
    int last_run = -1;
    int cut = 0;
    for (int g = 0; g < n; ++g) {
        const int r = __ldg(run_of + g);
        if (r != last_run) {
            const long long stride = __ldg(digits + nr + r);
            cut = stride ? (int)((j / stride) % __ldg(digits + 2 * nr + r))
                         : (int)__ldg(digits + r);
            last_run = r;
        }
        const int pos = __ldg(pos_of + g);
        frame[g * B + b] = __ldg(dir_neg + g) ? (pos >= cut) : (pos < cut);
    }
}

// --------------------------------------------------------------------- cost
// rows of the static table, [10][n] float64
constexpr int T_COMP = 0, T_ROW = 1, T_WEIGHT = 2, T_SIDE = 3, T_ROWFM = 4,
              T_SCOMP = 5, T_SWEIGHT = 6, T_OUTF = 7, T_OUTR = 8, T_WRR = 9;

__global__ void __launch_bounds__(BLOCK)
cost_rows_kernel(const uint8_t* __restrict__ frame,     // [n][B]
                 const int* __restrict__ io,            // [n][B]
                 const int* __restrict__ stats,         // [7][B]
                 const double* __restrict__ tab,        // [10][n]
                 double* __restrict__ out,              // [4][gridDim.x]
                 long long lo, long long S, long long B, int n,
                 double bpc, double goc, double budget, double wbytes,
                 double row_buff, int objective) {
    const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    Key key = pad_key();
    if (b < B && lo + b < S) {
        double lat = 0.0, rterm = 0.0;
        double wbuff = 0.0, outf = 0.0, outr = 0.0, wrr = 0.0;
        for (int g = 0; g < n; ++g) {
            const bool fr = frame[g * B + b] != 0;
            const double comp = __ldg(tab + T_COMP * n + g);
            double per;
            if (__ldg(tab + T_SIDE * n + g) > 0.0) {
                per = comp;
            } else if (fr) {
                const double mem =
                    (__ldg(tab + T_WEIGHT * n + g) + (double)io[g * B + b])
                    / bpc;
                per = fmax(comp, mem) + goc;
            } else {
                per = __ldg(tab + T_ROW * n + g);
            }
            // the latency total: one term per step, in gid order
            lat += per;
            if (!fr) rterm += __ldg(tab + T_ROWFM * n + g);
            if (__ldg(tab + T_SCOMP * n + g) > 0.0) {
                if (fr) {
                    outf = fmax(outf, __ldg(tab + T_OUTF * n + g));
                } else {
                    wbuff = fmax(wbuff, __ldg(tab + T_SWEIGHT * n + g));
                    outr = fmax(outr, __ldg(tab + T_OUTR * n + g));
                    wrr = fmax(wrr, __ldg(tab + T_WRR * n + g));
                }
            }
        }
        const double b0 = (double)stats[0 * B + b];
        const double b1 = (double)stats[1 * B + b];
        const double b2 = (double)stats[2 * B + b];
        const double side = (double)stats[3 * B + b];
        const double wrf = (double)stats[4 * B + b];
        const double bfm = (double)stats[5 * B + b];
        const bool feas = stats[6 * B + b] > 0;
        // integer-valued float64 terms below 2^53: exact in any order
        const double dram = rterm + bfm + wbytes;
        const double sram = row_buff + fmax(outf, outr) + fmax(wrr, wrf)
                            + b0 + fmax(b1, wbuff) + b2 + side;
        const bool feasible = (sram <= budget) && feas;
        key.infeas = feasible ? 0.0 : 1.0;
        key.idx = (double)(lo + b);
        if (objective == 0) {            // latency
            key.primary = lat;
            key.secondary = sram;
        } else if (objective == 1) {     // sram
            key.primary = sram;
            key.secondary = lat;
        } else {                         // dram
            key.primary = dram;
            key.secondary = lat;
        }
    }
    const Key win = block_argmin(key);
    if (threadIdx.x == 0) {
        const long long nb = gridDim.x;
        out[0 * nb + blockIdx.x] = win.infeas;
        out[1 * nb + blockIdx.x] = win.primary;
        out[2 * nb + blockIdx.x] = win.secondary;
        out[3 * nb + blockIdx.x] = win.idx;
    }
}

// ------------------------------------------------------------------- argmin
// One block reduces L lanes, [4][L] float64, to the first lexicographic
// minimum: 4 float64.
__global__ void __launch_bounds__(BLOCK)
argmin_rows_kernel(const double* __restrict__ lanes, double* __restrict__ out,
                   long long L) {
    Key best = pad_key();
    for (long long i = threadIdx.x; i < L; i += BLOCK) {
        const Key k{lanes[i], lanes[L + i], lanes[2 * L + i],
                    lanes[3 * L + i]};
        if (key_less(k, best)) best = k;
    }
    const Key win = block_argmin(best);
    if (threadIdx.x == 0) {
        out[0] = win.infeas;
        out[1] = win.primary;
        out[2] = win.secondary;
        out[3] = win.idx;
    }
}

}  // namespace

extern "C" int enum_frames_launch(const void* digits, const void* run_of,
                                  const void* pos_of, const void* dir_neg,
                                  void* frame, long long lo, long long B,
                                  int n, int nr, int device, void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + BLOCK - 1) / BLOCK;
    enum_frames_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        (const long long*)digits, (const int*)run_of, (const int*)pos_of,
        (const uint8_t*)dir_neg, (uint8_t*)frame, lo, B, n, nr);
    return (int)cudaGetLastError();
}

// out must hold [4][ceil(B / 256)] float64
extern "C" int cost_rows_launch(const void* frame, const void* io,
                                const void* stats, const void* tab, void* out,
                                long long lo, long long S, long long B, int n,
                                double bpc, double goc, double budget,
                                double wbytes, double row_buff, int objective,
                                int device, void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + BLOCK - 1) / BLOCK;
    cost_rows_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frame, (const int*)io, (const int*)stats,
        (const double*)tab, (double*)out, lo, S, B, n, bpc, goc, budget,
        wbytes, row_buff, objective);
    return (int)cudaGetLastError();
}

extern "C" int argmin_rows_launch(const void* lanes, void* out, long long L,
                                  int device, void* stream) {
    if (L <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    argmin_rows_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(
        (const double*)lanes, (double*)out, L);
    return (int)cudaGetLastError();
}
