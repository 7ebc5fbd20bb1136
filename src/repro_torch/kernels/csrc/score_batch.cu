// The staged float32 scorer of the cut search, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/score_batch.py::_score_kernel.  Per
// candidate it reduces the B x G frame-mask and boundary-I/O matrices against
// the nine per-group cost tables into six float32 numbers: the latency sum,
// the row-mode DRAM feature-map sum and four SRAM maxima (see
// score_batch.py).  Two kernels compute it; score_batch.py::score_batch_plan
// picks one from B and the number of SMs.
//
// * score_batch_kernel -- one thread a candidate, walking the groups in gid
//   order with its six accumulators in registers.  Frame and io are
//   lane-major ([G][B]), so a warp's 32 candidates read 32 neighbouring
//   addresses at every group; the output is lane-major [6][B].  At the
//   pipeline's chunk (B 1,048,576, G 26) it is bound by bytes: 5 bytes a
//   candidate and group against ~14 float32 operations.  It keeps large
//   batches.
// * score_batch_split_kernel -- one warp a candidate, for batches that would
//   fill fewer than two blocks an SM of the first kernel.  The cut search's
//   descent gives the scorer 1 to 8 candidates, the engine's exhaustive
//   batches 1,024: there one thread a candidate is a chain of G round trips
//   to memory, one group's loads waiting for the last (G 139: ~0.05 ms),
//   and the bytes (5 B G) bound nothing.  So lane l owns groups l, l + 32,
//   ... and issues all of their mask and io loads at once, while the block
//   stages the nine table rows in shared memory: a candidate costs one round
//   trip for every SPLIT_PASS groups.  Each lane prices its groups with the
//   first kernel's operations and leaves the latency and row-mode terms in
//   shared memory; lanes 0 and 1 then add them up in gid order, one plain
//   left-to-right float32 sum each, the same sum as the first kernel's and
//   the plain version's.  The four maxima are reduced across the lanes by
//   fmaxf from 0.f: exact in any order, since every table entry is a
//   non-negative, non-NaN float32.  It reads frame and io in place through
//   their strides (row-major (B, G) from the host or lane-major from K1
//   alike, no copy), and writes its stats row-major, [B][6], so the host
//   reads them back in one piece.
//
// THIS FILE MUST BE COMPILED WITH -fmad=false AND WITHOUT --use_fast_math.
// The plain torch version in score_batch.py does the same float32 operations
// in the same order (a left-to-right sum in gid order, an IEEE division), and
// both kernels are held equal to it bit for bit; the explicit _rn intrinsics
// below say so in the source as well.
//
// The tables are (9, G) float32 rows.  Plain C interface; every launch goes
// to the stream it is given, allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
// rows of the table matrix, in score_batch.py::TABLE_KEYS order
enum { T_COMP, T_ROW, T_WEIGHT, T_SIDE, T_ROWFM, T_COMPUTE, T_OUTF, T_OUTR,
       T_WRR, N_TABLES };

__global__ void score_batch_kernel(const uint8_t* __restrict__ frame,
                                   const float* __restrict__ io_f,
                                   const int* __restrict__ io_i,
                                   const float* __restrict__ tab,
                                   float* __restrict__ out,
                                   long long B, int G, float bpc, float ovh) {
    const long long b = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (b >= B) return;
    float lat = 0.f, rfm = 0.f;
    float wbuff = 0.f, outf = 0.f, outr = 0.f, wrr = 0.f;
    for (int g = 0; g < G; ++g) {
        const long long at = (long long)g * B + b;
        const bool fr = frame[at] != 0;
        const float iov = io_f != nullptr ? io_f[at] : __int2float_rn(io_i[at]);
        const float comp = __ldg(tab + T_COMP * G + g);
        const float weight = __ldg(tab + T_WEIGHT * G + g);
        const float mem = __fdiv_rn(__fadd_rn(weight, iov), bpc);
        const float frame_lat = __fadd_rn(fmaxf(comp, mem), ovh);
        const float per = __ldg(tab + T_SIDE * G + g) > 0.f
                              ? comp
                              : (fr ? frame_lat : __ldg(tab + T_ROW * G + g));
        lat = __fadd_rn(lat, per);
        rfm = __fadd_rn(rfm, fr ? 0.f : __ldg(tab + T_ROWFM * G + g));
        if (__ldg(tab + T_COMPUTE * G + g) > 0.f) {
            if (fr) {
                outf = fmaxf(outf, __ldg(tab + T_OUTF * G + g));
            } else {
                wbuff = fmaxf(wbuff, weight);
                outr = fmaxf(outr, __ldg(tab + T_OUTR * G + g));
                wrr = fmaxf(wrr, __ldg(tab + T_WRR * G + g));
            }
        }
    }
    out[0 * B + b] = lat;
    out[1 * B + b] = rfm;
    out[2 * B + b] = wbuff;
    out[3 * B + b] = outf;
    out[4 * B + b] = outr;
    out[5 * B + b] = wrr;
}

constexpr int SPLIT_WARPS = 4;    // candidates a block of the split kernel
constexpr int SPLIT_THREADS = 32 * SPLIT_WARPS;
constexpr int SPLIT_PER = 8;      // groups a lane has in flight in a pass
constexpr int SPLIT_PASS = 32 * SPLIT_PER;  // groups a pass (the zoo's G is
                                            // at most 160: one pass)
static_assert(SPLIT_PASS % SPLIT_THREADS == 0,
              "the block stages a pass's table columns in whole rounds");

// An io word as float32: K1's int32 bytes rounded once, or float32 as is.
__device__ __forceinline__ float io_value(float v) { return v; }
__device__ __forceinline__ float io_value(int v) { return __int2float_rn(v); }

// One warp a candidate, SPLIT_WARPS candidates a block.  Pass p covers groups
// g0 = p * SPLIT_PASS .. g0 + SPLIT_PASS - 1: lane l loads the mask byte and
// io word of groups g0 + l + 32 j (j < SPLIT_PER) into registers, the block
// stages those table columns in shared memory, each lane prices its groups,
// and lanes 0 (latency) and 1 (row-mode DRAM) add the pass's terms to their
// running sums in gid order.  Warps past B still stage and wait.
template <typename IO>
__global__ void __launch_bounds__(SPLIT_THREADS)
score_batch_split_kernel(const uint8_t* __restrict__ frame,
                         long long fs_b, long long fs_g,
                         const IO* __restrict__ io,
                         long long is_b, long long is_g,
                         const float* __restrict__ tab,
                         float* __restrict__ out,       // [B][6]
                         long long B, int G, float bpc, float ovh) {
    __shared__ float tabs[N_TABLES][SPLIT_PASS];
    // per warp: [0] the latency terms, [1] the row-mode terms of a pass (one
    // float apart in the banks: lanes 0 and 1 read them side by side)
    __shared__ float terms[SPLIT_WARPS][2][SPLIT_PASS + 1];
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const long long b = (long long)blockIdx.x * SPLIT_WARPS + w;
    const bool in = b < B;
    const uint8_t* frow = frame + (in ? b * fs_b : 0);
    const IO* iorow = io + (in ? b * is_b : 0);
    float sum = 0.f;     // lane 0: the latency, lane 1: the row-mode term
    float wbuff = 0.f, outf = 0.f, outr = 0.f, wrr = 0.f;
    for (int g0 = 0; g0 < G; g0 += SPLIT_PASS) {
        const int n = min(SPLIT_PASS, G - g0);
        // the pass's loads, all issued before any is used
        uint8_t fr[SPLIT_PER];
        IO iw[SPLIT_PER];
#pragma unroll
        for (int j = 0; j < SPLIT_PER; ++j) {
            const int g = g0 + lane + 32 * j;
            fr[j] = 0;
            iw[j] = 0;
            if (in && g < G) {
                fr[j] = frow[g * fs_g];
                iw[j] = iorow[g * is_g];
            }
        }
        if (g0 > 0) __syncthreads();     // the last pass's table is read
#pragma unroll
        for (int k = 0; k < N_TABLES; ++k)
#pragma unroll
            for (int h = 0; h < SPLIT_PASS / SPLIT_THREADS; ++h) {
                const int g = threadIdx.x + h * SPLIT_THREADS;
                if (g < n) tabs[k][g] = __ldg(tab + (long long)k * G + g0 + g);
            }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < SPLIT_PER; ++j) {
            const int i = lane + 32 * j;
            if (i < n) {
                const bool f = fr[j] != 0;
                const float comp = tabs[T_COMP][i];
                const float weight = tabs[T_WEIGHT][i];
                const float mem =
                    __fdiv_rn(__fadd_rn(weight, io_value(iw[j])), bpc);
                const float frame_lat = __fadd_rn(fmaxf(comp, mem), ovh);
                terms[w][0][i] = tabs[T_SIDE][i] > 0.f
                                     ? comp
                                     : (f ? frame_lat : tabs[T_ROW][i]);
                terms[w][1][i] = f ? 0.f : tabs[T_ROWFM][i];
                if (tabs[T_COMPUTE][i] > 0.f) {
                    if (f) {
                        outf = fmaxf(outf, tabs[T_OUTF][i]);
                    } else {
                        wbuff = fmaxf(wbuff, weight);
                        outr = fmaxf(outr, tabs[T_OUTR][i]);
                        wrr = fmaxf(wrr, tabs[T_WRR][i]);
                    }
                }
            }
        }
        __syncwarp();
        if (lane < 2) {
            // one plain left-to-right sum in gid order a lane
            const float* t = terms[w][lane];
#pragma unroll 8
            for (int i = 0; i < n; ++i) sum = __fadd_rn(sum, t[i]);
        }
        __syncwarp();                    // before the next pass's terms
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
        wbuff = fmaxf(wbuff, __shfl_xor_sync(0xffffffffu, wbuff, off));
        outf = fmaxf(outf, __shfl_xor_sync(0xffffffffu, outf, off));
        outr = fmaxf(outr, __shfl_xor_sync(0xffffffffu, outr, off));
        wrr = fmaxf(wrr, __shfl_xor_sync(0xffffffffu, wrr, off));
    }
    const float rfm = __shfl_sync(0xffffffffu, sum, 1);
    if (in && lane == 0) {
        float* o = out + b * 6;
        o[0] = sum;
        o[1] = rfm;
        o[2] = wbuff;
        o[3] = outf;
        o[4] = outr;
        o[5] = wrr;
    }
}

}  // namespace

// frame: [G][B] uint8; io: [G][B] float32 (io_is_int 0) or int32 (1);
// tab: [9][G] float32; out must hold [6][B] float32
extern "C" int score_batch_launch(const void* frame, const void* io,
                                  int io_is_int, const void* tab, void* out,
                                  long long B, int G, float bpc, float ovh,
                                  int device, void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + BLOCK - 1) / BLOCK;
    score_batch_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frame, io_is_int ? nullptr : (const float*)io,
        io_is_int ? (const int*)io : nullptr, (const float*)tab, (float*)out,
        B, G, bpc, ovh);
    return (int)cudaGetLastError();
}

// frame: (B, G) uint8 at element strides (fs_b, fs_g); io: (B, G) float32
// (io_is_int 0) or int32 (1) at (is_b, is_g); tab: [9][G] float32; out must
// hold [B][6] float32
extern "C" int score_batch_split_launch(const void* frame, long long fs_b,
                                        long long fs_g, const void* io,
                                        long long is_b, long long is_g,
                                        int io_is_int, const void* tab,
                                        void* out, long long B, int G,
                                        float bpc, float ovh, int device,
                                        void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + SPLIT_WARPS - 1) / SPLIT_WARPS;
    const cudaStream_t st = (cudaStream_t)stream;
    if (io_is_int)
        score_batch_split_kernel<int><<<(unsigned)blocks, SPLIT_THREADS, 0,
                                         st>>>(
            (const uint8_t*)frame, fs_b, fs_g, (const int*)io, is_b, is_g,
            (const float*)tab, (float*)out, B, G, bpc, ovh);
    else
        score_batch_split_kernel<float><<<(unsigned)blocks, SPLIT_THREADS, 0,
                                           st>>>(
            (const uint8_t*)frame, fs_b, fs_g, (const float*)io, is_b, is_g,
            (const float*)tab, (float*)out, B, G, bpc, ovh);
    return (int)cudaGetLastError();
}
