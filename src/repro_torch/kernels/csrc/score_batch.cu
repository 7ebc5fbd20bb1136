// The staged float32 scorer of the cut search, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/score_batch.py::_score_kernel.  Per
// candidate it reduces the B x G frame-mask and boundary-I/O matrices against
// the nine per-group cost tables into six float32 numbers: the latency sum,
// the row-mode DRAM feature-map sum and four SRAM maxima (see
// score_batch.py).  One thread owns one candidate and walks the groups in gid
// order; the six accumulators live in registers.
//
// THIS FILE MUST BE COMPILED WITH -fmad=false AND WITHOUT --use_fast_math.
// The plain torch version in score_batch.py does the same float32 operations
// in the same order (a left-to-right sum in gid order, an IEEE division), and
// the two are held equal bit for bit; the explicit _rn intrinsics below say
// so in the source as well.
//
// Layout: frame and io are lane-major ([G][B]: one row per group), the layout
// the allocator kernel writes its io matrix in, so a warp's 32 candidates
// touch 32 neighbouring addresses; the tables are (9, G) float32 rows, read
// at the same address by the whole warp; the output is lane-major [6][B].
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing and does not synchronise.
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
