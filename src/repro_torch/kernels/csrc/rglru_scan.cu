// RG-LRU linear recurrence, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::_kernel: for a, b
// [B, S, W] float32 it computes h [B, S, W] with
//
//     h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0
//
// (a caller with an initial state folds a_0 * h0 into b_0 first, as
// models/rglru.py does).  The TPU kernel runs a log-depth doubling scan
// within chunks of the sequence and carries h across chunks in VMEM; here
// one lane owns one (batch, channel) and runs the recurrence in order, so
// the result is the plain sequential one: a product and a sum, each rounded
// (__fmul_rn, __fadd_rn, no fused multiply-add), equal bit for bit to the
// plain torch loop `h = a[:, t] * h + b[:, t]`.
//
// What bounds it on the card: the bytes, 12 per element (a and b read, h
// written; 189 MB at B = 2, S = 3,072, W = 2,560).  B * W chains (5,120 at
// recurrentgemma-2b) are all the parallelism there is, so the card reaches
// its memory rate only if each chain keeps many loads in flight while its
// dependent chain runs.  The design:
//
// * a block is one warp and owns a group of CPW = 16 neighbouring channels
//   of one batch row: a step is one 64-byte half line of each array, and
//   the 320 groups at recurrentgemma-2b spread 2-3 to every SM (8 and 32
//   channels a warp measured slower);
// * all 32 lanes fill a ring of STAGES stages x STEPS steps of a and b in
//   shared memory with cp.async (16-byte copies when W is a multiple of 4
//   and the rows are aligned, else 4-byte copies), STAGES - 1 stages ahead
//   of the chain: 112 steps, 14 KB a warp at CPW = 16, ~4.6 MB on the card;
// * the first CPW lanes run the chains from the ring and store h.
//
// A ragged last stage (S not a multiple of STEPS), a ragged channel group
// (W not a multiple of CPW) and S shorter than the ring are masked: a copy
// past the end reads nothing and fills zeros, and no chain step or store
// runs there.
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing and does not synchronise.
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int LANES = 32;              // one warp per block
constexpr int CPW = 16;                // channels a warp
constexpr int STEPS = 16;              // steps a stage
constexpr int STAGES = 8;              // stages in the ring

// Copy stage `t0 / STEPS` of a and b (steps t0 .. t0 + STEPS - 1, channels
// c0 .. c0 + CPW - 1) into `slot`: [2][STEPS][CPW] floats, VEC floats a copy.
template <int VEC>
__device__ __forceinline__ void issue_stage(
        float* slot, const float* a, const float* b, int t0, int S, int c0,
        int W, int lane) {
    constexpr int PER_ROW = CPW / VEC;     // copies a step of one array
    constexpr int PER_ARRAY = STEPS * PER_ROW;
    static_assert((2 * PER_ARRAY) % LANES == 0, "whole copies a lane");
#pragma unroll
    for (int j = 0; j < 2 * PER_ARRAY / LANES; ++j) {
        const int k = j * LANES + lane;
        const int arr = k / PER_ARRAY;
        const int step = (k % PER_ARRAY) / PER_ROW;
        const int ch = (k % PER_ROW) * VEC;
        const bool valid = t0 + step < S && c0 + ch < W;
        const float* src = arr ? b : a;
        // a masked copy reads nothing, but its address must be valid
        const float* from =
            valid ? src + (long long)(t0 + step) * W + c0 + ch : src;
        float* to = slot + (arr * STEPS + step) * CPW + ch;
        if (VEC == 4)
            tc::cp_async16(to, from, valid);
        else
            tc::cp_async4(to, from, valid);
    }
}

template <int VEC>
__global__ void __launch_bounds__(LANES) rglru_scan_kernel(
        const float* __restrict__ a, const float* __restrict__ b,
        float* __restrict__ h, int S, int W, int groups_per_row) {
    __shared__ __align__(16) float ring[STAGES][2][STEPS][CPW];
    const int lane = threadIdx.x;
    const long long bi = blockIdx.x / groups_per_row;
    const int c0 = (blockIdx.x % groups_per_row) * CPW;
    const long long row = bi * S * (long long)W;
    const float* ap = a + row;
    const float* bp = b + row;
    const int nstages = (S + STEPS - 1) / STEPS;
    // the chain lane's channel; lanes past the group or past W only copy
    const bool chain = lane < CPW && c0 + lane < W;
    float* hp = h + row + c0 + lane;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nstages)
            issue_stage<VEC>(&ring[s][0][0][0], ap, bp, s * STEPS, S,
                                  c0, W, lane);
        tc::cp_async_commit();          // empty groups keep the count even
    }
    float hv = 0.f;
    for (int i = 0; i < nstages; ++i) {
        // stage i + STAGES - 1 goes into the slot stage i - 1 left
        const int ahead = i + STAGES - 1;
        if (ahead < nstages)
            issue_stage<VEC>(&ring[ahead % STAGES][0][0][0], ap, bp,
                                  ahead * STEPS, S, c0, W, lane);
        tc::cp_async_commit();
        tc::cp_async_wait<STAGES - 1>();   // this lane's copies of stage i
        __syncwarp();                       // ... and every other lane's
        const float(*as)[CPW] = ring[i % STAGES][0];
        const float(*bs)[CPW] = ring[i % STAGES][1];
        const int t0 = i * STEPS;
        if (chain) {
            if (t0 + STEPS <= S) {
#pragma unroll
                for (int s = 0; s < STEPS; ++s) {
                    hv = __fadd_rn(__fmul_rn(as[s][lane], hv), bs[s][lane]);
                    hp[(long long)(t0 + s) * W] = hv;
                }
            } else {
                for (int s = 0; t0 + s < S; ++s) {
                    hv = __fadd_rn(__fmul_rn(as[s][lane], hv), bs[s][lane]);
                    hp[(long long)(t0 + s) * W] = hv;
                }
            }
        }
        __syncwarp();                       // slot i % STAGES is free again
    }
}

}  // namespace

// a, b, h: [B, S, W] float32, contiguous.  vec: floats a copy (4 needs
// W % 4 == 0 and 16-byte aligned a and b; else 1), as
// kernels/rglru_scan.py::rglru_scan_plan picks it.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h,
                                 int B, int S, int W, int vec, int device,
                                 void* stream) {
    if (B <= 0 || S <= 0 || W <= 0) return 0;
    if (vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int groups_per_row = (W + CPW - 1) / CPW;
    const long long blocks = (long long)B * groups_per_row;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const float* af = (const float*)a;
    const float* bf = (const float*)b;
    float* hf = (float*)h;
    cudaStream_t st = (cudaStream_t)stream;
    if (vec == 4)
        rglru_scan_kernel<4><<<(unsigned)blocks, LANES, 0, st>>>(
            af, bf, hf, S, W, groups_per_row);
    else
        rglru_scan_kernel<1><<<(unsigned)blocks, LANES, 0, st>>>(
            af, bf, hf, S, W, groups_per_row);
    return (int)cudaGetLastError();
}
