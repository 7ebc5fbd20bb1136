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
// one thread owns one (batch, channel) and runs the recurrence in order, so
// the result is the plain sequential one: a product and a sum, each rounded
// (__fmul_rn, __fadd_rn, no fused multiply-add), equal bit for bit to the
// plain torch loop `h = a[:, t] * h + b[:, t]`.
//
// What bounds it on the card: the bytes, 12 per element (a and b read, h
// written; 189 MB at B = 2, S = 3,072, W = 2,560).  A warp's 32 threads
// own 32 neighbouring channels, so every load and store is one 128-byte
// line; the loads of U steps are issued before the dependent chain that
// consumes them, so a thread has 2 * U loads in flight.  B * W threads
// (5,120 at recurrentgemma-2b) are all the parallelism there is: blocks of
// one warp spread them over as many SMs as possible.
//
// Plain C interface; every launch goes to the stream it is given, allocates
// nothing and does not synchronise.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 32;                 // one warp per block
constexpr int U = 16;                  // steps loaded ahead

__global__ void __launch_bounds__(NT) rglru_scan_kernel(
        const float* __restrict__ a, const float* __restrict__ b,
        float* __restrict__ h, int S, int W, long long BW) {
    const long long i = (long long)blockIdx.x * NT + threadIdx.x;
    if (i >= BW) return;
    const long long bi = i / W, w = i % W;
    const long long base = bi * S * (long long)W + w;
    const float* ap = a + base;
    const float* bp = b + base;
    float* hp = h + base;
    float hv = 0.f;
    int t = 0;
    for (; t + U <= S; t += U) {
        float av[U], bv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            av[u] = __ldg(ap + (long long)(t + u) * W);
            bv[u] = __ldg(bp + (long long)(t + u) * W);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
            hp[(long long)(t + u) * W] = hv;
        }
    }
    for (; t < S; ++t) {
        hv = __fadd_rn(__fmul_rn(__ldg(ap + (long long)t * W), hv),
                       __ldg(bp + (long long)t * W));
        hp[(long long)t * W] = hv;
    }
}

}  // namespace

// a, b, h: [B, S, W] float32, contiguous
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h,
                                 int B, int S, int W, int device,
                                 void* stream) {
    if (B <= 0 || S <= 0 || W <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long bw = (long long)B * W;
    const long long blocks = (bw + NT - 1) / NT;
    rglru_scan_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)h, S, W, bw);
    return (int)cudaGetLastError();
}
