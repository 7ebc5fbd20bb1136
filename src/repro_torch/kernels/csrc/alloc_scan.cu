// Allocator replay for a batch of candidate policies (Algorithm 1 as a
// per-candidate state machine), CUDA C++ for sm_90a.
//
// One thread replays one candidate: the loop over the G groups runs inside
// the kernel.  Every lane index the update rule touches at step g (g itself,
// the fan-in producers, the main-path producer, the shortcut source) is a
// per-group constant shared by all candidates, so the per-gid state rows
// (rem / loc / bw / io) are stored lane-major, [n + 2][B]: the 32 candidates
// of a warp read and write 32 neighbouring addresses -- indexed loads,
// coalesced.  The three buffer owners, the buffer maxima and the
// accumulators stay in registers; the per-group step table is read through
// the read-only path.  All quantities are int32: the Python wrapper refuses a
// graph whose byte totals could overflow it.
//
// The order of effects inside a step is the contract (it is the order of
// core/allocator.py::alloc_step): row-branch boundary writes -> consume ->
// frame boundary reads -> output placement with the reuse-main rule ->
// release of dead operands after the output claim.
//
// Plain C interface; the launch goes to the stream it is given, allocates
// nothing and does not synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NB = 3;            // physical buffers
constexpr int LOC_SIDE = 3;      // location codes beyond the buffer ids
constexpr int LOC_DRAM = 4;
constexpr int LIVE_EMPTY = -1;

// columns of one row of the per-group step table, then k producer lanes and
// k producer sizes
constexpr int S_SIDE = 0, S_MAIN = 1, S_SC = 2, S_SCSZ = 3, S_INSZ = 4,
              S_OUTSZ = 5, S_WRC = 6, S_SOK = 7, S_GIN = 8;

constexpr int THREADS = 128;

__device__ __forceinline__ int first_free(bool f0, bool f1, bool f2) {
    return f0 ? 0 : (f1 ? 1 : (f2 ? 2 : -1));
}

__global__ void __launch_bounds__(THREADS)
alloc_scan_kernel(const uint8_t* __restrict__ frame,    // [n][B] 0/1
                  const int* __restrict__ steps,        // [n][8 + 2k]
                  const int* __restrict__ wr_cand,      // [n + 2]
                  const int* __restrict__ rem0,         // [n + 2]
                  const int8_t* __restrict__ loc0,      // [n + 2]
                  int* __restrict__ rem,                // [n + 2][B] scratch
                  int8_t* __restrict__ loc,             // [n + 2][B] scratch
                  uint8_t* __restrict__ bw,             // [n + 2][B] scratch
                  int* __restrict__ io,                 // [n + 2][B] out
                  int* __restrict__ stats,              // [7][B] out
                  long long B, int n, int k) {
    const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int ni = n;            // graph-input lane
    const int sink = n + 1;      // padded fan-in slots point here
    const int width = S_GIN + 2 * k;

    for (int l = 0; l < n + 2; ++l) {
        rem[l * B + b] = __ldg(rem0 + l);
        loc[l * B + b] = __ldg(loc0 + l);
        bw[l * B + b] = 0;
        io[l * B + b] = 0;
    }
    int live[NB] = {LIVE_EMPTY, LIVE_EMPTY, LIVE_EMPTY};
    int buff[NB] = {0, 0, 0};
    int side_buff = 0, wrf = 0, bfm = 0, feas = 1;

    for (int g = 0; g < n; ++g) {
        const int* s = steps + (long long)g * width;
        const int* gin = s + S_GIN;
        const int* gsz = s + S_GIN + k;
        const int outsz = __ldg(s + S_OUTSZ);

        if (__ldg(s + S_SIDE)) {
            // SE side path: side space whatever the mode, consume, release
            side_buff = max(side_buff, outsz);
            loc[g * B + b] = LOC_SIDE;
            for (int j = 0; j < k; ++j) {
                const int src = __ldg(gin + j);
                if (src == sink) continue;
                rem[src * B + b] -= 1;
            }
            for (int j = 0; j < k; ++j) {
                const int src = __ldg(gin + j);
                if (src == sink || src == ni) continue;
                if (rem[src * B + b] <= 0) {
                    const int sl = loc[src * B + b];
#pragma unroll
                    for (int i = 0; i < NB; ++i)
                        if (sl == i && live[i] == src) live[i] = LIVE_EMPTY;
                }
            }
            continue;
        }

        const bool fr = frame[g * B + b] != 0;
        const int main_g = __ldg(s + S_MAIN);
        const int sc_g = __ldg(s + S_SC);

        // ---- frame pre-state: operand locations, DRAM reads, fetch slot
        const int mloc = loc[main_g * B + b];
        const bool main_in_buf = mloc < NB;
        int read_bytes = 0;
        bool in_buf[NB] = {false, false, false};
        for (int j = 0; j < k; ++j) {
            const int src = __ldg(gin + j);
            if (src == sink) continue;
            const int sl = loc[src * B + b];
            if (sl == LOC_DRAM) read_bytes += __ldg(gsz + j);
#pragma unroll
            for (int i = 0; i < NB; ++i) in_buf[i] |= (sl == i);
        }
        const int fetch_b = first_free(live[0] == LIVE_EMPTY,
                                       live[1] == LIVE_EMPTY,
                                       live[2] == LIVE_EMPTY);
        const bool need_fetch = !main_in_buf && fetch_b >= 0;
        const int insz = __ldg(s + S_INSZ);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
            const bool fetched = need_fetch && fetch_b == i;
            if (fr && ((main_in_buf && mloc == i) || fetched))
                buff[i] = max(buff[i], insz);
            in_buf[i] |= fetched;
        }
        if (sc_g != sink) {
            const int sloc = loc[sc_g * B + b];
            const int scsz = __ldg(s + S_SCSZ);
#pragma unroll
            for (int i = 0; i < NB; ++i)
                if (fr && sloc == i) buff[i] = max(buff[i], scsz);
        }

        // ---- row branch: frame-produced operands cross the boundary
        if (!fr) {
            for (int j = 0; j < k; ++j) {
                const int src = __ldg(gin + j);
                if (src == sink || src == ni) continue;
                if (loc[src * B + b] < NB && !bw[src * B + b]) {
                    const int sz = __ldg(gsz + j);
                    bw[src * B + b] = 1;
                    io[src * B + b] += sz;
                    bfm += sz;
                    wrf = max(wrf, __ldg(wr_cand + src));
                }
            }
        }

        // ---- consume inputs
        for (int j = 0; j < k; ++j) {
            const int src = __ldg(gin + j);
            if (src == sink) continue;
            rem[src * B + b] -= 1;
        }

        // ---- frame branch: boundary reads charged to this group
        int io_g = io[g * B + b];
        if (fr) {
            io_g += read_bytes;
            bfm += read_bytes;
        }

        // ---- place this group's output
        const bool final_out = rem[g * B + b] == 0;
        bool bw_g = bw[g * B + b] != 0;
        if (fr && final_out && !bw_g) {
            bw_g = true;
            bw[g * B + b] = 1;
            io_g += outsz;
            bfm += outsz;
            wrf = max(wrf, __ldg(s + S_WRC));
        }
        int b_out = first_free(live[0] == LIVE_EMPTY && !in_buf[0],
                               live[1] == LIVE_EMPTY && !in_buf[1],
                               live[2] == LIVE_EMPTY && !in_buf[2]);
        bool main_live = false;
#pragma unroll
        for (int i = 0; i < NB; ++i)
            main_live |= (mloc == i && live[i] == main_g);
        // no free buffer: take over the main operand's if this group is
        // its last consumer
        if (b_out < 0 && main_in_buf && rem[main_g * B + b] == 0 && main_live)
            b_out = mloc;
        const bool alloc_out = fr && !final_out && b_out >= 0;
        const bool spill = fr && !final_out && b_out < 0;
        if (spill && !bw_g) {
            io_g += outsz;
            bfm += outsz;
        }
        if (spill && !__ldg(s + S_SOK)) feas = 0;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
            if (alloc_out && b_out == i) {
                live[i] = g;
                buff[i] = max(buff[i], outsz);
            }
        }
        loc[g * B + b] = alloc_out ? (int8_t)b_out : (int8_t)LOC_DRAM;
        io[g * B + b] = io_g;

        // ---- release dead operands (after the output claim)
        for (int j = 0; j < k; ++j) {
            const int src = __ldg(gin + j);
            if (src == sink || src == ni) continue;
            if (rem[src * B + b] <= 0) {
                const int sl = loc[src * B + b];
#pragma unroll
                for (int i = 0; i < NB; ++i)
                    if (sl == i && live[i] == src) live[i] = LIVE_EMPTY;
            }
        }
    }

    stats[0 * B + b] = buff[0];
    stats[1 * B + b] = buff[1];
    stats[2 * B + b] = buff[2];
    stats[3 * B + b] = side_buff;
    stats[4 * B + b] = wrf;
    stats[5 * B + b] = bfm;
    stats[6 * B + b] = feas;
}

}  // namespace

extern "C" int alloc_scan_launch(const void* frame, const void* steps,
                                 const void* wr_cand, const void* rem0,
                                 const void* loc0, void* rem, void* loc,
                                 void* bw, void* io, void* stats,
                                 long long B, int n, int k, int device,
                                 void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + THREADS - 1) / THREADS;
    alloc_scan_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frame, (const int*)steps, (const int*)wr_cand,
        (const int*)rem0, (const int8_t*)loc0, (int*)rem, (int8_t*)loc,
        (uint8_t*)bw, (int*)io, (int*)stats, B, n, k);
    return (int)cudaGetLastError();
}
