// Allocator replay for a batch of candidate policies (Algorithm 1 as a
// per-candidate state machine), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/alloc_scan.py::_alloc_kernel.  One
// thread replays one candidate: the loop over the G groups runs inside the
// kernel.  The order of effects inside a step is the contract (it is the
// order of core/allocator.py::alloc_step): row-branch boundary writes ->
// consume -> frame boundary reads -> output placement with the reuse-main
// rule -> release of dead operands after the output claim.  All quantities
// are int32: the Python wrapper refuses a graph whose byte totals could
// overflow it.
//
// What bounds it on the card: the function's own traffic is the frame bits
// in, io [n][B] and 7 stats out (about 5 n + 28 bytes a candidate), against
// about a hundred integer operations a step; at the int32 rate the
// operations are the larger time.
//
// Design: the state lives on chip.  A lane (a group's output, or the graph
// input) is live from its producer's step to its last reader, and few are
// live at once (2-7 on the zoo).  The host colours the live ranges with W
// slots (kernels/alloc_scan.py::lane_slots) and hands over, per step, the
// slot of every lane the step touches and the lanes whose range ends
// there.  Each candidate keeps rem / loc / bw / io of its W slots in shared
// memory, slot-major ([slot][thread]): the slot is a constant of the step,
// so a warp's 32 accesses are 32 neighbouring words, free of bank
// conflicts, and no thread reads another's column.  Global memory is
// touched at the function's own points only: the frame once a step (the
// next step's byte is loaded while this step runs), a lane's io when its
// range ends (lane-major, coalesced), the stats at the end.  The three
// buffer owners, the buffer maxima and the accumulators stay in registers.
// The step and slot tables are the same for every candidate: the block
// copies them into shared memory a window of up to 64 steps at a time, so
// no step waits on L2 for its constants (at a small batch, two warps an SM,
// that wait was the step's time).  Blocks are sized from B so that a small
// batch (resnet152: 8,748 candidates) still spreads over every SM.
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
// columns of one row of the per-group slot table: the slots of the step's
// own lane, main operand and shortcut, the own lane's initial packed state
// (below), then k producer slots and k producer write-buffer candidates,
// the number of lanes whose range ends at the step, E lanes and E slots
constexpr int L_OWN = 0, L_MAIN = 1, L_SC = 2, L_META0 = 3, L_GIN = 4;

constexpr int MAX_THREADS = 128;
constexpr int MIN_THREADS = 32;
constexpr int MAX_SLOTS = 128;   // kernels/alloc_scan.py: MAX_SLOTS
constexpr int MAX_FAN_IN = 64;   // kernels/alloc_scan.py: MAX_FAN_IN
constexpr int SLOT_BYTES = 8;    // a slot's packed state and io (int32)
constexpr int MAX_WINDOW = 64;   // steps of the tables in shared memory
constexpr size_t SMEM_BUDGET = 200 * 1024;

// a slot's packed state: rem << 8 | bw << 4 | loc (rem signed, loc < 16)
constexpr int M_REM = 256, M_BW = 16, M_LOC = 15;

__device__ __forceinline__ int first_free(bool f0, bool f1, bool f2) {
    return f0 ? 0 : (f1 ? 1 : (f2 ? 2 : -1));
}

// K: the fan-in width the loops over producers are unrolled to (k <= K)
template <int K>
__global__ void __launch_bounds__(MAX_THREADS)
alloc_scan_kernel(const uint8_t* __restrict__ frame,    // [n][B] 0/1
                  const int* __restrict__ steps,        // [n][8 + 2k]
                  const int* __restrict__ slots,        // [n][lw]
                  int* __restrict__ io,                 // [n][B] out
                  int* __restrict__ stats,              // [7][B] out
                  long long B, int n, int k, int lw, int input_slot,
                  int input_meta, int W, int window) {
    extern __shared__ __align__(16) int smem[];
    const int T = blockDim.x, tid = threadIdx.x;
    const int width = S_GIN + 2 * k;
    // the tables of `window` steps, then slot s of this candidate at
    // s * T + tid in each state array
    int* w_steps = smem;                        // [window][width]
    int* w_slots = w_steps + window * width;    // [window][lw]
    int* s_meta = w_slots + window * lw;        // [W][T]
    int* s_io = s_meta + W * T;                 // [W][T]

    const long long b = blockIdx.x * (long long)T + tid;
    // a thread past B only helps copy the tables (it meets the barriers)
    const bool active = b < B;
    const int ni = n;                // graph-input lane
    const int sink = n + 1;          // padded fan-in slots point here
    const int E = (lw - L_GIN - 2 * k - 1) / 2;

#define META(s) s_meta[(s) * T + tid]
#define IO(s) s_io[(s) * T + tid]

    if (active) {
        META(input_slot) = input_meta;
        IO(input_slot) = 0;
    }
    int live[NB] = {LIVE_EMPTY, LIVE_EMPTY, LIVE_EMPTY};
    int buff[NB] = {0, 0, 0};
    int side_buff = 0, wrf = 0, bfm = 0, feas = 1;
    const uint8_t* frame_b = frame + b;         // this candidate's column
    uint8_t fr_next = active ? *frame_b : 0;

    for (int g = 0; g < n; ++g) {
        const int wg = g % window;
        if (wg == 0) {               // the next window of the tables
            const int rows = min(window, n - g);
            __syncthreads();
            for (int i = tid; i < rows * width; i += T)
                w_steps[i] = __ldg(steps + (long long)g * width + i);
            for (int i = tid; i < rows * lw; i += T)
                w_slots[i] = __ldg(slots + (long long)g * lw + i);
            __syncthreads();
        }
        if (!active) continue;
        const uint8_t fr_byte = fr_next;
        frame_b += B;
        if (g + 1 < n) fr_next = *frame_b;
        const int* s = w_steps + wg * width;
        const int* gin = s + S_GIN;
        const int* gsz = s + S_GIN + k;
        const int* ls = w_slots + wg * lw;
        const int* gsl = ls + L_GIN;
        const int* gwrc = gsl + k;
        const int own = ls[L_OWN];
        const int outsz = s[S_OUTSZ];
        // the step's producers: lane, slot (sink: skipped below)
        int src[K], sj[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            src[j] = j < k ? gin[j] : sink;
            sj[j] = j < k ? gsl[j] : 0;
        }

        // lane g's range starts here: rem and loc from the table
        int own_meta = ls[L_META0];

        if (s[S_SIDE]) {
            // SE side path: side space whatever the mode, consume, release
            side_buff = max(side_buff, outsz);
            own_meta = (own_meta & ~M_LOC) | LOC_SIDE;
#pragma unroll
            for (int j = 0; j < K; ++j)
                if (src[j] != sink) META(sj[j]) -= M_REM;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                if (src[j] == sink || src[j] == ni) continue;
                const int m = META(sj[j]);
                if (m < M_REM) {                    // rem <= 0
                    const int sl = m & M_LOC;
#pragma unroll
                    for (int i = 0; i < NB; ++i)
                        if (sl == i && live[i] == src[j]) live[i] = LIVE_EMPTY;
                }
            }
            META(own) = own_meta;
            IO(own) = 0;
        } else {
            const bool fr = fr_byte != 0;
            const int main_g = s[S_MAIN];
            const int sc_g = s[S_SC];
            const int smain = ls[L_MAIN];

            // ---- frame pre-state: operand locations, DRAM reads, fetch slot
            const int mloc = META(smain) & M_LOC;
            const bool main_in_buf = mloc < NB;
            int read_bytes = 0;
            bool in_buf[NB] = {false, false, false};
            int meta[K];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                meta[j] = src[j] != sink ? META(sj[j]) : LOC_DRAM;
                if (src[j] == sink) continue;
                const int sl = meta[j] & M_LOC;
                if (sl == LOC_DRAM) read_bytes += gsz[j];
#pragma unroll
                for (int i = 0; i < NB; ++i) in_buf[i] |= (sl == i);
            }
            const int fetch_b = first_free(live[0] == LIVE_EMPTY,
                                           live[1] == LIVE_EMPTY,
                                           live[2] == LIVE_EMPTY);
            const bool need_fetch = !main_in_buf && fetch_b >= 0;
            const int insz = s[S_INSZ];
#pragma unroll
            for (int i = 0; i < NB; ++i) {
                const bool fetched = need_fetch && fetch_b == i;
                if (fr && ((main_in_buf && mloc == i) || fetched))
                    buff[i] = max(buff[i], insz);
                in_buf[i] |= fetched;
            }
            if (sc_g != sink) {
                const int sloc = META(ls[L_SC]) & M_LOC;
                const int scsz = s[S_SCSZ];
#pragma unroll
                for (int i = 0; i < NB; ++i)
                    if (fr && sloc == i) buff[i] = max(buff[i], scsz);
            }

            // ---- row branch: frame-produced operands cross the boundary;
            // then consume inputs (a lane listed twice is read again)
#pragma unroll
            for (int j = 0; j < K; ++j) {
                if (src[j] == sink) continue;
                int m = META(sj[j]);
                if (!fr && src[j] != ni && (m & M_LOC) < NB && !(m & M_BW)) {
                    const int sz = gsz[j];
                    m |= M_BW;
                    IO(sj[j]) += sz;
                    bfm += sz;
                    wrf = max(wrf, gwrc[j]);
                }
                META(sj[j]) = m - M_REM;
            }

            // ---- frame branch: boundary reads charged to this group
            int io_g = 0;                // lane g's io starts at 0 here
            if (fr) {
                io_g += read_bytes;
                bfm += read_bytes;
            }

            // ---- place this group's output
            const bool final_out = own_meta < M_REM && own_meta >= 0;
            bool bw_g = false;
            if (fr && final_out) {
                bw_g = true;
                own_meta |= M_BW;
                io_g += outsz;
                bfm += outsz;
                wrf = max(wrf, s[S_WRC]);
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
            if (b_out < 0 && main_in_buf && main_live) {
                const int mm = META(smain);
                if (mm >= 0 && mm < M_REM) b_out = mloc;    // rem == 0
            }
            const bool alloc_out = fr && !final_out && b_out >= 0;
            const bool spill = fr && !final_out && b_out < 0;
            if (spill && !bw_g) {
                io_g += outsz;
                bfm += outsz;
            }
            if (spill && !s[S_SOK]) feas = 0;
#pragma unroll
            for (int i = 0; i < NB; ++i) {
                if (alloc_out && b_out == i) {
                    live[i] = g;
                    buff[i] = max(buff[i], outsz);
                }
            }
            META(own) = (own_meta & ~M_LOC) | (alloc_out ? b_out : LOC_DRAM);
            IO(own) = io_g;

            // ---- release dead operands (after the output claim)
#pragma unroll
            for (int j = 0; j < K; ++j) {
                if (src[j] == sink || src[j] == ni) continue;
                const int m = META(sj[j]);
                if (m < M_REM) {                    // rem <= 0
                    const int sl = m & M_LOC;
#pragma unroll
                    for (int i = 0; i < NB; ++i)
                        if (sl == i && live[i] == src[j]) live[i] = LIVE_EMPTY;
                }
            }
        }

        // ---- lanes whose range ends at this step: their io is final
        const int* ends = ls + L_GIN + 2 * k;
        const int n_end = ends[0];
        for (int e = 0; e < n_end; ++e)
            io[(long long)ends[1 + e] * B + b] = IO(ends[1 + E + e]);
    }
#undef META
#undef IO

    if (!active) return;
    stats[0 * B + b] = buff[0];
    stats[1 * B + b] = buff[1];
    stats[2 * B + b] = buff[2];
    stats[3 * B + b] = side_buff;
    stats[4 * B + b] = wrf;
    stats[5 * B + b] = bfm;
    stats[6 * B + b] = feas;
}

template <int K>
int launch(const void* frame, const void* steps, const void* slots,
           void* io, void* stats, long long B, int n, int k, int lw,
           int input_slot, int input_meta, int W, int device,
           cudaStream_t stream) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    // the widest block that still gives every SM two blocks
    int threads = MAX_THREADS;
    while (threads > MIN_THREADS
           && (B + threads - 1) / threads < 2LL * sms)
        threads /= 2;
    // the widest window of table rows that fits beside the slots
    const size_t slot_bytes = (size_t)SLOT_BYTES * W * threads;
    const size_t row_bytes = sizeof(int) * (size_t)(S_GIN + 2 * k + lw);
    int window = n < MAX_WINDOW ? n : MAX_WINDOW;
    while (window > 1 && slot_bytes + row_bytes * window > SMEM_BUDGET)
        window /= 2;
    const size_t smem = row_bytes * window + slot_bytes;
    if (smem > SMEM_BUDGET) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(alloc_scan_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + threads - 1) / threads;
    alloc_scan_kernel<K><<<(unsigned)blocks, threads, smem, stream>>>(
        (const uint8_t*)frame, (const int*)steps, (const int*)slots,
        (int*)io, (int*)stats, B, n, k, lw, input_slot, input_meta, W,
        window);
    return (int)cudaGetLastError();
}

}  // namespace

// frame [n][B] uint8; steps [n][8 + 2k] and slots [n][lw] int32
// (kernels/alloc_scan.py packs them); io [n][B] and stats [7][B] int32
// out.  W slots (1..128), the graph input's in input_slot with its packed
// state input_meta; k <= 64.
extern "C" int alloc_scan_launch(const void* frame, const void* steps,
                                 const void* slots, void* io, void* stats,
                                 long long B, int n, int k, int lw,
                                 int input_slot, int input_meta, int W,
                                 int device, void* stream) {
    if (B <= 0 || n <= 0) return 0;
    if (W <= 0 || W > MAX_SLOTS || input_slot < 0 || input_slot >= W
            || k <= 0 || k > MAX_FAN_IN || lw < L_GIN + 2 * k + 3)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(K_)                                                          \
    return launch<K_>(frame, steps, slots, io, stats, B, n, k, lw,          \
                      input_slot, input_meta, W, device, s)
    if (k <= 1) LAUNCH(1);
    if (k <= 2) LAUNCH(2);
    if (k <= 4) LAUNCH(4);
    if (k <= 8) LAUNCH(8);
    if (k <= 16) LAUNCH(16);
    if (k <= 32) LAUNCH(32);
    LAUNCH(64);
#undef LAUNCH
}
