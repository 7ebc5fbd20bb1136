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
// The shared prefix.  The state entering group g depends only on the frame
// bits of groups 0 .. g-1, and the fused search hands this kernel chunks of
// consecutive candidates of a mixed-radix space (last run fastest).  The
// candidates of an aligned block of D consecutive indices share their
// leading runs' digits, and so their leading groups' frame bits: the
// block's g, the first group of the first run whose digit is not the same
// over the block.  alloc_prefix_kernel, one thread a block and one launch a
// sub-space, computes each block's g from the sub-space's digit table,
// replays groups 0 .. g-1 for the block's first candidate (its frame bits
// decoded with the enumeration kernel's three gathers) and writes the state
// entering g into the block's state row.  The host picks D
// (kernels/search_pipeline.py::row_grain), a run's block: the stride of the
// run before it, which divides the sub-space, so every row starts at that
// run's first group, 52 of mobilenet-v3's 72 groups at D 108.  Given the
// rows, thread b of the chunk at lo starts from row (lo + b) / D: it copies
// the row's slots and registers, stores the final io of every lane whose
// range ended before the row's g, and runs groups g .. n-1.  A block of
// threads walks the table windows from the least g of its rows, each thread
// stepping from its own (at the host's grain all the same), so any rows
// give the integers of the whole replay.  Without rows it starts from the
// initial state at group 0.  Both kernels run the same step (alloc_step),
// so the integers are those of the whole replay.  The rows are stored
// field-major, [R][rows]: the prefix kernel's warp writes one field of 32
// neighbouring rows as one store, and a block of the replay copies the one
// or few rows its candidates read into shared memory in a few coalesced
// loads a thread, where neighbouring threads then read one row (on an
// H100, row-major rows cost the prefix kernel 4x, each of a warp's stores
// touching 32 lines; field-major rows read straight from global memory
// cost the replay ~20 %, a line a field of its row).  A launch whose
// block's rows do not fit in shared memory beside one row of the tables
// is refused.
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
// fields of a block's state row (kernels/alloc_scan.py: ROW_FIXED): g0, the
// three buffer owners, the three buffer maxima, the side maximum, wrf, bfm,
// feas and the number m of lanes whose range ended before g0; then the W
// slots' packed state, their io, and n entries each for those m lanes and
// their final io
constexpr int R_G0 = 0, R_LIVE = 1, R_BUFF = R_LIVE + NB,
              R_SIDE = R_BUFF + NB, R_WRF = R_SIDE + 1, R_BFM = R_WRF + 1,
              R_FEAS = R_BFM + 1, R_ENDED = R_FEAS + 1, R_SLOTS = R_ENDED + 1;

constexpr int MAX_THREADS = 128;
constexpr int MIN_THREADS = 32;
constexpr int PREFIX_THREADS = 64;   // rows a block of the prefix kernel
constexpr int MAX_SLOTS = 128;   // kernels/alloc_scan.py: MAX_SLOTS
constexpr int MAX_FAN_IN = 64;   // kernels/alloc_scan.py: MAX_FAN_IN
constexpr int SLOT_BYTES = 8;    // a slot's packed state and io (int32)
constexpr int MAX_WINDOW = 64;   // steps of the tables in shared memory
constexpr size_t SMEM_BUDGET = 200 * 1024;

// a slot's packed state: rem << 8 | bw << 4 | loc (rem signed, loc < 16)
constexpr int M_REM = 256, M_BW = 16, M_LOC = 15;

// A candidate's state beside its W slots, in registers.
struct Replay {
    int live[NB];                // owning lane of each buffer
    int buff[NB];                // buffer maxima
    int side_buff, wrf, bfm, feas;
};

__device__ __forceinline__ Replay initial_state() {
    return Replay{{LIVE_EMPTY, LIVE_EMPTY, LIVE_EMPTY}, {0, 0, 0}, 0, 0, 0,
                  1};
}

__device__ __forceinline__ int first_free(bool f0, bool f1, bool f2) {
    return f0 ? 0 : (f1 ? 1 : (f2 ? 2 : -1));
}

// One step of the replay: group g with frame bit fr, its rows s of the step
// table and ls of the slot table, for the candidate whose slot x lies at
// sm[x * T] (packed state) and sio[x * T] (io) and whose other state is st.
// K: the fan-in width the loops over producers are unrolled to (k <= K).
template <int K>
__device__ __forceinline__ void alloc_step(int g, bool fr, const int* s,
                                           const int* ls, int k, int ni,
                                           int sink, int* sm, int* sio,
                                           int T, Replay& st) {
#define META(x) sm[(x) * T]
#define IO(x) sio[(x) * T]
    const int* gin = s + S_GIN;
    const int* gsz = s + S_GIN + k;
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
        st.side_buff = max(st.side_buff, outsz);
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
                    if (sl == i && st.live[i] == src[j])
                        st.live[i] = LIVE_EMPTY;
            }
        }
        META(own) = own_meta;
        IO(own) = 0;
    } else {
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
        const int fetch_b = first_free(st.live[0] == LIVE_EMPTY,
                                       st.live[1] == LIVE_EMPTY,
                                       st.live[2] == LIVE_EMPTY);
        const bool need_fetch = !main_in_buf && fetch_b >= 0;
        const int insz = s[S_INSZ];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
            const bool fetched = need_fetch && fetch_b == i;
            if (fr && ((main_in_buf && mloc == i) || fetched))
                st.buff[i] = max(st.buff[i], insz);
            in_buf[i] |= fetched;
        }
        if (sc_g != sink) {
            const int sloc = META(ls[L_SC]) & M_LOC;
            const int scsz = s[S_SCSZ];
#pragma unroll
            for (int i = 0; i < NB; ++i)
                if (fr && sloc == i) st.buff[i] = max(st.buff[i], scsz);
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
                st.bfm += sz;
                st.wrf = max(st.wrf, gwrc[j]);
            }
            META(sj[j]) = m - M_REM;
        }

        // ---- frame branch: boundary reads charged to this group
        int io_g = 0;                // lane g's io starts at 0 here
        if (fr) {
            io_g += read_bytes;
            st.bfm += read_bytes;
        }

        // ---- place this group's output
        const bool final_out = own_meta < M_REM && own_meta >= 0;
        bool bw_g = false;
        if (fr && final_out) {
            bw_g = true;
            own_meta |= M_BW;
            io_g += outsz;
            st.bfm += outsz;
            st.wrf = max(st.wrf, s[S_WRC]);
        }
        int b_out = first_free(st.live[0] == LIVE_EMPTY && !in_buf[0],
                               st.live[1] == LIVE_EMPTY && !in_buf[1],
                               st.live[2] == LIVE_EMPTY && !in_buf[2]);
        bool main_live = false;
#pragma unroll
        for (int i = 0; i < NB; ++i)
            main_live |= (mloc == i && st.live[i] == main_g);
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
            st.bfm += outsz;
        }
        if (spill && !s[S_SOK]) st.feas = 0;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
            if (alloc_out && b_out == i) {
                st.live[i] = g;
                st.buff[i] = max(st.buff[i], outsz);
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
                    if (sl == i && st.live[i] == src[j])
                        st.live[i] = LIVE_EMPTY;
            }
        }
    }

#undef META
#undef IO
}

// Rows [g, g + rows) of the step and slot tables into shared memory; every
// thread of the block takes part.
__device__ __forceinline__ void load_window(int* w_steps, int* w_slots,
                                            const int* steps,
                                            const int* slots, int g,
                                            int rows, int width, int lw) {
    const int T = blockDim.x, tid = threadIdx.x;
    __syncthreads();
    for (int i = tid; i < rows * width; i += T)
        w_steps[i] = __ldg(steps + (long long)g * width + i);
    for (int i = tid; i < rows * lw; i += T)
        w_slots[i] = __ldg(slots + (long long)g * lw + i);
    __syncthreads();
}

// ROWS: the candidates start from state rows (rows not null); the replay
// without them is compiled on its own, free of the rows' code
template <int K, bool ROWS>
__global__ void __launch_bounds__(MAX_THREADS)
alloc_scan_kernel(const uint8_t* __restrict__ frame,    // [n][B] 0/1
                  const int* __restrict__ steps,        // [n][8 + 2k]
                  const int* __restrict__ slots,        // [n][lw]
                  const int* __restrict__ rows,         // [R][nrows], or null
                  long long nrows, long long lo, long long D,
                  int* __restrict__ io,                 // [n][B] out
                  int* __restrict__ stats,              // [7][B] out
                  long long B, int n, int k, int lw, int input_slot,
                  int input_meta, int W, int window) {
    extern __shared__ __align__(16) int smem[];
    const int T = blockDim.x, tid = threadIdx.x;
    const int width = S_GIN + 2 * k;
    // the tables of `window` steps, then slot s of this candidate at
    // s * T + tid in each state array, then the block's state rows
    int* w_steps = smem;                        // [window][width]
    int* w_slots = w_steps + window * width;    // [window][lw]
    int* sm = w_slots + window * lw + tid;      // [W][T]
    int* sio = sm + W * T;                      // [W][T]

    const long long b = blockIdx.x * (long long)T + tid;
    // a thread past B only helps copy the tables (it meets the barriers)
    const bool active = b < B;
    const int ni = n;                // graph-input lane
    const int sink = n + 1;          // padded fan-in slots point here
    const int E = (lw - L_GIN - 2 * k - 1) / 2;

    Replay st = initial_state();
    // the group this thread's replay starts at (n: it replays none), and
    // the block's first, from which the block walks the table windows
    int start = active ? 0 : n, g0 = 0;
    if constexpr (ROWS) {
        // the rows of this block's candidates, [lo + b_first, lo + b_last],
        // copied field by field into shared memory by the whole block: each
        // field of neighbouring rows is contiguous, so the copy is a few
        // coalesced loads a thread, all in flight at once
        const long long first = lo + blockIdx.x * (long long)T;
        const long long r0 = first / D;
        const long long last = lo + (B < blockIdx.x * (long long)T + T
                                     ? B : blockIdx.x * (long long)T + T) - 1;
        const int nr = (int)(last / D - r0) + 1;
        const int R = R_SLOTS + 2 * W + 2 * n;
        int* srows = w_slots + window * lw + 2 * W * T;     // [R][nr]
        for (int i = tid; i < R * nr; i += T)
            srows[i] = __ldg(rows + (long long)(i / nr) * nrows + r0 + i % nr);
        __syncthreads();
        g0 = n;
        for (int r = 0; r < nr; ++r) g0 = min(g0, srows[R_G0 * nr + r]);
        if (active) {
            // the state entering its g of this candidate's block of D
            const int* row = srows + (int)((lo + b) / D - r0);
#define ROW(f) row[(f) * nr]
            start = ROW(R_G0);
#pragma unroll
            for (int i = 0; i < NB; ++i) {
                st.live[i] = ROW(R_LIVE + i);
                st.buff[i] = ROW(R_BUFF + i);
            }
            st.side_buff = ROW(R_SIDE);
            st.wrf = ROW(R_WRF);
            st.bfm = ROW(R_BFM);
            st.feas = ROW(R_FEAS);
            for (int x = 0; x < W; ++x) {
                sm[x * T] = ROW(R_SLOTS + x);
                sio[x * T] = ROW(R_SLOTS + W + x);
            }
            // the lanes whose range ended before start: their io is final
            const int ended = R_SLOTS + 2 * W;
            const int m = ROW(R_ENDED);
            for (int e = 0; e < m; ++e)
                io[(long long)ROW(ended + e) * B + b] = ROW(ended + n + e);
#undef ROW
        }
    } else if (active) {
        sm[input_slot * T] = input_meta;
        sio[input_slot * T] = 0;
    }
    const uint8_t* frame_b = frame + (long long)start * B + b;  // its column
    uint8_t fr_next = start < n ? *frame_b : 0;

    for (int g = g0, wg = 0; g < n; ++g, ++wg) {
        if (wg == window) wg = 0;
        if (wg == 0)                 // the next window of the tables
            load_window(w_steps, w_slots, steps, slots, g,
                        min(window, n - g), width, lw);
        if (g < start) continue;
        const uint8_t fr_byte = fr_next;
        frame_b += B;
        if (g + 1 < n) fr_next = *frame_b;
        const int* ls = w_slots + wg * lw;
        alloc_step<K>(g, fr_byte != 0, w_steps + wg * width, ls, k, ni, sink,
                      sm, sio, T, st);

        // ---- lanes whose range ends at this step: their io is final
        const int* ends = ls + L_GIN + 2 * k;
        const int n_end = ends[0];
        for (int e = 0; e < n_end; ++e)
            io[(long long)ends[1 + e] * B + b] = sio[ends[1 + E + e] * T];
    }

    if (!active) return;
    stats[0 * B + b] = st.buff[0];
    stats[1 * B + b] = st.buff[1];
    stats[2 * B + b] = st.buff[2];
    stats[3 * B + b] = st.side_buff;
    stats[4 * B + b] = st.wrf;
    stats[5 * B + b] = st.bfm;
    stats[6 * B + b] = st.feas;
}

// The shared prefix of every block of a sub-space of S candidates, blocks
// of D: one thread a block, block c holding the candidates [c D, min((c +
// 1) D, S)).  The block's g0 is the first group of the first free run (its
// stride not 0) in whose stride the block's first and last candidates
// differ: runs from there on vary inside the block, runs before it do not
// (a run's stride divides every earlier run's).  Groups 0 .. g0-1 are
// replayed for the block's first candidate into the block's state row,
// field f of row c at rows[f * nrows + c].
template <int K>
__global__ void __launch_bounds__(PREFIX_THREADS)
alloc_prefix_kernel(const long long* __restrict__ digits,  // [3][nr]
                    const int* __restrict__ run_of,        // [n]
                    const int* __restrict__ pos_of,        // [n]
                    const uint8_t* __restrict__ dir_neg,   // [n]
                    const int* __restrict__ steps,         // [n][8 + 2k]
                    const int* __restrict__ slots,         // [n][lw]
                    int* __restrict__ rows,                // [R][nrows] out
                    long long S, long long D, long long nrows, int n,
                    int nr, int k, int lw, int input_slot, int input_meta,
                    int W, int window) {
    extern __shared__ __align__(16) int smem[];
    __shared__ int g_block;          // the block's largest g0
    const int T = blockDim.x, tid = threadIdx.x;
    const int width = S_GIN + 2 * k;
    int* w_steps = smem;                        // [window][width]
    int* w_slots = w_steps + window * width;    // [window][lw]
    int* sm = w_slots + window * lw + tid;      // [W][T]
    int* sio = sm + W * T;                      // [W][T]

    const long long c = blockIdx.x * (long long)T + tid;
    const bool active = c < nrows;
    const int ni = n, sink = n + 1;
    const int E = (lw - L_GIN - 2 * k - 1) / 2;
    const long long lo = c * D;
    const long long last = (S - lo < D ? S : lo + D) - 1;
    int* row = rows + (active ? c : 0);
#define OUT(f) row[(long long)(f) * nrows]

    int g0 = 0;
    if (active) {
        int q0 = nr;
        for (int r = 0; r < nr; ++r) {
            const long long stride = __ldg(digits + nr + r);
            if (stride > 0 && lo / stride != last / stride) {
                q0 = r;
                break;
            }
        }
        g0 = n;
        for (int g = 0; g < n; ++g)
            if (__ldg(run_of + g) >= q0) {
                g0 = g;
                break;
            }
        for (int x = 0; x < W; ++x) {
            sm[x * T] = 0;
            sio[x * T] = 0;
        }
        sm[input_slot * T] = input_meta;
    }
    if (tid == 0) g_block = 0;
    __syncthreads();
    if (active) atomicMax(&g_block, g0);
    __syncthreads();
    const int g_end = g_block;

    Replay st = initial_state();
    int m = 0;                       // lanes ended so far
    int run = -1, cut = 0;           // the current run and its cut
    for (int g = 0, wg = 0; g < g_end; ++g, ++wg) {
        if (wg == window) wg = 0;
        if (wg == 0)
            load_window(w_steps, w_slots, steps, slots, g,
                        min(window, g_end - g), width, lw);
        if (!active || g >= g0) continue;
        // the first candidate's frame bit, as the enumeration kernel
        // decodes it: the run's cut, then the group's place in the run
        const int r = __ldg(run_of + g);
        if (r != run) {
            const long long stride = __ldg(digits + nr + r);
            cut = stride > 0 ? (int)(lo / stride % __ldg(digits + 2 * nr + r))
                             : (int)__ldg(digits + r);
            run = r;
        }
        const int pos = __ldg(pos_of + g);
        const bool fr = __ldg(dir_neg + g) ? pos >= cut : pos < cut;
        const int* ls = w_slots + wg * lw;
        alloc_step<K>(g, fr, w_steps + wg * width, ls, k, ni, sink, sm, sio,
                      T, st);
        const int* ends = ls + L_GIN + 2 * k;
        const int n_end = ends[0];
        for (int e = 0; e < n_end; ++e, ++m) {
            OUT(R_SLOTS + 2 * W + m) = ends[1 + e];
            OUT(R_SLOTS + 2 * W + n + m) = sio[ends[1 + E + e] * T];
        }
    }

    if (!active) return;
    OUT(R_G0) = g0;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        OUT(R_LIVE + i) = st.live[i];
        OUT(R_BUFF + i) = st.buff[i];
    }
    OUT(R_SIDE) = st.side_buff;
    OUT(R_WRF) = st.wrf;
    OUT(R_BFM) = st.bfm;
    OUT(R_FEAS) = st.feas;
    OUT(R_ENDED) = m;
    for (int x = 0; x < W; ++x) {
        OUT(R_SLOTS + x) = sm[x * T];
        OUT(R_SLOTS + W + x) = sio[x * T];
    }
#undef OUT
}

// The widest window of table rows (at most MAX_WINDOW, at most n) that fits
// in shared memory beside `threads` candidates' W slots and `extra` bytes,
// and the bytes it all takes; 0 where not even one row fits.
int table_window(int n, int k, int lw, int W, int threads, size_t* smem,
                 size_t extra = 0) {
    const size_t slot_bytes = (size_t)SLOT_BYTES * W * threads + extra;
    const size_t row_bytes = sizeof(int) * (size_t)(S_GIN + 2 * k + lw);
    int window = n < MAX_WINDOW ? n : MAX_WINDOW;
    while (window > 1 && slot_bytes + row_bytes * window > SMEM_BUDGET)
        window /= 2;
    *smem = row_bytes * window + slot_bytes;
    return *smem > SMEM_BUDGET ? 0 : window;
}

template <int K, bool ROWS>
int launch(const void* frame, const void* steps, const void* slots,
           const void* rows, long long nrows, long long lo, long long D,
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
    // the state rows a block's candidates read: a block of threads spans
    // at most (threads - 1) / D + 2 blocks of D candidates
    const long long spans = ROWS ? (threads - 1) / D + 2 : 0;
    size_t smem = 0;
    const int window = table_window(
        n, k, lw, W, threads, &smem,
        sizeof(int) * (size_t)(R_SLOTS + 2 * W + 2 * n)
            * (size_t)(spans < threads ? spans : threads));
    if (window == 0) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(alloc_scan_kernel<K, ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (B + threads - 1) / threads;
    alloc_scan_kernel<K, ROWS><<<(unsigned)blocks, threads, smem, stream>>>(
        (const uint8_t*)frame, (const int*)steps, (const int*)slots,
        (const int*)rows, nrows, lo, D, (int*)io, (int*)stats, B, n, k, lw,
        input_slot, input_meta, W, window);
    return (int)cudaGetLastError();
}

template <int K>
int launch_prefix(const void* digits, const void* run_of, const void* pos_of,
                  const void* dir_neg, const void* steps, const void* slots,
                  void* rows, long long S, long long D, long long nrows,
                  int n, int nr, int k, int lw, int input_slot,
                  int input_meta, int W, cudaStream_t stream) {
    size_t smem = 0;
    const int window = table_window(n, k, lw, W, PREFIX_THREADS, &smem);
    if (window == 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        alloc_prefix_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (nrows + PREFIX_THREADS - 1) / PREFIX_THREADS;
    alloc_prefix_kernel<K><<<(unsigned)blocks, PREFIX_THREADS, smem,
                             stream>>>(
        (const long long*)digits, (const int*)run_of, (const int*)pos_of,
        (const uint8_t*)dir_neg, (const int*)steps, (const int*)slots,
        (int*)rows, S, D, nrows, n, nr, k, lw, input_slot, input_meta, W,
        window);
    return (int)cudaGetLastError();
}

bool tables_ok(int n, int k, int lw, int input_slot, int W) {
    return n > 0 && W > 0 && W <= MAX_SLOTS && input_slot >= 0
           && input_slot < W && k > 0 && k <= MAX_FAN_IN
           && lw >= L_GIN + 2 * k + 3;
}

}  // namespace

// the fan-in widths the kernels are instantiated at: CALL(K) for the least
// K >= k
#define BY_FAN_IN(CALL)                                                     \
    if (k <= 1) return CALL(1);                                             \
    if (k <= 2) return CALL(2);                                             \
    if (k <= 4) return CALL(4);                                             \
    if (k <= 8) return CALL(8);                                             \
    if (k <= 16) return CALL(16);                                           \
    if (k <= 32) return CALL(32);                                           \
    return CALL(64)

// frame [n][B] uint8; steps [n][8 + 2k] and slots [n][lw] int32
// (kernels/alloc_scan.py packs them); rows: null, or the state rows
// [R_SLOTS + 2 W + 2 n][nrows] int32 that alloc_prefix_launch wrote at
// blocks of D, the B candidates being those from lo of its sub-space; io
// [n][B] and stats [7][B] int32 out.
// W slots (1..128), the graph input's in input_slot with its packed state
// input_meta; k <= 64.
extern "C" int alloc_scan_launch(const void* frame, const void* steps,
                                 const void* slots, const void* rows,
                                 long long nrows, long long lo, long long D,
                                 void* io, void* stats, long long B, int n,
                                 int k, int lw, int input_slot,
                                 int input_meta, int W, int device,
                                 void* stream) {
    if (B <= 0 || n <= 0) return 0;
    if (!tables_ok(n, k, lw, input_slot, W)
        || (rows && (D <= 0 || lo < 0 || (lo + B - 1) / D >= nrows)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
#define SCAN(K_)                                                            \
    (rows ? launch<K_, true>(frame, steps, slots, rows, nrows, lo, D, io,   \
                             stats, B, n, k, lw, input_slot, input_meta, W, \
                             device, s)                                     \
          : launch<K_, false>(frame, steps, slots, rows, nrows, lo, D, io,  \
                              stats, B, n, k, lw, input_slot, input_meta,   \
                              W, device, s))
    BY_FAN_IN(SCAN);
#undef SCAN
}

// The state rows [R_SLOTS + 2 W + 2 n][ceil(S / D)] int32 of a sub-space of
// S candidates in blocks of D: digits [3][nr] int64 (each run's fixed cut,
// stride -- 0 for a fixed run -- and dim), run_of / pos_of [n] int32 and
// dir_neg [n] uint8, the enumeration kernel's tables; the rest as
// alloc_scan_launch's.
extern "C" int alloc_prefix_launch(const void* digits, const void* run_of,
                                   const void* pos_of, const void* dir_neg,
                                   const void* steps, const void* slots,
                                   void* rows, long long S, long long D,
                                   int n, int nr, int k, int lw,
                                   int input_slot, int input_meta, int W,
                                   int device, void* stream) {
    if (S <= 0) return 0;
    if (D <= 0 || nr <= 0 || !tables_ok(n, k, lw, input_slot, W))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long nrows = (S + D - 1) / D;
    cudaStream_t s = (cudaStream_t)stream;
#define PREFIX(K_)                                                          \
    launch_prefix<K_>(digits, run_of, pos_of, dir_neg, steps, slots, rows,  \
                      S, D, nrows, n, nr, k, lw, input_slot, input_meta,    \
                      W, s)
    BY_FAN_IN(PREFIX);
#undef PREFIX
}
