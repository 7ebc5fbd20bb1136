// The three remaining stages of the fused cut search, CUDA C++ for sm_90a:
// candidate enumeration, the float64 cost reduction with a per-block argmin
// (and, in its block 0, the chunk's winner), and the lexicographic argmin
// over rows.
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

constexpr int BLOCK = 256;       // threads a block: enumeration, argmin

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

// First lexicographic minimum of the keys of threads 0 .. NK - 1 (NK a
// power of two), every thread of the block taking part; sh is [4][NK]
// float64 of shared memory.  The result is valid in thread 0.
template <int NK>
__device__ Key block_argmin_in(Key k, double* sh) {
    const int t = threadIdx.x;
    if (t < NK) {
        sh[0 * NK + t] = k.infeas;
        sh[1 * NK + t] = k.primary;
        sh[2 * NK + t] = k.secondary;
        sh[3 * NK + t] = k.idx;
    }
    __syncthreads();
    for (int step = NK / 2; step > 0; step >>= 1) {
        if (t < step) {
            const Key a{sh[t], sh[NK + t], sh[2 * NK + t], sh[3 * NK + t]};
            const Key o{sh[t + step], sh[NK + t + step], sh[2 * NK + t + step],
                        sh[3 * NK + t + step]};
            if (key_less(o, a)) {
                sh[t] = o.infeas;
                sh[NK + t] = o.primary;
                sh[2 * NK + t] = o.secondary;
                sh[3 * NK + t] = o.idx;
            }
        }
        __syncthreads();
    }
    return Key{sh[0], sh[NK], sh[2 * NK], sh[3 * NK]};
}

// The same over a block of NT threads, with its own scratch.
template <int NT>
__device__ Key block_argmin(Key k) {
    __shared__ double sh[4 * NT];
    return block_argmin_in<NT>(k, sh);
}

// A key as entry i of four rows of `stride` float64.
__device__ __forceinline__ void store_key(double* p, long long stride,
                                          long long i, const Key& k) {
    p[0 * stride + i] = k.infeas;
    p[1 * stride + i] = k.primary;
    p[2 * stride + i] = k.secondary;
    p[3 * stride + i] = k.idx;
}

__device__ __forceinline__ Key shfl_down(const Key& k, int off) {
    return Key{__shfl_down_sync(0xffffffffu, k.infeas, off),
               __shfl_down_sync(0xffffffffu, k.primary, off),
               __shfl_down_sync(0xffffffffu, k.secondary, off),
               __shfl_down_sync(0xffffffffu, k.idx, off)};
}

__device__ __forceinline__ Key warp_argmin(Key k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const Key o = shfl_down(k, off);
        if (key_less(o, k)) k = o;
    }
    return k;
}

// The least key of a block of NT threads (a multiple of 32, at most 1,024)
// by warp shuffles, the warps' winners through shared memory; valid in
// thread 0.  The order of the comparisons does not matter: the idx of the
// keys compared is unique (or the keys are pads, equal bit for bit), so the
// least key is one key whatever the order.
template <int NT>
__device__ Key block_argmin_shfl(Key k) {
    constexpr int NW = NT / 32;
    static_assert(NT % 32 == 0 && NW <= 32, "one warp takes the warps' keys");
    __shared__ double sh[4][NW];
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    k = warp_argmin(k);
    if (lane == 0) {
        sh[0][w] = k.infeas;
        sh[1][w] = k.primary;
        sh[2][w] = k.secondary;
        sh[3][w] = k.idx;
    }
    __syncthreads();
    if (w == 0) {
        k = lane < NW ? Key{sh[0][lane], sh[1][lane], sh[2][lane],
                            sh[3][lane]}
                      : pad_key();
        k = warp_argmin(k);
    }
    return k;
}

// ------------------------------------------------------------ argmin of rows
// Replaces repro/kernels/search_pipeline.py::_argmin_only_kernel.  The first
// lexicographic minimum of L keys stored as four rows [4][L] float64, by one
// block of NT threads; valid in thread 0.  Its work is a few thousand keys,
// so what bounds it is latency: each thread issues the loads of R keys (4R
// independent 8-byte loads, 64 in flight) before it compares any, then the
// block reduces by warp shuffles.
template <int NT>
__device__ Key rows_argmin(const double* __restrict__ rows, long long L) {
    constexpr int R = 16;
    Key best = pad_key();
    for (long long i0 = threadIdx.x; i0 < L; i0 += (long long)NT * R) {
        double v[4][R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const long long i = i0 + (long long)k * NT;
#pragma unroll
            for (int c = 0; c < 4; ++c)
                v[c][k] = i < L ? __ldg(rows + c * L + i) : INFINITY;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const Key key{v[0][k], v[1][k], v[2][k], v[3][k]};
            if (key_less(key, best)) best = key;
        }
    }
    return block_argmin_shfl<NT>(best);
}

// ------------------------------------------------------ the chunk's winner
// K4's reduction in the cost kernels' block 0.  Blocks finish in no order,
// so the reducing block has to learn that every row is written.  A ticket
// (a fence and an atomic a block) would hold every block's slot for two
// round trips to L2 after its row; instead each block also stores its row,
// with relaxed stores and nothing to wait for, into `slots`, a [4][cap]
// float64 scratch of the stream that holds NaN between launches (no key is
// NaN).  Block 0 polls the rows until none is NaN, reduces them, and sets
// them back to NaN for the next launch on the stream.  The card starts
// block 0 first, so its reduction runs beside the other blocks' pricing and
// only the rows of the last ones are waited for; it holds one of the
// launch's block slots meanwhile, and every other block can still run.

__device__ __forceinline__ double load_relaxed(const double* p) {
    double v;
    asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];"
                 : "=d"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_relaxed(double* p, double v) {
    asm volatile("st.relaxed.gpu.global.f64 [%0], %1;"
                 :: "l"(p), "d"(v) : "memory");
}

// A block's row, for block 0 to find.
__device__ __forceinline__ void post_row(double* slots, long long cap,
                                         long long i, const Key& k) {
    store_relaxed(slots + 0 * cap + i, k.infeas);
    store_relaxed(slots + 1 * cap + i, k.primary);
    store_relaxed(slots + 2 * cap + i, k.secondary);
    store_relaxed(slots + 3 * cap + i, k.idx);
}

// The chunk's winner from the nb rows posted in `slots`, by block 0 (NT
// threads), into winner[0..3]; the rows are set back to NaN.  A key with a
// NaN component is not posted in full yet and is loaded again: each poll
// waits a round trip to L2 and the warp issues nothing meanwhile.  The rows
// arrive over the whole launch, so a thread takes one key at a time (more
// in flight would not end it sooner).  Not inlined: it keeps its registers
// out of the pricing loop's.
template <int NT>
__device__ __noinline__ void chunk_winner(double* slots, long long cap,
                                          long long nb, double* winner) {
    Key best = pad_key();
    for (long long i = threadIdx.x; i < nb; i += NT) {
        double v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = load_relaxed(slots + c * cap + i);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            while (isnan(v[c]))                  // not posted yet
                v[c] = load_relaxed(slots + c * cap + i);
            slots[c * cap + i] = NAN;
        }
        const Key key{v[0], v[1], v[2], v[3]};
        if (key_less(key, best)) best = key;
    }
    const Key w = block_argmin_shfl<NT>(best);
    if (threadIdx.x == 0) store_key(winner, 1, 0, w);
}

// After the block's winner is known in thread 0: its row, and its post for
// the chunk's winner, taken by block 0.  Every thread calls it, with the
// same `winner`.
template <int NT>
__device__ __forceinline__ void finish_block(double* out, double* winner,
                                             double* slots, long long cap,
                                             const Key& win) {
    if (threadIdx.x == 0) {
        store_key(out, gridDim.x, blockIdx.x, win);
        if (winner) post_row(slots, cap, blockIdx.x, win);
    }
    if (winner && blockIdx.x == 0)
        chunk_winner<NT>(slots, cap, gridDim.x, winner);
}

// ---------------------------------------------------------------- enumerate
// Replaces repro/kernels/search_pipeline.py::_enum_kernel.  Linear index
// lo + b -> cut per run (a fixed prefix cut, or the mixed-radix digit
// (j / stride) % dim, last run fastest) -> frame bit per group.  digits is
// [3][nr] int64: fixed cut, stride (0 marks a fixed run), dim.
//
// Its bound is the bytes it writes, one a candidate and group.  What held a
// thread a candidate far above it was the decode: sm_90 has no 64-bit
// integer divider, so each `/` and `%` is a routine of dozens of
// instructions, run for every candidate and run.  So a thread owns V
// consecutive candidates (B % V == 0, kernels/search_pipeline.py::
// enum_frames_plan): it decodes the first, j0, once per run, and the other
// V - 1 follow without a division -- for a run of stride >= V the digit
// steps at most once, at v = stride - j0 % stride; for a smaller stride an
// odometer in 32 bits steps it.  The groups of a run are contiguous, so one
// run's V digits are held in registers while its groups are written, each
// group's V mask bytes as one V-byte store (a warp: 32 V contiguous bytes).

// a / b for a, b >= 0, in 32 bits when both fit
__device__ __forceinline__ unsigned long long udiv(unsigned long long a,
                                                   unsigned long long b) {
    return ((a | b) >> 32) ? a / b
                           : (unsigned long long)((unsigned)a / (unsigned)b);
}

// The digits of candidates j0 .. j0 + V - 1 in one run.
template <int V>
__device__ __forceinline__ void run_digits(int (&dig)[V], long long j0,
                                           long long fixed, long long stride,
                                           long long dim) {
    if (stride == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) dig[v] = (int)fixed;
        return;
    }
    const unsigned long long q = udiv(j0, stride);
    const long long rem = j0 - (long long)q * stride;
    const int D = (int)dim;
    int d = (int)(q - udiv(q, dim) * dim);
    if (stride >= V) {                   // one step at most, at v = first
        const long long left = stride - rem;
        const int first = left < V ? (int)left : V;
        const int d1 = d + 1 == D ? 0 : d + 1;
#pragma unroll
        for (int v = 0; v < V; ++v) dig[v] = v < first ? d : d1;
    } else {                             // an odometer over v
        const int s = (int)stride;
        int r = (int)rem;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            dig[v] = d;
            if (++r == s) {
                r = 0;
                if (++d == D) d = 0;
            }
        }
    }
}

// One group's V mask bytes, byte v = candidate v, as one store.
template <int V>
__device__ __forceinline__ void store_masks(uint8_t* p, const int (&dig)[V],
                                            int pos, bool neg) {
    constexpr int NW = (V + 3) / 4;
    uint32_t w[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
        w[k] = 0;
#pragma unroll
        for (int u = 0; u < 4 && 4 * k + u < V; ++u)    // neg ? pos >= cut
            w[k] |= (uint32_t)((pos >= dig[4 * k + u]) == neg) << (8 * u);
    }                                                    //     : pos < cut
    if constexpr (V == 16)
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (V == 4)
        *reinterpret_cast<uint32_t*>(p) = w[0];
    else
        *p = (uint8_t)w[0];
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
enum_frames_kernel(const long long* __restrict__ digits,
                   const int* __restrict__ run_of,
                   const int* __restrict__ pos_of,
                   const uint8_t* __restrict__ dir_neg,
                   uint8_t* __restrict__ frame,          // [n][B]
                   long long lo, long long B, int n, int nr) {
    static_assert(V == 1 || V == 4 || V == 16, "a 1-, 4- or 16-byte store");
    const long long b0 = (blockIdx.x * (long long)BLOCK + threadIdx.x) * V;
    if (b0 >= B) return;
    const long long j0 = lo + b0;
    uint8_t* p = frame + b0;             // aligned to V: B % V == 0
    int dig[V];
    int last_run = -1;
    for (int g = 0; g < n; ++g, p += B) {
        const int r = __ldg(run_of + g);
        if (r != last_run) {
            run_digits<V>(dig, j0, __ldg(digits + r),
                          __ldg(digits + nr + r), __ldg(digits + 2 * nr + r));
            last_run = r;
        }
        store_masks<V>(p, dig, __ldg(pos_of + g), __ldg(dir_neg + g) != 0);
    }
}

// --------------------------------------------------------------------- cost
// Replaces repro/kernels/search_pipeline.py::_cost_kernel.  A candidate's
// latency is one float64 sum over its groups in gid order, so a candidate
// is one chain; its terms are priced branch by branch as the host prices
// them.  What bounds it on the card is not the bytes (5 a candidate and
// group) but the instructions each group issues: a correctly rounded
// float64 division where the group is framed, the maxima where it counts
// for SRAM, and the branches between them.  So the loads are issued a
// window ahead of the arithmetic, frame and io alike; the table is staged
// in shared memory as one 16-byte-aligned entry a group (paired loads,
// integer flags), padded so that the loops run whole windows; fmax is a
// compare and a select; and a batch of too few blocks to fill the card
// splits each candidate's groups over SPLIT threads.
//
// rows of the static table, [10][n] float64
constexpr int T_COMP = 0, T_ROW = 1, T_WEIGHT = 2, T_SIDE = 3, T_ROWFM = 4,
              T_SCOMP = 5, T_SWEIGHT = 6, T_OUTF = 7, T_OUTR = 8, T_WRR = 9;
constexpr int COST_BLOCK = 256;  // candidates a block: one output row
constexpr int TILE = 64;         // groups of the table in shared memory
constexpr int WIN = 4;           // groups whose loads a thread issues ahead
constexpr int SPLIT = 4;         // threads a candidate in the split kernel
constexpr int STEP = 2 * SPLIT;  // groups a step of the split kernel
constexpr int AHEAD = 2;         // steps whose loads the split kernel has
                                 // in flight
static_assert(TILE % WIN == 0 && TILE % STEP == 0,
              "a window or a step never straddles two tiles");

// The larger of two numbers that are never NaN nor -0 (every operand here
// is a finite, non-negative cycle or byte count): fmax's result in a
// compare and a select, without its NaN handling.
__device__ __forceinline__ double dmax(double a, double b) {
    return a < b ? b : a;
}

// A candidate's terms that do not depend on the order of its groups:
// integer-valued float64 below 2^53, so exact in any order.
struct Partial {
    double rterm, wbuff, outf, outr, wrr;
};

// A group's entry of the staged table: the eight float64 the pricing reads,
// in the pairs it reads them (16-byte loads), and the group's two flags.
struct alignas(16) GroupEntry {
    double comp, row;           // compute cycles, row-mode latency
    double weight, rowfm;       // weight bytes, row-mode DRAM bytes
    double outf, sweight;       // the four SRAM terms
    double outr, wrr;
    int side, scomp;            // side group; counts for the SRAM maxima
    int pad[2];
};

// The latency term of one group (its staged entry e) for a candidate with
// frame bit fr and boundary word io; its order-free terms go into q.  The
// division stays a division and nothing contracts (-fmad=false).
__device__ __forceinline__ double price_group(const GroupEntry& e, bool fr,
                                              int io, double bpc, double goc,
                                              Partial& q) {
    double per = e.row;
    if (e.side)
        per = e.comp;
    else if (fr)
        per = dmax(e.comp, (e.weight + (double)io) / bpc) + goc;
    if (!fr) q.rterm += e.rowfm;
    if (e.scomp) {
        if (fr) {
            q.outf = dmax(q.outf, e.outf);
        } else {
            q.wbuff = dmax(q.wbuff, e.sweight);
            q.outr = dmax(q.outr, e.outr);
            q.wrr = dmax(q.wrr, e.wrr);
        }
    }
    return per;
}

// Groups g0 .. g0 + TILE - 1 of the table into shared memory, by the
// block's nt threads; the caller synchronises around it.  An entry past n
// is a side group of 0 cycles and no SRAM term: its latency term is +0.0
// and adding it leaves a total bit for bit as it was, so the loops need not
// stop at n.
__device__ __forceinline__ void stage_table(GroupEntry* tabs,
                                            const double* __restrict__ tab,
                                            int g0, int n, int nt) {
    for (int i = threadIdx.x; i < TILE; i += nt) {
        const int g = g0 + i;
        GroupEntry e{};
        e.side = 1;
        if (g < n) {
            e.comp = __ldg(tab + T_COMP * n + g);
            e.row = __ldg(tab + T_ROW * n + g);
            e.weight = __ldg(tab + T_WEIGHT * n + g);
            e.rowfm = __ldg(tab + T_ROWFM * n + g);
            e.outf = __ldg(tab + T_OUTF * n + g);
            e.sweight = __ldg(tab + T_SWEIGHT * n + g);
            e.outr = __ldg(tab + T_OUTR * n + g);
            e.wrr = __ldg(tab + T_WRR * n + g);
            e.side = __ldg(tab + T_SIDE * n + g) > 0.0;
            e.scomp = __ldg(tab + T_SCOMP * n + g) > 0.0;
        }
        tabs[i] = e;
    }
}

// A candidate's key from its latency total, order-free terms and stats.
__device__ __forceinline__ Key cost_key(double lat, const Partial& q,
                                        const int (&st)[7], long long idx,
                                        double wbytes, double row_buff,
                                        double budget, int objective) {
    // integer-valued float64 terms below 2^53: exact in any order
    const double dram = q.rterm + (double)st[5] + wbytes;
    const double sram = row_buff + dmax(q.outf, q.outr)
                        + dmax(q.wrr, (double)st[4]) + (double)st[0]
                        + dmax((double)st[1], q.wbuff) + (double)st[2]
                        + (double)st[3];
    const bool feasible = (sram <= budget) && st[6] > 0;
    Key k;
    k.infeas = feasible ? 0.0 : 1.0;
    k.idx = (double)idx;
    if (objective == 0) {            // latency
        k.primary = lat;
        k.secondary = sram;
    } else if (objective == 1) {     // sram
        k.primary = sram;
        k.secondary = lat;
    } else {                         // dram
        k.primary = dram;
        k.secondary = lat;
    }
    return k;
}

// Ask L2 for a candidate's 7 stats, ahead of their loads.
__device__ __forceinline__ void prefetch_stats(const int* __restrict__ stats,
                                               long long B, long long b) {
#pragma unroll
    for (int r = 0; r < 7; ++r)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(stats + r * B + b));
}

__device__ __forceinline__ void load_stats(int (&st)[7],
                                           const int* __restrict__ stats,
                                           long long B, long long b,
                                           bool in) {
#pragma unroll
    for (int r = 0; r < 7; ++r)
        st[r] = in ? __ldg(stats + r * B + b) : 0;
}

// The frame bytes and io words of one candidate, read group after group
// with a stride of `every` groups: io whether the group is framed or not,
// nothing past n or for a candidate out of range.  The two pointers move by
// a row at a time, so a load costs no address arithmetic but an add.
struct Rows {
    const uint8_t* __restrict__ fp;
    const int* __restrict__ ip;
    long long step;
    int g, every, n;
    bool in;

    __device__ __forceinline__ Rows(const uint8_t* f, const int* i,
                                    long long B, long long b, int g0,
                                    int every_, int n_, bool in_)
        : fp(f + (long long)g0 * B + b), ip(i + (long long)g0 * B + b),
          step(every_ * B), g(g0), every(every_), n(n_), in(in_) {}

    __device__ __forceinline__ void next(uint8_t& fr, int& w) {
        const bool ok = in && g < n;
        fr = ok ? __ldg(fp) : (uint8_t)0;
        w = ok ? __ldg(ip) : 0;
        fp += step;
        ip += step;
        g += every;
    }
};

// One thread a candidate: it prices its groups in gid order, accumulating
// the latency in a register, with the frame bytes and io words of the next
// WIN groups in flight while it prices these; the table is read from shared
// memory.  Four blocks an SM (<= 64 registers) hide the float64 division's
// latency.  The block then takes its first minimum; given a winner buffer,
// block 0 also takes the chunk's (finish_block).
__global__ void __launch_bounds__(COST_BLOCK, 4)
cost_rows_kernel(const uint8_t* __restrict__ frame,     // [n][B]
                 const int* __restrict__ io,            // [n][B]
                 const int* __restrict__ stats,         // [7][B]
                 const double* __restrict__ tab,        // [10][n]
                 double* __restrict__ out,              // [4][gridDim.x]
                 double* __restrict__ winner,           // [4] or null
                 double* __restrict__ slots,            // [4][cap]
                 long long cap,
                 long long lo, long long S, long long B, int n,
                 double bpc, double goc, double budget, double wbytes,
                 double row_buff, int objective) {
    __shared__ GroupEntry tabs[TILE];
    const long long b = (long long)blockIdx.x * COST_BLOCK + threadIdx.x;
    const bool in = b < B && lo + b < S;
    // the stats are asked of L2 now and loaded after the loop: loaded now,
    // they would hold 7 registers through it
    if (in) prefetch_stats(stats, B, b);
    Rows rows(frame, io, B, b, 0, 1, n, in);
    uint8_t fr[WIN], fr_next[WIN];
    int iw[WIN], iw_next[WIN];
#pragma unroll
    for (int u = 0; u < WIN; ++u) rows.next(fr[u], iw[u]);
    double lat = 0.0;
    Partial q{0.0, 0.0, 0.0, 0.0, 0.0};
    for (int g0 = 0; g0 < n; g0 += WIN) {
        if (g0 % TILE == 0) {
            __syncthreads();
            stage_table(tabs, tab, g0, n, COST_BLOCK);
            __syncthreads();
        }
#pragma unroll
        for (int u = 0; u < WIN; ++u) rows.next(fr_next[u], iw_next[u]);
        const GroupEntry* col = &tabs[g0 % TILE];
#pragma unroll
        for (int u = 0; u < WIN; ++u)     // the latency total, in gid order
            lat += price_group(col[u], fr[u], iw[u], bpc, goc, q);
#pragma unroll
        for (int u = 0; u < WIN; ++u) {
            fr[u] = fr_next[u];
            iw[u] = iw_next[u];
        }
    }
    int st[7];
    load_stats(st, stats, B, b, in);
    const Key key = in ? cost_key(lat, q, st, lo + b, wbytes, row_buff,
                                  budget, objective)
                       : pad_key();
    const Key win = block_argmin<COST_BLOCK>(key);
    finish_block<COST_BLOCK>(out, winner, slots, cap, win);
}

// SPLIT threads a candidate, for batches too small to fill the card with
// one thread a candidate (resnet152's 8,748 candidates are 35 blocks).
// Thread (p, c) = (threadIdx.x / COST_BLOCK, threadIdx.x % COST_BLOCK)
// prices groups g0 + p + SPLIT * j of each step of STEP groups and leaves
// each latency term in shared memory; after the step's barrier thread (0,
// c) adds the step's STEP terms to the latency in gid order, while the
// others price the next step into the other buffer.  The loads of the next
// AHEAD steps are in flight meanwhile: a step's arithmetic is short beside
// a round trip to memory.  The order-free terms
// are combined across the SPLIT threads at the end.  The latency total is
// the same sum in the same order as one thread a candidate.
__global__ void __launch_bounds__(COST_BLOCK * SPLIT)
cost_rows_split_kernel(const uint8_t* __restrict__ frame,     // [n][B]
                       const int* __restrict__ io,            // [n][B]
                       const int* __restrict__ stats,         // [7][B]
                       const double* __restrict__ tab,        // [10][n]
                       double* __restrict__ out,          // [4][gridDim.x]
                       double* __restrict__ winner,       // [4] or null
                       double* __restrict__ slots,        // [4][cap]
                       long long cap,
                       long long lo, long long S, long long B, int n,
                       double bpc, double goc, double budget, double wbytes,
                       double row_buff, int objective) {
    constexpr int NT = COST_BLOCK * SPLIT, PER = STEP / SPLIT;
    __shared__ GroupEntry tabs[TILE];
    __shared__ double pers[2][STEP][COST_BLOCK];
    static_assert(5 * (SPLIT - 1) <= 2 * STEP && 4 <= 2 * STEP,
                  "the partials and the argmin fit in the term buffers");
    const int c = threadIdx.x % COST_BLOCK, p = threadIdx.x / COST_BLOCK;
    const long long b = (long long)blockIdx.x * COST_BLOCK + c;
    const bool in = b < B && lo + b < S;
    int st[7];
    load_stats(st, stats, B, b, in && p == 0);
    // the thread's groups p, p + SPLIT, ...: PER of each step; the loads of
    // AHEAD steps in flight, slot d holding step k0 + d
    Rows rows(frame, io, B, b, p, SPLIT, n, in);
    uint8_t fr[AHEAD][PER];
    int iw[AHEAD][PER];
#pragma unroll
    for (int d = 0; d < AHEAD; ++d)
#pragma unroll
        for (int j = 0; j < PER; ++j) rows.next(fr[d][j], iw[d][j]);
    double lat = 0.0;
    Partial q{0.0, 0.0, 0.0, 0.0, 0.0};
    for (int k0 = 0; k0 * STEP < n; k0 += AHEAD) {
#pragma unroll
        for (int d = 0; d < AHEAD; ++d) {
            const int k = k0 + d, g0 = k * STEP;
            if (g0 >= n) break;
            if (g0 % TILE == 0) {
                __syncthreads();
                stage_table(tabs, tab, g0, n, NT);
                __syncthreads();
            }
            double (*terms)[COST_BLOCK] = pers[k & 1];
            const GroupEntry* col = &tabs[g0 % TILE];
#pragma unroll
            for (int j = 0; j < PER; ++j) {
                const int i = p + SPLIT * j;
                terms[i][c] = price_group(col[i], fr[d][j], iw[d][j], bpc,
                                          goc, q);
                rows.next(fr[d][j], iw[d][j]);   // step k + AHEAD
            }
            __syncthreads();
            if (p == 0) {
                // the latency total: one term per step, in gid order
#pragma unroll
                for (int i = 0; i < STEP; ++i) lat += terms[i][c];
            }
        }
    }
    __syncthreads();                     // the last terms are read
    double* red = &pers[0][0][0];        // [5][SPLIT - 1][COST_BLOCK]
    if (p > 0) {
        const double v[5] = {q.rterm, q.wbuff, q.outf, q.outr, q.wrr};
#pragma unroll
        for (int r = 0; r < 5; ++r)
            red[(r * (SPLIT - 1) + p - 1) * COST_BLOCK + c] = v[r];
    }
    __syncthreads();
    Key key = pad_key();
    if (p == 0) {
#pragma unroll
        for (int o = 0; o < SPLIT - 1; ++o) {
            const double* v = red + o * COST_BLOCK + c;
            const int stride = (SPLIT - 1) * COST_BLOCK;
            q.rterm += v[0];
            q.wbuff = dmax(q.wbuff, v[stride]);
            q.outf = dmax(q.outf, v[2 * stride]);
            q.outr = dmax(q.outr, v[3 * stride]);
            q.wrr = dmax(q.wrr, v[4 * stride]);
        }
        if (in)
            key = cost_key(lat, q, st, lo + b, wbytes, row_buff, budget,
                           objective);
    }
    __syncthreads();                     // the partials are read
    const Key win = block_argmin_in<COST_BLOCK>(key, red);
    finish_block<COST_BLOCK * SPLIT>(out, winner, slots, cap, win);
}

// ------------------------------------------------------------------- argmin
// One block reduces L lanes, [4][L] float64, to the first lexicographic
// minimum: 4 float64.  The cut search takes its chunk winners in the cost
// kernels' block 0; this launch serves the other callers.
__global__ void __launch_bounds__(BLOCK)
argmin_rows_kernel(const double* __restrict__ lanes, double* __restrict__ out,
                   long long L) {
    const Key win = rows_argmin<BLOCK>(lanes, L);
    if (threadIdx.x == 0) store_key(out, 1, 0, win);
}

}  // namespace

// vec: candidates a thread (1, 4 or 16, dividing B);
// kernels/search_pipeline.py::enum_frames_plan picks.
extern "C" int enum_frames_launch(const void* digits, const void* run_of,
                                  const void* pos_of, const void* dir_neg,
                                  void* frame, long long lo, long long B,
                                  int n, int nr, int vec, int device,
                                  void* stream) {
    if (B <= 0) return 0;
    if ((vec != 1 && vec != 4 && vec != 16) || B % vec)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((B / vec + BLOCK - 1) / BLOCK);
    cudaStream_t st = (cudaStream_t)stream;
    const long long* d = (const long long*)digits;
    const int* r = (const int*)run_of;
    const int* p = (const int*)pos_of;
    const uint8_t* neg = (const uint8_t*)dir_neg;
    uint8_t* f = (uint8_t*)frame;
    if (vec == 16)
        enum_frames_kernel<16><<<blocks, BLOCK, 0, st>>>(d, r, p, neg, f, lo,
                                                         B, n, nr);
    else if (vec == 4)
        enum_frames_kernel<4><<<blocks, BLOCK, 0, st>>>(d, r, p, neg, f, lo,
                                                        B, n, nr);
    else
        enum_frames_kernel<1><<<blocks, BLOCK, 0, st>>>(d, r, p, neg, f, lo,
                                                        B, n, nr);
    return (int)cudaGetLastError();
}

// out must hold [4][ceil(B / 256)] float64.  split: SPLIT threads a
// candidate (cost_rows_split_kernel) instead of one (cost_rows_kernel);
// kernels/search_pipeline.py::cost_rows_plan picks.  winner: null, or [4]
// float64 for the chunk's winner, with slots [4][cap] float64, cap >= the
// blocks, all NaN and used by no launch on another stream (the launch
// leaves them NaN again).
extern "C" int cost_rows_launch(const void* frame, const void* io,
                                const void* stats, const void* tab, void* out,
                                void* winner, void* slots, long long cap,
                                long long lo, long long S, long long B, int n,
                                double bpc, double goc, double budget,
                                double wbytes, double row_buff, int objective,
                                int split, int device, void* stream) {
    if (B <= 0) return 0;
    const long long blocks = (B + COST_BLOCK - 1) / COST_BLOCK;
    if (winner && cap < blocks) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const uint8_t* f = (const uint8_t*)frame;
    const int* i = (const int*)io;
    const int* s = (const int*)stats;
    const double* t = (const double*)tab;
    double* o = (double*)out;
    double* w = (double*)winner;
    double* sl = (double*)slots;
    cudaStream_t st = (cudaStream_t)stream;
    if (split)
        cost_rows_split_kernel<<<(unsigned)blocks, COST_BLOCK * SPLIT, 0,
                                 st>>>(f, i, s, t, o, w, sl, cap, lo, S, B, n,
                                       bpc, goc, budget, wbytes, row_buff,
                                       objective);
    else
        cost_rows_kernel<<<(unsigned)blocks, COST_BLOCK, 0, st>>>(
            f, i, s, t, o, w, sl, cap, lo, S, B, n, bpc, goc, budget,
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
