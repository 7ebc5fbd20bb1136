"""Tensorized allocator replay (candidates x groups) in PyTorch and CUDA.

The batched candidate scorer (``CutpointEngine.score_batch``) prices B cut
tuples as one set of B x G mask-matrix reductions; this module supplies the
per-candidate allocator quantities those reductions need without a Python
replay per candidate.  The sequential allocator of Algorithm 1
(``core/allocator.py::alloc_step``) is re-expressed as a **state machine
over fixed-width integer rows** -- one data-independent update rule per
group -- and the whole replay of a B-candidate batch is one pass over the
groups.

State (``n`` groups; lane ``n`` is the ``GRAPH_INPUT`` pseudo producer,
lane ``n+1`` a write-off sink that padded fan-in slots point at -- see
``allocator.state_to_arrays`` for the scalar origin), per candidate:

* ``rem``  (n+2) unmet consumer counts
* ``loc``  (n+2) location codes -- buffer id 0..2, ``LOC_SIDE``, ``LOC_DRAM``
* ``live`` (3)   owning gid per physical buffer or ``LIVE_EMPTY``
* ``buff`` (3) / ``side_buff``  byte maxima (Algorithm 1)
* ``io``   (n+2) per-gid boundary-I/O bytes (reads + boundary writes +
  spill write-outs -- the engine's journal-fed ``_x_io`` rows)
* ``bw``   (n+2) boundary-write membership (dedups multi-consumer
  row-side reads of one frame tensor)
* ``bfm`` / ``wrf`` / ``feas``  running DRAM boundary total, eq. (5) frame
  write-buffer max, and spill feasibility

Two implementations of the same function, bit-identical on every integer:

* :func:`alloc_scan_torch` -- the plain version: a Python loop over groups,
  each step a handful of (B,)-vector torch ops in int64.  Runs on the CPU
  and on the GPU; the tests, ``device="cpu"`` and the ``:torch`` engine
  variants use it.
* :func:`alloc_scan_cuda` -- the hand-written kernel
  (``csrc/alloc_scan.cu``), int32.

**The kernel.**  It replaces the TPU kernel
``repro/kernels/alloc_scan.py::_alloc_kernel``.  That version runs the
group axis as the sequential trailing grid dimension with the state in
scratch memory and addresses per-gid lanes with one-hot masks.  Here one
thread replays one candidate with the loop over groups inside the kernel.
Every lane the rule touches at step g is a per-group constant, and only a
few lanes are live at once: a lane lives from its producer's step (the
graph input from the start) to its last reader.  :func:`lane_slots`
colours those live ranges with W slots -- the paper's reuse-aware static
allocation, applied to the replay's own state -- and the kernel keeps each
candidate's ``rem`` / ``loc`` / ``bw`` / ``io`` for the W slots in shared
memory (W is 2-7 on the zoo).  Global memory sees only the function's own
traffic: the frame bits in, each lane's ``io`` out when its range ends,
seven stats out.  What bounds it on the card: the least it must move is
about ``5 * n + 28`` bytes per candidate, and each step costs on the order
of a hundred integer operations per candidate, which at the card's integer
rate is the larger of the two times.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.allocator import (GRAPH_INPUT, LIVE_EMPTY, LOC_DRAM,
                                        LOC_SIDE, NUM_BUFFERS, graph_steps,
                                        init_alloc_state, spill_is_long_path,
                                        state_to_arrays)
from repro_torch.kernels import upload

# Sink slot's initial consumer count: decremented once per padded fan-in
# slot per step in the plain version, must never reach zero.
_SINK_REMAINING = 1 << 40
_INT32_MAX = 2 ** 31 - 1

# columns of AllocScanResult.stats
STAT_SIDE = NUM_BUFFERS          # columns 0..2: the three buffer maxima
STAT_WRF = NUM_BUFFERS + 1
STAT_BFM = NUM_BUFFERS + 2
STAT_FEAS = NUM_BUFFERS + 3
N_STATS = NUM_BUFFERS + 4

# columns of one row of the kernel's per-group step table (then k producer
# lanes and k producer sizes); csrc/alloc_scan.cu has the same list
_STEP_FIXED = 8

TABLE_FIELDS = ("is_side", "gin", "src_size", "main", "sc", "sc_size",
                "in_size", "out_size", "wr_cand", "spill_ok", "rem0", "loc0")

# the most slots the kernel's wrapper takes (W x 8 bytes a candidate of
# shared memory, csrc/alloc_scan.cu: 128 KB a block of 128 candidates at
# 128), and the widest fan-in its step loops are unrolled to
MAX_SLOTS = 128
MAX_FAN_IN = 64


@dataclass(frozen=True)
class LaneSlots:
    """A static slot map of the replay's lanes (see :func:`lane_slots`)."""
    start: np.ndarray          # (n+2,) first step the lane is live (sink: -1)
    end: np.ndarray            # (n+2,) its last reader's step (sink: -1)
    slot: np.ndarray           # (n+2,) int32 slot (sink: -1)
    width: int                 # W: slots in use, the most lanes live at once
    ends: tuple                # per step, the lanes < n whose range ends there


def lane_slots(gin: np.ndarray, main: np.ndarray,
               sc: np.ndarray) -> LaneSlots:
    """Colour the lanes' live ranges with the fewest slots.

    Lane ``g < n`` lives from step g, which produces it, to the last step
    that reads it as a producer (``gin``), main operand or shortcut source;
    the graph-input lane ``n`` from step 0; the sink ``n + 1`` holds no
    state.  Two lanes live at one step never share a slot (both are read or
    written in it).  The ranges form an interval graph, so greedy colouring
    by start, lowest free slot first, uses exactly as many slots as the
    most ranges that overlap."""
    n = gin.shape[0]
    ni, sink = n, n + 1
    start = np.full(n + 2, -1, dtype=np.int64)
    start[:n + 1] = np.append(np.arange(n), 0)
    end = start.copy()
    for g in range(n):
        for lane in (*gin[g], main[g], sc[g]):
            if lane != sink:
                end[lane] = max(end[lane], g)
    slot = np.full(n + 2, -1, dtype=np.int32)
    free_at = []                   # per slot: the step after its lane's end
    for lane in sorted(range(n + 1), key=lambda x: (start[x], x)):
        s = next((i for i, f in enumerate(free_at) if f <= start[lane]),
                 len(free_at))
        if s == len(free_at):
            free_at.append(0)
        free_at[s] = end[lane] + 1
        slot[lane] = s
    ends = tuple(tuple(int(x) for x in np.flatnonzero(end[:n] == g))
                 for g in range(n))
    return LaneSlots(start=start, end=end, slot=slot, width=len(free_at),
                     ends=ends)


def _meta(rem0, loc0):
    """A lane's packed state as the kernel keeps it in a slot: ``rem << 8 |
    bw << 4 | loc`` (bw 0 at the start; rem is a consumer count, at most
    n, and loc a code below 16)."""
    return (np.asarray(rem0, np.int64) << 8) | np.asarray(loc0, np.int64)


def _slot_table(gin, main, sc, rem0, loc0, wr_cand,
                slots: LaneSlots) -> np.ndarray:
    """The kernel's per-step table of what a step reads beside the step
    table: the slots of its own lane, main operand and shortcut (-1: the
    sink), its lane's initial packed state (:func:`_meta`), its k
    producers' slots and frame write-buffer candidates, then how many
    lanes end at the step, their lanes and their slots (padded with -1)."""
    n, k = gin.shape
    e = max([1] + [len(x) for x in slots.ends])
    out = np.full((n, 5 + 2 * k + 2 * e), -1, dtype=np.int64)
    out[:, 0] = slots.slot[:n]
    out[:, 1] = slots.slot[main]
    out[:, 2] = slots.slot[sc]              # the sink's slot is -1
    out[:, 3] = _meta(rem0[:n], loc0[:n])
    out[:, 4:4 + k] = slots.slot[gin]
    out[:, 4 + k:4 + 2 * k] = wr_cand[gin]
    for g, ended in enumerate(slots.ends):
        out[g, 4 + 2 * k] = len(ended)
        out[g, 5 + 2 * k:5 + 2 * k + len(ended)] = ended
        out[g, 5 + 2 * k + e:5 + 2 * k + e + len(ended)] = \
            slots.slot[list(ended)]
    return out


@dataclass(frozen=True)
class AllocScanTables:
    """Static per-graph tables of the tensorized allocator.

    The per-group rows (indexed by gid; fan-in padded to width ``k`` with
    slots pointing at the sink lane) are host numpy arrays: both
    implementations read them as per-step constants.  ``dev`` holds what
    has to live on ``device``: the initial state rows for the plain
    version (int64) and the packed int32 tables the kernel reads."""
    n: int                     # real group count
    k: int                     # padded fan-in width (>= 1)
    input_idx: int             # == n: GRAPH_INPUT lane
    sink_idx: int              # == n + 1: padded-slot write-off lane
    is_side: np.ndarray        # (G,) bool
    gin: np.ndarray            # (G, K) int32 producer lanes
    src_size: np.ndarray       # (G, K) int64 producer out bytes (pads: 0)
    main: np.ndarray           # (G,) int32 main-path producer lane
    sc: np.ndarray             # (G,) int32 shortcut lane (sink if none)
    sc_size: np.ndarray        # (G,) int64
    in_size: np.ndarray        # (G,) int64
    out_size: np.ndarray       # (G,) int64
    wr_cand: np.ndarray        # (n+2,) int64 eq. (5) frame write candidates
    spill_ok: np.ndarray       # (G,) bool long-path spill tolerated
    rem0: np.ndarray           # (n+2,) int64 initial consumer counts
    loc0: np.ndarray           # (n+2,) int8 initial location codes
    device: torch.device
    dev: dict                  # name -> tensor on ``device``
    # True when every per-candidate total provably fits int32 (the kernel's
    # integer width): the DRAM boundary total ``bfm`` adds at most each
    # group's producer bytes plus its own output bytes
    fits_int32: bool
    slots: LaneSlots           # the kernel's static slot map of the lanes

    @classmethod
    def from_numpy(cls, fields: dict, device="cpu") -> "AllocScanTables":
        """Tables from plain numpy data: the ``TABLE_FIELDS`` arrays (``n``
        and ``k`` follow from their shapes)."""
        f = {name: np.asarray(fields[name]) for name in TABLE_FIELDS}
        n, k = f["gin"].shape
        src_size = f["src_size"].astype(np.int64)
        out_size = f["out_size"].astype(np.int64)
        bound = int(src_size.sum() + out_size.sum())
        biggest = max([bound] + [int(f[x].max(initial=0)) for x in
                                 ("src_size", "sc_size", "in_size",
                                  "out_size", "wr_cand")])
        steps = np.zeros((n, _STEP_FIXED + 2 * k), dtype=np.int64)
        steps[:, 0] = f["is_side"]
        steps[:, 1] = f["main"]
        steps[:, 2] = f["sc"]
        steps[:, 3] = f["sc_size"]
        steps[:, 4] = f["in_size"]
        steps[:, 5] = out_size
        steps[:, 6] = f["wr_cand"][:n]
        steps[:, 7] = f["spill_ok"]
        steps[:, _STEP_FIXED:_STEP_FIXED + k] = f["gin"]
        steps[:, _STEP_FIXED + k:] = src_size
        rem0 = f["rem0"].astype(np.int64)
        slots = lane_slots(f["gin"], f["main"], f["sc"])

        def i32(a):
            return np.minimum(a, _INT32_MAX).astype(np.int32)

        loc0 = f["loc0"].astype(np.int64)
        table = _slot_table(f["gin"], f["main"], f["sc"], rem0, loc0,
                            f["wr_cand"].astype(np.int64), slots)
        dev = dict(zip(("rem0", "loc0", "steps32", "slots32"),
                       upload(device, rem0, loc0, i32(steps), i32(table))))
        # the tensors' own device: "cuda" has become "cuda:0" by now
        device = dev["rem0"].device
        return cls(n=n, k=k, input_idx=n, sink_idx=n + 1,
                   is_side=f["is_side"].astype(bool),
                   gin=f["gin"].astype(np.int32), src_size=src_size,
                   main=f["main"].astype(np.int32),
                   sc=f["sc"].astype(np.int32),
                   sc_size=f["sc_size"].astype(np.int64),
                   in_size=f["in_size"].astype(np.int64), out_size=out_size,
                   wr_cand=f["wr_cand"].astype(np.int64),
                   spill_ok=f["spill_ok"].astype(bool), rem0=rem0,
                   loc0=f["loc0"].astype(np.int8), device=device, dev=dev,
                   fits_int32=biggest <= _INT32_MAX, slots=slots)


@dataclass(frozen=True)
class AllocScanResult:
    """Per-candidate replay outputs, tensors on the tables' device.

    ``io`` is the engine's ``_x_io`` rows; ``stats`` holds, per candidate,
    the replayed ``Allocation.buff`` (3 columns) and ``side_buff`` and the
    engine's ``_x_wrf`` / ``_x_bfm`` / ``_x_feas`` accumulators --
    everything ``score_batch`` extracts from a journal replay.  The plain
    version returns int64, the kernel int32 (exact: see
    ``AllocScanTables.fits_int32``).  Both matrices may be transposed
    views of lane-major storage."""
    io: torch.Tensor           # (B, n)
    stats: torch.Tensor        # (B, 7): buff x3, side, wrf, bfm, feasible

    @property
    def buff(self) -> torch.Tensor:
        return self.stats[:, :NUM_BUFFERS]

    @property
    def side_buff(self) -> torch.Tensor:
        return self.stats[:, STAT_SIDE]

    @property
    def wrf(self) -> torch.Tensor:
        return self.stats[:, STAT_WRF]

    @property
    def bfm(self) -> torch.Tensor:
        return self.stats[:, STAT_BFM]

    @property
    def feasible(self) -> torch.Tensor:
        return self.stats[:, STAT_FEAS] > 0


def pack_alloc_tables(gg, hw, device="cpu") -> AllocScanTables:
    """Resolve one graph's allocator walk into scan tables on ``device``.

    ``hw`` feeds the eq. (5) write-buffer candidates (``hw.to`` lane
    count); everything else is pure graph topology from
    ``allocator.graph_steps`` plus the exported ``init_alloc_state``."""
    from repro_torch.core.sram import sram_tables

    steps = graph_steps(gg)
    n = len(steps)
    ni, nd = n, n + 1
    k = max(1, max(len(s.gin) for s in steps))

    def lane(src: int) -> int:
        return ni if src == GRAPH_INPUT else src

    is_side = np.zeros(n, dtype=bool)
    gin = np.full((n, k), nd, dtype=np.int32)
    src_size = np.zeros((n, k), dtype=np.int64)
    main = np.full(n, ni, dtype=np.int32)
    sc = np.full(n, nd, dtype=np.int32)
    sc_size = np.zeros(n, dtype=np.int64)
    in_size = np.zeros(n, dtype=np.int64)
    out_size = np.zeros(n, dtype=np.int64)
    spill_ok = np.zeros(n, dtype=bool)
    for g, s in enumerate(steps):
        is_side[g] = s.is_side
        for j, (src, sz) in enumerate(zip(s.gin, s.src_sizes)):
            gin[g, j] = lane(src)
            src_size[g, j] = sz
        if s.gin:
            main[g] = lane(s.gin[0])
        if s.sc_src is not None:
            sc[g] = lane(s.sc_src)
            sc_size[g] = s.sc_size
        in_size[g] = s.in_size
        out_size[g] = s.out_size
        spill_ok[g] = spill_is_long_path(gg, g)

    st = sram_tables(gg, hw)
    wr_cand = np.zeros(n + 2, dtype=np.int64)
    wr_cand[:n] = np.where(st.compute, np.asarray(st.wr_frame), 0)

    init = state_to_arrays(init_alloc_state(gg, lean=True))
    rem0 = np.empty(n + 2, dtype=np.int64)
    rem0[:n] = init["remaining"][:n]
    rem0[ni] = init["remaining"][n]          # graph input (list slot -1)
    rem0[nd] = _SINK_REMAINING
    loc0 = np.full(n + 2, LOC_DRAM, dtype=np.int8)
    loc0[:n] = init["location"][:n]
    loc0[ni] = init["location"][n]
    return AllocScanTables.from_numpy(
        dict(is_side=is_side, gin=gin, src_size=src_size, main=main, sc=sc,
             sc_size=sc_size, in_size=in_size, out_size=out_size,
             wr_cand=wr_cand, spill_ok=spill_ok, rem0=rem0, loc0=loc0),
        device=device)


# ------------------------------------------------------------ plain version
def _first_free(m0, m1, m2) -> torch.Tensor:
    """Lowest buffer id whose mask is True, else -1; (B,) int64."""
    minus = torch.full_like(m0, -1, dtype=torch.int64)
    return torch.where(m0, 0, torch.where(m1, 1, torch.where(m2, 2, minus)))


def alloc_scan_torch(t: AllocScanTables,
                     frame: torch.Tensor) -> AllocScanResult:
    """Plain torch replay: B candidates through all groups, exact int64.

    ``frame`` is the (B, G) frame-mask matrix on ``t.device``.  The loop is
    over *groups* only; every step is a handful of (B,)-vector ops, so the
    whole batch advances in lock-step, with the static fan-in slots
    unrolled.  The state rows are kept lane-major, (n+2, B), so each
    per-gid row is contiguous."""
    if frame.device != t.device:
        raise ValueError(f"frame is on {frame.device}, the tables on "
                         f"{t.device}")
    B = frame.shape[0]
    n, ni, sink = t.n, t.input_idx, t.sink_idx
    NB = NUM_BUFFERS
    dev = t.device
    i64 = torch.int64
    frame = frame.to(torch.bool)
    rem = t.dev["rem0"][:, None].expand(n + 2, B).clone()
    loc = t.dev["loc0"][:, None].expand(n + 2, B).clone()
    live = [torch.full((B,), LIVE_EMPTY, dtype=i64, device=dev)
            for _ in range(NB)]
    buff = [torch.zeros(B, dtype=i64, device=dev) for _ in range(NB)]
    side_buff = torch.zeros(B, dtype=i64, device=dev)
    io = torch.zeros((n + 2, B), dtype=i64, device=dev)
    bw = torch.zeros((n + 2, B), dtype=torch.bool, device=dev)
    bfm = torch.zeros(B, dtype=i64, device=dev)
    wrf = torch.zeros(B, dtype=i64, device=dev)
    feas = torch.ones(B, dtype=torch.bool, device=dev)

    def release(slots):
        for src, _ in slots:
            if src == ni:
                continue                 # graph input is never in a buffer
            dead = rem[src] <= 0
            sl = loc[src]
            for i in range(NB):
                freed = dead & (sl == i) & (live[i] == src)
                live[i] = live[i].masked_fill(freed, LIVE_EMPTY)

    for g in range(n):
        slots = [(int(t.gin[g, j]), int(t.src_size[g, j]))
                 for j in range(t.k) if t.gin[g, j] != sink]
        outsz = int(t.out_size[g])
        main_g = int(t.main[g])

        if t.is_side[g]:
            # SE side path: side space regardless of mode, consume, free.
            side_buff = side_buff.clamp(min=outsz)
            loc[g] = LOC_SIDE
            for src, _ in slots:
                rem[src] -= 1
            release(slots)
            continue

        fr = frame[:, g]
        rw = ~fr

        # ---- frame pre-state: operand locations, DRAM reads, fetch slot
        mloc = loc[main_g].clone()
        main_in_buf = mloc < NB
        read_bytes = torch.zeros(B, dtype=i64, device=dev)
        in_buf = [torch.zeros(B, dtype=torch.bool, device=dev)
                  for _ in range(NB)]
        for src, sz in slots:
            sl = loc[src]
            read_bytes += (sl == LOC_DRAM).to(i64) * sz
            for i in range(NB):
                in_buf[i] = in_buf[i] | (sl == i)
        empty = [live[i] == LIVE_EMPTY for i in range(NB)]
        fetch_b = _first_free(*empty)
        need_fetch = ~main_in_buf & (fetch_b >= 0)
        insz = int(t.in_size[g])
        for i in range(NB):
            fetched = need_fetch & (fetch_b == i)
            cond = fr & ((main_in_buf & (mloc == i)) | fetched)
            buff[i] = torch.where(cond, buff[i].clamp(min=insz), buff[i])
            in_buf[i] = in_buf[i] | fetched
        if t.sc[g] != sink:
            sloc = loc[int(t.sc[g])]
            scsz = int(t.sc_size[g])
            for i in range(NB):
                cond = fr & (sloc == i)
                buff[i] = torch.where(cond, buff[i].clamp(min=scsz), buff[i])

        # ---- row branch: frame-produced operands cross the boundary
        for src, sz in slots:
            if src == ni:
                continue
            add = rw & (loc[src] < NB) & ~bw[src]
            bw[src] |= add
            delta = add.to(i64) * sz
            io[src] += delta
            bfm += delta
            wrf = torch.where(add, wrf.clamp(min=int(t.wr_cand[src])), wrf)

        # ---- consume inputs
        for src, _ in slots:
            rem[src] -= 1

        # ---- frame branch: boundary reads charged to this group
        rb = fr.to(i64) * read_bytes
        io[g] += rb
        bfm += rb

        # ---- place this group's output
        final = rem[g] == 0
        addf = fr & final & ~bw[g]
        bw[g] |= addf
        delta = addf.to(i64) * outsz
        io[g] += delta
        bfm += delta
        wrf = torch.where(addf, wrf.clamp(min=int(t.wr_cand[g])), wrf)

        b_out = _first_free(*[empty[i] & ~in_buf[i] for i in range(NB)])
        main_live = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(NB):
            main_live |= (mloc == i) & (live[i] == main_g)
        reuse = (b_out < 0) & main_in_buf & (rem[main_g] == 0) & main_live
        b_out = torch.where(reuse, mloc, b_out)
        alloc_out = fr & ~final & (b_out >= 0)
        spill = fr & ~final & (b_out < 0)
        add_sp = spill & ~bw[g]
        delta = add_sp.to(i64) * outsz
        io[g] += delta
        bfm += delta
        if not t.spill_ok[g]:
            feas &= ~spill
        for i in range(NB):
            sel = alloc_out & (b_out == i)
            live[i] = live[i].masked_fill(sel, g)
            buff[i] = torch.where(sel, buff[i].clamp(min=outsz), buff[i])
        loc[g] = torch.where(alloc_out, b_out,
                             torch.full_like(b_out, LOC_DRAM))

        # ---- release dead operands (post output claim, as alloc_step)
        release(slots)

    stats = torch.stack(buff + [side_buff, wrf, bfm, feas.to(i64)], dim=1)
    return AllocScanResult(io=io[:n].t(), stats=stats)


# ------------------------------------------------------------------- kernel
def lane_major(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, G) as a tensor whose storage is lane-major, [G][B]
    contiguous -- itself when it already is, else a copy."""
    b = x.shape[0]
    if x.stride() == (1, b) or (b == 1 and x.stride(1) == 1):
        return x
    return x.t().contiguous().t()


def alloc_scan_cuda(t: AllocScanTables,
                    frame: torch.Tensor) -> AllocScanResult:
    """The CUDA replay (``csrc/alloc_scan.cu``): bit-identical integers to
    :func:`alloc_scan_torch`, int32.

    ``frame`` is a (B, G) bool or uint8 CUDA tensor; lane-major storage
    (as :func:`~repro_torch.kernels.search_pipeline.enum_frames_cuda`
    writes it) is read in place, anything else is copied once.  A graph
    whose live lanes need more than ``MAX_SLOTS`` slots is refused.
    Launches the kernel or raises -- there is no other path."""
    from repro_torch.kernels import _build

    if t.slots.width > MAX_SLOTS:
        raise ValueError(
            f"alloc_scan_cuda: this graph keeps {t.slots.width} lanes live "
            f"at once, more than the {MAX_SLOTS} slots of shared memory the "
            f"kernel holds a candidate's state in; use the plain version")
    if t.k > MAX_FAN_IN:
        raise ValueError(f"alloc_scan_cuda: a group reads {t.k} producers, "
                         f"more than the kernel's {MAX_FAN_IN}; use the "
                         f"plain version")
    if not frame.is_cuda or frame.device != t.device:
        raise ValueError(f"alloc_scan_cuda wants a CUDA frame on the "
                         f"tables' device {t.device}, got {frame.device}")
    if frame.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"frame must be bool or uint8, got {frame.dtype}")
    if frame.ndim != 2 or frame.shape[1] != t.n:
        raise ValueError(f"frame must be (B, {t.n}), got "
                         f"{tuple(frame.shape)}")
    if not t.fits_int32:
        raise OverflowError(
            "this graph's byte totals could exceed int32, the kernel's "
            "integer width; use the plain version (int64)")
    B, n = frame.shape
    dev = t.device
    io = torch.empty((n, B), dtype=torch.int32, device=dev)
    stats = torch.empty((N_STATS, B), dtype=torch.int32, device=dev)
    if B == 0:
        return AllocScanResult(io=io.t(), stats=stats.t())
    frame_lm = lane_major(frame.view(torch.uint8)
                          if frame.dtype == torch.bool else frame)
    slots = t.dev["slots32"]
    lib = _build.load()
    ni = t.input_idx
    err = lib.alloc_scan_launch(
        frame_lm.data_ptr(), t.dev["steps32"].data_ptr(), slots.data_ptr(),
        io.data_ptr(), stats.data_ptr(), B, n, t.k, slots.shape[1],
        int(t.slots.slot[ni]), int(_meta(t.rem0[ni], t.loc0[ni])),
        t.slots.width, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "alloc_scan")
    alloc_scan_cuda.launches += 1
    return AllocScanResult(io=io.t(), stats=stats.t())


alloc_scan_cuda.launches = 0


def alloc_scan(t: AllocScanTables, frame: torch.Tensor,
               backend: str | None = None,
               skip: torch.Tensor | None = None) -> AllocScanResult:
    """Run the tensorized allocator replay for a B x G frame-mask batch.

    ``backend`` selects the implementation: ``"cuda"`` (the kernel;
    raises for a CPU tensor), ``"torch"`` (the plain version, wherever
    the tensor lies) or ``None`` -- by the tensor's device: the kernel
    for a CUDA tensor, the plain version only because the tensor lies on
    the CPU.  Both are bit-identical on every integer.

    ``skip`` (optional, bool (B,)) masks out batch lanes pruned by the
    branch-and-bound search before any replay work: skipped rows are
    compressed away, the surviving sub-batch runs through the selected
    backend unchanged, and the outputs are scattered back into
    zero-filled full-width matrices (``feasible`` is 1 on skipped lanes
    so downstream masking stays inert).  The surviving rows are
    bit-identical to an unskipped call on the same sub-batch."""
    if backend is None:
        backend = "cuda" if frame.is_cuda else "torch"
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown alloc_scan backend: {backend!r}")
    run = alloc_scan_cuda if backend == "cuda" else alloc_scan_torch
    if skip is None:
        return run(t, frame)
    b = frame.shape[0]
    if skip.shape != (b,):
        raise ValueError(f"skip mask shape {tuple(skip.shape)} != batch "
                         f"({b},)")
    keep = ~skip.to(torch.bool)
    sub = run(t, frame[keep])
    io = torch.zeros((b, t.n), dtype=sub.io.dtype, device=frame.device)
    stats = torch.zeros((b, N_STATS), dtype=sub.stats.dtype,
                        device=frame.device)
    stats[:, STAT_FEAS] = 1
    io[keep] = sub.io
    stats[keep] = sub.stats
    return AllocScanResult(io=io, stats=stats)
