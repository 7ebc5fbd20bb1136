"""Fused on-device sub-space search: enumerate -> replay -> score -> argmin.

The journal/device engines drive the exhaustive cut search from the host:
``branch_bound_subspace`` materializes every candidate tuple in Python,
batches them through ``score_batch``, and keeps the running winner on the
host.  This module fuses that whole loop into one device pipeline behind
``CompileOptions(engine="pipeline")``:

1. **In-kernel enumeration** -- a sub-space is ``prefix`` (fixed cuts for
   the leading runs) x the product order over ``suffix_dims``.  Product
   order over runs *is* lexicographic order of the cut tuples, so every
   candidate has a global linear index ``j in [0, S)`` with the last run
   varying fastest (``stride[q] = prod(dims[q+1:])``).  The index is
   decoded straight into the B x G frame-mask matrix (the same three
   gathers as ``CutpointEngine._frame_matrix``); the host never
   materializes the candidate tuple stream.
2. **Allocator replay** -- the decoded masks feed the tensorized allocator
   (``kernels/alloc_scan.py``), integer-exact.  An aligned block of
   candidates shares its leading runs' digits, so the replay of the groups
   before its :func:`shared_prefix` is done once a block, by one launch a
   sub-space that writes each block's state row, and each candidate's
   replay starts from its block's row; :func:`row_grain` picks the block.
3. **Cost reduction** -- the B x G mask-matrix reductions of
   ``timing/dram/sram.*_fast_batch``, evaluated in float64.  Every integer
   quantity is far below 2**53, so the int -> f64 embedding is exact and
   ``<=`` comparisons match the host's integer comparisons bit for bit.
   The latency total is the one order-sensitive float reduction: one
   group's term is added per step, in gid order (``timing.seq_sum``) --
   never a pairwise or parallel sum, which would break oracle exactness.
4. **Argmin** -- the objective key is the host's ``_key``:
   ``(infeasible, primary, secondary)``, tie-broken by the cut tuple, i.e.
   by the linear index ``j``.  The first lexicographic minimum of
   ``(infeas, primary, secondary, idx)`` is taken per block of the cost
   stage and then over the block rows, so one row per chunk is left.  Each
   ``idx`` is unique, so that row is the same in every reduction order.

Between the stages everything stays on the device.  The chunk rows are
read back once per sub-space and folded on the host by plain tuple
comparison; the final index is decoded back into cuts (mixed radix, last
run fastest) and the winner is re-priced through the engine's exact journal
oracle, so the returned ``CandidateMetrics`` is byte-identical to the
journal path's and the kernels only ever decide *which* candidate wins.
``evaluations`` is credited with the full enumeration count ``S``, which
equals the journal path's ``scored + pruned``.

Each stage has a plain torch version and a hand-written CUDA kernel
(``csrc/search_pipeline.cu``) beside it, bit-identical to each other:

* :func:`enum_frames_torch` / :func:`enum_frames_cuda` replace the TPU
  kernel ``repro/kernels/search_pipeline.py::_enum_kernel``.  A thread
  decodes V consecutive candidates (:func:`enum_frames_plan`): the
  mixed-radix digits of the first by division, once per run, the others by
  stepping them, and writes each group's V mask bytes lane-major as one
  store.  Bound by the bytes it writes (B x G).
* :func:`cost_rows_torch` / :func:`cost_rows_cuda` replace ``_cost_kernel``.
  A thread prices one candidate in a single pass over its G groups,
  accumulating the latency in a register in gid order -- the order the TPU
  version has to build from one-hot lane sums comes for free -- then the
  block of 256 candidates takes its argmin in shared memory.  The frame
  bytes and io words of the next window of ``COST_WINDOW`` groups are
  loaded, whatever the frame bits, while this window's arithmetic runs,
  and the table is read from shared memory.  A batch too small to fill the
  card takes ``COST_SPLIT`` threads a candidate, which leave their groups'
  latency terms in shared memory for one of them to add in gid order
  (:func:`cost_rows_plan`).  Compiled without multiply-add contraction; the
  division stays a division.  Its bound is the bytes it reads (mask + io, 5
  B per candidate and group); on the card its float64 arithmetic, not the
  bytes, sets its time.  Blocks run in no order, so the reduction across
  blocks waits for all of them: given a ``winner`` buffer, each block also
  posts its row to a scratch of the stream that holds NaN between launches,
  and block 0 reduces the posted rows as they arrive (a NaN row is not
  there yet) into the chunk's winner (K4's reduction, run inside K3's
  launch).
* :func:`argmin_rows_torch` / :func:`argmin_rows_cuda` replace
  ``_argmin_only_kernel``: the first lexicographic minimum of L rows, as a
  launch of its own for the callers outside the cut search.  One block,
  each thread's loads all in flight before it compares, then warp shuffles;
  bound by latency at the few thousand rows a chunk leaves.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.options import DEFAULT_BATCH_SIZE
from repro_torch.kernels import upload
from repro_torch.kernels.alloc_scan import (N_STATS, STAT_BFM, STAT_FEAS,
                                            STAT_SIDE, STAT_WRF,
                                            StateRows, alloc_prefix_cuda,
                                            alloc_scan, lane_major,
                                            state_row_width)
from repro_torch.utils import tracing
from repro_torch.utils.tracing import span

VARIANTS = ("torch", "cuda")
OBJECTIVES = ("latency", "sram", "dram")

# candidates per block of the cost stage (one output row per block),
# csrc/search_pipeline.cu COST_BLOCK
COST_BLOCK = 256
# the cost kernels' schedule (csrc/search_pipeline.cu WIN, TILE, SPLIT,
# STEP): with one thread a candidate, the loads of the next COST_WINDOW
# groups are issued before this window's arithmetic; with COST_SPLIT threads
# a candidate, each prices STEP / COST_SPLIT of every step of COST_STEP
# groups, with the loads of COST_AHEAD steps in flight; both read the table
# from shared memory COST_TILE groups at a time
COST_WINDOW = 4
COST_TILE = 64
COST_SPLIT = 4
COST_STEP = 2 * COST_SPLIT
COST_AHEAD = 2                       # steps the split kernel loads ahead

# candidates a thread of the enumeration kernel decodes and stores as one
# vector, widest first (csrc/search_pipeline.cu enum_frames_kernel<V>)
ENUM_VECTORS = (16, 4, 1)

# bytes the state rows of one sub-space may take (row_grain): the prefix
# launch writes them once and the chunks' replays read them
ROW_BUDGET = 256 << 20

# rows of PipelineTables.tab
_TAB_ROWS = ("lt_comp", "lt_row", "lt_weight", "lt_side", "dt_rowfm",
             "st_comp", "st_weight", "st_outf", "st_outr", "st_wrr")


# --------------------------------------------------------------- index math
def _space_strides(dims: tuple[int, ...]) -> tuple[int, ...]:
    """Mixed-radix strides of the product order (last run fastest)."""
    strides = [1] * len(dims)
    for q in range(len(dims) - 2, -1, -1):
        strides[q] = strides[q + 1] * dims[q + 1]
    return tuple(strides)


def _decode_index(idx: int, strides: tuple[int, ...],
                  dims: tuple[int, ...]) -> tuple[int, ...]:
    """Linear index -> suffix cut tuple (inverse of the in-kernel decode)."""
    return tuple((idx // s) % d for s, d in zip(strides, dims))


def shared_prefix(space: "SubSpace", run_of, lo: int, count: int) -> int:
    """The shared prefix ``g0`` of the candidates ``[lo, lo + count)``: the
    least group whose run's digit is not constant over them (``n`` when every
    run's is).  A free run's digit is constant when ``j // stride`` is, and
    its stride divides every earlier run's, so the runs whose digit varies
    are those from the first such run on; a fixed run never varies.  Every
    candidate of the range has the same frame bits on groups ``< g0``, so
    the allocator state entering group ``g0`` is the same for all of them
    (``alloc_prefix_kernel`` in ``csrc/alloc_scan.cu`` computes the same
    ``g0`` on the card)."""
    run_of = np.asarray(run_of)
    last = lo + count - 1
    npfx = len(space.prefix)
    q0 = next((npfx + q for q, s in enumerate(space.strides)
               if lo // s != last // s), None)
    if q0 is None:
        return len(run_of)
    return int(np.argmax(run_of >= q0))


def row_grain(space: "SubSpace", run_of, chunk: int,
              row_bytes: int) -> tuple[int, int] | None:
    """The grain of the state rows the replay of ``space``'s chunks of
    ``chunk`` starts from: ``(D, g1)``, a row a block of D consecutive
    candidates, every row starting at group ``g1``; ``None`` where no such
    block's rows fit.

    The candidates of an aligned block of a free run's stride, or of the
    whole sub-space, share the digits of the runs before the next run whose
    digit varies, so they share the allocator state entering its first group
    ``g1`` (the block's :func:`shared_prefix`); such a D divides the
    sub-space, so every block is whole and every row starts at ``g1``.  Of
    these, the D no larger than the chunk whose rows (``row_bytes`` each)
    fit in ``ROW_BUDGET`` that models the fewest group steps a candidate --
    its ``G - g1`` replayed, plus the ``g1`` of its block's row over the D
    candidates that share it; the larger D on a tie."""
    run_of = np.asarray(run_of).tolist()
    n, size, strides = len(run_of), space.size, space.strides
    # the first group at or past each run, n past the last: the
    # shared_prefix of an aligned block is that of the first free run
    # whose stride is below the block
    npfx = len(space.prefix)
    first = [n] * (npfx + len(strides) + 1)
    for g in reversed(range(n)):
        first[run_of[g]] = g
    for r in reversed(range(len(first) - 1)):
        first[r] = min(first[r], first[r + 1])
    best, grain, q = None, None, 0
    for block in sorted({size, *strides}, reverse=True):
        while q < len(strides) and strides[q] >= block:
            q += 1
        if block > chunk or -(-size // block) * row_bytes > ROW_BUDGET:
            continue
        g1 = first[npfx + q]
        steps = n - g1 + g1 / block
        if best is None or steps < best:
            best, grain = steps, (block, g1)
    return grain


def _fold(best, w):
    """Deterministic host fold of chunk winners: plain tuple comparison
    on ``(infeas, primary, secondary, idx)``.  Chunk index ranges are
    disjoint, so ties through the idx component are impossible and the
    fold order cannot matter."""
    w = (float(w[0]), float(w[1]), float(w[2]), float(w[3]))
    return w if best is None or w < best else best


# ------------------------------------------------------------- shared tables
@dataclass(frozen=True)
class PipelineTables:
    """One engine's static tables as tensors on ``device``."""
    n: int
    device: torch.device
    run_of: torch.Tensor       # (n,) int64 run index per group
    pos_of: torch.Tensor       # (n,) int64 block position inside its run
    dir_neg: torch.Tensor      # (n,) bool: the run's sizes decrease
    run_of32: torch.Tensor     # the same three for the kernel:
    pos_of32: torch.Tensor     # int32, int32, uint8
    dir_neg8: torch.Tensor
    tab: torch.Tensor          # (10, n) float64 static cost rows (_TAB_ROWS)
    bpc: float                 # DRAM bytes per cycle
    goc: float                 # group overhead cycles
    budget: int                # SRAM budget, bytes
    weight_bytes: int          # constant weight traffic
    row_buff: int              # eq. (3), policy-independent

    @classmethod
    def from_numpy(cls, d: dict, device="cpu") -> "PipelineTables":
        """Tables from plain numpy data: ``run_of`` / ``pos_of`` /
        ``dir_neg``, the ten ``_TAB_ROWS`` arrays and the five scalars
        ``bpc`` / ``goc`` / ``budget`` / ``weight_bytes`` / ``row_buff``."""
        run_of = np.asarray(d["run_of"]).astype(np.int64)
        pos_of = np.asarray(d["pos_of"]).astype(np.int64)
        dir_neg = np.asarray(d["dir_neg"]).astype(bool)
        tab = np.stack([np.asarray(d[name]).astype(np.float64)
                        for name in _TAB_ROWS])

        (tab, run_of_t, pos_of_t, dir_neg_t, run_of32, pos_of32,
         dir_neg8) = upload(device, tab, run_of, pos_of, dir_neg,
                            run_of.astype(np.int32), pos_of.astype(np.int32),
                            dir_neg.astype(np.uint8))
        # the tensors' own device: "cuda" has become "cuda:0" by now
        return cls(n=len(run_of), device=tab.device, run_of=run_of_t,
                   pos_of=pos_of_t, dir_neg=dir_neg_t, run_of32=run_of32,
                   pos_of32=pos_of32, dir_neg8=dir_neg8, tab=tab,
                   bpc=float(d["bpc"]), goc=float(d["goc"]),
                   budget=int(d["budget"]),
                   weight_bytes=int(d["weight_bytes"]),
                   row_buff=int(d["row_buff"]))


def _engine_tables(engine) -> PipelineTables:
    """Per-engine tables on the engine's device (built once and stashed on
    the engine, like its alloc tables)."""
    tbl = engine.__dict__.get("_pipeline_tables")
    if tbl is not None:
        return tbl
    lt, dt, st = engine._lt, engine._dt, engine._st
    hw = engine.hw
    with span("pipeline.tables"):
        tbl = PipelineTables.from_numpy({
            "run_of": engine._run_of, "pos_of": engine._pos_of,
            "dir_neg": engine._dir_neg,
            "lt_comp": lt.comp, "lt_row": lt.row, "lt_weight": lt.weight,
            "lt_side": lt.side, "dt_rowfm": dt.row_fm,
            "st_comp": st.compute, "st_weight": st.weight,
            "st_outf": st.out_frame, "st_outr": st.out_row,
            "st_wrr": st.wr_row,
            "bpc": hw.dram_bytes_per_cycle, "goc": hw.group_overhead_cycles,
            "budget": hw.sram_budget, "weight_bytes": dt.weight_bytes,
            "row_buff": st.row_buff,
        }, device=engine.device)
    engine._pipeline_tables = tbl
    return tbl


@dataclass(frozen=True)
class SubSpace:
    """A sub-space of the cut product: fixed ``prefix`` cuts for the
    leading runs, mixed-radix ``dims`` for the rest.  ``digits`` is the
    (3, nr) int64 device table both enumeration forms read: per run the
    fixed cut, the stride (0 marks a fixed run) and the dim."""
    prefix: tuple[int, ...]
    dims: tuple[int, ...]
    strides: tuple[int, ...]
    size: int
    digits: torch.Tensor

    @classmethod
    def make(cls, prefix, dims, device) -> "SubSpace":
        with span("pipeline.tables"):
            prefix = tuple(int(c) for c in prefix)
            dims = tuple(int(d) for d in dims)
            strides = _space_strides(dims)
            size = 1
            for d in dims:
                size *= d
            npfx = len(prefix)
            digits = np.zeros((3, npfx + len(dims)), dtype=np.int64)
            digits[0, :npfx] = prefix
            digits[1, npfx:] = strides
            digits[2, :npfx] = 1
            digits[2, npfx:] = dims
            [digits] = upload(device, digits)
            return cls(prefix=prefix, dims=dims, strides=strides, size=size,
                       digits=digits)


def _objective_code(objective: str) -> int:
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective: {objective!r}")
    return OBJECTIVES.index(objective)


def _pick(backend: str | None, x: torch.Tensor, what: str) -> bool:
    """True when the CUDA kernel is to run: asked for by name, or -- with
    no backend named -- because ``x`` lies on a CUDA device."""
    if backend is None:
        return x.is_cuda
    if backend not in VARIANTS:
        raise ValueError(f"unknown {what} backend: {backend!r}")
    return backend == "cuda"


def _stream_args(dev: torch.device) -> tuple[int, int]:
    return dev.index or 0, torch.cuda.current_stream(dev).cuda_stream


# K3's winner slots, one (4, cap) float64 scratch a (device, stream): a
# launch that takes the chunk's winner posts each block's row there, and its
# block 0 waits for every row to be there (no longer NaN), reduces them and
# sets them back to NaN.  So the launches on one stream, which run one after
# another, share one, and launches on two streams, which may overlap, never
# do.
_SLOTS: dict[tuple[int, int], torch.Tensor] = {}


def _winner_slots(dev: torch.device, blocks: int) -> torch.Tensor:
    key = _stream_args(dev)
    slots = _SLOTS.get(key)
    if slots is None or slots.shape[1] < blocks:
        # NaN on the stream it serves, ahead of its first launch; a larger
        # one replaces it, and the old one's memory goes only to later work
        # on this stream
        slots = _SLOTS[key] = torch.full((4, max(blocks, COST_BLOCK)),
                                         float("nan"), dtype=torch.float64,
                                         device=dev)
    return slots


# ------------------------------------------------------------ K2: enumerate
def enum_frames_torch(tbl: PipelineTables, space: SubSpace, lo: int,
                      count: int) -> torch.Tensor:
    """Frame masks (count, G) bool of the linear indices ``lo + i``."""
    j = lo + torch.arange(count, dtype=torch.int64, device=tbl.device)
    fixed, stride, dim = space.digits
    is_free = stride > 0
    digit = (j[:, None] // stride.clamp(min=1)[None, :]) % dim[None, :]
    cuts = torch.where(is_free[None, :], digit, fixed[None, :])
    cut = cuts[:, tbl.run_of]
    pos = tbl.pos_of[None, :]
    return torch.where(tbl.dir_neg[None, :], pos >= cut, pos < cut)


def enum_frames_plan(B: int) -> int:
    """Candidates V a thread of the enumeration kernel decodes: the widest
    of ``ENUM_VECTORS`` that divides ``B``, so that each thread's V bytes of
    a group row are whole and V-aligned (the row base ``g * B`` is a
    multiple of V)."""
    return next(v for v in ENUM_VECTORS if B % v == 0)


def enum_frames_cuda(tbl: PipelineTables, space: SubSpace, lo: int,
                     count: int) -> torch.Tensor:
    """The CUDA enumeration: (count, G) uint8 0/1, stored lane-major, V
    candidates a thread (:func:`enum_frames_plan`).  Launches the kernel or
    raises."""
    from repro_torch.kernels import _build

    if tbl.device.type != "cuda" or space.digits.device != tbl.device:
        raise ValueError(f"enum_frames_cuda wants CUDA tables, got "
                         f"{tbl.device} / {space.digits.device}")
    frame = torch.empty((tbl.n, count), dtype=torch.uint8, device=tbl.device)
    if count == 0:
        return frame.t()
    err = _build.load().enum_frames_launch(
        space.digits.data_ptr(), tbl.run_of32.data_ptr(),
        tbl.pos_of32.data_ptr(), tbl.dir_neg8.data_ptr(), frame.data_ptr(),
        lo, count, tbl.n, space.digits.shape[1], enum_frames_plan(count),
        *_stream_args(tbl.device))
    _build.check(err, "enum_frames")
    enum_frames_cuda.launches += 1
    return frame.t()


enum_frames_cuda.launches = 0


def enum_frames(tbl: PipelineTables, space: SubSpace, lo: int, count: int,
                backend: str | None = None) -> torch.Tensor:
    """Frame masks of ``count`` candidates from linear index ``lo``; the
    kernel on a CUDA device, the plain version only on the CPU, unless
    ``backend`` names one."""
    if _pick(backend, tbl.tab, "enum_frames"):
        return enum_frames_cuda(tbl, space, lo, count)
    return enum_frames_torch(tbl, space, lo, count)


# ----------------------------------------------------------------- K3: cost
@dataclass(frozen=True)
class CostPlan:
    """How :func:`cost_rows_cuda` launches its kernel."""
    split: bool         # COST_SPLIT threads a candidate, else one
    threads: int        # a block: COST_BLOCK candidates
    blocks: int         # ceil(B / COST_BLOCK): one output row each
    smem_bytes: int     # the table's tile, the split kernel's latency
    #                     terms, the block's argmin, the chunk's winner


def cost_rows_plan(B: int, sms: int = 132,
                   split: bool | None = None) -> CostPlan:
    """The launch of the cost stage on a chunk of ``B`` candidates: one
    thread a candidate, or -- with fewer blocks than two an SM of ``sms``,
    unless ``split`` says -- ``COST_SPLIT`` threads a candidate."""
    blocks = -(-B // COST_BLOCK)
    if split is None:
        split = blocks < 2 * sms
    tab = 8 * len(_TAB_ROWS) * COST_TILE
    if split:
        threads = COST_BLOCK * COST_SPLIT
        own = 8 * 2 * COST_STEP * COST_BLOCK
    else:
        threads = COST_BLOCK
        own = 8 * 4 * COST_BLOCK
    # and a key a warp for the chunk's winner
    return CostPlan(split=split, threads=threads, blocks=blocks,
                    smem_bytes=tab + own + 8 * 4 * (threads // 32))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cost_keys_torch(tbl: PipelineTables, frame: torch.Tensor,
                    io: torch.Tensor, stats: torch.Tensor, lo: int,
                    objective: str) -> torch.Tensor:
    """Per-candidate key lanes (4, B) float64:
    ``(infeas, primary, secondary, idx)`` with ``idx = lo + i``."""
    code = _objective_code(objective)
    f64 = torch.float64
    frame = frame.to(torch.bool)
    (comp, rowl, wlat, side, rowfm, scomp, swt, soutf, soutr,
     swrr) = tbl.tab
    side = side > 0
    scomp = scomp > 0
    B = frame.shape[0]
    mem = (wlat[None, :] + io.to(f64)) / tbl.bpc
    frame_lat = torch.maximum(comp[None, :], mem) + tbl.goc
    per = torch.where(side[None, :], comp[None, :],
                      torch.where(frame, frame_lat, rowl[None, :]))
    # det: the latency total adds one group column per step, in gid order
    lat = torch.zeros(B, dtype=f64, device=frame.device)
    for g in range(tbl.n):
        lat = lat + per[:, g]
    zero = torch.zeros((), dtype=f64, device=frame.device)
    # det: int-exact f64 terms; association-free
    rterm = torch.where(frame, zero, rowfm[None, :]).sum(dim=1)
    st = stats.to(f64)
    dram = rterm + st[:, STAT_BFM] + float(tbl.weight_bytes)
    rowm = scomp[None, :] & ~frame
    frm = scomp[None, :] & frame

    def masked_max(mask, row):
        return torch.where(mask, row[None, :], zero).amax(dim=1)

    wbuff = masked_max(rowm, swt)
    outf = masked_max(frm, soutf)
    outr = masked_max(rowm, soutr)
    wrr = masked_max(rowm, swrr)
    sram = (float(tbl.row_buff) + torch.maximum(outf, outr)
            + torch.maximum(wrr, st[:, STAT_WRF]) + st[:, 0]
            + torch.maximum(st[:, 1], wbuff) + st[:, 2]
            + st[:, STAT_SIDE])
    feasible = (sram <= float(tbl.budget)) & (st[:, STAT_FEAS] > 0)
    infeas = (~feasible).to(f64)
    idx = (lo + torch.arange(B, dtype=torch.int64,
                             device=frame.device)).to(f64)
    primary, secondary = ((lat, sram), (sram, lat), (dram, lat))[code]
    return torch.stack([infeas, primary, secondary, idx])


def cost_rows_torch(tbl: PipelineTables, frame: torch.Tensor,
                    io: torch.Tensor, stats: torch.Tensor, lo: int,
                    objective: str,
                    winner: torch.Tensor | None = None) -> torch.Tensor:
    """Cost stage, plain version: the winner row of every block of
    ``COST_BLOCK`` candidates, (4, ceil(B / COST_BLOCK)) float64; and, into
    ``winner`` (4,) when given, the chunk's winner over those rows."""
    keys = cost_keys_torch(tbl, frame, io, stats, lo, objective)
    B = keys.shape[1]
    nb = -(-B // COST_BLOCK)
    padded = torch.full((4, nb * COST_BLOCK), float("inf"),
                        dtype=torch.float64, device=keys.device)
    padded[:, :B] = keys
    rows = argmin_rows_torch(padded.view(4, nb, COST_BLOCK))
    if winner is not None:
        winner.copy_(argmin_rows_torch(rows))
    return rows


def cost_rows_cuda(tbl: PipelineTables, frame: torch.Tensor,
                   io: torch.Tensor, stats: torch.Tensor, lo: int,
                   objective: str, split: bool | None = None,
                   winner: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA cost stage: (4, ceil(B / COST_BLOCK)) float64, bit-equal to
    :func:`cost_rows_torch`.  ``frame`` (B, G) bool/uint8, ``io`` (B, G)
    and ``stats`` (B, 7) integer CUDA tensors; lane-major int32 storage
    (as the allocator kernel writes it) is read in place, anything else is
    converted once.  ``split``: ``COST_SPLIT`` threads a candidate or one
    (:func:`cost_rows_plan` picks when None).  ``winner``: a contiguous (4,)
    float64 tensor on the same device, which the launch's block 0 fills
    with the chunk's winner (counted in ``argmin_rows_cuda.fused_launches``).
    The blocks post their rows to the winner slots of the current stream
    (``_winner_slots``: one scratch a device and stream, NaN again after each
    launch), so launches on one stream use theirs in turn and launches on
    two streams never share one.  Launches the kernel or raises."""
    from repro_torch.kernels import _build

    code = _objective_code(objective)
    dev = tbl.device
    for name, x in (("frame", frame), ("io", io), ("stats", stats)):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"cost_rows_cuda wants {name} on the tables' "
                             f"CUDA device {dev}, got {x.device}")
    B = frame.shape[0]
    if frame.shape != (B, tbl.n) or io.shape != (B, tbl.n) \
            or stats.shape != (B, N_STATS):
        raise ValueError(
            f"cost_rows_cuda: frame {tuple(frame.shape)}, io "
            f"{tuple(io.shape)}, stats {tuple(stats.shape)} do not fit "
            f"B={B}, G={tbl.n}")
    if frame.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"frame must be bool or uint8, got {frame.dtype}")
    if winner is not None and (
            winner.device != dev or winner.dtype != torch.float64
            or winner.shape != (4,) or not winner.is_contiguous()):
        raise ValueError(f"cost_rows_cuda wants the winner as a contiguous "
                         f"(4,) float64 tensor on {dev}, got "
                         f"{tuple(winner.shape)} {winner.dtype} on "
                         f"{winner.device}")
    nb = -(-B // COST_BLOCK)
    out = torch.empty((4, nb), dtype=torch.float64, device=dev)
    if B == 0:
        return out
    frame_lm = lane_major(frame.view(torch.uint8)
                          if frame.dtype == torch.bool else frame)
    io_lm = lane_major(io.to(torch.int32))
    stats_lm = lane_major(stats.to(torch.int32))
    plan = cost_rows_plan(B, sms=_sm_count(dev.index or 0), split=split)
    if winner is None:
        fused = (None, None, 0)
    else:
        slots = _winner_slots(dev, nb)
        fused = (winner.data_ptr(), slots.data_ptr(), slots.shape[1])
    err = _build.load().cost_rows_launch(
        frame_lm.data_ptr(), io_lm.data_ptr(), stats_lm.data_ptr(),
        tbl.tab.data_ptr(), out.data_ptr(), *fused, lo, lo + B, B, tbl.n,
        tbl.bpc, tbl.goc, float(tbl.budget), float(tbl.weight_bytes),
        float(tbl.row_buff), code, int(plan.split), *_stream_args(dev))
    _build.check(err, "cost_rows")
    cost_rows_cuda.launches += 1
    if winner is not None:
        argmin_rows_cuda.fused_launches += 1
    return out


cost_rows_cuda.launches = 0


def cost_rows(tbl: PipelineTables, frame, io, stats, lo: int,
              objective: str, backend: str | None = None,
              winner: torch.Tensor | None = None) -> torch.Tensor:
    """Block winner rows of a chunk, and the chunk's winner into ``winner``
    when given; the kernel for CUDA tensors, the plain version only for CPU
    tensors, unless ``backend`` names one."""
    if _pick(backend, frame, "cost_rows"):
        return cost_rows_cuda(tbl, frame, io, stats, lo, objective,
                              winner=winner)
    return cost_rows_torch(tbl, frame, io, stats, lo, objective,
                           winner=winner)


# --------------------------------------------------------------- K4: argmin
def argmin_rows_torch(lanes: torch.Tensor) -> torch.Tensor:
    """First lexicographic minimum along the last axis of (4, ..., L)
    float64 lanes ``(infeas, primary, secondary, idx)`` -> (4, ...).

    Nested masked minima: each level keeps only the lanes that achieved
    the previous minima, then minimizes the next key component over them;
    the last level minimizes the (unique) lane index, so ties on the full
    key resolve to the *first* lane -- the host merge's ``(objective key,
    cut tuple)`` order, since index order is cut-tuple order.  The result
    is that lane's own key, so a -0.0 and a +0.0, which tie, come back as
    the winner holds them, as the kernels' comparisons leave them."""
    infeas, primary, secondary, idx = lanes
    inf = torch.full((), float("inf"), dtype=lanes.dtype,
                     device=lanes.device)
    i_min = infeas.amin(dim=-1, keepdim=True)
    m0 = infeas == i_min
    p_min = torch.where(m0, primary, inf).amin(dim=-1, keepdim=True)
    m1 = m0 & (primary == p_min)
    s_min = torch.where(m1, secondary, inf).amin(dim=-1, keepdim=True)
    m2 = m1 & (secondary == s_min)
    i_win = torch.where(m2, idx, inf).amin(dim=-1, keepdim=True)
    first = (m2 & (idx == i_win)).to(torch.uint8).argmax(dim=-1,
                                                          keepdim=True)
    return lanes.gather(-1, first.expand(lanes.shape[:-1] + (1,))).squeeze(-1)


def argmin_rows_cuda(lanes: torch.Tensor) -> torch.Tensor:
    """The CUDA argmin: (4, L) float64 -> (4,) float64.  Launches the
    kernel or raises.  The cut search does not call it: its chunk winners
    are K4's reduction run by K3's block 0, counted apart in
    ``fused_launches``."""
    from repro_torch.kernels import _build

    if not lanes.is_cuda:
        raise ValueError(f"argmin_rows_cuda wants a CUDA tensor, got "
                         f"{lanes.device}")
    if lanes.dtype != torch.float64 or lanes.ndim != 2 \
            or lanes.shape[0] != 4 or lanes.shape[1] == 0:
        raise ValueError(f"argmin_rows_cuda wants (4, L>0) float64 lanes, "
                         f"got {tuple(lanes.shape)} {lanes.dtype}")
    lanes = lanes.contiguous()
    out = torch.empty(4, dtype=torch.float64, device=lanes.device)
    err = _build.load().argmin_rows_launch(
        lanes.data_ptr(), out.data_ptr(), lanes.shape[1],
        *_stream_args(lanes.device))
    _build.check(err, "argmin_rows")
    argmin_rows_cuda.launches += 1
    return out


argmin_rows_cuda.launches = 0
argmin_rows_cuda.fused_launches = 0       # in cost_rows_cuda's launches


def argmin_rows(lanes: torch.Tensor,
                backend: str | None = None) -> torch.Tensor:
    """Winner row of (4, L) key lanes; the kernel for a CUDA tensor, the
    plain version only for a CPU tensor, unless ``backend`` names one."""
    if _pick(backend, lanes, "argmin_rows"):
        return argmin_rows_cuda(lanes)
    return argmin_rows_torch(lanes)


def argmin_lanes(infeas, primary, secondary, idx,
                 backend: str | None = None, device="cpu") -> tuple:
    """Winner of a batch of objective keys: ``(infeas, primary,
    secondary, idx)`` of the first lane attaining the lexicographic
    minimum key.  The four lanes are array-likes of one length; they are
    moved to ``device`` and reduced by :func:`argmin_rows`."""
    cols = [np.asarray(c, dtype=np.float64)
            for c in (infeas, primary, secondary, idx)]
    if not (cols[0].shape == cols[1].shape == cols[2].shape == cols[3].shape
            and cols[0].ndim == 1 and cols[0].size):
        raise ValueError("argmin_lanes wants four equal-length 1-D lanes")
    lanes = torch.from_numpy(np.stack(cols)).to(device)
    w = argmin_rows(lanes, backend=backend).tolist()
    return (w[0], w[1], w[2], int(w[3]))


# ------------------------------------------------------------------ entrypoint
def run_chunks(engine, space: SubSpace, objective: str, chunk: int,
               variant: str) -> torch.Tensor:
    """The device loop: one winner row per chunk of ``chunk`` candidates,
    (nchunks, 4) float64 on the engine's device, each written by the
    chunk's cost stage.  Under the kernels, one launch first writes the
    state rows (``alloc_prefix_cuda``: the allocator state the candidates
    of a block share up to their first differing group), at the grain
    :func:`row_grain` picks, and each candidate's replay starts from its
    block's row; where no grain's rows fit, every replay starts at group 0.
    Nothing is read back here and nothing synchronises.

    While a profiler records, each chunk adds to two counters, at the
    chunk's grain whatever the rows' grain (the benchmark's readers define
    them so): its shared cut prefix ``g0`` times its candidates to
    ``alloc.shared_prefix_steps`` (under the kernels only), and the side
    groups at or past that ``g0`` (0 without rows) times its candidates to
    ``alloc.side_steps``.  A chunk of D or more candidates varies in every
    run a block of D varies in, so its rows start at ``g1 >= g0`` and the
    replay skips at least that much."""
    tbl = _engine_tables(engine)
    at = engine.alloc_tables()
    los = range(0, space.size, chunk)
    winners = torch.empty((len(los), 4), dtype=torch.float64,
                          device=tbl.device)
    with span("pipeline.enqueue"):
        grain = (row_grain(space, engine._run_of, chunk,
                           4 * state_row_width(at))
                 if _pick(variant, tbl.tab, "alloc_scan") else None)
        rows = (None if grain is None
                else alloc_prefix_cuda(at, tbl, space, grain[0]))
        for k, lo in enumerate(los):
            count = min(chunk, space.size - lo)
            frame = enum_frames(tbl, space, lo, count, backend=variant)
            res = (alloc_scan(at, frame, backend=variant) if rows is None
                   else alloc_scan(at, frame, backend=variant,
                                   state=StateRows(rows, grain[0], lo)))
            cost_rows(tbl, frame, res.io, res.stats, lo, objective,
                      backend=variant, winner=winners[k])
            if tracing.recording():
                g0 = 0
                if rows is not None:
                    g0 = shared_prefix(space, engine._run_of, lo, count)
                    tracing.count("alloc.shared_prefix_steps", g0 * count)
                tracing.count("alloc.side_steps",
                              int(at.is_side[g0:].sum()) * count)
    return winners


def pipeline_subspace(engine, prefix, suffix_dims, objective: str,
                      batch_size: int = DEFAULT_BATCH_SIZE,
                      variant: str = "torch"):
    """Argmin over one sub-space through the fused device pipeline.

    Drop-in for ``branch_bound_subspace``'s return contract:
    ``(CandidateMetrics, pruned)`` with the bit-identical
    ``(key, cuts)``-lexicographic winner.  Every candidate is priced on
    the device (no pruning), so ``pruned`` is always 0 and the engine's
    ``evaluations`` is credited with the full enumeration count --
    matching the journal path's ``scored + pruned`` total exactly.  The
    winner itself is re-priced through the engine's exact journal
    scorer, so the returned metrics never depend on kernel arithmetic.

    ``variant`` is ``"cuda"`` (the kernels K2, K1, and K3 with K4's
    reduction in its block 0) or ``"torch"`` (their plain versions), on
    ``engine.device``; ``batch_size`` is the chunk.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective: {objective!r}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown pipeline variant: {variant!r}")
    nr = len(engine.runs)
    if len(prefix) + len(suffix_dims) != nr:
        raise ValueError(f"prefix ({len(prefix)}) + suffix "
                         f"({len(suffix_dims)}) must cover all {nr} runs")
    space = SubSpace.make(prefix, [int(d) + 1 for d in suffix_dims],
                          engine.device)
    before = engine.evaluations

    def finish(cuts):
        with span("search.reprice"):
            [m] = engine.score_batch([cuts], memoize=False,
                                     replay="journal")
        engine.evaluations = before + space.size
        return m, 0

    if space.size == 1:
        return finish(space.prefix + (0,) * len(space.dims))
    rows = run_chunks(engine, space, objective, max(1, int(batch_size)),
                      variant)
    best = None
    with span("pipeline.readback"):
        # the one read-back per sub-space: it waits for the last chunk
        for row in rows.cpu().tolist():
            best = _fold(best, row)
    assert best is not None and best[0] <= 1.0
    return finish(space.prefix
                  + _decode_index(int(best[3]), space.strides, space.dims))
