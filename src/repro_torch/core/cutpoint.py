"""Cut-point optimizer (paper §IV).

A *block* is a residual block or a standalone group (Fig. 10); all groups in
a block share one reuse mode.  Feature-map sizes are monotone within runs of
blocks in modern CNNs, so the search space is restricted to one cut-point
per monotone run (Fig. 11/12): within a decreasing run, blocks after the cut
run frame-reuse (small maps fit on-chip); within an increasing run, blocks
before the cut run frame-reuse.  The optimum is found by exhaustive search
over the cross-product of cut positions, O(N^k) (paper §IV-B); when the
product blows past ``exhaustive_limit`` (many short runs, e.g. per-level
detector heads) we fall back to coordinate descent with restarts, which is
exact in practice because runs interact only through shared buffer maxima.

Search-engine architecture
--------------------------

``evaluate`` is the *oracle*: a from-scratch ``allocate()`` plus whole-graph
SRAM/DRAM/latency reports for one cut tuple.  The inner loop of ``search``
instead uses :class:`CutpointEngine`, which must agree with the oracle
bit-for-bit on every metric and is built from three pieces:

* **Prefix-cached allocation** -- the allocator's sequential state
  (:class:`~repro_torch.core.allocator.AllocState`: buffer liveness, spills,
  boundary sets) is checkpointed at monotone-run boundaries.  Changing the
  cut of run *r* replays ``alloc_step`` only from run *r*'s first group;
  with the odometer enumeration order below, most candidates replay a
  single run.
* **Vectorized cost models** -- per-group static quantities (sizes, MACs,
  weight bytes, row-mode traffic/latency, SRAM candidate terms) are
  tabulated into numpy arrays once per graph (``latency_tables`` /
  ``dram_tables`` / ``sram_tables``); each candidate's reports are masked
  array reductions over the frame/row mask plus the small boundary/spill
  deltas produced by the allocator, instead of per-group Python loops.
  Elementwise IEEE ops and left-to-right summation keep the results
  bit-identical to the scalar reports.
* **Smarter search** -- candidates are memoized by cut tuple, exhaustive
  enumeration walks ``itertools.product`` order (last run varies fastest,
  maximizing prefix reuse), and coordinate descent keeps the seed's move
  order (so its trajectory, and therefore its answer, is unchanged) while
  the memo absorbs re-visited tuples across sweeps and restarts.
* **Batched mask-matrix scoring** -- ``score_batch`` expands B cut tuples
  into a B x G frame-mask matrix plus a B x G boundary-IO matrix and
  prices all B candidates in one set of 2-D reductions
  (``latency_cycles_fast_batch`` / ``dram_fm_fast_batch`` /
  ``sram_total_fast_batch``), amortizing the per-candidate numpy
  dispatch that dominates per-tuple evaluation.  The per-candidate
  inputs come from an *incremental extraction* maintained during the
  checkpointed replays: the allocator journals boundary-set additions
  (``AllocState.j_*``) and the engine folds them into running io/DRAM/
  write-buffer/feasibility accumulators that are checkpointed next to
  the allocator state -- so a batch in product order replays and
  re-extracts only what each tuple changes.  ``search``/
  ``coordinate_descent`` consume this path behind the ``batch_size``
  knob (results and ``evaluated`` counts are identical for every batch
  size).
* **Device allocator replay** -- behind ``engine="device"`` (with
  ``:torch`` / ``:cuda`` variants), ``score_batch`` skips the Python
  replay altogether: the frame-mask matrix is computed directly from the
  cut tuples (three gathers) and the whole batch runs through the
  *tensorized allocator state machine* of ``kernels/alloc_scan.py`` --
  ``alloc_step`` re-expressed as a data-independent update rule over
  fixed-width integer arrays, stepped once over groups for all B
  candidates (a plain torch version and a CUDA kernel, both
  integer-exact).  The two replays are bit-identical, including memo
  contents and ``evaluations`` (tests/test_torch_compile.py).
* **Fused device search pipeline** -- behind ``engine="pipeline"`` (the
  default), exhaustive sub-spaces never materialize their candidate
  tuples on the host at all: ``kernels/search_pipeline.py`` enumerates
  cut tuples in-kernel from the product-order run tables, replays the
  allocator via ``alloc_scan``, reduces the exact costs, and runs a
  lexicographic argmin so only the winning ``(key, index)`` row comes
  back.  Dispatch happens through ``CutpointEngine.run_subspace`` -- the
  resolution point of the ``ReplayEngine`` protocol in
  ``core/options.py``.
* **Staged float32 scorer** -- behind ``backend="pallas"`` (the JAX
  package's spelling, kept so the two packages' plan keys agree),
  ``score_batch``'s latency sum, row-mode DRAM term and SRAM maxima run
  in float32 through ``kernels/score_batch.py`` (kernel K5 on a CUDA
  device).  Not oracle-exact, hence plan-affecting; its results never
  enter the memo.  Exhaustive sub-spaces under ``engine="pipeline"``
  still go through the exact fused pipeline.

Oracle contract: ``CutpointEngine.evaluate(cuts)`` returns the same
``latency_cycles`` / ``dram_total`` / ``dram_fm`` / ``sram_total`` /
``bram18k`` / ``feasible`` as ``evaluate(...)`` for *every* cut tuple
(tests/test_cutpoint_engine.py enforces this on the whole CNN zoo), and
``search`` materializes its winning tuple through the oracle, so the
returned Candidate is byte-identical to what the seed implementation
produced.

``search`` runs serially in-process at ``workers=1``; ``workers=None`` or
``> 1`` and ``resume_dir`` hand it to the process pool of
``core/search_pool.py``, whose workers run the same engine (and launch its
kernels) on disjoint sub-spaces or descent starts and merge to the
bit-identical result.
"""
from __future__ import annotations

import itertools
import warnings
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.allocator import (Allocation, Policy, alloc_bound_terms,
                                  allocate, alloc_step, frame_feasible,
                                  graph_steps, init_alloc_state,
                                  spill_is_long_path)
from repro_torch.core.dram import (dram_fm_fast, dram_fm_fast_batch, dram_report,
                             dram_tables)
from repro_torch.core.grouping import GroupedGraph
from repro_torch.core.hw import FPGAConfig
# DEFAULT_BATCH_SIZE / EXHAUSTIVE_LIMIT canonically live with the
# CompileOptions defaults; re-exported here for long-standing import sites.
from repro_torch.core.options import (DEFAULT_BATCH_SIZE,  # noqa: F401
                                      EXHAUSTIVE_LIMIT, CompileOptions,
                                      is_cuda_device, resolve_engine,
                                      resolve_options)
from repro_torch.core.sram import (sram_report, sram_tables, sram_total_fast,
                             sram_total_fast_batch)
from repro_torch.core.timing import (latency_cycles_fast,
                                     latency_cycles_fast_batch,
                                     latency_report, latency_tables, seq_sum)
from repro_torch.utils.tracing import span


# ------------------------------------------------------------------- blocks
@dataclass
class Block:
    bid: int
    gids: list[int]
    out_size: int                 # feature-map bytes at block output


def split_blocks(gg: GroupedGraph) -> list[Block]:
    """Residual blocks (groups up to and including a fused/standalone add
    whose shortcut source is inside the window) + standalone groups."""
    blocks: list[Block] = []
    current: list[int] = []
    open_shortcuts: set[int] = set()     # gids still awaited as shortcut src

    for g in gg.groups:
        current.append(g.gid)
        # does any later group take this one as a shortcut operand?
        for c in gg.group_consumers(g):
            cg = gg.groups[c]
            if cg.fused_add is not None and gg.shortcut_source_group(cg) == g.gid:
                if c - g.gid <= 8:       # short-path residual
                    open_shortcuts.add(g.gid)
        if g.fused_add is not None:
            src = gg.shortcut_source_group(g)
            open_shortcuts.discard(src)
        if not open_shortcuts:
            blocks.append(Block(bid=len(blocks), gids=current,
                                out_size=g.out_size))
            current = []
    if current:
        blocks.append(Block(bid=len(blocks), gids=current,
                            out_size=gg.groups[current[-1]].out_size))
    return blocks


def monotone_runs(blocks: list[Block]) -> list[list[int]]:
    """Split block indices into monotone runs of out_size (ties extend)."""
    if not blocks:
        return []
    runs: list[list[int]] = [[0]]
    direction = 0
    for i in range(1, len(blocks)):
        prev, cur = blocks[i - 1].out_size, blocks[i].out_size
        d = 0 if cur == prev else (1 if cur > prev else -1)
        if d == 0 or direction == 0 or d == direction:
            runs[-1].append(i)
            if d != 0:
                direction = d
        else:
            runs.append([i])
            direction = d
    return runs


def _run_direction(blocks: list[Block], run: list[int]) -> int:
    return 1 if blocks[run[-1]].out_size >= blocks[run[0]].out_size else -1


def policy_from_cuts(gg: GroupedGraph, blocks: list[Block],
                     runs: list[list[int]], cuts: tuple[int, ...]) -> Policy:
    """cut c in run r: for decreasing runs blocks[run[c:]] are frame-reuse;
    for increasing runs blocks[run[:c]] are frame-reuse."""
    mode_by_block: dict[int, str] = {}
    for run, cut in zip(runs, cuts):
        d = _run_direction(blocks, run)
        for pos, b in enumerate(run):
            if d < 0:
                mode_by_block[b] = "frame" if pos >= cut else "row"
            else:
                mode_by_block[b] = "frame" if pos < cut else "row"
    policy: Policy = {}
    for b, mode in mode_by_block.items():
        for gid in blocks[b].gids:
            policy[gid] = mode
    return policy


# ------------------------------------------------------------------- search
@dataclass
class Candidate:
    cuts: tuple[int, ...]
    policy: Policy
    alloc: Allocation
    latency_cycles: float
    dram_total: int
    dram_fm: int
    sram_total: int
    bram18k: int
    feasible: bool

    def ms(self, hw: FPGAConfig) -> float:
        return 1e3 * self.latency_cycles / hw.freq


@dataclass
class SearchResult:
    best: Candidate
    evaluated: int
    runs: list[list[int]]
    blocks: list[Block] = field(default_factory=list)
    # Fault/recovery events a parallel runtime
    # took to produce this result -- retries, journal resumes, straggler
    # duplicates, device-replay fallbacks.  Always empty on the serial
    # path and on fault-free parallel runs; deliberately excluded from
    # the bit-identity contract (same cuts/metrics/evaluated regardless
    # of what the run survived).
    events: list = field(default_factory=list)
    # Candidates eliminated by branch-and-bound pruning without being
    # scored (see branch_bound_subspace).  The argmin and its metrics are
    # bit-identical whether or not pruning ran; with the default
    # ``count_pruned=True`` accounting, ``evaluated`` includes these (so
    # it equals the full enumeration count exactly).  The split between
    # scored and pruned -- this field -- legitimately varies with worker
    # count and scheduling (later tasks inherit a better incumbent), so
    # like ``events`` it is excluded from the bit-identity contract.
    pruned: int = 0
    # Which search path produced the result: "exhaustive" (full
    # enumeration of the cut product, the guaranteed optimum) or
    # "descent" (coordinate descent beyond ``exhaustive_limit``).  A plan
    # cache records it so warm-start eligibility can be decided per
    # record.
    path: str = "exhaustive"


def evaluate(gg: GroupedGraph, blocks: list[Block], runs: list[list[int]],
             cuts: tuple[int, ...], hw: FPGAConfig) -> Candidate:
    policy = policy_from_cuts(gg, blocks, runs, cuts)
    alloc = allocate(gg, policy)
    sram = sram_report(gg, alloc, hw)
    dram = dram_report(gg, alloc)
    lat = latency_report(gg, alloc, hw)
    feasible = (sram.sram_total <= hw.sram_budget
                and frame_feasible(gg, policy, alloc))
    return Candidate(cuts=cuts, policy=policy, alloc=alloc,
                     latency_cycles=lat.cycles, dram_total=dram.total,
                     dram_fm=dram.fm_bytes, sram_total=sram.sram_total,
                     bram18k=sram.bram18k, feasible=feasible)


def _key(c, objective: str):
    big = not c.feasible
    if objective == "latency":
        return (big, c.latency_cycles, c.sram_total)
    if objective == "sram":
        return (big, c.sram_total, c.latency_cycles)
    if objective == "dram":
        return (big, c.dram_total, c.latency_cycles)
    raise ValueError(objective)


# ------------------------------------------------------- incremental engine
@dataclass(slots=True)
class CandidateMetrics:
    """Metrics of one cut tuple, without the policy/alloc payload.

    Attribute names mirror :class:`Candidate` so ``_key`` applies to both;
    ``search`` materializes only the winner into a full Candidate.
    Treated as immutable by convention (millions are constructed per
    exhaustive search, so the class stays a plain slots dataclass rather
    than paying ``frozen=True``'s per-field ``object.__setattr__``)."""
    cuts: tuple[int, ...]
    latency_cycles: float
    dram_total: int
    dram_fm: int
    sram_total: int
    bram18k: int
    feasible: bool


class CutpointEngine:
    """Incremental, oracle-exact evaluator of cut tuples (see module
    docstring).  Build once per (graph, hardware) pair; ``evaluate`` is then
    10-100x cheaper than the direct oracle, and cheapest when successive
    tuples share a long prefix of unchanged runs."""

    def __init__(self, gg: GroupedGraph, hw: FPGAConfig,
                 blocks: list[Block] | None = None,
                 runs: list[list[int]] | None = None,
                 backend: str = "numpy", engine: str = "journal",
                 device: str = "cpu"):
        self.gg = gg
        self.hw = hw
        # "numpy" (oracle-exact, default) or "pallas" (the staged float32
        # scorer of kernels/score_batch.py: K5 on a CUDA device, its plain
        # torch version on the CPU)
        if backend not in ("numpy", "pallas"):
            raise ValueError(f"unknown score_batch backend: {backend!r}")
        self.backend = backend
        # ``engine`` (an options.resolve_engine spelling) resolves onto
        # the replay mode of score_batch, the alloc_scan implementation
        # and, for the "pipeline" engine, the fused sub-space pipeline in
        # run_subspace.
        spec = resolve_engine(engine, device=device)
        self.device = device
        if ((spec.name != "journal" or backend == "pallas")
                and is_cuda_device(device)):
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"engine={engine!r}, backend={backend!r} resolved for "
                    f"device={device!r}, but this host has no CUDA device; "
                    f"pass device='cpu' (the plain torch versions) or "
                    f"engine='journal', backend='numpy' (host code)")
        # which score_batch implementation the staged scorer runs: the
        # kernel on a CUDA device, the plain version on the CPU or under an
        # explicit ":torch" engine variant
        self.score_backend = ("cuda" if is_cuda_device(device)
                              and spec.variant != "torch" else "torch")
        self._kt = None               # packed scorer tables, lazy
        # "journal" (per-candidate checkpointed Python replay) or "device"
        # (tensorized allocator scan over the whole batch, see
        # kernels/alloc_scan.py) -- the replay mode of score_batch.  Under
        # the pipeline engine score_batch keeps the journal replay (the
        # descent path is host-driven either way); run_subspace routes
        # exhaustive sub-spaces through the fused pipeline.
        self.replay = "device" if spec.name == "device" else "journal"
        self._pipeline = spec.variant if spec.name == "pipeline" else None
        # which alloc_scan implementation the device replay runs: "torch"
        # (plain) or "cuda" (the kernel); both integer-exact
        self.alloc_backend = spec.variant or "torch"
        self._at = None               # packed alloc-scan tables, lazy
        self.blocks = blocks if blocks is not None else split_blocks(gg)
        self.runs = runs if runs is not None else monotone_runs(self.blocks)
        self.dirs = [_run_direction(self.blocks, r) for r in self.runs]
        # groups of run r occupy the contiguous gid range run_span[r]
        self.run_span = [(self.blocks[r[0]].gids[0],
                          self.blocks[r[-1]].gids[-1] + 1)
                         for r in self.runs]
        # groups of block b occupy the contiguous gid range _block_span[b]
        self._block_span = [(b.gids[0], b.gids[-1] + 1) for b in self.blocks]
        self._lt = latency_tables(gg, hw)
        self._dt = dram_tables(gg)
        self._st = sram_tables(gg, hw)
        self._steps = graph_steps(gg)
        self._spill_ok: dict[int, bool] = {}
        n = len(gg.groups)
        self._frame = np.zeros(n, dtype=bool)
        self._io = np.zeros(n)
        # incremental cost extraction, updated run-by-run during replays
        # from the allocator's boundary journals and checkpointed next to
        # the allocator state: per-group frame-mode IO bytes, dram
        # boundary/spill byte total, eq. (5) frame write-buffer max, and
        # spill feasibility
        self._outsz = self._dt.out_size
        comp = self._st.compute.tolist()
        wft = self._st.wr_frame
        self._wr_cand = [wft[g] if comp[g] else 0 for g in range(n)]
        self._x_io: list = [0] * n
        self._x_bfm = 0
        self._x_wrf = 0
        self._x_feas = True
        self._x_cache: list = ([([0] * n, 0, 0, True)]
                               + [None] * len(self.runs))
        # checkpoint r = allocator state entering run r, valid for the
        # current materialized prefix cuts[:r] (lean: replays skip the
        # metrics-irrelevant assignment maps; the winner is materialized
        # through the full oracle)
        self._ckpts: list = ([init_alloc_state(gg, lean=True)]
                             + [None] * len(self.runs))
        # reused working state for replays (reset in place per replay;
        # the checkpoints themselves are real clone() snapshots)
        self._scratch = init_alloc_state(gg, lean=True)
        self._bram_memo: dict = {}
        self._cur: tuple[int, ...] | None = None
        # how many leading runs of _cur are actually materialized in the
        # scratch state / frame mask / extraction accumulators: full
        # replays set len(runs), prefix replays (prefix_bound) set their
        # depth, and checkpoints are only trusted up to this length
        self._cur_len = 0
        self._cache: dict[tuple[int, ...], CandidateMetrics] = {}
        self.evaluations = 0              # cache misses (actual replays)
        # per-group (run index, block position, direction) -- the whole
        # frame-mask matrix of a batch is then three gathers, no replay
        run_of = np.zeros(n, dtype=np.int64)
        pos_of = np.zeros(n, dtype=np.int64)
        dir_neg = np.zeros(n, dtype=bool)
        for r, run in enumerate(self.runs):
            d = self.dirs[r]
            for pos, b in enumerate(run):
                lo, hi = self._block_span[b]
                run_of[lo:hi] = r
                pos_of[lo:hi] = pos
                dir_neg[lo:hi] = d < 0
        self._run_of = run_of
        self._pos_of = pos_of
        self._dir_neg = dir_neg
        # ------------------------------ branch-and-bound floor tables
        # Static per-group completion floors for prefix_bound.  Latency:
        # a free (suffix) group costs at least min(row latency, frame
        # latency at zero boundary IO) -- the very IEEE ops of
        # latency_cycles_fast with io_bytes=0, so elementwise the floor
        # never exceeds the candidate's actual per-group term.  SRAM:
        # every suffix compute group contributes one of its eq. (4)
        # candidates to out_buff, so at least min(out_frame, out_row);
        # _sfx_minout[p] is the max of that floor over gids >= p.
        lt = self._lt
        bpc = hw.dram_bytes_per_cycle
        frame_floor = (np.maximum(lt.comp, lt.weight / bpc)
                       + hw.group_overhead_cycles)
        self._lat_floor = np.where(lt.side, lt.comp,
                                   np.minimum(lt.row, frame_floor))
        self._lat_lb = np.empty(n)        # reused per-bound scratch row
        st = self._st
        minout = np.where(st.compute,
                          np.minimum(st.out_frame, st.out_row), 0)
        sfx = [0] * (n + 1)
        for g in range(n - 1, -1, -1):
            sfx[g] = max(sfx[g + 1], int(minout[g]))
        self._sfx_minout = sfx

    def _replay(self, cuts: tuple[int, ...],
                rd: int | None = None,
                rend: int | None = None) -> Allocation:
        """Materialize the allocation for ``cuts`` (or a prefix of it).

        Finds the longest prefix of runs whose cuts match the engine's
        current tuple (callers that know it -- ``score_batch`` computes
        the whole batch's shared prefixes in one vectorized pass -- pass
        it as ``rd``), resets the reused scratch state to the allocator
        checkpoint at that run boundary (in-place container reuse: two
        C-level list copies plus clear+update on the small sets), and
        replays ``alloc_step`` only over the changed suffix (refreshing
        the downstream checkpoints, as real clones, along the way).  A
        batch walked in product order therefore replays each shared cut
        prefix exactly once.  On return, ``self._frame`` holds the
        candidate's frame mask; the returned Allocation is the scratch
        state's and is only valid until the next replay -- callers must
        extract what they need immediately.

        ``rend`` stops the replay after run ``rend - 1`` (default: all
        runs), leaving the scratch state, frame mask (up to the prefix's
        last gid) and extraction accumulators describing exactly the
        cut prefix ``cuts[:rend]`` -- this is what ``prefix_bound``
        evaluates its completion floors from.  A prefix replay writes
        the entering-run checkpoint at ``rend`` so sibling prefixes and
        surviving completions replay only what they change; when the
        requested prefix is already materialized (checkpoint match) the
        state is reset from the checkpoint with no replay at all."""
        runs = self.runs
        nr = len(runs)
        if rend is None:
            rend = nr
        if rd is None:
            # longest prefix of runs whose cuts are unchanged; only the
            # materialized prefix of _cur (and its checkpoints) may be
            # trusted after a prefix replay
            cur = self._cur
            if cur is None:
                rd = 0
            else:
                limit = self._cur_len
                rd = limit
                for r in range(limit):
                    if cuts[r] != cur[r]:
                        rd = r
                        break
                if rd >= rend:
                    if rend == nr and nr:
                        # identical tuple re-evaluated without a cache hit
                        # (e.g. memoize=False): replay the last run
                        rd = nr - 1
                    else:
                        # prefix already materialized: reset to its
                        # checkpoint, replay nothing
                        rd = rend
        # reset the scratch state to checkpoint rd in place, reusing its
        # containers (lean states: the journals are already drained and
        # the assignment maps stay empty, so neither needs touching)
        state = self._scratch
        ck = self._ckpts[rd]
        cka = ck.alloc
        sa = state.alloc
        sa.buff[:] = cka.buff
        sa.side_buff = cka.side_buff
        sp = sa.spilled
        sp.clear()
        sp.update(cka.spilled)
        bws = sa.boundary_writes
        bws.clear()
        bws.update(cka.boundary_writes)
        brd = sa.boundary_reads
        brd.clear()
        brd.update(cka.boundary_reads)
        state.remaining[:] = ck.remaining
        state.location[:] = ck.location
        lib = state.live_in_buffer
        lib.clear()
        lib.update(ck.live_in_buffer)
        x_io = self._x_io
        cio, bfm, wrf, feas = self._x_cache[rd]
        x_io[:] = cio
        frame = self._frame
        steps = self._steps
        ckpts = self._ckpts
        xcache = self._x_cache
        dirs = self.dirs
        spans = self._block_span
        alloc = state.alloc
        jw, jr, jsp = state.j_writes, state.j_reads, state.j_spills
        outsz = self._outsz
        wr_cand = self._wr_cand
        ok = self._spill_ok
        for r in range(rd, rend):
            if r > rd:
                ckpts[r] = state.clone()
                xcache[r] = (list(x_io), bfm, wrf, feas)
            cut = cuts[r]
            d = dirs[r]
            for pos, b in enumerate(runs[r]):
                fr = (pos >= cut) if d < 0 else (pos < cut)
                lo, hi = spans[b]
                frame[lo:hi] = fr
                mode = "frame" if fr else "row"
                for step in steps[lo:hi]:
                    alloc_step(state, step, mode)
            # drain this run's boundary-journal additions into the
            # incremental extraction (O(additions), not O(|sets|))
            if jr:
                br = alloc.boundary_reads
                for gid in jr:
                    v = br[gid]
                    x_io[gid] += v
                    bfm += v
                del jr[:]
            if jw:
                for gid in jw:
                    v = outsz[gid]
                    x_io[gid] += v
                    bfm += v
                    w = wr_cand[gid]
                    if w > wrf:
                        wrf = w
                del jw[:]
            if jsp:
                bw = alloc.boundary_writes
                for gid in jsp:
                    if gid not in bw:
                        v = outsz[gid]
                        x_io[gid] += v
                        bfm += v
                    sv = ok.get(gid)
                    if sv is None:
                        sv = ok[gid] = spill_is_long_path(self.gg, gid)
                    if not sv:
                        feas = False
                del jsp[:]
        if rend < nr and rd < rend:
            # trailing entering-run checkpoint of a prefix replay, so
            # extensions (deeper bounds, surviving completions) resume
            # here instead of re-walking the prefix
            ckpts[rend] = state.clone()
            xcache[rend] = (list(x_io), bfm, wrf, feas)
        self._cur = cuts
        self._cur_len = rend
        self._x_bfm = bfm
        self._x_wrf = wrf
        self._x_feas = feas
        return alloc

    def evaluate(self, cuts: tuple[int, ...],
                 memoize: bool = True) -> CandidateMetrics:
        """Metrics for one cut tuple.  ``memoize=False`` skips storing the
        result -- exhaustive enumeration visits every tuple exactly once,
        so caching there only costs memory (coordinate descent, which
        revisits tuples across sweeps and restarts, keeps the default)."""
        hit = self._cache.get(cuts)
        if hit is not None:
            return hit
        self.evaluations += 1
        gg = self.gg
        alloc = self._replay(cuts)

        # vectorized cost models over the allocation delta
        frame = self._frame
        io = self._io
        io[:] = 0.0
        for gid, rb in alloc.boundary_reads.items():
            io[gid] = rb
        out = self._dt.out_size
        for gid in alloc.boundary_writes:
            io[gid] += out[gid]
        for gid in alloc.spilled:
            if gid not in alloc.boundary_writes:
                io[gid] += out[gid]
        lat = latency_cycles_fast(self._lt, frame, io, self.hw)
        fm = dram_fm_fast(self._dt, frame, alloc)
        sram_total, bram = sram_total_fast(self._st, frame, alloc, self.hw)

        ok = self._spill_ok
        spills_ok = True
        for gid in alloc.spilled:
            v = ok.get(gid)
            if v is None:
                v = ok[gid] = spill_is_long_path(gg, gid)
            if not v:
                spills_ok = False
                break
        feasible = sram_total <= self.hw.sram_budget and spills_ok

        m = CandidateMetrics(cuts=cuts, latency_cycles=lat,
                             dram_total=fm + self._dt.weight_bytes,
                             dram_fm=fm, sram_total=sram_total,
                             bram18k=bram, feasible=feasible)
        if memoize:
            self._cache[cuts] = m
        return m

    # ------------------------------------------------- branch-and-bound
    def prefix_bound(self, cuts: tuple[int, ...], depth: int,
                     objective: str):
        """Admissible lower bound on the primary objective term over
        *every* completion of the cut prefix ``cuts[:depth]``.

        The bound is the exact prefix cost plus a nonnegative completion
        floor, both read off the checkpointed prefix replay:

        * **latency** -- prefix groups are priced with the exact per-group
          model at the *current* boundary-IO accumulator (``_x_io`` only
          grows as later runs allocate, and the frame-mode term is IEEE-
          monotone in io bytes); suffix groups take the static
          ``_lat_floor`` (min of row latency and zero-IO frame latency).
          The per-group floors are summed left-to-right in gid order --
          the same association as ``latency_cycles_fast`` -- so IEEE
          monotone addition keeps the total a true lower bound.
        * **sram** -- the replayed buffer maxima (monotone, see
          ``allocator.alloc_bound_terms``), the prefix's eq. (1)/(4)/(5)
          masked maxima, the running frame-write max ``_x_wrf``
          (monotone) and the static suffix out-buffer floor
          ``_sfx_minout``.  Integer-exact.
        * **dram** -- the prefix's masked row-traffic sum plus the
          running boundary/spill byte total ``_x_bfm`` (monotone) plus
          the constant weight traffic.  Integer-exact.

        Feasibility is assumed optimistically and the tie-break
        (secondary) term is floored at zero, so the pruner's bound key
        ``(False, lb, 0)`` never exceeds any completion's ``_key``.  At
        ``depth == len(runs)`` the bound equals the candidate's exact
        primary metric (the completion is unique) -- the differential
        gate in analysis/mutate.py kills deflated-bound mutations
        against exactly this property.

        Leaves the engine holding the prefix replay (``_cur_len ==
        depth``); full replays afterwards resume from its checkpoints.
        """
        nr = len(self.runs)
        if not 0 < depth <= nr:
            raise ValueError(f"prefix_bound depth {depth} outside "
                             f"1..{nr}")
        self._replay(cuts, rend=depth)
        pend = self.run_span[depth - 1][1]      # gids < pend are fixed
        frame = self._frame
        if objective == "latency":
            lt = self._lt
            hw = self.hw
            per = self._lat_lb
            per[:] = self._lat_floor
            io = np.asarray(self._x_io[:pend], dtype=np.float64)
            mem = (lt.weight[:pend] + io) / hw.dram_bytes_per_cycle
            frame_lat = (np.maximum(lt.comp[:pend], mem)
                         + hw.group_overhead_cycles)
            per[:pend] = np.where(lt.side[:pend], lt.comp[:pend],
                                  np.where(frame[:pend], frame_lat,
                                           lt.row[:pend]))
            # det: left-to-right association of latency_cycles_fast
            return seq_sum(per.tolist())
        if objective == "dram":
            row_pre = int(np.where(frame[:pend], 0,
                                   self._dt.row_fm[:pend]).sum())
            return row_pre + self._x_bfm + self._dt.weight_bytes
        if objective == "sram":
            st = self._st
            cm = st.compute[:pend]
            frm = cm & frame[:pend]
            rowm = cm & ~frame[:pend]
            wbuff = int(st.weight[:pend].max(where=rowm, initial=0))
            outf = int(st.out_frame[:pend].max(where=frm, initial=0))
            outr = int(st.out_row[:pend].max(where=rowm, initial=0))
            wrr = int(st.wr_row[:pend].max(where=rowm, initial=0))
            b0, b1, b2, side = alloc_bound_terms(self._scratch)
            if wbuff > b1:
                b1 = wbuff
            out_lb = max(outf, outr, self._sfx_minout[pend])
            write_lb = max(wrr, self._x_wrf)
            return (st.row_buff + out_lb + write_lb
                    + b0 + b1 + b2 + side)
        raise ValueError(objective)

    # ------------------------------------------------------- device replay
    def _frame_matrix(self, tuples: list) -> np.ndarray:
        """B x G frame-mask matrix straight from the cut tuples.

        Exactly the masks the checkpointed replay paints block-by-block
        (``policy_from_cuts`` semantics), but as three vectorized gathers
        -- no allocator involved, so the device replay can start from the
        masks alone."""
        nr = len(self.runs)
        b = len(tuples)
        if not nr or not b:
            return np.zeros((b, len(self.gg.groups)), dtype=bool)
        arr = np.fromiter(itertools.chain.from_iterable(tuples),
                          dtype=np.int64, count=b * nr).reshape(b, nr)
        cut = arr[:, self._run_of]
        pos = self._pos_of[None, :]
        return np.where(self._dir_neg[None, :], pos >= cut, pos < cut)

    def _device_replay(self, frame: np.ndarray, skip=None):
        """Tensorized allocator replay of a whole frame-mask batch
        (kernels/alloc_scan.py) under ``self.alloc_backend`` on
        ``self.device``.  ``skip`` masks pruned batch lanes out of the
        scan (their outputs come back zero-filled).  ``frame`` is the
        host's numpy mask matrix; returns ``(frame, result)`` as tensors on
        ``self.device``, where the staged scorer reads them in place."""
        import torch

        from repro_torch.kernels.alloc_scan import alloc_scan
        frame_t = torch.from_numpy(frame).to(self.device)
        if skip is not None:
            skip = torch.as_tensor(np.asarray(skip, dtype=bool),
                                   device=self.device)
        res = alloc_scan(self.alloc_tables(), frame_t,
                         backend=self.alloc_backend, skip=skip)
        if skip is not None:
            frame_t[skip] = True          # as the host mask below
        return frame_t, res

    def score_tables(self):
        """This graph's packed float32 scorer tables on ``self.device``
        (built on first use)."""
        if self._kt is None:
            from repro_torch.kernels.score_batch import pack_tables
            self._kt = pack_tables(self._lt, self._dt, self._st,
                                   device=self.device)
        return self._kt

    def alloc_tables(self):
        """This graph's packed allocator-scan tables on ``self.device``
        (built on first use)."""
        if self._at is None:
            from repro_torch.kernels.alloc_scan import pack_alloc_tables
            with span("pipeline.tables"):
                self._at = pack_alloc_tables(self.gg, self.hw,
                                             device=self.device)
        return self._at

    # ------------------------------------------------------ batched scoring
    def score_batch(self, cuts_batch, memoize: bool = True,
                    backend: str | None = None,
                    replay: str | None = None,
                    skip=None) -> list:
        """Metrics for a batch of B cut tuples in one set of 2-D reductions.

        The batch is expanded into a B x G frame-mask matrix plus a B x G
        boundary-I/O matrix (one allocator replay per *distinct* miss, in
        batch order, so a batch drawn from one sub-space in product order
        replays each shared cut prefix exactly once through the allocator
        checkpoints), and ``latency_cycles`` / ``dram_total`` / ``dram_fm``
        / ``sram_total`` / ``bram18k`` / ``feasible`` for all B candidates
        fall out of ``latency_cycles_fast_batch`` / ``dram_fm_fast_batch``
        / ``sram_total_fast_batch``.

        Contract: with the default "numpy" backend, element ``i`` of the
        returned list is bit-identical to ``evaluate(cuts_batch[i])`` --
        same IEEE elementwise ops, same left-to-right per-row summation
        order -- and the memo/``evaluations`` bookkeeping matches a
        per-tuple loop exactly: cache hits are returned (not recounted),
        duplicate tuples within a memoized batch are evaluated once, and
        ``memoize=False`` replays every element (as exhaustive enumeration
        wants).  ``backend="pallas"`` routes the latency sum, the row-mode
        DRAM term and the four SRAM maxima through the staged float32
        scorer (kernels/score_batch.py: K5 on a CUDA device, its plain
        version on the CPU) -- NOT oracle-exact; its results are never
        written into the memo, so ``evaluate``'s bit-exact contract on the
        same engine instance is preserved (cached exact entries are still
        served to pallas callers).  Under the journal replay the host's
        mask and io matrices are copied to the device once per batch;
        under the device replay the allocator kernel's matrices stay on
        the device and go straight into the scorer.

        ``skip`` (a length-B boolean mask, ``memoize=False`` only) marks
        batch lanes the caller has already pruned: the branch-and-bound
        walk (``branch_bound_subspace``) enqueues leaves batch-by-batch
        and the incumbent may improve before a batch flushes, so lanes
        whose recorded bound now exceeds the incumbent are skipped
        *before* any journal or device replay.  Skipped lanes return
        ``None``, are never replayed, and do not count toward
        ``evaluations``; surviving lanes are bit-identical to an
        unmasked call.

        ``replay`` selects how the per-candidate allocator quantities are
        produced: ``"journal"`` (default) is the checkpointed Python
        replay above; ``"device"`` builds the frame-mask matrix directly
        from the cut tuples and runs the whole batch through the
        tensorized allocator scan (kernels/alloc_scan.py, integer-exact
        under every ``alloc_backend``), leaving the journal checkpoints
        untouched.  Both produce bit-identical CandidateMetrics and the
        same memo/``evaluations`` bookkeeping, so every caller --
        ``search``, ``coordinate_descent``, ``compile_graph`` -- inherits
        the knob with byte-identical results.
        """
        if backend is None:
            backend = self.backend
        if backend not in ("numpy", "pallas"):
            raise ValueError(f"unknown score_batch backend: {backend!r}")
        if replay is None:
            replay = self.replay
        if replay not in ("journal", "device"):
            raise ValueError(f"unknown score_batch replay: {replay!r}")
        if skip is not None and memoize:
            raise ValueError("score_batch: skip requires memoize=False "
                             "(pruned lanes must not poison the memo)")
        cuts_batch = list(cuts_batch)
        out: list[CandidateMetrics | None] = [None] * len(cuts_batch)
        slots: list[tuple[int, int]] = []      # (batch index, miss index)
        if memoize:
            miss: list = []              # distinct tuples needing a replay
            pending: dict[tuple[int, ...], int] = {}
            for i, cuts in enumerate(cuts_batch):
                hit = self._cache.get(cuts)
                if hit is not None:
                    out[i] = hit
                    continue
                j = pending.get(cuts)
                if j is None:
                    j = pending[cuts] = len(miss)
                    miss.append(cuts)
                slots.append((i, j))
            if not miss:
                return out
        else:
            # exhaustive enumeration: every element replays, in order
            miss = cuts_batch
            if not miss:
                return out

        if replay == "device":
            # --- tensorized allocator scan over the whole batch: frame
            # masks straight from the cut tuples, one alloc_scan call for
            # every per-candidate quantity the reductions below need.
            # .tolist() materializes exact Python ints, so the assembled
            # CandidateMetrics (and the memo) are byte-identical to the
            # journal path's.
            from repro_torch.kernels.alloc_scan import AllocScanResult
            frame = self._frame_matrix(miss)
            dev_frame, res = self._device_replay(frame, skip=skip)
            if skip is None:
                self.evaluations += len(miss)
            else:
                self.evaluations += len(miss) - sum(map(bool, skip))
                # pruned lanes must not contribute row-mode DRAM/latency
                # terms in the 2-D reductions below (their metrics are
                # discarded, but keep them finite and cheap)
                frame[np.asarray(skip, dtype=bool)] = True
            # the stats come to the host; the io matrix stays where the
            # replay wrote it when the float32 scorer reads it
            res = AllocScanResult(io=res.io, stats=res.stats.cpu())
            io = (res.io if backend == "pallas"
                  else res.io.cpu().numpy().astype(np.float64))
            boundary_fm = res.bfm.tolist()
            feas_spills = res.feasible.tolist()
            cand_terms = [(b[0], b[1], b[2], s, w)
                          for b, s, w in zip(res.buff.tolist(),
                                             res.side_buff.tolist(),
                                             res.wrf.tolist())]
        else:
            # --- vectorized shared-prefix lengths: rd[j] = first run
            # whose cut differs from the *previously replayed* miss (the
            # engine replays the batch in order, so the previous replayed
            # miss *is* the engine's current tuple); the first replayed
            # miss compares against the engine's real current tuple
            # inside _replay.  With a skip mask the chain runs over the
            # surviving subsequence only -- a skipped lane never becomes
            # the engine's current tuple, so comparing across it would
            # desynchronize the checkpoints.
            nr = len(self.runs)
            todo = (miss if skip is None
                    else [c for c, s in zip(miss, skip) if not s])
            if len(todo) > 1 and nr:
                arr = np.fromiter(itertools.chain.from_iterable(todo),
                                  dtype=np.int64,
                                  count=len(todo) * nr).reshape(len(todo),
                                                                nr)
                neq = arr[1:] != arr[:-1]
                rds = np.where(neq.any(axis=1), neq.argmax(axis=1),
                               nr - 1).tolist()
            else:
                rds = []

            # --- replay each distinct surviving miss; the incremental
            # extraction state (self._x_*) holds the candidate-dependent
            # scalars afterwards, so the per-candidate work here is four
            # row/scalar copies.  Skipped lanes keep zero rows (their
            # assembled metrics are never read).
            n = len(self.gg.groups)
            frame = np.zeros((len(miss), n), dtype=bool)
            io_rows: list[list] = []             # per-candidate io vectors
            boundary_fm: list[int] = []          # dram boundary/spill bytes
            cand_terms: list[tuple] = []         # sram per-candidate terms
            feas_spills: list[bool] = []         # spill feasibility
            _replay = self._replay
            my_frame = self._frame
            x_io = self._x_io
            zero_row = [0] * n
            zero_terms = (0, 0, 0, 0, 0)
            ti = 0                               # index into todo/rds
            for j, cuts in enumerate(miss):
                if skip is not None and skip[j]:
                    io_rows.append(zero_row)
                    cand_terms.append(zero_terms)
                    boundary_fm.append(0)
                    feas_spills.append(True)
                    continue
                self.evaluations += 1
                alloc = _replay(cuts, rds[ti - 1] if ti else None)
                ti += 1
                frame[j] = my_frame
                io_rows.append(list(x_io))
                b = alloc.buff
                cand_terms.append((b[0], b[1], b[2], alloc.side_buff,
                                   self._x_wrf))
                boundary_fm.append(self._x_bfm)
                feas_spills.append(self._x_feas)
            io = np.asarray(io_rows, dtype=np.float64)

        # --- one set of 2-D reductions across the whole batch
        if backend == "pallas":
            from repro_torch.kernels.score_batch import score_stats
            # device replay: its mask and io tensors, never via the host
            st = score_stats(self.score_tables(),
                             dev_frame if replay == "device" else frame, io,
                             self.hw, backend=self.score_backend)
            lat = st.latency
            fm = dram_fm_fast_batch(self._dt, frame, boundary_fm,
                                    row_terms=st.row_fm)
            sram, bram = sram_total_fast_batch(
                self._st, frame, cand_terms, self.hw, maxima=st.maxima,
                bram_memo=self._bram_memo)
        else:
            lat = latency_cycles_fast_batch(self._lt, frame, io, self.hw)
            fm = dram_fm_fast_batch(self._dt, frame, boundary_fm)
            sram, bram = sram_total_fast_batch(
                self._st, frame, cand_terms, self.hw,
                bram_memo=self._bram_memo)

        # --- assemble CandidateMetrics in batch order.  Only oracle-exact
        # (numpy) results may enter the memo: evaluate() serves from it
        # under a bit-exactness contract, and float32 scorer results would
        # silently poison it.
        lat = lat.tolist()
        budget = self.hw.sram_budget
        wb = self._dt.weight_bytes
        store = memoize and backend == "numpy"
        cache = self._cache
        scored: list[CandidateMetrics | None] = []
        for j, cuts in enumerate(miss):
            if skip is not None and skip[j]:
                scored.append(None)
                continue
            fm_j = fm[j]
            sram_j = sram[j]
            m = CandidateMetrics(
                cuts=cuts, latency_cycles=lat[j],
                dram_total=fm_j + wb, dram_fm=fm_j, sram_total=sram_j,
                bram18k=bram[j],
                feasible=sram_j <= budget and feas_spills[j])
            if store:
                cache[cuts] = m
            scored.append(m)
        if not memoize:
            return scored
        for i, j in slots:
            out[i] = scored[j]
        return out

    # ------------------------------------------------- engine dispatch
    def run_subspace(self, prefix, suffix_dims, objective: str,
                     batch_size: int = DEFAULT_BATCH_SIZE,
                     incumbent_key=None, prune: bool = True):
        """Argmin over one sub-space, under this engine's execution mode.

        The single resolution point of the ``options.ReplayEngine``
        protocol: the serial ``search`` loop routes exhaustive sub-spaces
        through here.  Returns
        ``(best, pruned)`` exactly like :func:`branch_bound_subspace`.

        * journal / device engines -> the host-driven branch-and-bound
          walk (``branch_bound_subspace``), scoring through
          ``score_batch`` under the engine's replay mode;
        * the pipeline engine -> ``kernels/search_pipeline.py``'s fused
          enumerate + alloc-scan + reduce + argmin device loop, which
          scores the *whole* sub-space (no pruning -- every candidate is
          priced in-kernel, so ``pruned`` comes back 0 and ``evaluated``
          equals the full enumeration count, i.e. the journal path's
          count under the default ``count_pruned=True`` accounting).

        Both paths return the bit-identical ``(key, cuts)``-lexicographic
        winner (tests/test_torch_search_pipeline.py).
        """
        if self._pipeline is not None:
            from repro_torch.kernels.search_pipeline import pipeline_subspace
            return pipeline_subspace(self, tuple(prefix),
                                     list(suffix_dims), objective,
                                     batch_size=batch_size,
                                     variant=self._pipeline)
        return branch_bound_subspace(self, prefix, suffix_dims, objective,
                                     batch_size=batch_size,
                                     incumbent_key=incumbent_key,
                                     prune=prune)


# ------------------------------------------------------------------ search
# Largest cut-product space searched exhaustively; larger spaces fall back
# to coordinate descent.  8M covers yolov2's full 7.96M-tuple space, the
# workload the pipeline engine exists for.
# (EXHAUSTIVE_LIMIT / DEFAULT_BATCH_SIZE are re-exported from
# core/options.py at the top of this module.)

# Smallest subtree (number of completions under a shared cut prefix) worth
# a ``prefix_bound`` call: a bound costs roughly one checkpointed run
# replay plus a handful of masked reductions -- a few candidate scorings
# -- so bounding tiny subtrees loses even when every one of them prunes.
PRUNE_MIN_SUBTREE = 16


def branch_bound_subspace(engine: "CutpointEngine",
                          prefix: tuple[int, ...],
                          suffix_dims,
                          objective: str,
                          batch_size: int = DEFAULT_BATCH_SIZE,
                          incumbent_key=None,
                          prune: bool = True,
                          prune_min_subtree: int = PRUNE_MIN_SUBTREE):
    """Argmin over ``prefix x product(range(d + 1) for d in suffix_dims)``
    with exact branch-and-bound pruning.

    Returns ``(best, pruned)``: ``best`` is the first product-order
    optimum among scored candidates as a :class:`CandidateMetrics`
    (``None`` iff every completion was pruned -- only possible when an
    external ``incumbent_key`` already beats the whole sub-space), and
    ``pruned`` counts candidates eliminated without scoring.

    The walk is depth-first in ``itertools.product`` order.  At each
    internal node (a shared cut prefix) whose subtree holds at least
    ``prune_min_subtree`` completions, ``engine.prefix_bound`` prices the
    prefix; a bound key strictly above the incumbent kills the whole
    subtree, *before* any journal or device replay of its tuples.  The
    incumbent is the min of ``incumbent_key`` (best-so-far inherited from
    a caller that has already searched other sub-spaces) and the best
    candidate scored here.  Leaves are flushed
    through ``score_batch`` in ``batch_size`` chunks; because the
    incumbent can improve between enqueue and flush, each leaf remembers
    its deepest ancestor bound and the flush passes a ``skip`` mask for
    lanes that became prunable late -- so pruning composes with the
    batched scorer and the device replay instead of fighting them.

    Exactness (the repo's standing invariant): the bound is admissible
    (``prefix_bound``) and pruning requires *strictly* exceeding the
    incumbent, while every incumbent is a real candidate's key.  The
    product-order argmin -- the first tuple attaining the optimal key,
    which is also the ``(key, cuts)``-lexicographic optimum the parallel
    merge selects -- therefore can never be pruned: every ancestor bound
    of it is <= its own key <= every incumbent ever formed.  So the
    returned argmin and its metrics are bit-identical to the unpruned
    enumeration, for any incumbent timing, worker count, or resume
    schedule.  With ``prune=False`` the walk degenerates to exactly the
    chunked exhaustive enumeration (same ``score_batch`` calls in the
    same order, same ``engine.evaluations``).
    """
    nr = len(engine.runs)
    nr_pre = len(prefix)
    dims = [d + 1 for d in suffix_dims]
    nd = len(dims)
    ranges = [range(d) for d in dims]
    # subtree[j] = completions below a node with j suffix coords fixed
    subtree = [1] * (nd + 1)
    for j in range(nd - 1, -1, -1):
        subtree[j] = subtree[j + 1] * dims[j]
    # levels at or below which no bound check can fire -- their subtrees
    # enumerate in C through itertools.product instead of recursing
    can_check = [False] * (nd + 1)
    for j in range(nd - 1, -1, -1):
        here = (subtree[j + 1] >= prune_min_subtree
                and nr_pre + j + 1 < nr)
        can_check[j] = here or can_check[j + 1]

    best = None
    best_key = None
    inc = incumbent_key
    pruned = 0
    pend_t: list[tuple[int, ...]] = []
    pend_b: list = []               # deepest ancestor bound key per leaf
    bs = max(1, batch_size)

    def flush() -> None:
        nonlocal best, best_key, inc, pruned
        if not pend_t:
            return
        skip = None
        if prune and inc is not None:
            sk = [b is not None and b > inc for b in pend_b]
            n_skip = sum(sk)
            if n_skip:
                skip = sk
                pruned += n_skip
        for c in engine.score_batch(pend_t, memoize=False, skip=skip):
            if c is None:
                continue
            k = _key(c, objective)
            if best is None or k < best_key:
                best, best_key = c, k
                if inc is None or k < inc:
                    inc = k
        pend_t.clear()
        pend_b.clear()

    def enqueue_all(j: int, node: tuple[int, ...], bkey) -> None:
        # no bound can fire below this node: C-speed product enumeration
        for suffix in itertools.product(*ranges[j:]):
            pend_t.append(node + suffix)
            pend_b.append(bkey)
            if len(pend_t) >= bs:
                flush()

    def walk(j: int, node: tuple[int, ...], bkey) -> None:
        nonlocal pruned
        if j == nd:
            pend_t.append(node)
            pend_b.append(bkey)
            if len(pend_t) >= bs:
                flush()
            return
        if not prune or not can_check[j]:
            enqueue_all(j, node, bkey)
            return
        sub = subtree[j + 1]
        depth = nr_pre + j + 1
        check = sub >= prune_min_subtree and depth < nr
        for v in ranges[j]:
            child = node + (v,)
            ck = bkey
            if check and inc is not None:
                lb = engine.prefix_bound(
                    child + (0,) * (nr - len(child)), depth, objective)
                ck = (False, lb, 0)
                if ck > inc:
                    pruned += sub
                    continue
            walk(j + 1, child, ck)

    walk(0, tuple(prefix), None)
    flush()
    return best, pruned


def coordinate_descent(engine: "CutpointEngine", start: tuple[int, ...],
                       objective: str, on_eval=None,
                       batch_size: int = 1) -> CandidateMetrics:
    """One coordinate descent from ``start`` to its local optimum.

    The single definition of the descent trajectory -- move order, strict
    ``<`` improvement test, tie behavior -- shared by the serial loop in
    :func:`search` and any parallel per-start runner, whose bit-identity
    contract requires both to move in lock-step.  ``on_eval`` (if given)
    observes every requested cut tuple, e.g. to collect the visited set
    that reconstructs ``evaluated``.

    ``batch_size > 1`` pre-scores each coordinate sweep's trial tuples
    through ``score_batch`` (memoized) before the decision loop walks
    them.  The trajectory, the memo contents, the ``evaluations`` count
    and the ``on_eval`` sequence are unchanged: a sweep over run ``ri``
    only ever varies coordinate ``ri`` (so the trial set is known up
    front), and the one tuple the serial loop may skip -- the current
    point -- is always already memoized, so pre-scoring it costs no
    evaluation.
    """
    def ev(t: tuple[int, ...]) -> CandidateMetrics:
        if on_eval is not None:
            on_eval(t)
        return engine.evaluate(t)

    cuts = list(start)
    cur = ev(tuple(cuts))
    improved = True
    while improved:
        improved = False
        for ri, run in enumerate(engine.runs):
            scored: dict[tuple[int, ...], CandidateMetrics] | None = None
            if batch_size > 1:
                trials = [tuple(cuts[:ri] + [v] + cuts[ri + 1:])
                          for v in range(len(run) + 1)]
                scored = dict(zip(trials, engine.score_batch(trials)))
            for cand_cut in range(len(run) + 1):
                if cand_cut == cuts[ri]:
                    continue
                trial = list(cuts)
                trial[ri] = cand_cut
                if scored is not None:
                    if on_eval is not None:
                        on_eval(tuple(trial))
                    c = scored[tuple(trial)]
                else:
                    c = ev(tuple(trial))
                if _key(c, objective) < _key(cur, objective):
                    cur, cuts, improved = c, trial, True
    return cur


def descent_starts(blocks: list[Block],
                   runs: list[list[int]]) -> list[tuple[int, ...]]:
    """The three deterministic coordinate-descent start points: the exact
    all-row and all-frame policies (whose cut encoding depends on each
    run's direction) plus the run midpoints."""
    all_row = tuple(len(r) if _run_direction(blocks, r) < 0 else 0
                    for r in runs)
    all_frame = tuple(0 if _run_direction(blocks, r) < 0 else len(r)
                      for r in runs)
    return [all_row, all_frame, tuple(len(r) // 2 for r in runs)]


def valid_warm_start(cuts, runs: list[list[int]]) -> tuple[int, ...] | None:
    """Validate a warm-start cut tuple against this graph's run structure.

    Warm starts come from the compile service's plan cache (the nearest
    cached plan of the same net family on a different hw config); they
    are best-effort, so an incompatible tuple -- wrong arity, or a cut
    past some run's length -- returns ``None`` instead of raising.
    """
    if cuts is None:
        return None
    cuts = tuple(int(c) for c in cuts)
    if len(cuts) != len(runs):
        return None
    if any(not 0 <= c <= len(r) for c, r in zip(cuts, runs)):
        return None
    return cuts


def search(gg: GroupedGraph, hw: FPGAConfig,
           options: CompileOptions | None = None,
           *, guard=None, warm_start=None, **legacy) -> SearchResult:
    """Find the best cut tuple for ``gg`` on ``hw``.

    All knobs arrive as one
    :class:`repro_torch.core.options.CompileOptions` value -- see that
    class for the per-field reference (the single source of truth).
    Loose keyword knobs (``batch_size=64`` etc.) still work through the
    deprecation shim but emit
    :class:`~repro_torch.core.options.LegacyKnobWarning`.

    ``guard`` (a live preemption guard the process pool polls for a
    clean SIGTERM drain) and ``warm_start`` (a cut tuple from a plan
    cache) are not options: the former is a runtime object, the latter
    is derived per-request state.  ``workers=None`` or ``> 1`` and
    ``resume_dir`` route the search through
    :class:`repro_torch.core.search_pool.ParallelSearchDriver` (which
    polls ``guard``; the serial path has nothing to drain and ignores
    it).  On the exhaustive path a valid ``warm_start`` is
    scored through the direct oracle and seeds the branch-and-bound
    incumbent -- the result stays bit-identical to a cold search
    (including ``evaluated`` under the default ``count_pruned``
    accounting) because an incumbent that is a real candidate's key can
    never prune the product-order argmin.  On the coordinate-descent
    path it is appended as an extra deterministic start: the result can
    only improve, but ``evaluated`` (and, on ties, the argmin) may
    differ from a cold search -- which is why the service only promises
    hit/cold byte-identity for exhaustively-searched requests.

    Returns a :class:`SearchResult` whose ``best`` Candidate is
    materialized through the direct oracle, so it is exactly what the
    seed implementation produced for the same graph.
    """
    opts = resolve_options(options, legacy, site="search")
    if (opts.workers is None or opts.workers > 1
            or opts.resume_dir is not None):
        from repro_torch.core.search_pool import ParallelSearchDriver
        with ParallelSearchDriver(workers=opts.workers,
                                  max_retries=opts.max_retries,
                                  task_deadline_s=opts.task_deadline_s,
                                  guard=guard) as driver:
            return driver.search(gg, hw, opts, warm_start=warm_start)
    with span("search"):
        return _serial_search(gg, hw, opts, warm_start)


def _serial_search(gg: GroupedGraph, hw: FPGAConfig, opts: CompileOptions,
                   warm_start) -> SearchResult:
    """``search`` in this process: the exhaustive path or the descent."""
    with span("search.engine"):
        blocks = split_blocks(gg)
        runs = monotone_runs(blocks)
        engine = CutpointEngine(gg, hw, blocks, runs, backend=opts.backend,
                                engine=opts.engine, device=opts.device)
    space = 1
    for r in runs:
        space *= len(r) + 1
    spec = opts.engine_spec()
    objective, batch_size = opts.objective, spec.batch_size

    def materialize(best: CandidateMetrics, pruned: int = 0,
                    path: str = "exhaustive") -> SearchResult:
        # Re-run the winner through the direct oracle so the returned
        # Candidate (policy, alloc, metrics) is exactly what the direct
        # search would have produced.
        with span("search.oracle"):
            cand = evaluate(gg, blocks, runs, best.cuts, hw)
        evaluated = engine.evaluations
        if opts.count_pruned:
            evaluated += pruned
        return SearchResult(best=cand, evaluated=evaluated,
                            runs=runs, blocks=blocks, pruned=pruned,
                            path=path)

    ws = valid_warm_start(warm_start, runs)
    if space <= opts.exhaustive_limit:
        if space > 1_000_000 and not opts.prune:
            warnings.warn(
                f"exhaustive cut search over {space} tuples on a single "
                f"core; use engine='pipeline' to enumerate on the "
                f"device, keep prune=True, or lower exhaustive_limit to "
                f"fall back to coordinate descent",
                RuntimeWarning, stacklevel=3)
        # Warm start: price the cached cuts through the direct oracle
        # (not the engine, so ``evaluations`` bookkeeping is untouched)
        # and open branch-and-bound with that real candidate's key as
        # the incumbent.  Admissibility + strict-> pruning guarantee the
        # argmin still survives, so the result is bit-identical to a
        # cold search -- the warm start only prunes more, earlier.
        incumbent = None
        if ws is not None and opts.prune:
            incumbent = _key(evaluate(gg, blocks, runs, ws, hw), objective)
        # product order: the last run varies fastest, so consecutive tuples
        # share the longest possible checkpoint prefix; with prune=True
        # whole sub-spaces fall to the incumbent bound instead of being
        # walked at all.  The pipeline engine instead fuses the whole loop
        # on device -- see run_subspace / kernels/search_pipeline.py.
        best, pruned = engine.run_subspace(
            (), [len(r) for r in runs], objective,
            batch_size=batch_size, incumbent_key=incumbent,
            prune=opts.prune)
        # never all-pruned: any external incumbent is a candidate *inside*
        # this space, whose own subtree no admissible bound can eliminate
        assert best is not None
        return materialize(best, pruned)

    # Coordinate descent with deterministic restarts (descent_starts).
    # Move order matches the seed implementation exactly (same trajectory,
    # same answer); the engine's memo absorbs the tuples revisited across
    # sweeps and restarts, and trials for a given run reuse the shared
    # allocation prefix of all earlier runs.
    starts = descent_starts(blocks, runs)
    if ws is not None and ws not in starts:
        starts.append(ws)           # appended: ties still favor the cold
        #                             starts, a warm start only ever wins
        #                             by a strictly better key
    best = None
    for start in starts:
        cur = coordinate_descent(engine, start, objective,
                                 batch_size=batch_size)
        if best is None or _key(cur, objective) < _key(best, objective):
            best = cur
    assert best is not None
    return materialize(best, path="descent")


def sweep_single_cut(gg: GroupedGraph, hw: FPGAConfig) -> list[Candidate]:
    """Fig. 16/17: metrics vs the position of a single global cut-point:
    blocks < L row-reuse, >= L frame-reuse."""
    blocks = split_blocks(gg)
    out = []
    for L in range(len(blocks) + 1):
        policy: Policy = {}
        for b in blocks:
            mode = "row" if b.bid < L else "frame"
            for gid in b.gids:
                policy[gid] = mode
        alloc = allocate(gg, policy)
        sram = sram_report(gg, alloc, hw)
        dram = dram_report(gg, alloc)
        lat = latency_report(gg, alloc, hw)
        out.append(Candidate(
            cuts=(L,), policy=policy, alloc=alloc,
            latency_cycles=lat.cycles, dram_total=dram.total,
            dram_fm=dram.fm_bytes, sram_total=sram.sram_total,
            bram18k=sram.bram18k,
            feasible=(sram.sram_total <= hw.sram_budget
                      and frame_feasible(gg, policy, alloc))))
    return out
