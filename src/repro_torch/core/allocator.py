"""Reuse-aware static memory allocation (paper Algorithm 1, §IV-A).

Given a grouped graph and a data-reuse policy L (mode per group, 'row' or
'frame'), statically assign the three interchangeable physical buffers
{0,1,2} to the input / output / shortcut tensors of every frame-mode group,
maximising on-chip shortcut reuse.  Buffer sizes are the max over all
tensors assigned to each buffer (Algorithm 1).

Deviations from the paper, all conservative:
  * allocation is simulated with exact liveness at *group* granularity
    (instructions are per group, Fig. 5b), which reproduces the paper's
    hand-drawn allocations of Fig. 13 for plain / residual / SE blocks;
  * tensors that cannot be held (no free buffer, e.g. FPN lateral data and
    concat operands -- the paper's "long-path" data) are spilled to DRAM,
    exactly as §IV-A prescribes for long-lifetime data;
  * small SE side-path tensors (global-pool + FC outputs) live in a
    dedicated side space, as in Fig. 13(c)/(d).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from repro_torch.core.grouping import Group, GroupedGraph

NUM_BUFFERS = 3
SIDE_THRESHOLD = 64 << 10           # tensors <= 64 KB ride in the side space
GRAPH_INPUT = -1                    # pseudo producer id of the input image

# Integer encoding of ``AllocState.location`` shared by the export/import
# round-trip below and the scan-style device replay (kernels/alloc_scan.py):
# buffer ids {0,1,2} map to themselves, the two symbolic locations get the
# codes past the last buffer, and an empty ``live_in_buffer`` slot is
# ``LIVE_EMPTY`` (safe: real gids are >= 0 and the graph input never owns a
# buffer).
LOC_SIDE = NUM_BUFFERS
LOC_DRAM = NUM_BUFFERS + 1
LIVE_EMPTY = -1

Policy = dict[int, str]             # gid -> 'row' | 'frame'


@dataclass
class Allocation:
    policy: Policy
    alloc_in: dict[int, int] = field(default_factory=dict)
    alloc_out: dict[int, int] = field(default_factory=dict)
    alloc_shortcut: dict[int, int] = field(default_factory=dict)
    buff: list[int] = field(default_factory=lambda: [0] * NUM_BUFFERS)
    side_buff: int = 0
    # gids whose output was spilled to DRAM although produced in frame mode
    spilled: set[int] = field(default_factory=set)
    # gids whose output additionally crosses a frame->row/final boundary
    boundary_writes: set[int] = field(default_factory=set)
    # frame gids reading (an) input from DRAM (row->frame boundary, spill
    # re-reads, concat gathers).  gid -> bytes read
    boundary_reads: dict[int, int] = field(default_factory=dict)

    @property
    def total_fm_buffer(self) -> int:
        return sum(self.buff) + self.side_buff


def _is_side(gg: GroupedGraph, g: Group) -> bool:
    """SE side-path groups (global-pool / FC chains with tiny outputs)."""
    return (g.head.kind in ("fc", "globalpool")
            and g.out_size <= SIDE_THRESHOLD
            and g.head.out_h == 1 and g.head.out_w == 1)


@dataclass
class AllocState:
    """Full sequential allocator state after processing a prefix of groups.

    The allocator walks groups in gid order; everything it carries between
    iterations lives here, so a snapshot taken at any group boundary can be
    cloned and replayed forward (the cut-point engine checkpoints these at
    monotone-run boundaries to make candidate evaluation incremental, and
    ``score_batch`` replays each shared cut prefix of a batch exactly once
    from these checkpoints).

    ``remaining`` and ``location`` are flat per-gid lists rather than
    dicts: a checkpoint clone is then two C-level list copies, which is
    what keeps the millions of per-candidate replays of a batched
    exhaustive search cheap.  Index ``-1`` (Python's last-element alias)
    is the ``GRAPH_INPUT`` pseudo producer, so ``remaining[src]`` /
    ``location[src]`` work verbatim for real gids and the graph input.

    ``lean=True`` (the search engines) skips recording the
    ``alloc_in``/``alloc_out``/``alloc_shortcut`` assignment maps: they
    never influence metrics, and the winning tuple is re-materialized
    through the full oracle anyway, so the engine neither writes nor
    clones them."""
    alloc: Allocation
    # consumer counts not yet satisfied, per gid ([-1] = graph input)
    remaining: list[int]
    # location of each produced tensor: buffer id, 'side', or 'dram'
    location: list[int | str]
    # buffer id -> producing gid currently held live
    live_in_buffer: dict[int, int]
    # skip the assignment-map record keeping (search-engine replays)
    lean: bool = False
    # journals of boundary-set additions since the caller last cleared
    # them: each ``alloc_step`` that grows ``boundary_writes`` /
    # ``boundary_reads`` / ``spilled`` appends the gid here.  The search
    # engine drains these per replayed run to update its incremental
    # cost extraction in O(additions) instead of re-walking the full
    # (mostly prefix-shared) boundary sets per candidate.
    j_writes: list[int] = field(default_factory=list)
    j_reads: list[int] = field(default_factory=list)
    j_spills: list[int] = field(default_factory=list)

    def clone(self) -> "AllocState":
        # journals intentionally start empty: snapshots are taken at run
        # boundaries, after the caller drained them
        a = self.alloc
        return AllocState(
            alloc=Allocation(
                policy=dict(a.policy),
                alloc_in=dict(a.alloc_in), alloc_out=dict(a.alloc_out),
                alloc_shortcut=dict(a.alloc_shortcut), buff=list(a.buff),
                side_buff=a.side_buff, spilled=set(a.spilled),
                boundary_writes=set(a.boundary_writes),
                boundary_reads=dict(a.boundary_reads)),
            remaining=self.remaining.copy(),
            location=self.location.copy(),
            live_in_buffer=dict(self.live_in_buffer),
            lean=self.lean)

def init_alloc_state(gg: GroupedGraph, lean: bool = False) -> AllocState:
    # Consumer counts at group level (plus 1 virtual consumer for the final
    # network output so it is always written out).  The trailing slot is
    # GRAPH_INPUT (= index -1): location starts at 'dram'; its remaining
    # count starts at 1, matching the dict-era ``.get(src, 1)`` default.
    remaining = [len(gg.group_consumers(g)) for g in gg.groups] + [1]
    location: list[int | str] = ["dram"] * (len(gg.groups) + 1)
    return AllocState(alloc=Allocation(policy={}), remaining=remaining,
                      location=location, live_in_buffer={}, lean=lean)


class GroupStep(NamedTuple):
    """Static per-group facts consumed by the allocator loop body, resolved
    once per graph so replays touch no Group/GroupedGraph objects.  A
    NamedTuple so the (very hot) ``alloc_step`` body unpacks it in one
    bytecode instead of eight attribute lookups."""
    gid: int
    is_side: bool
    gin: tuple[int, ...]          # producing gids (main path first)
    src_sizes: tuple[int, ...]    # out bytes of each gin source
    sc_src: int | None
    sc_size: int
    in_size: int
    out_size: int


def graph_steps(gg: GroupedGraph) -> list[GroupStep]:
    """Per-graph step table, cached on the GroupedGraph."""
    steps = getattr(gg, "_alloc_steps", None)
    if steps is not None:
        return steps
    input_size = gg.graph.nodes[0].out_size
    steps = []
    for g in gg.groups:
        gin = tuple(gg.group_inputs(g))
        sc_src = gg.shortcut_source_group(g)
        steps.append(GroupStep(
            gid=g.gid, is_side=_is_side(gg, g), gin=gin,
            src_sizes=tuple(input_size if s == GRAPH_INPUT
                            else gg.groups[s].out_size for s in gin),
            sc_src=sc_src,
            sc_size=gg.groups[sc_src].out_size if sc_src is not None else 0,
            in_size=g.in_size, out_size=g.out_size))
    gg._alloc_steps = steps
    return steps


def alloc_step(state: AllocState, step: GroupStep, mode: str) -> None:
    """Process one group under ``mode``, advancing ``state`` in place.

    This is the loop body of Algorithm 1; ``allocate`` applies it to every
    group and the incremental search engine replays it from a checkpoint
    (millions of times per exhaustive search -- the body is written with
    flat list indexing and no per-call allocations on purpose)."""
    (gid, is_side, gin, src_sizes, sc_src, sc_size,
     in_size, out_size) = step
    alloc = state.alloc
    remaining = state.remaining
    location = state.location
    live_in_buffer = state.live_in_buffer

    # "release if dead" -- a consumed tensor whose last consumer this is
    # frees its buffer -- is inlined at each consumption site below
    # (type(loc) is int: locations are exactly int | str).

    if is_side:
        # SE side path: on-chip side space regardless of mode.
        if out_size > alloc.side_buff:
            alloc.side_buff = out_size
        location[gid] = "side"
        for src in gin:
            r = remaining[src] - 1
            remaining[src] = r
            if r <= 0 and src != GRAPH_INPUT:
                loc = location[src]
                if type(loc) is int and live_in_buffer.get(loc) == src:
                    del live_in_buffer[loc]
        return

    if mode == "row":
        # Feature maps stream through DRAM; no {0,1,2} assignment.
        location[gid] = "dram"
        bw = alloc.boundary_writes
        for src in gin:
            r = remaining[src] - 1
            remaining[src] = r
            loc = location[src]
            if type(loc) is int:
                # A frame-produced tensor consumed by a row group must
                # have been written to DRAM at the boundary.
                if src not in bw:
                    bw.add(src)
                    state.j_writes.append(src)
                if (r <= 0 and src != GRAPH_INPUT
                        and live_in_buffer.get(loc) == src):
                    del live_in_buffer[loc]
        return

    # ---------------------------------------------------- frame mode
    in_buffers: set[int] = set()
    read_bytes = 0
    for src, src_size in zip(gin, src_sizes):
        loc = location[src]
        if type(loc) is int:
            in_buffers.add(loc)
        elif loc == "dram":
            # row->frame boundary (or spilled/long-path data): the
            # group's input is fetched from DRAM into its input buffer.
            read_bytes += src_size
    if read_bytes:
        alloc.boundary_reads[gid] = (
            alloc.boundary_reads.get(gid, 0) + read_bytes)
        state.j_reads.append(gid)

    # Record alloc_in / alloc_shortcut from where the operands live.
    record = not state.lean
    main_src = gin[0] if gin else GRAPH_INPUT
    main_loc = location[main_src]
    buff = alloc.buff
    if type(main_loc) is int:
        if record:
            alloc.alloc_in[gid] = main_loc
        if in_size > buff[main_loc]:
            buff[main_loc] = in_size
    else:
        b = None
        for i in range(NUM_BUFFERS):
            if i not in live_in_buffer:
                b = i
                break
        if b is not None:
            if record:
                alloc.alloc_in[gid] = b
            if in_size > buff[b]:
                buff[b] = in_size
            # transient: the fetched input lives only during this group,
            # but the output must not clobber it while it is being read.
            in_buffers.add(b)
    if sc_src is not None:
        sloc = location[sc_src]
        if type(sloc) is int:
            if record:
                alloc.alloc_shortcut[gid] = sloc
            if sc_size > buff[sloc]:
                buff[sloc] = sc_size

    # Consume inputs (shortcut included -- group_inputs covers it).
    for src in gin:
        remaining[src] -= 1

    # Concat operands are long-path by definition: producers must have
    # spilled (handled below when the producer ran) or be re-read.
    if remaining[gid] == 0:
        # Final output: written straight to DRAM through the write
        # buffer (eq. 5 final_layers term).
        location[gid] = "dram"
        bw = alloc.boundary_writes
        if gid not in bw:
            bw.add(gid)
            state.j_writes.append(gid)
    else:
        b = None
        for i in range(NUM_BUFFERS):
            if i not in live_in_buffer and i not in in_buffers:
                b = i
                break
        if b is None:
            # reuse the main input's buffer if the input dies here
            if (type(main_loc) is int
                    and remaining[main_src] == 0
                    and live_in_buffer.get(main_loc) == main_src):
                del live_in_buffer[main_loc]
                b = main_loc
        if b is None:
            # Long-path data (paper §IV-A): spill to DRAM.
            location[gid] = "dram"
            sp = alloc.spilled
            if gid not in sp:
                sp.add(gid)
                state.j_spills.append(gid)
        else:
            location[gid] = b
            live_in_buffer[b] = gid
            if record:
                alloc.alloc_out[gid] = b
            if out_size > buff[b]:
                buff[b] = out_size

    for src in gin:
        if remaining[src] <= 0 and src != GRAPH_INPUT:
            loc = location[src]
            if type(loc) is int and live_in_buffer.get(loc) == src:
                del live_in_buffer[loc]


def allocate(gg: GroupedGraph, policy: Policy) -> Allocation:
    state = init_alloc_state(gg)
    state.alloc.policy = dict(policy)
    for step in graph_steps(gg):
        alloc_step(state, step, policy[step.gid])
    return state.alloc


def iter_alloc_states(gg: GroupedGraph, policy: Policy):
    """Journal export: replay Algorithm 1 under ``policy`` and yield
    ``(step, state)`` after every ``alloc_step``.

    The yielded ``AllocState`` is the live (mutating) replay state, not a
    snapshot -- callers that only *observe* per-step facts (buffer
    ownership transitions, boundary-journal additions) read what they need
    before advancing.  A static liveness analysis can derive per-buffer
    live intervals from it:
    ``live_in_buffer`` transitions between consecutive yields are exactly
    the buffer claim/release events of the allocator's journal, and the
    ``j_writes``/``j_reads``/``j_spills`` journals carry the boundary-set
    additions of the step just executed (drained per yield)."""
    state = init_alloc_state(gg)
    state.alloc.policy = dict(policy)
    for step in graph_steps(gg):
        state.j_writes.clear()
        state.j_reads.clear()
        state.j_spills.clear()
        alloc_step(state, step, policy[step.gid])
        yield step, state


# --------------------------------------------------- state tensorization
# ``AllocState`` is a handful of Python containers; the scan-style device
# replay needs the same information as fixed-width integer arrays (one
# lane per gid).  ``state_to_arrays`` / ``arrays_to_state`` are the
# canonical encoding -- kernels/alloc_scan.py seeds its initial scan state
# from the exported ``init_alloc_state`` and tests round-trip arbitrary
# mid-replay snapshots through both directions.

def state_to_arrays(state: AllocState) -> dict[str, np.ndarray]:
    """Encode a (lean) allocator state as fixed-width integer arrays.

    Layout (``n`` = group count; the trailing slot of the per-gid arrays
    is the ``GRAPH_INPUT`` pseudo producer, mirroring the list encoding
    where index ``-1`` aliases the last element):

    ====================  =======================================
    ``remaining``         (n+1,) int64 unmet consumer counts
    ``location``          (n+1,) int8  ``LOC_*`` codes / buffer id
    ``live``              (3,)   int64 owning gid or ``LIVE_EMPTY``
    ``buff``              (3,)   int64 buffer byte maxima
    ``side_buff``         ()     int64
    ``boundary_writes``   (n,)   bool
    ``boundary_reads``    (n,)   int64 bytes per consuming gid
    ``spilled``           (n,)   bool
    ====================  =======================================

    The metrics-irrelevant assignment maps (``alloc_in`` etc.) and the
    drained journals are intentionally not part of the encoding -- they
    are exactly what ``lean`` replay states never carry."""
    n = len(state.remaining) - 1
    a = state.alloc
    location = np.empty(n + 1, dtype=np.int8)
    for i, loc in enumerate(state.location):
        location[i] = (loc if type(loc) is int
                       else LOC_SIDE if loc == "side" else LOC_DRAM)
    live = np.full(NUM_BUFFERS, LIVE_EMPTY, dtype=np.int64)
    for b, gid in state.live_in_buffer.items():
        live[b] = gid
    bw = np.zeros(n, dtype=bool)
    bw[list(a.boundary_writes)] = True
    br = np.zeros(n, dtype=np.int64)
    for gid, v in a.boundary_reads.items():
        br[gid] = v
    spilled = np.zeros(n, dtype=bool)
    spilled[list(a.spilled)] = True
    return {
        "remaining": np.asarray(state.remaining, dtype=np.int64),
        "location": location,
        "live": live,
        "buff": np.asarray(a.buff, dtype=np.int64),
        "side_buff": np.int64(a.side_buff),
        "boundary_writes": bw,
        "boundary_reads": br,
        "spilled": spilled,
    }


def arrays_to_state(arrays: dict[str, np.ndarray],
                    lean: bool = True) -> AllocState:
    """Inverse of :func:`state_to_arrays`: rebuild a replayable
    ``AllocState`` from the tensor encoding.  ``alloc_step`` can continue
    from the result exactly as from the original snapshot."""
    location: list[int | str] = [
        int(c) if c < NUM_BUFFERS else ("side" if c == LOC_SIDE else "dram")
        for c in arrays["location"].tolist()]
    live = {b: gid for b, gid in enumerate(arrays["live"].tolist())
            if gid != LIVE_EMPTY}
    bw = {int(g) for g in np.flatnonzero(arrays["boundary_writes"])}
    br_arr = arrays["boundary_reads"]
    br = {int(g): int(br_arr[g]) for g in np.flatnonzero(br_arr)}
    sp = {int(g) for g in np.flatnonzero(arrays["spilled"])}
    alloc = Allocation(policy={}, buff=arrays["buff"].astype(int).tolist(),
                       side_buff=int(arrays["side_buff"]), spilled=sp,
                       boundary_writes=bw, boundary_reads=br)
    return AllocState(alloc=alloc,
                      remaining=arrays["remaining"].astype(int).tolist(),
                      location=location, live_in_buffer=live, lean=lean)


def alloc_bound_terms(state: AllocState) -> tuple[int, int, int, int]:
    """Monotone buffer terms of a (checkpointed) prefix state:
    ``(buff[0], buff[1], buff[2], side_buff)``.

    Every one of these is only ever *max-updated* by ``alloc_step`` (the
    ``if x > buff[b]`` / ``if out_size > side_buff`` sites above), so the
    values read from any prefix state lower-bound the values of every
    replay that continues from it, whatever modes the remaining groups
    take.  The same monotonicity holds for the boundary sets
    (``boundary_writes`` / ``boundary_reads`` / ``spilled`` only grow),
    which is what makes the cut-point engine's incremental accumulators
    (``_x_io`` / ``_x_bfm`` / ``_x_wrf``) valid prefix floors too.  The
    branch-and-bound pruner (``cutpoint.CutpointEngine.prefix_bound``)
    builds its admissible SRAM floor from exactly these terms."""
    a = state.alloc
    b = a.buff
    return b[0], b[1], b[2], a.side_buff


def spill_is_long_path(gg: GroupedGraph, gid: int,
                       long_path_span: int = 8) -> bool:
    """Whether a spill of ``gid``'s output is tolerable long-path data
    (policy-independent, so the search engine precomputes it per gid)."""
    g = gg.groups[gid]
    cons = gg.group_consumers(g)
    if any(gg.groups[c].kind in ("concat", "route") for c in cons):
        return True
    span = max((c - gid for c in cons), default=0)
    return span > long_path_span


def frame_feasible(gg: GroupedGraph, policy: Policy,
                   alloc: Allocation, long_path_span: int = 8) -> bool:
    """Constraint (10) check: frame-mode feature maps must stay on-chip.

    Spills are tolerated only for genuinely long-path data: concat/route
    operands and shortcut spans longer than ``long_path_span`` groups (the
    paper stores those off-chip by design)."""
    return all(spill_is_long_path(gg, gid, long_path_span)
               for gid in alloc.spilled)
