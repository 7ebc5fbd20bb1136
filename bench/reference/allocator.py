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

from .grouping import Group, GroupedGraph

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

def _is_side(gg: GroupedGraph, g: Group) -> bool:
    """SE side-path groups (global-pool / FC chains with tiny outputs)."""
    return (g.head.kind in ("fc", "globalpool")
            and g.out_size <= SIDE_THRESHOLD
            and g.head.out_h == 1 and g.head.out_w == 1)


@dataclass
class AllocState:
    """Full sequential allocator state after processing a prefix of groups.

    The allocator walks groups in gid order; everything it carries between
    iterations lives here.  ``remaining`` and ``location`` are flat per-gid
    lists; index ``-1`` (Python's last-element alias) is the
    ``GRAPH_INPUT`` pseudo producer, so ``remaining[src]`` /
    ``location[src]`` work verbatim for real gids and the graph input."""
    alloc: Allocation
    # consumer counts not yet satisfied, per gid ([-1] = graph input)
    remaining: list[int]
    # location of each produced tensor: buffer id, 'side', or 'dram'
    location: list[int | str]
    # buffer id -> producing gid currently held live
    live_in_buffer: dict[int, int]

def init_alloc_state(gg: GroupedGraph) -> AllocState:
    # Consumer counts at group level (plus 1 virtual consumer for the final
    # network output so it is always written out).  The trailing slot is
    # GRAPH_INPUT (= index -1): location starts at 'dram'; its remaining
    # count starts at 1, matching the dict-era ``.get(src, 1)`` default.
    remaining = [len(gg.group_consumers(g)) for g in gg.groups] + [1]
    location: list[int | str] = ["dram"] * (len(gg.groups) + 1)
    return AllocState(alloc=Allocation(policy={}), remaining=remaining,
                      location=location, live_in_buffer={})


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
                bw.add(src)
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

    # Record alloc_in / alloc_shortcut from where the operands live.
    main_src = gin[0] if gin else GRAPH_INPUT
    main_loc = location[main_src]
    buff = alloc.buff
    if type(main_loc) is int:
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
            alloc.alloc_in[gid] = b
            if in_size > buff[b]:
                buff[b] = in_size
            # transient: the fetched input lives only during this group,
            # but the output must not clobber it while it is being read.
            in_buffers.add(b)
    if sc_src is not None:
        sloc = location[sc_src]
        if type(sloc) is int:
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
        alloc.boundary_writes.add(gid)
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
            alloc.spilled.add(gid)
        else:
            location[gid] = b
            live_in_buffer[b] = gid
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
