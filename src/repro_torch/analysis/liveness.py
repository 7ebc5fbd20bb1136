"""Per-buffer live intervals, derived from the allocator journal replay.

Algorithm 1 is sequential: walking groups in gid order, each frame-mode
group may claim one of the three physical buffers for its output and each
consumption may release one.  ``core.allocator.iter_alloc_states`` replays
that walk and exposes the state after every step; the ownership
transitions of ``live_in_buffer`` between consecutive steps are exactly
the claim/release events of the allocator's journal, so a full interval
timeline costs one O(groups) replay -- no simulation, no search.

The verifier uses these intervals two ways:

* **consistency** -- the instruction stream's ``alloc_out`` assignments
  must land inside the journal's intervals (a swapped or clobbered
  assignment diverges, diagnostic SF024);
* **context** -- liveness diagnostics render the overlapping interval
  (owner, span) so a clobber report names the tensor that would have been
  destroyed.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.allocator import Allocation, Policy, iter_alloc_states
from repro_torch.core.grouping import GroupedGraph


@dataclass(frozen=True)
class BufferInterval:
    """Tensor ``owner``'s residency in physical buffer ``buffer``:
    claimed while processing group ``start`` (== owner for output claims),
    still resident through group ``end`` inclusive."""
    buffer: int
    owner: int
    start: int
    end: int

    def covers(self, gid: int) -> bool:
        return self.start <= gid <= self.end

    def render(self) -> str:
        return f"buf{self.buffer}<-g{self.owner} live [g{self.start}, g{self.end}]"


@dataclass
class JournalTrace:
    """Everything the verifier needs from one journal replay."""
    intervals: list[BufferInterval]
    # the replayed (authoritative) allocation for the policy
    alloc: Allocation

    def intervals_in(self, buffer: int) -> list[BufferInterval]:
        return [iv for iv in self.intervals if iv.buffer == buffer]

    def owner_at(self, buffer: int, gid: int) -> BufferInterval | None:
        """The interval occupying ``buffer`` when group ``gid`` runs."""
        for iv in self.intervals:
            if iv.buffer == buffer and iv.covers(gid):
                return iv
        return None


def journal_trace(gg: GroupedGraph, policy: Policy) -> JournalTrace:
    """Replay the allocator under ``policy`` and derive per-buffer live
    intervals from the ownership transitions of its journal."""
    open_ivs: dict[int, tuple[int, int]] = {}      # buffer -> (owner, start)
    intervals: list[BufferInterval] = []
    prev_gid = 0
    state = None
    for step, state in iter_alloc_states(gg, policy):
        cur = state.live_in_buffer
        for b, (owner, start) in list(open_ivs.items()):
            if cur.get(b) != owner:
                # Released during this step: the tensor was still readable
                # while this group consumed it, so the interval includes
                # step.gid.
                intervals.append(BufferInterval(b, owner, start, step.gid))
                del open_ivs[b]
        for b, owner in cur.items():
            if b not in open_ivs:
                open_ivs[b] = (owner, step.gid)
        prev_gid = step.gid
    for b, (owner, start) in open_ivs.items():
        intervals.append(BufferInterval(b, owner, start, prev_gid))
    intervals.sort(key=lambda iv: (iv.start, iv.buffer))
    alloc = state.alloc if state is not None else Allocation(policy={})
    return JournalTrace(intervals=intervals, alloc=alloc)


def render_intervals(trace: JournalTrace, limit: int = 12) -> str:
    """Compact interval summary for CLI reports."""
    ivs = trace.intervals
    shown = ", ".join(iv.render() for iv in ivs[:limit])
    more = f", ... ({len(ivs) - limit} more)" if len(ivs) > limit else ""
    return f"{len(ivs)} buffer live intervals: {shown}{more}"
