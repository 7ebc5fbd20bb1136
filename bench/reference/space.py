"""A plain enumeration of a graph's whole cut space on a device, in blocks.

Every cut tuple of the product order (the last run varies fastest, so a
tuple's index is its mixed-radix number) is priced: its latency, its SRAM
and DRAM totals, and whether every spill it makes is long-path data.  The
budget and the objective enter only the argmin, so one enumeration serves
every request on the same accelerator.

The allocator (Algorithm 1, ``allocator.alloc_step``) runs on all the
tuples of a block at once, one group at a time, as a walk down the tree of
cut prefixes: the tuples that share the cuts of runs ``0..r`` share the
allocator's state after run ``r``'s groups, so the state is expanded by
run ``r + 1``'s cut values only when its groups are reached.  The group
steps are written from ``alloc_step``, with each candidate's state as one
column of a tensor.  The consumer counts depend on no cut, so they are
counted once on the host.  The latency total adds one group's term per step
in gid order, as ``timing.seq_sum`` does; every other total is an exact
integer.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from .allocator import (GRAPH_INPUT, NUM_BUFFERS, graph_steps,
                        init_alloc_state, spill_is_long_path)
from .cuts import Block, run_direction
from .dram import dram_tables
from .grouping import GroupedGraph
from .hw import FPGAConfig
from .sram import sram_tables
from .timing import latency_tables

LOC_SIDE = NUM_BUFFERS
LOC_DRAM = NUM_BUFFERS + 1
EMPTY = -1
# tuples a block prices at once: its state is ~25 bytes per group a tuple
BLOCK = 1 << 22
PRECISIONS = {"float64": torch.float64, "float32": torch.float32}


@dataclass
class State:
    """The allocator state of M tuples, one column each."""
    loc: torch.Tensor          # (n+1, M) int8: buffer id, side or DRAM
    live: torch.Tensor         # (3, M) int64: owning gid or EMPTY
    buff: torch.Tensor         # (3, M) int64: buffer byte maxima
    io: torch.Tensor           # (n, M) int64: boundary bytes per gid
    bw: torch.Tensor           # (n, M) bool: boundary writes
    frame: torch.Tensor        # (n, M) bool: the tuple's mode per gid
    bfm: torch.Tensor          # (M,) DRAM boundary bytes
    wrf: torch.Tensor          # (M,) eq. (5) frame write-buffer maximum
    feas: torch.Tensor         # (M,) bool: every spill long-path
    row_fm: torch.Tensor       # (M,) row-mode DRAM bytes
    wbuff: torch.Tensor        # (M,) eq. (1) maximum over row groups
    outf: torch.Tensor         # (M,) eq. (4) frame term
    outr: torch.Tensor         # (M,) eq. (4) row term
    wrr: torch.Tensor          # (M,) eq. (5) row term

    def map(self, fn) -> "State":
        return State(**{f.name: fn(getattr(self, f.name))
                        for f in fields(self)})


@dataclass
class Costs:
    """Every tuple's metrics, by index in the product order."""
    dims: tuple[int, ...]
    latency: torch.Tensor      # float64 (float32 in the control)
    sram: torch.Tensor         # int64
    dram: torch.Tensor         # int64
    spills_ok: torch.Tensor    # bool

    def winner(self, budget: int, objective: str) -> int:
        """Index of the first tuple with the least key
        ``(infeasible, primary, secondary)``."""
        ok = self.spills_ok & (self.sram <= budget)
        cand = ok if bool(ok.any()) else torch.ones_like(ok)
        primary, secondary = {
            "latency": (self.latency, self.sram),
            "sram": (self.sram, self.latency),
            "dram": (self.dram, self.latency)}[objective]
        for x in (primary, secondary):
            best = torch.where(cand, x, _top(x)).min()
            cand = cand & (x == best)
        return int(torch.nonzero(cand)[0, 0])

    def cuts(self, index: int) -> tuple[int, ...]:
        out = []
        for d in reversed(self.dims):
            out.append(index % d)
            index //= d
        return tuple(reversed(out))


def _top(x: torch.Tensor):
    if x.dtype.is_floating_point:
        return torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    return torch.full((), torch.iinfo(x.dtype).max, dtype=x.dtype,
                      device=x.device)


class Space:
    """The cut space of one graph on one accelerator."""

    def __init__(self, gg: GroupedGraph, blocks: list[Block],
                 runs: list[list[int]], hw: FPGAConfig):
        self.n = n = len(gg.groups)
        self.dims = tuple(len(r) + 1 for r in runs)
        self.size = 1
        for d in self.dims:
            self.size *= d
        self.steps = graph_steps(gg)
        # groups of each run, in gid order; runs must cover the gids in order
        self.run_groups = []
        self.pos = [0] * n
        self.neg = []
        for run in runs:
            gids = []
            for pos, b in enumerate(run):
                for gid in blocks[b].gids:
                    self.pos[gid] = pos
                    gids.append(gid)
            self.run_groups.append(gids)
            self.neg.append(run_direction(blocks, run) < 0)
        if [g for gids in self.run_groups for g in gids] != list(range(n)):
            raise ValueError("runs do not cover the groups in gid order")
        lt, dt, st = latency_tables(gg, hw), dram_tables(gg), sram_tables(gg, hw)
        self.lt, self.st = lt, st
        self.row_fm = dt.row_fm.tolist()
        self.weight_bytes = dt.weight_bytes
        self.bpc = hw.dram_bytes_per_cycle
        self.goc = hw.group_overhead_cycles
        self.side_buff = max([s.out_size for s in self.steps if s.is_side],
                             default=0)
        self.spill_ok = [spill_is_long_path(gg, g) for g in range(n)]
        self.wr_cand = [st.wr_frame[g] if st.compute[g] else 0
                        for g in range(n)]
        # the consumer counts, counted once: which producers a step leaves
        # dead, whether its main operand dies in it, whether it is final
        rem = init_alloc_state(gg).remaining       # [-1]: the graph input
        self.dead, self.main_dead, self.final = [], [], []
        for s in self.steps:
            for src in s.gin:
                rem[src] -= 1
            main = s.gin[0] if s.gin else GRAPH_INPUT
            self.dead.append(sorted({self.lane(src) for src in s.gin
                                     if src != GRAPH_INPUT and rem[src] <= 0}))
            self.main_dead.append(rem[main] == 0)
            self.final.append(rem[s.gid] == 0)

    def lane(self, src: int) -> int:
        return self.n if src == GRAPH_INPUT else src

    # ------------------------------------------------------------ the walk
    def costs(self, device, precision: str = "float64",
              block: int = BLOCK) -> Costs:
        """Price the whole space on ``device``, ``block`` tuples at a
        time; the latency in ``precision``."""
        dtype = PRECISIONS[precision]
        levels = len(self.dims)
        split, suffix = 0, self.size
        while suffix > block:
            suffix //= self.dims[split]
            split += 1
        top = self._initial(device)
        for r in range(split):
            top = self._advance(top, r)
        prefixes = self.size // suffix
        per = max(1, block // suffix)
        lat = torch.empty(self.size, dtype=dtype, device=device)
        sram = torch.empty(self.size, dtype=torch.int64, device=device)
        dram = torch.empty_like(sram)
        ok = torch.empty(self.size, dtype=torch.bool, device=device)
        for p0 in range(0, prefixes, per):
            p1 = min(prefixes, p0 + per)
            st = top.map(lambda x: x[..., p0:p1])
            for r in range(split, levels):
                st = self._advance(st, r)
            sl = slice(p0 * suffix, p1 * suffix)
            lat[sl] = self._latency(st, dtype)
            sram[sl] = self._sram(st)
            dram[sl] = st.row_fm + st.bfm + self.weight_bytes
            ok[sl] = st.feas
            del st
        return Costs(dims=self.dims, latency=lat, sram=sram, dram=dram,
                     spills_ok=ok)

    def _initial(self, device) -> State:
        n = self.n
        i64 = dict(dtype=torch.int64, device=device)

        def zeros(*shape):
            return torch.zeros(*shape, 1, **i64)

        return State(
            loc=torch.full((n + 1, 1), LOC_DRAM, dtype=torch.int8,
                           device=device),
            live=torch.full((NUM_BUFFERS, 1), EMPTY, **i64),
            buff=zeros(NUM_BUFFERS), io=zeros(n),
            bw=torch.zeros(n, 1, dtype=torch.bool, device=device),
            frame=torch.zeros(n, 1, dtype=torch.bool, device=device),
            bfm=zeros(), wrf=zeros(),
            feas=torch.ones(1, dtype=torch.bool, device=device),
            row_fm=zeros(), wbuff=zeros(), outf=zeros(), outr=zeros(),
            wrr=zeros())

    def _advance(self, st: State, r: int) -> State:
        """Each column once for every cut of run ``r``, then run ``r``'s
        groups."""
        d = self.dims[r]
        m = st.feas.shape[0]
        st = st.map(lambda x: x.repeat_interleave(d, dim=-1))
        cut = torch.arange(d, device=st.feas.device).repeat(m)
        for g in self.run_groups[r]:
            pos = self.pos[g]
            self._step(st, g, cut <= pos if self.neg[r] else cut > pos)
        return st

    def _step(self, st: State, g: int, fr: torch.Tensor) -> None:
        """``alloc_step`` of group ``g``: mode frame where ``fr``, else row;
        and the group's terms of eqs. (1), (4), (5) and (9)."""
        s = self.steps[g]
        loc, live, buff, io, bw = st.loc, st.live, st.buff, st.io, st.bw
        NB = NUM_BUFFERS
        st.frame[g] = fr
        if s.is_side:
            loc[g] = LOC_SIDE
        else:
            rw = ~fr
            lanes = [self.lane(src) for src in s.gin]
            # row mode: a frame-produced operand crosses the boundary
            for lane, size in zip(lanes, s.src_sizes):
                if lane == self.n:
                    continue
                add = rw & (loc[lane] < NB) & ~bw[lane]
                bw[lane] |= add
                io[lane] += add * size
                st.bfm += add * size
                st.wrf = torch.where(add, st.wrf.clamp(min=self.wr_cand[lane]),
                                     st.wrf)
            # frame mode: operands in buffers, DRAM reads, the input's buffer
            read = torch.zeros_like(st.bfm)
            held = [torch.zeros_like(fr) for _ in range(NB)]
            for lane, size in zip(lanes, s.src_sizes):
                read += (loc[lane] == LOC_DRAM) * size
                for i in range(NB):
                    held[i] |= loc[lane] == i
            io[g] += fr * read
            st.bfm += fr * read
            main = lanes[0] if lanes else self.n
            mloc = loc[main].long()
            main_in = mloc < NB
            empty = [live[i] == EMPTY for i in range(NB)]
            fetch = _first(empty)
            for i in range(NB):
                fetched = ~main_in & (fetch == i)
                grow = fr & ((main_in & (mloc == i)) | fetched)
                buff[i] = torch.where(grow, buff[i].clamp(min=s.in_size),
                                      buff[i])
                held[i] |= fetched
            if s.sc_src is not None:
                sloc = loc[self.lane(s.sc_src)]
                for i in range(NB):
                    buff[i] = torch.where(fr & (sloc == i),
                                          buff[i].clamp(min=s.sc_size),
                                          buff[i])
            if self.final[g]:
                # final output: written through the write buffer
                bw[g] |= fr
                io[g] += fr * s.out_size
                st.bfm += fr * s.out_size
                st.wrf = torch.where(fr, st.wrf.clamp(min=self.wr_cand[g]),
                                     st.wrf)
                loc[g] = LOC_DRAM
            else:
                b = _first([empty[i] & ~held[i] for i in range(NB)])
                if self.main_dead[g]:
                    owner = torch.zeros_like(fr)
                    for i in range(NB):
                        owner |= (mloc == i) & (live[i] == main)
                    b = torch.where((b < 0) & main_in & owner, mloc, b)
                spill = fr & (b < 0)
                io[g] += spill * s.out_size
                st.bfm += spill * s.out_size
                if not self.spill_ok[g]:
                    st.feas &= ~spill
                for i in range(NB):
                    sel = fr & (b == i)
                    live[i] = torch.where(sel, g, live[i])
                    buff[i] = torch.where(sel, buff[i].clamp(min=s.out_size),
                                          buff[i])
                loc[g] = torch.where(fr & (b >= 0), b, LOC_DRAM).to(torch.int8)
        # release the producers this step leaves dead
        for lane in self.dead[g]:
            for i in range(NB):
                freed = (loc[lane] == i) & (live[i] == lane)
                live[i] = live[i].masked_fill(freed, EMPTY)
        # the reports' per-group terms that depend only on the mode
        rw = ~fr
        if not s.is_side:
            st.row_fm += rw * self.row_fm[g]
        t = self.st
        if t.compute[g]:
            st.wbuff = torch.where(rw, st.wbuff.clamp(min=int(t.weight[g])),
                                   st.wbuff)
            st.outf = torch.where(fr, st.outf.clamp(min=int(t.out_frame[g])),
                                  st.outf)
            st.outr = torch.where(rw, st.outr.clamp(min=int(t.out_row[g])),
                                  st.outr)
            st.wrr = torch.where(rw, st.wrr.clamp(min=int(t.wr_row[g])),
                                 st.wrr)

    def _latency(self, st: State, dtype) -> torch.Tensor:
        """``timing.latency_report``'s total, one group's term a step."""
        lt = self.lt
        dev = st.feas.device
        total = torch.zeros(st.feas.shape[0], dtype=dtype, device=dev)

        def const(x):
            return torch.tensor(x, dtype=dtype, device=dev)

        bpc = const(self.bpc)
        for g in range(self.n):
            comp = const(lt.comp[g])
            if lt.side[g]:
                term = comp.expand_as(total)
            else:
                # (weight + io) as an exact integer, then one division
                mem = (st.io[g] + int(lt.weight[g])).to(dtype) / bpc
                framed = torch.maximum(comp, mem) + self.goc
                term = torch.where(st.frame[g], framed, const(lt.row[g]))
            total = total + term
        return total

    def _sram(self, st: State) -> torch.Tensor:
        """``sram.sram_report``'s total, eq. (6)."""
        b0, b1, b2 = st.buff
        return (self.st.row_buff + torch.maximum(st.outf, st.outr)
                + torch.maximum(st.wrr, st.wrf) + b0
                + torch.maximum(b1, st.wbuff) + b2 + self.side_buff)


def _first(masks) -> torch.Tensor:
    """Lowest buffer id whose mask holds, else -1."""
    out = torch.full_like(masks[0], -1, dtype=torch.int64)
    for i in reversed(range(len(masks))):
        out = torch.where(masks[i], i, out)
    return out
