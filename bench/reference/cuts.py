"""Residual blocks, monotone runs and the cut-tuple encoding (paper §IV).

Frozen copy of the port's ``core/cutpoint.py`` definitions that fix the
search space and what a cut tuple means, with the direct oracle
``evaluate``: a from-scratch allocation and the three reports for one cut
tuple.
"""
from __future__ import annotations

from dataclasses import dataclass

from .allocator import Allocation, Policy, allocate, frame_feasible
from .dram import DRAMReport, dram_report
from .grouping import GroupedGraph
from .hw import FPGAConfig
from .sram import SRAMReport, sram_report
from .timing import LatencyReport, latency_report


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


def run_direction(blocks: list[Block], run: list[int]) -> int:
    return 1 if blocks[run[-1]].out_size >= blocks[run[0]].out_size else -1


def policy_from_cuts(blocks: list[Block], runs: list[list[int]],
                     cuts: tuple[int, ...]) -> Policy:
    """cut c in run r: for decreasing runs blocks[run[c:]] are frame-reuse;
    for increasing runs blocks[run[:c]] are frame-reuse."""
    policy: Policy = {}
    for run, cut in zip(runs, cuts):
        d = run_direction(blocks, run)
        for pos, b in enumerate(run):
            frame = pos >= cut if d < 0 else pos < cut
            for gid in blocks[b].gids:
                policy[gid] = "frame" if frame else "row"
    return dict(sorted(policy.items()))


@dataclass
class Evaluated:
    """One cut tuple priced by the direct oracle."""
    cuts: tuple[int, ...]
    policy: Policy
    alloc: Allocation
    sram: SRAMReport
    dram: DRAMReport
    latency: LatencyReport
    feasible: bool


def evaluate(gg: GroupedGraph, blocks: list[Block], runs: list[list[int]],
             cuts: tuple[int, ...], hw: FPGAConfig) -> Evaluated:
    policy = policy_from_cuts(blocks, runs, cuts)
    alloc = allocate(gg, policy)
    sram = sram_report(gg, alloc, hw)
    feasible = (sram.sram_total <= hw.sram_budget
                and frame_feasible(gg, policy, alloc))
    return Evaluated(cuts=cuts, policy=policy, alloc=alloc, sram=sram,
                     dram=dram_report(gg, alloc),
                     latency=latency_report(gg, alloc, hw),
                     feasible=feasible)
