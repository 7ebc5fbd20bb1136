"""Cycle-accurate-style latency model (paper §IV-B, Fig. 3).

The paper validates a cycle-accurate simulator against RTL; we model the
same pipeline structure analytically per group:

row-based weight reuse (Fig. 3b):
    the layer's full weights are pre-loaded on-chip (constraint (10)), then
    rows stream: compute overlaps feature-map DRAM traffic.
      latency = weight_load + max(compute_cycles, fm_dram_cycles)

frame-based weight reuse (Fig. 3a):
    feature maps resident on-chip; weight-block loads are hidden by the
    computation of the previous sub-frame ("the latency of reading the
    weight blocks ... can be hidden by the computation"):
      latency = max(compute_cycles, weight_dram_cycles + boundary_io_cycles)

Post-processing nodes fused into the group (pool / eltwise / upsample /
scale) ride the output chain and add no cycles (§III-B-2: "the element-wise
layer does not incur an additional timing overhead").
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .allocator import Allocation, _is_side
from .grouping import Group, GroupedGraph
from .hw import FPGAConfig


@dataclass
class LatencyReport:
    cycles: float
    per_group: dict[int, float] = field(default_factory=dict)

    def seconds(self, hw: FPGAConfig) -> float:
        return self.cycles / hw.freq

    def ms(self, hw: FPGAConfig) -> float:
        return 1e3 * self.seconds(hw)


def seq_sum(values) -> float:
    """The one definition of the latency total: plain IEEE float64
    accumulation, left to right in gid order.

    Every form of the total in this package -- the scalar report, the
    per-candidate fast path, the batched matrix form, the branch-and-bound
    floor and the CUDA cost kernel -- adds one group's term per step in
    this order, so all of them agree bit for bit.  A compensated sum
    (builtin ``sum`` on floats since Python 3.12, ``math.fsum``) or a
    pairwise / parallel reduction (``np.sum``, ``torch.sum``, a scan on
    the GPU) differs in the last bits and would flip argmin ties."""
    total = 0.0
    for v in values:
        total += v
    return total


def compute_cycles(g: Group, hw: FPGAConfig) -> float:
    """MAC-array occupancy with lane-granularity effects.

    Normal conv / fc: the shared array performs a Ti x To MAC step per
    cycle, so cycles = out_h*out_w*k^2 * ceil(Cin/Ti) * ceil(Cout/To); layers
    with few channels waste lanes (this is what drives the paper's 19.4%
    MAC efficiency on EfficientNet vs ~71% on ResNet152).
    Depthwise / SE-scale: single-mult path (Fig. 7b, 8a): one <=32-MAC
    kernel per array per cycle => To outputs/cycle."""
    import math
    cyc = 0.0
    for n in g.nodes:
        if n.macs == 0:
            continue
        if n.kind in ("dwconv", "scale"):
            kernel_passes = max(1, math.ceil(n.k * n.k / 32))
            cyc += (n.out_h * n.out_w * math.ceil(n.out_ch / hw.to)
                    * kernel_passes)
        else:
            cyc += (n.out_h * n.out_w * n.k * n.k
                    * math.ceil((n.in_ch / n.groups) / hw.ti)
                    * math.ceil(n.out_ch / hw.to))
    return cyc


def row_latency(gg: GroupedGraph, g: Group, hw: FPGAConfig,
                comp: float) -> float:
    """Row-mode (Fig. 3b) group latency.  Depends only on the group and the
    graph topology, never on the allocation, so it can be tabulated once."""
    if g.kind in ("concat", "route"):
        return hw.group_overhead_cycles              # redirect: free
    bpc = hw.dram_bytes_per_cycle
    extra = 0
    if g.head.kind == "add":
        # Standalone eltwise: every extra operand streamed once.  The
        # shortcut source is among group_inputs[1:], so the fused-shortcut
        # term below would double-count it (dram.row_fm_bytes has the
        # same split; the simulator byte counters arbitrate).
        extra = sum(gg.groups[i].out_size      # det: int-exact byte counts
                    for i in gg.group_inputs(g)[1:] if i >= 0)
    else:
        sc = gg.shortcut_source_group(g)
        if sc is not None:            # fused add: one shortcut read
            extra = gg.groups[sc].out_size
    fm_bytes = g.in_size + g.out_size + extra
    weight_load = g.weight_size / bpc
    return weight_load + max(comp, fm_bytes / bpc) + hw.group_overhead_cycles


def group_latency(gg: GroupedGraph, g: Group, alloc: Allocation,
                  hw: FPGAConfig) -> float:
    policy = alloc.policy
    if _is_side(gg, g):
        # SE side path: a handful of MACs + pooling, fully hidden behind the
        # main path in hardware; charge only its compute.
        return compute_cycles(g, hw)

    bpc = hw.dram_bytes_per_cycle
    mode = policy[g.gid]
    comp = compute_cycles(g, hw)

    if mode == "row":
        return row_latency(gg, g, hw, comp)

    # frame mode
    io_bytes = alloc.boundary_reads.get(g.gid, 0)
    if g.gid in alloc.boundary_writes or g.gid in alloc.spilled:
        io_bytes += g.out_size
    mem = (g.weight_size + io_bytes) / bpc
    return max(comp, mem) + hw.group_overhead_cycles


def latency_report(gg: GroupedGraph, alloc: Allocation,
                   hw: FPGAConfig) -> LatencyReport:
    per_group = {g.gid: group_latency(gg, g, alloc, hw) for g in gg.groups}
    # det: float reduction fixed left-to-right in gid order (dict insertion
    # order); latency_cycles_fast reproduces this association exactly
    return LatencyReport(cycles=seq_sum(per_group.values()),
                         per_group=per_group)


# ---------------------------------------------------- vectorized evaluation
@dataclass
class LatencyTables:
    """Static per-group quantities for vectorized latency evaluation.

    Every entry is computed with exactly the scalar code paths above
    (``compute_cycles`` / ``row_latency``), so the vectorized total is
    bit-identical to ``latency_report`` for any allocation."""
    comp: np.ndarray          # float64: compute cycles per group
    row: np.ndarray           # float64: full row-mode latency per group
    weight: np.ndarray        # float64: weight bytes per group
    side: np.ndarray          # bool: SE side-path groups


def latency_tables(gg: GroupedGraph, hw: FPGAConfig) -> LatencyTables:
    n = len(gg.groups)
    comp = np.empty(n)
    row = np.empty(n)
    weight = np.empty(n)
    side = np.zeros(n, dtype=bool)
    for g in gg.groups:
        c = compute_cycles(g, hw)
        comp[g.gid] = c
        weight[g.gid] = g.weight_size
        if _is_side(gg, g):
            side[g.gid] = True
            row[g.gid] = c
        else:
            row[g.gid] = row_latency(gg, g, hw, c)
    return LatencyTables(comp=comp, row=row, weight=weight, side=side)


