"""Off-chip access model: paper equations (8)-(9).

``dram_fm`` generalizes eq. (8) with explicit boundary terms so that
arbitrary (non-contiguous) policies are accounted exactly; for the paper's
contiguous segment policies it reduces to eq. (8):

  row-mode conv groups:   in_size + out_size        (stream through DRAM)
  row-mode fused shortcut: + shortcut in_size        (Fig. 9: 2 reads 1 write)
  frame-mode groups:      0, except
     - row->frame boundary reads (input fetched once),
     - frame->row / final-output boundary writes,
     - long-path spills (concat/route operands): write + read
       == the paper's  2 x in_size(concat)  term.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.allocator import Allocation, _is_side
from repro_torch.core.grouping import Group, GroupedGraph


@dataclass
class DRAMReport:
    fm_bytes: int
    weight_bytes: int

    @property
    def total(self) -> int:             # eq. (9)
        return self.fm_bytes + self.weight_bytes

    def __str__(self) -> str:
        mb = 1 / (1 << 20)
        return (f"DRAM fm={self.fm_bytes * mb:.2f} MB + "
                f"w={self.weight_bytes * mb:.2f} MB = {self.total * mb:.2f} MB")


def row_fm_bytes(gg: GroupedGraph, g: Group) -> int:
    """Row-mode DRAM feature-map traffic of one group (policy-independent)."""
    if g.kind in ("concat", "route"):
        # Feature-merging redirect (TensorRT-style, §III-A): the
        # producers already wrote into the concat destination.
        return 0
    fm = g.in_size + g.out_size
    if g.head.kind == "add":
        # Standalone eltwise: in+out counted above; every extra operand is
        # read once.  group_inputs[1:] already includes the shortcut
        # source, so the fused-shortcut term below must NOT be added on
        # top (it used to be, double-counting the second operand -- the
        # memory simulator counts 2 reads + 1 write, tests/
        # test_simulator_audit.py keeps the two in lock-step).
        fm += sum(gg.groups[i].out_size        # det: int-exact byte counts
                  for i in gg.group_inputs(g)[1:]
                  if i >= 0)
    else:
        sc = gg.shortcut_source_group(g)
        if sc is not None:            # fused add: one shortcut read
            fm += gg.groups[sc].out_size
    return fm


def dram_fm(gg: GroupedGraph, alloc: Allocation) -> int:
    policy = alloc.policy
    fm = 0
    for g in gg.groups:
        if _is_side(gg, g):
            continue                          # SE side path: on-chip always
        mode = policy[g.gid]
        if mode == "row":
            fm += row_fm_bytes(gg, g)
        else:
            # Reads of DRAM-resident inputs (boundaries, spills, concat
            # gathers) are charged to the consumer via boundary_reads; the
            # write side is charged to the producer here.
            fm += alloc.boundary_reads.get(g.gid, 0)
            if g.gid in alloc.boundary_writes or g.gid in alloc.spilled:
                fm += g.out_size
    return fm


def dram_report(gg: GroupedGraph, alloc: Allocation) -> DRAMReport:
    # det: int-exact byte counts (read exactly once)
    weights = sum(g.weight_size for g in gg.groups)
    return DRAMReport(fm_bytes=dram_fm(gg, alloc), weight_bytes=weights)


# ---------------------------------------------------- vectorized evaluation
@dataclass
class DRAMTables:
    """Static per-group quantities for vectorized DRAM evaluation."""
    row_fm: np.ndarray        # int64: row-mode fm traffic (0 for side/merge)
    out_size: list[int]       # per-gid output bytes (Python ints, exact)
    side: np.ndarray          # bool
    weight_bytes: int         # constant weight traffic, eq. (9)


def dram_tables(gg: GroupedGraph) -> DRAMTables:
    n = len(gg.groups)
    row_fm = np.zeros(n, dtype=np.int64)
    side = np.zeros(n, dtype=bool)
    out_size = [0] * n
    for g in gg.groups:
        out_size[g.gid] = g.out_size
        if _is_side(gg, g):
            side[g.gid] = True
        else:
            row_fm[g.gid] = row_fm_bytes(gg, g)
    return DRAMTables(row_fm=row_fm, out_size=out_size, side=side,
                      # det: int-exact byte counts
                      weight_bytes=sum(g.weight_size for g in gg.groups))


def dram_fm_fast(t: DRAMTables, frame: np.ndarray,
                 alloc: Allocation) -> int:
    """``dram_fm`` as an array reduction over the allocation delta: the row
    term is a masked sum of the static table; the frame term touches only
    the boundary/spill sets the allocator actually produced (all of whose
    members are frame-mode, non-side groups by construction)."""
    # det: all four reductions below are over exact int64/Python-int byte
    # counts -- no float rounding, any summation order is bit-identical
    fm = int(t.row_fm[~frame].sum())      # row_fm is 0 for side groups
    fm += sum(alloc.boundary_reads.values())                    # det: int
    out = t.out_size
    fm += sum(out[gid] for gid in alloc.boundary_writes)        # det: int
    fm += sum(out[gid] for gid in alloc.spilled                 # det: int
              if gid not in alloc.boundary_writes)
    return fm


def boundary_fm_bytes(alloc: Allocation, out_size: list[int]) -> int:
    """The candidate-dependent part of ``dram_fm_fast``: boundary reads +
    boundary writes + spill write-outs, as one exact Python int.  The
    engine extracts this per candidate while the replayed allocation is
    live; ``dram_fm_fast_batch`` adds the vectorized row-mode term."""
    writes = alloc.boundary_writes
    fm = 0
    for rb in alloc.boundary_reads.values():
        fm += rb
    for gid in writes:
        fm += out_size[gid]
    for gid in alloc.spilled:
        if gid not in writes:
            fm += out_size[gid]
    return fm


def dram_fm_fast_batch(t: DRAMTables, frame: np.ndarray,
                       boundary_fm: list[int],
                       row_terms=None) -> list[int]:
    """``dram_fm_fast`` for B candidates: one masked 2-D int64 reduction
    over the frame-mask matrix for the row-mode term, plus the
    per-candidate boundary/spill totals (``boundary_fm[i]`` from
    :func:`boundary_fm_bytes` -- exact ints, so each element is
    bit-identical to the scalar path).

    ``row_terms`` optionally injects precomputed per-candidate row-mode
    sums (the staged float32 scorer computes them on the device); when
    given they are used verbatim."""
    if row_terms is None:
        # det: int64 matrix reduction, exact at any association order
        row_terms = np.where(frame, 0, t.row_fm[None, :]).sum(axis=1)
    return [int(rt) + b for rt, b in zip(row_terms.tolist(), boundary_fm)]


def baseline_total(gg: GroupedGraph) -> int:
    """Paper's baseline (Table V footnote): weights/inputs/outputs accessed
    from DRAM exactly once *per layer* (node granularity -- interior tensors
    are written by their producer and re-read by each consumer)."""
    total = 0
    for n in gg.graph.nodes:
        if n.kind == "input":
            continue
        g = gg.groups[gg.node_group[n.idx]]
        if _is_side(gg, g):
            continue                        # SE side path: tiny, on-chip
        if n.kind in ("concat", "route"):
            continue                        # redirect, no movement
        total += n.in_size + n.out_size + n.weight_size
        if n.kind == "add":                 # second (shortcut) operand read
            # det: int-exact byte counts
            total += sum(gg.graph.nodes[i].out_size for i in n.inputs[1:])
    return total
