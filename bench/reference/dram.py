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

from .allocator import Allocation, _is_side
from .grouping import Group, GroupedGraph


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


