"""On-chip buffer sizing: paper equations (1)-(7)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .allocator import Allocation
from .grouping import GroupedGraph
from .hw import FPGAConfig


@dataclass
class SRAMReport:
    weight_buff: int
    row_buff: int
    out_buff: int
    write_buff: int
    buff: list[int]
    side_buff: int
    sram_total: int
    bram18k: int

    def __str__(self) -> str:
        mb = 1 / (1 << 20)
        return (f"SRAM {self.sram_total * mb:.3f} MB "
                f"(w={self.weight_buff * mb:.3f} row={self.row_buff * mb:.3f} "
                f"out={self.out_buff * mb:.3f} wr={self.write_buff * mb:.3f} "
                f"buf={[round(b * mb, 3) for b in self.buff]} "
                f"side={self.side_buff * mb:.3f}) bram18k={self.bram18k}")


def bram18k_count(depth: int, width_bits: int) -> int:
    """Eq. (7): BRAM18k = ceil(depth/1024) * ceil(width/18)."""
    if depth == 0:
        return 0
    return math.ceil(depth / 1024) * math.ceil(width_bits / 18)


def sram_report(gg: GroupedGraph, alloc: Allocation,
                hw: FPGAConfig) -> SRAMReport:
    policy = alloc.policy
    compute = [g for g in gg.groups if g.is_compute or g.kind == "scale"]

    # Eq. (1): in row-reuse mode the entire layer weights are pre-loaded
    # on-chip (constraint (10): weights from DRAM exactly once).
    weight_buff = max((g.weight_size for g in compute
                       if policy[g.gid] == "row"), default=0)

    # Eq. (2): buffer 1 is shared between feature maps and weights.
    buff = list(alloc.buff)
    buff[1] = max(buff[1], weight_buff)

    # Eq. (3): six rows of the widest input (incl. one prefetch row).
    row_buff = max((6 * g.head.in_w * g.head.in_ch * g.head.qa
                    for g in compute), default=0)

    # Eq. (4): partial-sum buffer, 4-byte accumulators; frame mode buffers a
    # whole To-channel frame, row mode only one row (frame dominates).
    out_frame = max((g.head.out_w * g.head.out_h * hw.to * g.head.qs
                     for g in compute if policy[g.gid] == "frame"), default=0)
    out_row = max((g.head.out_w * hw.to * g.head.qs
                   for g in compute if policy[g.gid] == "row"), default=0)
    out_buff = max(out_frame, out_row)

    # Eq. (5): write buffer.
    wr_row = max((g.tail.out_w * hw.to * g.tail.qa
                  for g in compute if policy[g.gid] == "row"), default=0)
    wr_frame = max((g.tail.out_w * g.tail.out_h * hw.to * g.tail.qa
                    for g in compute
                    if policy[g.gid] == "frame"
                    and g.gid in alloc.boundary_writes), default=0)
    write_buff = max(wr_row, wr_frame)

    # Eq. (6).
    sram_total = (row_buff + out_buff + write_buff
                  + sum(buff) + alloc.side_buff)   # det: int-exact bytes

    bram = _bram18k_total(row_buff, out_buff, write_buff, buff,
                          alloc.side_buff, hw)

    return SRAMReport(weight_buff=weight_buff, row_buff=row_buff,
                      out_buff=out_buff, write_buff=write_buff, buff=buff,
                      side_buff=alloc.side_buff, sram_total=sram_total,
                      bram18k=bram)


@lru_cache(maxsize=65536)
def _brams(total_bytes: int, width_bits: int, banks: int) -> int:
    """Eq. (7) for one physical buffer of ``banks`` banks (pure, cached:
    the cut-point engine hits the same few buffer sizes millions of
    times)."""
    if total_bytes == 0:
        return 0
    depth = math.ceil(total_bytes * 8 / (banks * width_bits))
    return banks * bram18k_count(depth, width_bits)


def _bram18k_total(row_buff: int, out_buff: int, write_buff: int,
                   buff: list[int], side_buff: int, hw: FPGAConfig) -> int:
    # Eq. (7) applied per physical buffer, To banks of 8-bit (x2 for the
    # double-INT8 weight feed), 32-bit for partial sums.
    to = hw.to
    return (_brams(row_buff, 8, to) + _brams(out_buff, 32, to)
            + _brams(write_buff, 8, to)
            + sum(_brams(b, 8, to) for b in buff)  # det: int bank counts
            + _brams(side_buff, 8, to))


# ---------------------------------------------------- vectorized evaluation
@dataclass
class SRAMTables:
    """Static per-group candidate terms for eqs. (1)-(5); the maxima are
    taken per candidate policy as masked array reductions."""
    compute: np.ndarray       # bool: compute/scale groups (eq. 1-5 domain)
    weight: np.ndarray        # int64: weight bytes (eq. 1 candidates)
    out_frame: np.ndarray     # int64: eq. (4) frame-mode candidates
    out_row: np.ndarray       # int64: eq. (4) row-mode candidates
    wr_row: np.ndarray        # int64: eq. (5) row-mode candidates
    wr_frame: list[int]       # eq. (5) frame-mode boundary-write candidates
    row_buff: int             # eq. (3): policy-independent


def sram_tables(gg: GroupedGraph, hw: FPGAConfig) -> SRAMTables:
    n = len(gg.groups)
    compute = np.zeros(n, dtype=bool)
    weight = np.zeros(n, dtype=np.int64)
    out_frame = np.zeros(n, dtype=np.int64)
    out_row = np.zeros(n, dtype=np.int64)
    wr_row = np.zeros(n, dtype=np.int64)
    wr_frame = [0] * n
    row_buff = 0
    for g in gg.groups:
        if not (g.is_compute or g.kind == "scale"):
            continue
        compute[g.gid] = True
        weight[g.gid] = g.weight_size
        row_buff = max(row_buff, 6 * g.head.in_w * g.head.in_ch * g.head.qa)
        out_frame[g.gid] = g.head.out_w * g.head.out_h * hw.to * g.head.qs
        out_row[g.gid] = g.head.out_w * hw.to * g.head.qs
        wr_row[g.gid] = g.tail.out_w * hw.to * g.tail.qa
        wr_frame[g.gid] = g.tail.out_w * g.tail.out_h * hw.to * g.tail.qa
    return SRAMTables(compute=compute, weight=weight, out_frame=out_frame,
                      out_row=out_row, wr_row=wr_row, wr_frame=wr_frame,
                      row_buff=row_buff)


