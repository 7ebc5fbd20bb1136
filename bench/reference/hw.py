"""The accelerator the compiler targets: the paper's KCU1500 (§III-B, §V).

Frozen copy of the port's ``FPGAConfig``; a configuration file gives its
field values as data.
"""
from __future__ import annotations

from dataclasses import dataclass

MB = 1 << 20


@dataclass(frozen=True)
class FPGAConfig:
    """KCU1500 accelerator parameters (paper §III-B / Table V)."""
    name: str = "kcu1500"
    freq: float = 200e6                  # Hz
    # Shared MAC array: 2048 MACs -> 4096 mult/cycle normal conv (double
    # INT8 per DSP), 2048 mult/cycle depthwise (no input sharing).
    mults_normal: int = 4096
    mults_dw: int = 2048
    ti: int = 64                         # input-channel parallelism
    to: int = 64                         # output-channel parallelism
    # Effective DRAM bandwidth calibrated against Table V latencies (the
    # paper's own numbers imply ~2.7-4 GB/s effective single-bank access).
    dram_bw: float = 4.0e9               # bytes/s effective
    bram18k_total: int = 4320
    sram_budget: int = 9 * MB            # raw SRAM ceiling (~BRAM capacity)
    group_overhead_cycles: int = 256     # per-group instruction dispatch

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_bw / self.freq
