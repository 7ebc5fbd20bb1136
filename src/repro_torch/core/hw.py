"""Hardware descriptions for the two back-ends the compiler targets.

``FPGAConfig`` models the paper's KCU1500 accelerator (§III-B, §V) and is
used for the faithful reproduction of Tables II-VII.  ``TPUConfig`` models a
TPU v5e chip and is used by the LM residency planner (core/residency.py);
it is the JAX package's description, carried over unchanged so that the
same call plans the same stack in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

MB = 1 << 20
GB = 1 << 30


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
    def peak_gops(self) -> float:
        """INT8 ops/s: each mult+add pair = 2 ops."""
        return 2.0 * self.mults_normal * self.freq

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_bw / self.freq


@dataclass(frozen=True)
class TPUConfig:
    """TPU v5e per-chip constants (roofline + residency planning)."""
    name: str = "tpu-v5e"
    peak_flops: float = 197e12           # bf16 FLOP/s
    hbm_bw: float = 819e9                # bytes/s
    ici_bw: float = 50e9                 # bytes/s per link
    vmem_bytes: int = 128 * MB
    hbm_bytes: int = 16 * GB
    # MXU tiling granularity.
    lane: int = 128
    sublane: int = 8


V5E = TPUConfig()
KCU1500 = FPGAConfig()
