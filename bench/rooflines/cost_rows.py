"""K3, the exact float64 costs and the chunk's argmin (``csrc/search_pipeline.cu``;
K4's reduction runs in its block 0)."""
from __future__ import annotations

from rooflines import PEAK_F64_OPS_PER_S, bound

TRACE_NAMES = ("cost_rows_kernel", "cost_rows_split_kernel")
BLOCK = 256                 # candidates a block, one 32-byte row out each


def bound_s(B: int, shape: dict):
    """Mask (1 B) + io (4 B) per candidate and group and 7 stats in, one
    32-byte row per block out; ~8 float64 operations per group."""
    G = shape["groups"]
    return bound(5 * B * G + 28 * B + 32 * (-(-B // BLOCK)), B * (8 * G + 16),
                 PEAK_F64_OPS_PER_S)
