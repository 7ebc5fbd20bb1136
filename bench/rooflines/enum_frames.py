"""K2, the enumeration of cut tuples (``csrc/search_pipeline.cu``)."""
from __future__ import annotations

from rooflines import PEAK_INT32_OPS_PER_S, bound

TRACE_NAMES = ("enum_frames_kernel",)


def bound_s(B: int, shape: dict):
    """One byte out per candidate and group; one divide and one modulo per
    enumerated run, a compare and a direction select per group."""
    G = shape["groups"]
    return bound(B * G, B * (2 * shape["runs"] + 3 * G), PEAK_INT32_OPS_PER_S)
