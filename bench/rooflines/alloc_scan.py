"""K1, the allocator replay (``csrc/alloc_scan.cu``)."""
from __future__ import annotations

from rooflines import PEAK_INT32_OPS_PER_S, bound

TRACE_NAMES = ("alloc_scan_kernel",)

# Operations of one allocator step as Algorithm 1 states it
# (``allocator.alloc_step``), one per compare, add, maximum or select, with
# buffers addressed by index:
#   a main-path step -- main operand in a buffer? (1), first free buffer (3),
#     fetch needed? (1), input buffer maximum (2), boundary reads into io and
#     bfm (2), final output? with its write into io, bfm, wrf (5), first
#     free buffer that holds no operand (3), take-over of the main operand's
#     buffer (3), claim or spill with its bytes and feasibility (5), owner and
#     buffer maximum (2), location (1): 28; a shortcut adds its buffer's
#     maximum (2);
#   each producer it consumes -- in DRAM? and its read bytes (2), mark its
#     buffer (1), consume (1), row-mode boundary write into io, bfm, wrf (5),
#     dead? owner? release (3): 12;
#   a side step -- side maximum and location (2); each producer: consume,
#     dead? owner? release (4).
OPS_STEP, OPS_SHORTCUT, OPS_PRODUCER = 28, 2, 12
OPS_SIDE_STEP, OPS_SIDE_PRODUCER = 2, 4


def ops_per_candidate(shape: dict) -> int:
    """Integer operations one candidate's replay needs on this graph."""
    total = 0
    for side, fan_in, shortcut in shape["steps"]:
        if side:
            total += OPS_SIDE_STEP + fan_in * OPS_SIDE_PRODUCER
        else:
            total += (OPS_STEP + shortcut * OPS_SHORTCUT
                      + fan_in * OPS_PRODUCER)
    return total


def bound_s(B: int, shape: dict):
    """Frame bits in; io (int32) and 7 stats out; the step rule's
    operations."""
    G = shape["groups"]
    return bound(B * G + 4 * B * G + 28 * B, B * ops_per_candidate(shape),
                 PEAK_INT32_OPS_PER_S)
