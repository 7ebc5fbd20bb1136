"""Frozen roofline counts of the cut search's kernels on an NVIDIA H100.

Each module beside this one holds one kernel's least time on the card at a
chunk of ``B`` candidates: the bytes the function must move (each input
read once, each output written once) against the operations it must do,
the larger of the two times.  The counts come from the shapes in a
configuration's data, never from what the program allocates.  A kernel
added later brings a module of its own.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet peaks: device memory rate, and the vector (non
# tensor core) rates of the two operation types these kernels use.  int32
# issues at half the float32 rate of 67 TFLOP/s; float64 is 34 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12
PEAK_F64_OPS_PER_S = 34e12


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(least seconds, "bytes" or "operations": which of the two sets it)."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S
    by_ops = n_ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def chunks(space: int, chunk: int) -> list[int]:
    """The candidates of each launch when ``space`` candidates are searched
    ``chunk`` at a time."""
    return [min(chunk, space - lo) for lo in range(0, space, chunk)]


def traced_share(window, kernel) -> float | None:
    """A kernel's share of its roofline in a traced window, in percent: its
    least time per launch at the window's chunks over its traced device
    time per launch.  None where the trace saw no launch of it."""
    if window.trace is None or not window.chunks:
        return None
    ops = window.trace["device_ops"]
    seen = [ops[n] for n in kernel.TRACE_NAMES if n in ops]
    count = sum(s["count"] for s in seen)
    seconds = sum(s["seconds"] for s in seen)
    if not count or seconds <= 0:
        return None
    least = sum(kernel.bound_s(b, window.shape)[0] for b in window.chunks)
    return 100.0 * least / len(window.chunks) * count / seconds
