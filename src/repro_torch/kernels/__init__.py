"""Hand-written CUDA kernels of the cut search, each beside its plain torch
version:

    alloc_scan.py      -- tensorized allocator replay: Algorithm 1's
                          sequential state machine for a whole batch of
                          candidates (CompileOptions engine="device")
    search_pipeline.py -- fused sub-space search: candidate enumeration ->
                          alloc_scan replay -> exact float64 cost reduction
                          -> lexicographic argmin, so only the winning tuple
                          reaches the host (CompileOptions engine="pipeline")
    score_batch.py     -- staged float32 scorer: the batched scorer's masked
                          reductions in float32 (CompileOptions
                          backend="pallas")
    csrc/*.cu          -- the kernels' sources, CUDA C++ for sm_90a
    _build.py          -- nvcc + ctypes: build at first use, load once

Nothing here touches nvcc or the GPU at import time.
"""
from __future__ import annotations


def kernel_wrappers() -> dict:
    """name -> the wrapper that launches that kernel.  Each wrapper counts
    its launches in its ``launches`` attribute."""
    from repro_torch.kernels.alloc_scan import alloc_scan_cuda
    from repro_torch.kernels.score_batch import score_batch_cuda
    from repro_torch.kernels.search_pipeline import (argmin_rows_cuda,
                                                     cost_rows_cuda,
                                                     enum_frames_cuda)
    return {"alloc_scan": alloc_scan_cuda, "enum_frames": enum_frames_cuda,
            "cost_rows": cost_rows_cuda, "argmin_rows": argmin_rows_cuda,
            "score_batch": score_batch_cuda}


def launch_counts() -> dict:
    """name -> launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
