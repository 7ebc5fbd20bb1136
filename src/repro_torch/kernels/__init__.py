"""Hand-written CUDA kernels of the cut search and of the LM substrate, each
beside its plain torch version:

    alloc_scan.py      -- tensorized allocator replay: Algorithm 1's
                          sequential state machine for a whole batch of
                          candidates (CompileOptions engine="device"), and
                          the state a chunk's candidates share before
                          their first differing group
    search_pipeline.py -- fused sub-space search: candidate enumeration ->
                          alloc_scan replay -> exact float64 cost reduction
                          -> lexicographic argmin, so only the winning tuple
                          reaches the host (CompileOptions engine="pipeline")
    score_batch.py     -- staged float32 scorer: the batched scorer's masked
                          reductions in float32 (CompileOptions
                          backend="pallas")
    flash_attention.py -- online-softmax attention of an LM prefill (on
                          the tensor cores in bfloat16)
    fused_block.py     -- the fused residual MLP block of every LM layer
                          (two tensor-core products in bfloat16)
    ssd_scan.py        -- the Mamba-2 SSD chunked scan of a prefill (on
                          the tensor cores in bfloat16)
    rglru_scan.py      -- the RG-LRU linear recurrence of a prefill
    ops.py             -- the LM kernels' dispatch: kernel on CUDA, plain
                          version on the CPU
    autograd.py        -- K6-K9 as autograd Functions: training takes its
                          gradient through the kernels
    csrc/*.cu          -- the kernels' sources, CUDA C++ for sm_90a
    _build.py          -- nvcc + ctypes: build at first use, load once

Nothing here touches nvcc or the GPU at import time.
"""
from __future__ import annotations


def kernel_wrappers() -> dict:
    """name -> the wrapper that launches that kernel.  Each wrapper counts
    its launches in its ``launches`` attribute; a wrapper that picks one of
    several kernels (K5, K6, K7, K8) also counts them apart in
    ``launches_by_variant``."""
    from repro_torch.kernels.alloc_scan import (alloc_prefix_cuda,
                                                alloc_scan_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.fused_block import fused_block_cuda
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda
    from repro_torch.kernels.score_batch import score_batch_cuda
    from repro_torch.kernels.search_pipeline import (argmin_rows_cuda,
                                                     cost_rows_cuda,
                                                     enum_frames_cuda)
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    return {"alloc_scan": alloc_scan_cuda, "alloc_prefix": alloc_prefix_cuda,
            "enum_frames": enum_frames_cuda,
            "cost_rows": cost_rows_cuda, "argmin_rows": argmin_rows_cuda,
            "score_batch": score_batch_cuda,
            "flash_attention": flash_attention_cuda,
            "fused_block": fused_block_cuda, "ssd_scan": ssd_scan_cuda,
            "rglru_scan": rglru_scan_cuda}


def launch_counts() -> dict:
    """name -> launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def fused_launch_counts() -> dict:
    """name -> launches of another wrapper's kernel that ran this kernel's
    work since the last :func:`reset_launch_counts`, for the wrappers whose
    work may be fused (K4: the chunk winners K3's block 0 takes)."""
    return {name: fn.fused_launches
            for name, fn in kernel_wrappers().items()
            if hasattr(fn, "fused_launches")}


def launch_counts_by_variant() -> dict:
    """name -> {variant: launches} since the last
    :func:`reset_launch_counts`, for the wrappers with variants."""
    return {name: dict(fn.launches_by_variant)
            for name, fn in kernel_wrappers().items()
            if hasattr(fn, "launches_by_variant")}


def launch_counts_by_form() -> dict:
    """name -> {form: launches} since the last :func:`reset_launch_counts`,
    for the wrappers with forms beside their default (K6 with a query
    offset, K7's partial sum)."""
    return {name: dict(fn.launches_by_form)
            for name, fn in kernel_wrappers().items()
            if hasattr(fn, "launches_by_form")}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "fused_launches"):
            fn.fused_launches = 0
        for variant in getattr(fn, "launches_by_variant", ()):
            fn.launches_by_variant[variant] = 0
        for form in getattr(fn, "launches_by_form", ()):
            fn.launches_by_form[form] = 0


def upload(device, *arrays) -> list:
    """numpy arrays -> tensors on ``device``, a copy each: the one way the
    cut search's tables reach the device, counted under a profiler as
    ``pipeline.uploads`` (``utils/tracing.py``)."""
    import numpy as np
    import torch

    from repro_torch.utils import tracing

    tracing.count("pipeline.uploads", len(arrays))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]
