"""RG-LRU linear recurrence in PyTorch and CUDA.

``a, b [B, S, W]`` float32 -> ``h [B, S, W]`` with ``h_t = a_t * h_{t-1} +
b_t`` and ``h_{-1} = 0``: the scan of every prefill of a recurrent layer
(``models/rglru.py::rglru_scan``, which folds an initial state into ``b_0``
first).

Two implementations of the same function:

* :func:`rglru_scan_torch` -- the plain version: the recurrence in order,
  one product and one sum per step in float32.
* :func:`rglru_scan_cuda` -- the hand-written kernel
  (``csrc/rglru_scan.cu``), which replaces the TPU kernel
  ``repro/kernels/rglru_scan.py::_kernel``: one lane per (batch, channel)
  running the same sequential recurrence, so the two are equal bit for bit
  on the card.  A warp owns ``CHANNELS`` neighbouring channels and keeps
  the loads of ``RING_STAGES - 1`` stages of ``STAGE_STEPS`` steps in
  flight in a ring of shared memory while its chains run
  (:func:`rglru_scan_plan`).
  The TPU kernel's log-depth doubling scan computes the same function in
  another order; against it (and the JAX model's associative scan) the
  tolerance is 1e-4 in float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# the kernel's warp and ring (csrc/rglru_scan.cu CPW, STEPS, STAGES): a
# warp (one block) owns CHANNELS channels of one batch row; a stage is
# STAGE_STEPS steps of a and b for them; RING_STAGES - 1 stages are in
# flight while the chains consume one
CHANNELS = 16
STAGE_STEPS = 16
RING_STAGES = 8
WARP = 32


@dataclass(frozen=True)
class ScanPlan:
    """How :func:`rglru_scan_cuda` launches its kernel."""
    vec: int            # floats a cp.async copy: 4 (16 bytes) or 1
    groups_per_row: int  # channel groups of one batch row (the last ragged)
    blocks: int         # one warp each: B * groups_per_row
    stages: int         # stages of the sequence, ceil(S / STAGE_STEPS)
    smem_bytes: int     # the ring: RING_STAGES x 2 x STAGE_STEPS x CHANNELS
    #                     floats


def rglru_scan_plan(B: int, S: int, W: int,
                    aligned: bool = True) -> ScanPlan:
    """The launch of the kernel on ``[B, S, W]``: 16-byte copies when a
    step's row of a channel group is 16-byte aligned (W a multiple of 4 and
    ``aligned`` base pointers), else 4-byte copies."""
    groups = -(-W // CHANNELS)
    return ScanPlan(vec=4 if aligned and W % 4 == 0 else 1,
                    groups_per_row=groups, blocks=B * groups,
                    stages=-(-S // STAGE_STEPS),
                    smem_bytes=RING_STAGES * 2 * STAGE_STEPS * CHANNELS * 4)


def stage_copies(plan: ScanPlan, lane: int):
    """The copies ``lane`` issues for one stage, as the kernel's
    ``issue_stage`` numbers them: ``(array, step, first channel)`` with
    array 0 for ``a`` and 1 for ``b``; each copies ``plan.vec`` floats."""
    per_row = CHANNELS // plan.vec
    per_array = STAGE_STEPS * per_row
    out = []
    for j in range(2 * per_array // WARP):
        k = j * WARP + lane
        out.append((k // per_array, (k % per_array) // per_row,
                    (k % per_row) * plan.vec))
    return out


def _check(a, b):
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must be [B, S, W] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


# ------------------------------------------------------------ plain version
def rglru_scan_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: ``h = a[:, t] * h + b[:, t]`` for t in order."""
    _check(a, b)
    a, b = a.to(torch.float32), b.to(torch.float32)
    out = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


# ------------------------------------------------------------------- kernel
def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA recurrence (``csrc/rglru_scan.cu``) on float32 CUDA tensors.
    Launches the kernel or raises."""
    from repro_torch.kernels import _build

    _check(a, b)
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("rglru_scan_cuda wants CUDA tensors")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be float32, got {a.dtype}, {b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    B, S, W = a.shape
    plan = rglru_scan_plan(B, S, W, aligned=all(
        t.data_ptr() % 16 == 0 for t in (a, b)))
    dev = a.device
    lib = _build.load()
    err = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                B, S, W, plan.vec, dev.index or 0,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rglru_scan")
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0
