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
  ``repro/kernels/rglru_scan.py::_kernel``: one thread per (batch, channel)
  running the same sequential recurrence, so the two are equal bit for bit
  on the card.  The TPU kernel's log-depth doubling scan computes the same
  function in another order; against it (and the JAX model's associative
  scan) the tolerance is 1e-4 in float32.
"""
from __future__ import annotations

import torch


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
    dev = a.device
    lib = _build.load()
    err = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                B, S, W, dev.index or 0,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rglru_scan")
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0
