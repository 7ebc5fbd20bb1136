"""Fused residual MLP block in PyTorch and CUDA.

The block every MLP of the LM substrate runs (``models/layers.py::
mlp_apply``)::

    y = x + [post_norm]( act(n @ Wg) * (n @ Wu) ) @ Wd,   n = rmsnorm(x)

gated (GeGLU / SwiGLU) or ungated (``act(n @ Wu) @ Wd``, granite), with an
optional sandwich RMS norm (gemma2).  ``x`` is ``[M, d]``; ``w_gate`` /
``w_up`` are ``[d, F]`` and ``w_down`` ``[F, d]``, the JAX package's
``x @ W`` layout; the norm scales are ``[d]``.

Two implementations of the same function:

* :func:`fused_block_torch` -- the plain version, the JAX package's oracle
  ``kernels/ref.py::fused_block_ref`` in torch: the normalised tile and
  ``h`` are rounded to the input type, the products are taken in float32
  (``preferred_element_type=float32`` there).
* :func:`fused_block_cuda` -- the hand-written kernel
  (``csrc/fused_block.cu``), which replaces the TPU kernel
  ``repro/kernels/fused_block.py::_kernel``.  It keeps the rounding points
  of the TPU kernel; the design, and what bounds it, are in the source.

On bfloat16 inputs the two agree to bfloat16 tolerance (2e-2), in float32 to
2e-5; ``mlp_apply`` in the JAX package rounds at other points, so the kernel
matches it only to those tolerances.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6
MAX_D = 2560            # the kernel keeps at most 10 columns per thread
BLOCK_M = 8             # rows per block (csrc/fused_block.cu: BM)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return x * torch.sigmoid(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def _norm(v: torch.Tensor, s: torch.Tensor, eps: float) -> torch.Tensor:
    v32 = v.to(torch.float32)
    var = torch.mean(v32 * v32, dim=-1, keepdim=True)
    return v32 * torch.rsqrt(var + eps) * (1 + s.to(torch.float32))


def _check(x, scale, w_gate, w_up, w_down, post_scale, gated, sandwich):
    if x.ndim != 2:
        raise ValueError(f"x must be [M, d], got {tuple(x.shape)}")
    m, d = x.shape
    f = w_up.shape[1]
    if w_up.shape != (d, f) or w_down.shape != (f, d) or scale.shape != (d,):
        raise ValueError(f"shapes: x {tuple(x.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if gated and (w_gate is None or w_gate.shape != (d, f)):
        raise ValueError("gated block needs w_gate of shape [d, F]")
    if sandwich and (post_scale is None or post_scale.shape != (d,)):
        raise ValueError("sandwich block needs post_scale of shape [d]")


# ------------------------------------------------------------ plain version
def fused_block_torch(x, scale, w_gate, w_up, w_down, post_scale=None, *,
                      act: str = "silu", gated: bool = True,
                      sandwich: bool = False,
                      eps: float = EPS) -> torch.Tensor:
    """The plain version: ``kernels/ref.py::fused_block_ref`` in torch."""
    _check(x, scale, w_gate, w_up, w_down, post_scale, gated, sandwich)
    f32 = torch.float32
    n = _norm(x, scale, eps).to(x.dtype)
    u = n.to(f32) @ w_up.to(f32)
    if gated:
        h = _act(act, n.to(f32) @ w_gate.to(f32)) * u
    else:
        h = _act(act, u)
    y = h.to(x.dtype).to(f32) @ w_down.to(f32)
    if sandwich:
        y = _norm(y, post_scale, eps)
    return (x.to(f32) + y).to(x.dtype)


# ------------------------------------------------------------------- kernel
def fused_block_cuda(x, scale, w_gate, w_up, w_down, post_scale=None, *,
                     act: str = "silu", gated: bool = True,
                     sandwich: bool = False,
                     eps: float = EPS) -> torch.Tensor:
    """The CUDA block (``csrc/fused_block.cu``).  ``x`` and the weights are
    contiguous CUDA tensors of one type, float32 or bfloat16; the scales
    may be of any float type.  Launches the kernel or raises."""
    from repro_torch.kernels import _build

    _check(x, scale, w_gate, w_up, w_down, post_scale, gated, sandwich)
    mats = [x, w_up, w_down] + ([w_gate] if gated else [])
    if not all(t.is_cuda for t in mats):
        raise ValueError("fused_block_cuda wants CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in mats):
        raise TypeError(f"x and the weights must share one type, float32 or "
                        f"bfloat16; got {[t.dtype for t in mats]}")
    if not all(t.is_contiguous() for t in mats):
        raise ValueError("fused_block_cuda wants contiguous tensors")
    if act not in ("silu", "gelu"):
        raise ValueError(act)
    m, d = x.shape
    f = w_up.shape[1]
    if d > MAX_D:
        raise ValueError(f"fused_block_cuda takes d <= {MAX_D}, got {d}")
    dev = x.device
    out = torch.empty_like(x)
    if m == 0:
        return out
    scale32 = scale.to(device=dev, dtype=torch.float32).contiguous()
    post32 = (post_scale.to(device=dev, dtype=torch.float32).contiguous()
              if sandwich else None)
    m_tiles = -(-m // BLOCK_M)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # enough row tiles fill the card; otherwise F is split across blocks in
    # slabs of 64 columns (aiming at two blocks per SM), added in a second
    # pass
    if m_tiles >= sms:
        bf, splits = 256, 1
    else:
        bf = 64
        splits = min(-(-f // bf), -(-2 * sms // m_tiles))
    part = (torch.empty((splits, m, d), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    lib = _build.load()
    err = lib.fused_block_launch(
        x.data_ptr(), scale32.data_ptr(),
        w_gate.data_ptr() if gated else None, w_up.data_ptr(),
        w_down.data_ptr(), post32.data_ptr() if sandwich else None,
        out.data_ptr(), part.data_ptr() if part is not None else None,
        m, d, f, bf, splits, int(gated), int(act == "gelu"), int(sandwich),
        float(eps), int(x.dtype == torch.bfloat16), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_block")
    fused_block_cuda.launches += 1
    return out


fused_block_cuda.launches = 0
