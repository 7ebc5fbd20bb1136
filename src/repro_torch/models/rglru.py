"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

recurrence:  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
             a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
gates r, i come from block-diagonal projections of the conv'd input.

The counterpart of the JAX package's ``models/rglru.py``.  A prefill runs
the recurrence as K9 (``kernels/ops.py::rglru_scan``); decode (S == 1) is
the O(1) update in torch, as in the JAX package.

With the width split over a mesh's ``model`` axis (``tp``, the ``ff``
rule): ``w_x``, ``w_y``, the convolution and ``lam`` are a rank's
contiguous slice of the width, ``w_out`` is row-parallel, and the state
is the slice's.  The block-diagonal gates are split on their rows inside
each block, which do not line up with a rank's slice of the width: they
are gathered when the layer runs (``2 x N x bw x bw``, small) and the
rank's blocks taken; K9 then scans the rank's width.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (D, Params, act_fn, block_in,
                                       block_out, model_dtype, on_shard,
                                       rms_norm)
from repro_torch.models.mamba2 import causal_conv

C_FACTOR = 8.0
N_DIAG_BLOCKS = 8


def rglru_defs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    bw = w // N_DIAG_BLOCKS
    return {
        "pre_norm": D((d,), ("embed",), init="zeros"),
        "w_x": D((d, w), ("embed", "ff")),         # input branch
        "w_y": D((d, w), ("embed", "ff")),         # gate branch
        "conv_w": D((cfg.conv_width, w), (None, "ff")),
        "conv_b": D((w,), ("ff",), init="zeros"),
        # block-diagonal RG-LRU gate projections
        "gate_a": D((N_DIAG_BLOCKS, bw, bw), (None, "ff", None)),
        "gate_x": D((N_DIAG_BLOCKS, bw, bw), (None, "ff", None)),
        "lam": D((w,), ("ff",), init="ones"),
        "w_out": D((w, d), ("ff", "embed")),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., nb*bw] @ blockdiag(w [nb,bw,bw]) -> [..., nb*bw]."""
    nb, bw, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bw)
    y = torch.einsum("...nb,nbc->...nc", xs, w.to(x.dtype))
    return y.reshape(*x.shape[:-1], nb * bw)


def _gates(p: Params, xc: torch.Tensor, tp=None):
    gate_a, gate_x = p.gate_a, p.gate_x
    if tp is not None and tp.ff:
        # the rank's blocks of the gathered gates (its width is whole
        # blocks), or its channels of the whole width's gates
        gate_a, gate_x = (tp.gather_shards(gate_a, 1),
                          tp.gather_shards(gate_x, 1))
        bw = gate_a.shape[1]
        w = xc.shape[-1]
        if w % bw == 0:
            mine = slice(tp.rank * w // bw, (tp.rank + 1) * w // bw)
            gate_a, gate_x = gate_a[mine], gate_x[mine]
        else:
            xs = tp.gather_shards(xc, -1)
            return _finish(tp.slice(_block_diag(xs, gate_a), -1),
                           tp.slice(_block_diag(xs, gate_x), -1), p, xc)
    return _finish(_block_diag(xc, gate_a), _block_diag(xc, gate_x), p, xc)


def _finish(ya: torch.Tensor, yx: torch.Tensor, p: Params,
            xc: torch.Tensor):
    f32 = torch.float32
    r = torch.sigmoid(ya.to(f32))
    i = torch.sigmoid(yx.to(f32))
    log_a = -C_FACTOR * torch.nn.functional.softplus(p.lam.to(f32)) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i * xc.to(f32)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1; a,b [B,S,W] float32.  An initial
    state is folded into b_0 (the kernel starts from 0)."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    return ops.rglru_scan(a, b)


def rglru_apply(p: Params, x: torch.Tensor, cfg, state: dict | None = None,
                tp=None):
    """Griffin recurrent block with residual.  state (decode):
      {"conv": [B,K-1,W], "h": [B,W] float32} (W the rank's width under
    ``tp``).  Under Megatron-SP (``tp.seq``) ``x`` is this rank's
    sequence shard: normed there, gathered for the block, its output
    reduce-scattered back."""
    split = tp is not None and tp.ff
    hh = block_in(rms_norm(x, on_shard(p.pre_norm, tp)), tp, split)
    S = hh.shape[1]
    gate = act_fn(cfg.act)(hh @ p.w_y.to(hh.dtype))
    xb = hh @ p.w_x.to(hh.dtype)
    conv_state = None if state is None else state["conv"]
    xc, new_conv = causal_conv(xb, p.conv_w.to(x.dtype),
                               p.conv_b.to(x.dtype), conv_state)
    a, b = _gates(p, xc, tp)
    if state is None or S > 1:
        h0 = None if state is None else state["h"]
        h = rglru_scan(a, b, h0=h0)
        h_last = h[:, -1]
    else:
        h = (a[:, 0] * state["h"] + b[:, 0])[:, None]
        h_last = h[:, 0]
    y = (h.to(x.dtype) * gate) @ p.w_out.to(x.dtype)
    if split:
        y = block_out(y.to(torch.float32), tp, x.dtype)
    return x + y, {"conv": new_conv, "h": h_last}


def init_rglru_state(cfg, batch: int, device="cpu") -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=model_dtype(cfg), device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
