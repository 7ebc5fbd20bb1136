"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

recurrence:  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
             a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
gates r, i come from block-diagonal projections of the conv'd input.

The counterpart of the JAX package's ``models/rglru.py``.  A prefill runs
the recurrence as K9 (``kernels/ops.py::rglru_scan``); decode (S == 1) is
the O(1) update in torch, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (D, Params, act_fn, model_dtype,
                                       rms_norm)
from repro_torch.models.mamba2 import causal_conv

C_FACTOR = 8.0
N_DIAG_BLOCKS = 8


def rglru_defs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    bw = w // N_DIAG_BLOCKS
    return {
        "pre_norm": D((d,), init="zeros"),
        "w_x": D((d, w)),                     # input branch
        "w_y": D((d, w)),                     # gate branch
        "conv_w": D((cfg.conv_width, w)),
        "conv_b": D((w,), init="zeros"),
        # block-diagonal RG-LRU gate projections
        "gate_a": D((N_DIAG_BLOCKS, bw, bw)),
        "gate_x": D((N_DIAG_BLOCKS, bw, bw)),
        "lam": D((w,), init="ones"),
        "w_out": D((w, d)),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., nb*bw] @ blockdiag(w [nb,bw,bw]) -> [..., nb*bw]."""
    nb, bw, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bw)
    y = torch.einsum("...nb,nbc->...nc", xs, w.to(x.dtype))
    return y.reshape(*x.shape[:-1], nb * bw)


def _gates(p: Params, xc: torch.Tensor):
    f32 = torch.float32
    r = torch.sigmoid(_block_diag(xc, p.gate_a).to(f32))
    i = torch.sigmoid(_block_diag(xc, p.gate_x).to(f32))
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


def rglru_apply(p: Params, x: torch.Tensor, cfg, state: dict | None = None):
    """Griffin recurrent block with residual.  state (decode):
      {"conv": [B,K-1,W], "h": [B,W] float32}."""
    S = x.shape[1]
    hidden = rms_norm(x, p.pre_norm)
    gate = act_fn(cfg.act)(hidden @ p.w_y.to(hidden.dtype))
    xb = hidden @ p.w_x.to(hidden.dtype)
    conv_state = None if state is None else state["conv"]
    xc, new_conv = causal_conv(xb, p.conv_w.to(x.dtype),
                               p.conv_b.to(x.dtype), conv_state)
    a, b = _gates(p, xc)
    if state is None or S > 1:
        h0 = None if state is None else state["h"]
        h = rglru_scan(a, b, h0=h0)
        h_last = h[:, -1]
    else:
        h = (a[:, 0] * state["h"] + b[:, 0])[:, None]
        h_last = h[:, 0]
    y = (h.to(x.dtype) * gate) @ p.w_out.to(x.dtype)
    return x + y, {"conv": new_conv, "h": h_last}


def init_rglru_state(cfg, batch: int, device="cpu") -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=model_dtype(cfg), device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
