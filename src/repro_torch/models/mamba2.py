"""Mamba-2 pieces in torch: so far only the depthwise causal convolution,
which the RG-LRU block shares with Mamba-2.

The SSD block itself (``ssm_defs``, ``ssm_apply``, ``ssd_chunked`` and the
TPU kernel ``repro/kernels/ssd_scan.py``, K8) is the next slice of the
port, with mamba2-2.7b serving.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: torch.Tensor | None = None):
    """x [B,S,Cd]; w [K,Cd] depthwise causal conv; state [B,K-1,Cd] carries
    the last K-1 inputs for decode.  Returns (silu(y), new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # [B,S+K-1,Cd]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return F.silu(y), new_state


def ssm_apply(*args, **kwargs):
    raise NotImplementedError(
        "the Mamba-2 SSD block (layer kind 'ssm', mamba2-2.7b) and its "
        "kernel K8 are the next slice of the port")
