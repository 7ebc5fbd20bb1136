"""Int8 error-feedback gradient compression for cross-pod reduction.

The counterpart of the JAX package's ``optim/compression.py``, over
``{name: tensor}`` dicts: each gradient (plus the error carried from the
last step) is quantized to int8 with a per-tensor scale, and the
quantization error is fed back into the next step's gradient (error
feedback keeps SGD/Adam convergence -- Karimireddy et al. 2019).
``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
and scales are the JAX package's.

:func:`compressed_psum` -- the all-reduce of the compressed gradients over
a pod axis -- needs more than the one card the port runs on.
"""
from __future__ import annotations

import torch


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compress(grads: dict, error: dict):
    """-> (int8 codes, float32 scales, new error), each a dict like
    ``grads``."""
    q, scales, new_error = {}, {}, {}
    for n, g in grads.items():
        g = g.to(torch.float32) + error[n]
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q[n] = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        scales[n] = scale
        new_error[n] = g - q[n].to(torch.float32) * scale
    return q, scales, new_error


def decompress(q: dict, scales: dict) -> dict:
    return {n: q[n].to(torch.float32) * scales[n] for n in q}


def compressed_psum(grads, error, axis_name: str):
    """The int8 all-reduce over the pod axis ``axis_name``: not on one
    card."""
    raise NotImplementedError(
        f"compressed_psum over {axis_name!r} needs a pod axis across "
        f"devices; the port runs on one card (multi-device planning is "
        f"ROADMAP queue 1's multi-device item)")
