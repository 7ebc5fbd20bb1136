"""Int8 error-feedback gradient compression for cross-pod reduction.

The counterpart of the JAX package's ``optim/compression.py``, over
``{name: tensor}`` dicts: each gradient (plus the error carried from the
last step) is quantized to int8 with a per-tensor scale, and the
quantization error is fed back into the next step's gradient (error
feedback keeps SGD/Adam convergence -- Karimireddy et al. 2019).
``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
and scales are the JAX package's.

:func:`compressed_psum` is the all-reduce of the compressed gradients
over a process group (a mesh run's ``pod`` group,
``launch/distributed.py::MeshRun.groups``); like the JAX package's, the
training step never calls it (a mesh run sums its gradients
uncompressed).
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


def compressed_psum(grads: dict, error: dict, group) -> tuple[dict, dict]:
    """The all-reduce of ``grads`` over ``group`` (the mesh's ``pod``
    axis) in int8 with error feedback: each rank compresses its own
    gradients (:func:`compress`), the int8 codes are summed as int32 and
    the scales reduced with MAX over the group, and each leaf is the
    codes' sum times the largest scale divided by the group's size.
    Returns ``(mean, new error)``.  That is the JAX package's function as
    it stands: each rank quantised with its own scale, so a rank whose
    scale is below the largest is weighted by the wrong one (ROADMAP R11;
    its ``train`` never calls it, nor does the port's)."""
    from repro_torch.launch import tensor_parallel as tpc

    q, scales, new_error = compress(grads, error)
    n = torch.distributed.get_world_size(group)
    mean = {}
    for k in q:
        total = tpc.all_reduce(q[k].to(torch.int32), group)
        top = tpc.all_reduce(scales[k].clone(), group,
                             torch.distributed.ReduceOp.MAX)
        mean[k] = total.to(torch.float32) * top / n
    return mean, new_error
