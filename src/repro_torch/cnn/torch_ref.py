"""Direct PyTorch execution of a compiler IR graph.

The counterpart of the JAX package's ``repro/cnn/jax_ref.py``: the paper's
"unified software reference code for hardware verification" (Fig. 4) -- the
same network semantics, executed op by op with no memory schedule.  The
functional simulator (core/simulator.py) runs these very ops, so on one
device its output equals :func:`run_graph`'s bit for bit; any
buffer-allocation bug shows up as corruption.

Conventions kept from the JAX package at every public function:
activations are NHWC with a leading batch of 1, weights come from
:func:`init_params` as numpy arrays (conv HWIO ``[k, k, cin/groups, cout]``,
dwconv ``[k, k, 1, C]``, fc ``[cin, cout]``).  Inside, a convolution runs on
an NCHW view of the NHWC storage (PyTorch's ``channels_last``), with its
weight in PyTorch's OIHW layout (:func:`load_params` converts once).

Numerics: every convolution runs in full float32 -- cuDNN would otherwise
take TF32 on the card by default -- under a local
``cudnn.flags(deterministic=True, benchmark=False, allow_tf32=False)``, and
the fc product with TF32 matmuls switched off for its duration.  SAME
padding follows XLA: ``out = ceil(in / stride)``, the total padding
``max((out - 1) * stride + k - in, 0)`` split with the odd row and column at
the bottom and right, so it is asymmetric when the input is not a multiple
of the stride.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.ir import Graph, LayerNode


def init_params(graph: Graph, seed: int = 0) -> dict[int, np.ndarray]:
    """Per-node weights, NHWC kernels [k, k, cin/groups, cout] (numpy; the
    JAX package's ``init_params``, draw for draw)."""
    rng = np.random.default_rng(seed)
    params: dict[int, np.ndarray] = {}
    for n in graph:
        if n.kind == "conv":
            shape = (n.k, n.k, n.in_ch // n.groups, n.out_ch)
        elif n.kind == "dwconv":
            shape = (n.k, n.k, 1, n.in_ch)
        elif n.kind == "fc":
            shape = (n.in_ch, n.out_ch)
        else:
            continue
        params[n.idx] = (rng.standard_normal(shape, dtype=np.float32)
                        * (2.0 / np.sqrt(np.prod(shape[:-1]))))
    return params


def load_params(params: dict, device="cuda") -> dict[int, torch.Tensor]:
    """Weights on ``device`` in the layout the ops here take: a numpy HWIO
    kernel becomes an OIHW tensor, a numpy fc matrix stays ``[cin, cout]``;
    tensors are taken as already converted (moved to ``device``)."""
    out: dict[int, torch.Tensor] = {}
    for idx, w in params.items():
        if isinstance(w, torch.Tensor):
            out[idx] = w.to(device)
            continue
        t = torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()      # HWIO -> OIHW
        out[idx] = t.to(device)
    return out


@contextlib.contextmanager
def full_fp32():
    """Float32 convolutions and matmuls on the card: no TF32, and cuDNN's
    algorithm chosen by its deterministic heuristics, not by timing."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        mm.allow_tf32 = saved


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if act == "swish":
        return x * torch.sigmoid(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    return x


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (low, high) along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, k: int, stride: int, value: float):
    """NCHW ``x`` padded SAME for a k x k window at ``stride``."""
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)            # NHWC storage, NCHW view


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def apply_node(n: LayerNode, operands: list[torch.Tensor],
               params: dict[int, torch.Tensor]) -> torch.Tensor:
    """Execute one IR node.  operands follow n.inputs order; activations are
    NHWC with a leading batch of 1; ``params`` as :func:`load_params`
    gives them."""
    x = operands[0]
    if n.kind in ("conv", "dwconv"):
        w = params[n.idx]
        groups = n.in_ch if n.kind == "dwconv" else n.groups
        xc = _pad_nchw(_nchw(x), n.k, n.stride, 0.0)
        with full_fp32():
            y = F.conv2d(xc, w, stride=n.stride, groups=groups)
        return _act(_nhwc(y), n.act)
    if n.kind == "fc":
        w = params[n.idx]
        with full_fp32():
            y = x.reshape(x.shape[0], -1) @ w
        return _act(y, n.act).reshape(x.shape[0], 1, 1, n.out_ch)
    if n.kind == "maxpool":
        xc = _pad_nchw(_nchw(x), n.k, n.stride, float("-inf"))
        return _nhwc(F.max_pool2d(xc, n.k, n.stride))
    if n.kind == "avgpool":
        # zero padding counts in the divisor: always k * k, as in XLA
        xc = _pad_nchw(_nchw(x), n.k, n.stride, 0.0)
        return _nhwc(F.avg_pool2d(xc, n.k, n.stride,
                                  divisor_override=n.k * n.k))
    if n.kind == "globalpool":
        return x.mean(dim=(1, 2), keepdim=True)
    if n.kind == "upsample":
        return x.repeat_interleave(n.stride, dim=1).repeat_interleave(
            n.stride, dim=2)
    if n.kind == "add":
        return operands[0] + operands[1]
    if n.kind == "concat":
        return torch.cat(operands, dim=-1)
    if n.kind == "route":
        if n.out_ch == 4 * n.in_ch:          # space-to-depth (YOLOv2 reorg)
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c)
            return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2,
                                                       4 * c)
        return x                              # identity passthrough
    if n.kind == "scale":
        se = operands[1].reshape(1, 1, 1, -1)  # [1,1,1,C] channel gates
        return x * se
    raise ValueError(f"cannot execute node kind {n.kind}")


def as_input(x, device) -> torch.Tensor:
    """The network input as a float32 NHWC tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device)


def run_graph(graph: Graph, params: dict, x,
              device="cuda") -> dict[int, torch.Tensor]:
    """Execute every node on ``device``; returns all node outputs keyed by
    idx.  ``params`` may be :func:`init_params`' numpy arrays or
    :func:`load_params`' tensors; ``x`` a numpy array or a tensor."""
    w = load_params(params, device)
    outs: dict[int, torch.Tensor] = {}
    for n in graph:
        if n.kind == "input":
            outs[n.idx] = as_input(x, device)
            continue
        operands = [outs[i] for i in n.inputs]
        outs[n.idx] = apply_node(n, operands, w)
    return outs
