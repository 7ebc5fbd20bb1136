"""The LM kernels' entry points, as the model code calls them.

Each function dispatches by the device of its tensors: the hand-written
CUDA kernel for CUDA tensors, the plain torch version for CPU tensors.
There is no fallback and no switch in the environment: a CUDA tensor
launches the kernel or raises.  Either runs inside the kernel's
``torch.autograd.Function`` (``kernels/autograd.py``), whose backward is
the same on both devices, so a training step takes its gradient through
the kernels on the card and through the same backward code on the CPU.

:func:`plain_versions` is the one exception, for checking: inside it the
plain versions run on the card as well, under ordinary autograd, so that a
whole model -- its loss and its gradients -- can be held against itself,
kernels against plain versions, on the same weights.  ``launch/serve.py``
and ``launch/train.py`` never enter it.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels.autograd import (FlashAttention, FusedBlock,
                                          RGLRUScan, SSDScan)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_torch)
from repro_torch.kernels.fused_block import (fused_block_cuda,
                                             fused_block_torch)
from repro_torch.kernels.rglru_scan import rglru_scan_cuda, rglru_scan_torch
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_torch

_PLAIN = False


@contextlib.contextmanager
def plain_versions():
    """Run the plain torch versions whatever the device, inside the block."""
    global _PLAIN
    before, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = before


def fused_block(x, scale, w_gate, w_up, w_down, post_scale=None, *,
                act="silu", gated=True, sandwich=False):
    """K7: ``x + [post_norm](act(n @ Wg) * (n @ Wu)) @ Wd`` on ``x [M, d]``."""
    kw = dict(act=act, gated=gated, sandwich=sandwich)
    if _PLAIN:
        return fused_block_torch(x, scale, w_gate, w_up, w_down, post_scale,
                                 **kw)
    fn = fused_block_cuda if x.is_cuda else fused_block_torch
    return FusedBlock.apply(fn, kw, x, scale, w_gate, w_up, w_down,
                            post_scale)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """K6: attention of a sequence from position 0 (a prefill, or a
    training forward)."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if _PLAIN:
        return flash_attention_torch(q, k, v, **kw)
    fn = flash_attention_cuda if q.is_cuda else flash_attention_torch
    return FlashAttention.apply(fn, kw, q, k, v)


def rglru_scan(a, b):
    """K9: ``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0``."""
    if _PLAIN:
        return rglru_scan_torch(a, b)
    fn = rglru_scan_cuda if a.is_cuda else rglru_scan_torch
    return RGLRUScan.apply(fn, a, b)


def ssd_scan(x, dt, A, Bm, Cm, D, h0=None, *, chunk):
    """K8: the SSD chunked scan of a prefill from state ``h0`` (or 0);
    returns ``(y, final_state)``."""
    if _PLAIN:
        return ssd_scan_torch(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    fn = ssd_scan_cuda if x.is_cuda else ssd_scan_torch
    return SSDScan.apply(fn, chunk, x, dt, A, Bm, Cm, D, h0)
