"""The LM kernels' entry points, as the model code calls them.

Each function dispatches by the device of its tensors: the hand-written
CUDA kernel for CUDA tensors, the plain torch version for CPU tensors.
There is no fallback and no switch in the environment: a CUDA tensor
launches the kernel or raises.

:func:`plain_versions` is the one exception, for checking: inside it the
plain versions run on the card as well, so that a whole model can be held
against itself, kernels against plain versions, on the same weights.
``launch/serve.py`` never enters it.
"""
from __future__ import annotations

import contextlib

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


def _kernel(t) -> bool:
    return t.is_cuda and not _PLAIN


def fused_block(x, scale, w_gate, w_up, w_down, post_scale=None, **kw):
    """K7: ``x + [post_norm](act(n @ Wg) * (n @ Wu)) @ Wd`` on ``x [M, d]``."""
    fn = fused_block_cuda if _kernel(x) else fused_block_torch
    return fn(x, scale, w_gate, w_up, w_down, post_scale, **kw)


def flash_attention(q, k, v, **kw):
    """K6: attention of a prefill from position 0."""
    fn = flash_attention_cuda if _kernel(q) else flash_attention_torch
    return fn(q, k, v, **kw)


def rglru_scan(a, b):
    """K9: ``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0``."""
    fn = rglru_scan_cuda if _kernel(a) else rglru_scan_torch
    return fn(a, b)


def ssd_scan(x, dt, A, Bm, Cm, D, h0=None, *, chunk):
    """K8: the SSD chunked scan of a prefill from state ``h0`` (or 0);
    returns ``(y, final_state)``."""
    fn = ssd_scan_cuda if _kernel(x) else ssd_scan_torch
    return fn(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
