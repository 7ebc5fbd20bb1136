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

Each kernel is also an operator of its own, ``torch.ops.repro_torch.<name>``
(registered once, when this module is imported), whose body is that
choice by device.  The dispatcher then sees a launch as one op, where it
would otherwise see only the output's ``torch.empty`` (the launch itself is
a ``ctypes`` call): so the training path's selective checkpoint
(``remat="dots"``, ``models/transformer.py::apply_stack``) can keep a
kernel's output, or run the kernel again, by the op's name, on the card
and on the CPU alike.
"""
import contextlib

import torch

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


# ------------------------------------------------- the kernels as operators
# Defined with ``torch.library.Library`` (a schema and one Python body for
# every device, ``CompositeExplicitAutograd``), which costs a call a few
# microseconds on the host where ``torch.library.custom_op`` costs tens.
# Each body picks the kernel for CUDA tensors and the plain version for CPU
# ones, looking the two up in this module when it runs; none returns a
# tensor that aliases an input.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("fused_block(Tensor x, Tensor scale, Tensor? w_gate, "
            "Tensor w_up, Tensor w_down, Tensor? post_scale, *, str act, "
            "bool gated, bool sandwich, bool partial=False) -> Tensor")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, *, bool causal, "
            "int window, float softcap, int q_offset=0) -> Tensor")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, "
            "Tensor D, Tensor? h0, *, int chunk) -> (Tensor, Tensor)")
_LIB.define("rglru_scan(Tensor a, Tensor b) -> Tensor")


def _fused_block(x, scale, w_gate, w_up, w_down, post_scale, *, act, gated,
                 sandwich, partial=False):
    fn = fused_block_cuda if x.is_cuda else fused_block_torch
    return fn(x, scale, w_gate, w_up, w_down, post_scale, act=act,
              gated=gated, sandwich=sandwich, partial=partial)


def _flash_attention(q, k, v, *, causal, window, softcap, q_offset=0):
    fn = flash_attention_cuda if q.is_cuda else flash_attention_torch
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)


def _ssd_scan(x, dt, A, Bm, Cm, D, h0, *, chunk):
    fn = ssd_scan_cuda if x.is_cuda else ssd_scan_torch
    return fn(x, dt, A, Bm, Cm, D, h0, chunk=chunk)


def _rglru_scan(a, b):
    fn = rglru_scan_cuda if a.is_cuda else rglru_scan_torch
    return fn(a, b)


_LIB.impl("fused_block", _fused_block, "CompositeExplicitAutograd")
_LIB.impl("flash_attention", _flash_attention, "CompositeExplicitAutograd")
_LIB.impl("ssd_scan", _ssd_scan, "CompositeExplicitAutograd")
_LIB.impl("rglru_scan", _rglru_scan, "CompositeExplicitAutograd")
fused_block_op = torch.ops.repro_torch.fused_block.default
flash_attention_op = torch.ops.repro_torch.flash_attention.default
ssd_scan_op = torch.ops.repro_torch.ssd_scan.default
rglru_scan_op = torch.ops.repro_torch.rglru_scan.default


# ------------------------------------------------------- the entry points
def fused_block(x, scale, w_gate, w_up, w_down, post_scale=None, *,
                act="silu", gated=True, sandwich=False, partial=False):
    """K7: ``x + [post_norm](act(n @ Wg) * (n @ Wu)) @ Wd`` on ``x [M, d]``;
    ``partial``: the float32 ``(act(n @ Wg) * (n @ Wu)) @ Wd`` of the F
    slice given, alone (tensor parallelism over ``ff``)."""
    kw = dict(act=act, gated=gated, sandwich=sandwich and not partial,
              partial=partial)
    if _PLAIN:
        return fused_block_torch(x, scale, w_gate, w_up, w_down, post_scale,
                                 **kw)
    return FusedBlock.apply(fused_block_op, kw, x, scale, w_gate, w_up,
                            w_down, post_scale)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0):
    """K6: attention of a sequence from position 0 (a prefill, or a
    training forward), or of its queries from ``q_offset`` on against keys
    from 0 (a context-parallel slice)."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if _PLAIN:
        return flash_attention_torch(q, k, v, **kw)
    return FlashAttention.apply(flash_attention_op, kw, q, k, v)


def rglru_scan(a, b):
    """K9: ``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0``."""
    if _PLAIN:
        return rglru_scan_torch(a, b)
    return RGLRUScan.apply(rglru_scan_op, a, b)


def ssd_scan(x, dt, A, Bm, Cm, D, h0=None, *, chunk):
    """K8: the SSD chunked scan of a prefill from state ``h0`` (or 0);
    returns ``(y, final_state)``."""
    if _PLAIN:
        return ssd_scan_torch(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    return SSDScan.apply(ssd_scan_op, chunk, x, dt, A, Bm, Cm, D, h0)
