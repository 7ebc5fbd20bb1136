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

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

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


# ------------------------------------------- fake versions and FLOP counts
# What lets a step be traced on fake tensors (``launch/dryrun.py::
# trace_cell``, under ``FakeTensorMode``, where ``x.is_cuda`` holds without
# a card): each operator's output shapes and types without running it, and
# the FLOPs of its own work for ``torch.utils.flop_counter.FlopCounterMode``
# (so the plain version's steps are never what is counted), each counted
# as ``utils/costmodel.py`` counts the same layer.
def _fused_block_fake(x, scale, w_gate, w_up, w_down, post_scale, *, act,
                      gated, sandwich, partial=False):
    return x.new_empty((x.shape[0], w_down.shape[1]),
                       dtype=torch.float32 if partial else x.dtype)


def _flash_attention_fake(q, k, v, *, causal, window, softcap, q_offset=0):
    return q.new_empty(q.shape)


def _ssd_scan_fake(x, dt, A, Bm, Cm, D, h0, *, chunk):
    b, _s, h, p = x.shape
    return x.new_empty(x.shape), x.new_empty((b, h, p, Bm.shape[-1]),
                                             dtype=torch.float32)


def _rglru_scan_fake(a, b):
    return a.new_empty(a.shape, dtype=torch.float32)


for _name, _fake in (("fused_block", _fused_block_fake),
                     ("flash_attention", _flash_attention_fake),
                     ("ssd_scan", _ssd_scan_fake),
                     ("rglru_scan", _rglru_scan_fake)):
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)


def attention_pairs(s: int, t: int, *, causal: bool, window: int,
                    q_offset: int = 0) -> int:
    """The (query, key) pairs K6 attends: queries at positions
    ``q_offset + i`` (i < s), keys at ``j < t``, each pair kept by the
    causal mask (``j <= position``) and the sliding window (``position -
    j < window``, 0 for none)."""
    pos = np.arange(s, dtype=np.int64) + q_offset
    hi = np.minimum(pos, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, *, causal, window,
                           softcap, q_offset=0, **_kw) -> int:
    """``Q K^T`` and ``P V`` over the pairs the masks keep, 2 hd each:
    ``costmodel._attn_layer_flops``'s ``2 * 2 * S * eff * nh * hd``, with
    the pairs counted exactly (causal: ``S (S + 1) / 2``, its
    ``eff = (S + 1) / 2``)."""
    b, s, h, hd = q_shape
    return 4 * b * h * hd * attention_pairs(
        s, k_shape[1], causal=causal, window=window, q_offset=q_offset)


@register_flop_formula(torch.ops.repro_torch.fused_block)
def _fused_block_flops(x_shape, scale_shape, w_gate_shape, w_up_shape,
                       w_down_shape, post_scale_shape, *, gated, **_kw
                       ) -> int:
    """K7's products, ``2 M d F`` each, three gated and two not
    (``costmodel._ffn_flops``); the partial form's ``F`` is the rank's."""
    m, d = x_shape
    return (3 if gated else 2) * 2 * m * d * w_up_shape[1]


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_scan_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, d_shape,
                    h0_shape, *, chunk, **_kw) -> int:
    """``costmodel._ssm_layer_flops``'s scan: ``S (2 Q g n + 2 Q h p + 8 h
    p n)`` a sequence, Q the chunk."""
    b, s, h, p = x_shape
    g, n = b_shape[2], b_shape[3]
    return b * s * (2 * chunk * g * n + 2 * chunk * h * p + 8 * h * p * n)


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _rglru_scan_flops(a_shape, b_shape, **_kw) -> int:
    """``costmodel._rglru_layer_flops``'s scan: ``8 S W`` a sequence."""
    b, s, w = a_shape
    return 8 * b * s * w


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
