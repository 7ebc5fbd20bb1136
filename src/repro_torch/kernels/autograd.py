"""The LM kernels K6-K9 as ``torch.autograd.Function``s, so that training
takes a gradient through them on the card.

The JAX package has no backward kernel: it differentiates its plain
training functions (its Pallas kernels serve only).  So each Function here:

* forward -- runs the forward it is given (``kernels/ops.py`` gives the
  CUDA wrapper for CUDA tensors, the plain version for CPU ones) and saves
  its inputs;
* backward -- recomputes the port's counterpart of the JAX package's
  training function from the saved inputs, in their own type, under
  ``torch.enable_grad()``, and differentiates it:

  - K6: causal ``models/attention.py::plain_attention`` with
    ``grad_fence`` on q, k and v (the JAX training path's attention);
  - K7: ``models/layers.py::mlp_unfused``, the JAX ``mlp_apply`` with its
    products in ``x``'s type (not ``fused_block_torch``, whose products
    sum in float64);
  - K8: ``ssd_scan_torch`` (the JAX ``ssd_chunked`` in torch);
  - K9: none to recompute: the gradient of ``h_t = a_t h_{t-1} + b_t`` is
    the same recurrence run backwards, ``g_t = dh_t + a_{t+1} g_{t+1}``,
    so the backward runs the Function's own forward (K9 itself on the
    card) on the reversed inputs, then ``da_t = g_t h_{t-1}``,
    ``db_t = g_t``.

So a training step on the card launches K6-K8 in the forward (and again in
a rematerialised layer's recomputation) and K9 in the forward and the
backward; the backward of K6-K8 is plain torch.  Backward kernels for
Hopper are later work (ROADMAP queue 2).
"""
from __future__ import annotations

import torch


def _grads(outputs, inputs, grad_outputs, needs):
    """d outputs / d inputs[i] for each ``needs[i]``, None elsewhere."""
    want = [x for x, n in zip(inputs, needs) if n]
    got = iter(torch.autograd.grad(outputs, want, grad_outputs,
                                   allow_unused=True) if want else ())
    return [next(got) if n else None for n in needs]


def _leaves(tensors):
    """Detached copies of ``tensors`` that require grad (None stays)."""
    return [None if t is None else t.detach().requires_grad_()
            for t in tensors]


class FlashAttention(torch.autograd.Function):
    """K6: ``forward(q, k, v, causal=, window=, softcap=)``."""

    @staticmethod
    def forward(ctx, forward, kw, q, k, v):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return forward(q, k, v, **kw)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import plain_attention
        from repro_torch.models.layers import grad_fence

        kw = ctx.kw
        ins = _leaves(ctx.saved_tensors)
        with torch.enable_grad():
            out = plain_attention(*(grad_fence(t) for t in ins),
                                  causal=kw["causal"], window=kw["window"],
                                  softcap_val=kw["softcap"])
        return (None, None, *_grads(out, ins, g, ctx.needs_input_grad[2:]))


class FusedBlock(torch.autograd.Function):
    """K7: ``forward(x, scale, w_gate, w_up, w_down, post_scale, act=,
    gated=, sandwich=)`` on ``x [M, d]``."""

    @staticmethod
    def forward(ctx, forward, kw, x, scale, w_gate, w_up, w_down,
                post_scale):
        ctx.save_for_backward(x, scale, w_gate, w_up, w_down, post_scale)
        ctx.kw = kw
        return forward(x, scale, w_gate, w_up, w_down, post_scale, **kw)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.layers import mlp_unfused

        ins = _leaves(ctx.saved_tensors)
        with torch.enable_grad():
            out = mlp_unfused(*ins, **ctx.kw)
        return (None, None, *_grads(out, ins, g, ctx.needs_input_grad[2:]))


class SSDScan(torch.autograd.Function):
    """K8: ``forward(x, dt, A, Bm, Cm, D, h0, chunk=)`` -> ``(y, state)``."""

    @staticmethod
    def forward(ctx, forward, chunk, x, dt, A, Bm, Cm, D, h0):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, h0)
        ctx.chunk = chunk
        return forward(x, dt, A, Bm, Cm, D, h0, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        from repro_torch.kernels.ssd_scan import ssd_scan_torch

        ins = _leaves(ctx.saved_tensors)
        with torch.enable_grad():
            out = ssd_scan_torch(*ins, chunk=ctx.chunk)
        return (None, None, *_grads(out, ins, (gy, gstate),
                                    ctx.needs_input_grad[2:]))


class RGLRUScan(torch.autograd.Function):
    """K9: ``forward(a, b)`` -> ``h`` with ``h_t = a_t h_{t-1} + b_t``,
    ``h_{-1} = 0``, over axis 1 of ``[B, S, W]`` float32."""

    @staticmethod
    def forward(ctx, forward, a, b):
        h = forward(a, b)
        ctx.save_for_backward(a, h)
        ctx.scan = forward
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        # g_t = g_t + a_{t+1} g_{t+1}: the forward recurrence on the
        # reversed sequence, with a shifted one step (a_S = 0)
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        gh = ctx.scan(a_next.flip(1),
                      g.to(torch.float32).flip(1)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        da = gh * h_prev if ctx.needs_input_grad[1] else None
        return None, da, gh if ctx.needs_input_grad[2] else None
