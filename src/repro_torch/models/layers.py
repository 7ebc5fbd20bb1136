"""Parameter definitions and core layer math in torch.

The counterpart of the JAX package's ``models/layers.py``.  Every parameter
is declared once as a :class:`ParamDef` (shape, initializer, scale); a
:class:`Params` module turns a dict of them into ``nn.Parameter``s, and
:func:`init_params` fills a module's parameters from a
``torch.Generator``: a standard normal truncated to [-2, 2] times the
scale (``1 / sqrt(fan_in)`` unless given), or zeros / ones -- the JAX
package's initializer, drawn from torch's generator, so the numbers differ
and the distribution is the same.  The layouts are the JAX package's
(``x @ W`` with ``W [in, out]``), so weights cross between the two
packages without a transpose (``convert.py::lm_params_from_numpy``).

Parameters are registered without gradients (serving needs none);
training turns them on (``launch/steps.py::train_params``).  The
sharding half of that module (``partition_specs``, ``abstract``) is left
out: the port runs on one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops


# ----------------------------------------------------------------- ParamDef
@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 0.0                    # 0 -> 1/sqrt(fan_in)


def D(shape, init="normal", scale=0.0) -> ParamDef:
    return ParamDef(tuple(shape), init, scale)


class Params(nn.Module):
    """A flat set of parameters declared by a ``{name: ParamDef}`` dict,
    allocated (uninitialised) with ``dtype`` on ``device``, without
    gradients until ``requires_grad_(True)``."""

    def __init__(self, defs: dict, dtype, device):
        super().__init__()
        self.defs = dict(defs)
        for name, d in self.defs.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(d.shape, dtype=dtype, device=device),
                requires_grad=False))

    def get(self, name: str):
        return getattr(self, name) if name in self.defs else None


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every :class:`Params` under ``module`` from ``generator`` (on
    the parameters' device), leaf by leaf in registration order; normal
    draws are float32, then rounded to the parameter's type."""
    for mod in module.modules():
        if not isinstance(mod, Params):
            continue
        for name, d in mod.defs.items():
            p = getattr(mod, name)
            if d.init == "zeros":
                p.zero_()
            elif d.init == "ones":
                p.fill_(1.0)
            else:
                fan_in = d.shape[-2] if len(d.shape) >= 2 else max(
                    1, d.shape[-1])
                scale = d.scale or 1.0 / math.sqrt(fan_in)
                draw = torch.empty(d.shape, dtype=torch.float32,
                                   device=p.device)
                nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                p.copy_(scale * draw)


# -------------------------------------------------------------- grad fence
class _GradFence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_fence(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward casts the cotangent to the primal's
    type (the JAX package's ``grad_fence``: attention's float32 scores must
    not make dq / dk / dv float32)."""
    return _GradFence.apply(x)


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dt)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [*, S] -> (sin, cos) each [*, S, head_dim/2], float32."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; sin/cos [..., S, hd/2] broadcast over heads."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ------------------------------------------------------------- activations
def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------- embedding
def embed_defs(cfg) -> dict:
    # std 1/sqrt(d): input scaling by sqrt(d) then yields unit-RMS inputs
    # and unit-scale tied-unembed logits.
    d = {"tok": D((cfg.vocab, cfg.d_model), scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        d["head"] = D((cfg.d_model, cfg.vocab))
    return d


def embed_lookup(embed: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The rows of ``tokens`` times sqrt(d) (in float32, as the JAX
    package's numpy scalar makes it), in the model's type."""
    x = embed.tok[tokens]
    return (x.to(torch.float32) * math.sqrt(cfg.d_model)).to(model_dtype(cfg))


def unembed(embed: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ embed.tok.to(x.dtype).t()
    else:
        logits = x @ embed.head.to(x.dtype)
    return softcap(logits.to(torch.float32), cfg.final_softcap)


# --------------------------------------------------------------------- MLP
def mlp_defs(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    out = {
        "pre_norm": D((d,), init="zeros"),
        "w_up": D((d, ff)),
        "w_down": D((ff, d)),
    }
    if cfg.mlp_gated:
        out["w_gate"] = D((d, ff))
    if cfg.sandwich_norm:
        out["post_norm"] = D((d,), init="zeros")
    return out


def mlp_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """(Gated-)linear-unit MLP with residual, as one fused block (K7,
    ``kernels/ops.py::fused_block``) over the rows of ``x [..., d]``; the
    weights are cast to ``x``'s type first, as the JAX package casts them
    for each product (float32 masters, bfloat16 activations)."""
    shape = x.shape

    def w(name):
        t = p.get(name)
        return None if t is None else t.to(x.dtype)

    y = ops.fused_block(
        x.reshape(-1, shape[-1]).contiguous(), p.pre_norm, w("w_gate"),
        w("w_up"), w("w_down"), p.get("post_norm"), act=cfg.act,
        gated=cfg.mlp_gated, sandwich=cfg.sandwich_norm)
    return y.reshape(shape)


def mlp_unfused(x, scale, w_gate, w_up, w_down, post_scale=None, *,
                act: str = "silu", gated: bool = True,
                sandwich: bool = False) -> torch.Tensor:
    """The JAX package's ``mlp_apply`` step by step, each product in
    ``x``'s type: the function K7's backward differentiates
    (``kernels/autograd.py``)."""
    h = rms_norm(x, scale)
    u = h @ w_up.to(h.dtype)
    if gated:
        u = act_fn(act)(h @ w_gate.to(h.dtype)) * u
    else:
        u = act_fn(act)(u)
    y = u @ w_down.to(h.dtype)
    if sandwich:
        y = rms_norm(y, post_scale)
    return x + y
