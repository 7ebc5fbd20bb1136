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
training turns them on (``launch/steps.py::train_params``).  Each
``ParamDef`` carries one logical axis a dimension (``"embed"``, ``"ff"``,
``"heads"``, ...), the JAX package's, from which
:func:`partition_specs` derives a parameter's placement on a mesh under a
plan's rules (``launch/sharding.py``).  ``abstract`` has no twin: a model
on the ``meta`` device is the port's abstract one.
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
    axes: tuple[str | None, ...]          # logical axis per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 0.0                    # 0 -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in length")


def D(shape, axes, init="normal", scale=0.0) -> ParamDef:
    return ParamDef(tuple(shape), tuple(axes), init, scale)


def partition_specs(defs: dict, rules: dict) -> dict:
    """``{name: ParamDef}`` -> ``{name: spec}``: a spec is a tuple with
    one entry a dimension, the mesh axis (a name, a tuple of names, or
    None: replicated) that ``rules`` maps the dimension's logical axis to
    (a logical axis missing from ``rules`` is replicated).  A mesh axis
    that an earlier dimension of the same tensor took is not used again:
    that dimension is replicated (the JAX package's rule against
    double-mapping)."""
    def one(d: ParamDef) -> tuple:
        mesh_axes = []
        used: set = set()
        for ax in d.axes:
            m = rules.get(ax)
            if m is not None and m in used:
                m = None                      # avoid double-mapping
            if m is not None:
                used.update(m if isinstance(m, tuple) else (m,))
            if isinstance(m, tuple) and len(m) == 1:
                m = m[0]                      # as PartitionSpec keeps it
            mesh_axes.append(m)
        return tuple(mesh_axes)

    return {name: one(d) for name, d in defs.items()}


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
    the parameters' device), leaf by leaf in registration order
    (:func:`init_leaf`)."""
    for mod in module.modules():
        if not isinstance(mod, Params):
            continue
        for name, d in mod.defs.items():
            init_leaf(getattr(mod, name), d, generator)


@torch.no_grad()
def init_leaf(p: torch.Tensor, d: ParamDef,
              generator: torch.Generator) -> torch.Tensor:
    """Fill one parameter ``p`` of ``d`` from ``generator`` and return it:
    normal draws are float32, scaled in place (a float32 ``p`` is drawn
    into, so a leaf takes no second copy of its size), then rounded to the
    parameter's type."""
    if d.init == "zeros":
        return p.zero_()
    if d.init == "ones":
        return p.fill_(1.0)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(1, d.shape[-1])
    scale = d.scale or 1.0 / math.sqrt(fan_in)
    draw = (p if p.dtype == torch.float32 else
            torch.empty(d.shape, dtype=torch.float32, device=p.device))
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    draw.mul_(scale)
    return p if draw is p else p.copy_(draw)


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


# --------------------------------------------------- a block's split work
def block_in(h: torch.Tensor, tp, split: bool) -> torch.Tensor:
    """``h`` as the input of a block's work split over ``tp``'s ranks
    (``split``): entered through ``tp.copy`` (its gradient, a part a rank,
    summed); under Megatron-SP (``tp.seq``) the ranks' sequence shards
    gathered instead, whose backward reduce-scatters the parts.  Work that
    is not split takes ``h`` as it is (under SP it has no path: the plans
    that split the stream split every block)."""
    if tp is not None and tp.seq:
        if not split:
            raise ValueError("Megatron-SP needs every block's work split "
                             "over the model axis (a tp plan)")
        return tp.gather_shards(h, 1)
    return tp.copy(h) if split else h


def block_out(y: torch.Tensor, tp, dtype) -> torch.Tensor:
    """The ranks' partial float32 results ``y`` summed, in ``dtype``: an
    all-reduce, or under Megatron-SP a reduce-scatter that leaves each
    rank its shard of the sequence (dimension 1)."""
    y = tp.reduce_scatter(y, 1) if tp.seq else tp.reduce(y)
    return y.to(dtype)


def on_shard(t: torch.Tensor, tp) -> torch.Tensor:
    """A parameter used on this rank's sequence shard under Megatron-SP
    (a norm's scale, a gate): entered through ``tp.copy``, so that its
    gradient sums the shards'.  Without SP, ``t``."""
    return tp.copy(t) if tp is not None and tp.seq else t


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
    d = {"tok": D((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                  scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        d["head"] = D((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return d


def embed_lookup(embed: Params, tokens: torch.Tensor, cfg,
                 tp=None) -> torch.Tensor:
    """The rows of ``tokens`` times sqrt(d) (in float32, as the JAX
    package's numpy scalar makes it), in the model's type.  With the
    vocabulary split over ``tp``'s ranks: each rank looks up the tokens
    of its rows of the table (zeros for the others) and the ranks' rows
    are summed, in float32, exactly.  Under Megatron-SP (``tp.seq``) the
    result is this rank's shard of the sequence: the sum a
    reduce-scatter, or a table that is not split looked up whole and
    cut (``tp.scatter``)."""
    if tp is None or not tp.vocab:
        x = embed.tok[tokens].to(torch.float32)
        if tp is not None and tp.seq:
            x = tp.scatter(x, 1)
    else:
        rows = embed.tok.shape[0]
        local = tokens.long() - tp.rank * rows
        own = (local >= 0) & (local < rows)
        x = embed.tok[local.clamp(0, rows - 1)].to(torch.float32)
        x = torch.where(own[..., None], x, torch.zeros_like(x))
        x = tp.reduce_scatter(x, 1) if tp.seq else tp.reduce(x)
    return (x * math.sqrt(cfg.d_model)).to(model_dtype(cfg))


def gather_sequence(x: torch.Tensor, tp) -> torch.Tensor:
    """Under Megatron-SP, the ranks' sequence shards of the stream
    gathered for the unembedding: by ``tp.gather_shards`` where the
    vocabulary is split (the column-parallel product leaves each rank a
    part of the gradient), else by ``tp.gather`` (every rank computes
    the same whole logits)."""
    if tp is None or not tp.seq:
        return x
    return tp.gather_shards(x, 1) if tp.vocab else tp.gather(x, 1)


def unembed(embed: Params, x: torch.Tensor, cfg, tp=None,
            gather: bool = True, enter: bool = True) -> torch.Tensor:
    """The float32 logits of ``x``.  With the vocabulary split over
    ``tp``'s ranks the product is column-parallel: each rank computes the
    logits of its slice of the vocabulary, gathered whole (in vocabulary
    order, so ``argmax`` keeps its first-occurrence rule) unless
    ``gather=False`` (the loss, :func:`vocab_parallel_nll`).  ``x``
    enters the split product through ``tp.copy`` unless ``enter=False``
    (a sequence gathered by :func:`gather_sequence`, whose backward
    already sums the ranks' parts)."""
    split = tp is not None and tp.vocab
    if split and enter:
        x = tp.copy(x)
    if cfg.tie_embeddings:
        logits = x @ embed.tok.to(x.dtype).t()
    else:
        logits = x @ embed.head.to(x.dtype)
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return tp.gather(logits, -1) if split and gather else logits


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, tp):
    """``(logsumexp - gold logit)`` of each row of ``logits`` (this rank's
    slice of the vocabulary, float32): the maximum is all-reduced with
    MAX, the sum of exponentials with SUM, and the gold logit comes from
    the rank whose slice holds the label (the others add 0).  The
    gradient, through the conjugate operators, is the softmax minus the
    one-hot on each rank's slice."""
    v = logits.shape[-1]
    m = tp.max(logits.amax(dim=-1))
    se = tp.reduce(torch.exp(logits - m[..., None]).sum(dim=-1))
    local = labels.long() - tp.rank * v
    own = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = tp.reduce(torch.where(own, gold, torch.zeros_like(gold)))
    return m + torch.log(se) - gold


# --------------------------------------------------------------------- MLP
def mlp_defs(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    out = {
        "pre_norm": D((d,), ("embed",), init="zeros"),
        "w_up": D((d, ff), ("embed", "ff")),
        "w_down": D((ff, d), ("ff", "embed")),
    }
    if cfg.mlp_gated:
        out["w_gate"] = D((d, ff), ("embed", "ff"))
    if cfg.sandwich_norm:
        out["post_norm"] = D((d,), ("embed",), init="zeros")
    return out


def mlp_apply(p: Params, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """(Gated-)linear-unit MLP with residual, as one fused block (K7,
    ``kernels/ops.py::fused_block``) over the rows of ``x [..., d]``; the
    weights are cast to ``x``'s type first, as the JAX package casts them
    for each product (float32 masters, bfloat16 activations).

    With ``ff`` split over ``tp``'s ranks (each holding ``F / n`` columns
    of ``w_gate`` / ``w_up`` and rows of ``w_down``), K7 runs in its
    partial form on the rank's slice; the float32 partial sums are
    all-reduced, then the sandwich norm (not linear) and the residual are
    applied in float32, as K7 applies them.  Under Megatron-SP
    (``tp.seq``: ``x`` is this rank's sequence shard) K7 runs on the
    gathered sequence and the partial sums are reduce-scattered back to
    the shard, where the norm and the residual are applied."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()

    def w(name):
        t = p.get(name)
        return None if t is None else t.to(x.dtype)

    if tp is None or not tp.ff:
        y = ops.fused_block(
            x2, p.pre_norm, w("w_gate"), w("w_up"), w("w_down"),
            p.get("post_norm"), act=cfg.act, gated=cfg.mlp_gated,
            sandwich=cfg.sandwich_norm)
        return y.reshape(shape)
    xin = block_in(x, tp, True)
    y = ops.fused_block(
        xin.reshape(-1, shape[-1]).contiguous(), tp.copy(p.pre_norm),
        w("w_gate"), w("w_up"), w("w_down"), None, act=cfg.act,
        gated=cfg.mlp_gated, partial=True)
    y = block_out(y.reshape(*xin.shape[:-1], -1), tp, torch.float32)
    if cfg.sandwich_norm:
        y = rms_norm(y, on_shard(p.post_norm, tp))
    return (x.to(torch.float32) + y).to(x.dtype)


def mlp_unfused(x, scale, w_gate, w_up, w_down, post_scale=None, *,
                act: str = "silu", gated: bool = True,
                sandwich: bool = False,
                partial: bool = False) -> torch.Tensor:
    """The JAX package's ``mlp_apply`` step by step, each product in
    ``x``'s type: the function K7's backward differentiates
    (``kernels/autograd.py``); ``partial``: the down product alone, in
    float32 (K7's partial form)."""
    h = rms_norm(x, scale)
    u = h @ w_up.to(h.dtype)
    if gated:
        u = act_fn(act)(h @ w_gate.to(h.dtype)) * u
    else:
        u = act_fn(act)(u)
    y = u @ w_down.to(h.dtype)
    if partial:
        return y.to(torch.float32)
    if sandwich:
        y = rms_norm(y, post_scale)
    return x + y
