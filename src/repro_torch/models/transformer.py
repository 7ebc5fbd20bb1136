"""Composable block definitions and the layer stack in torch.

The counterpart of the JAX package's ``models/transformer.py``.  Layer kinds
are cycled per the config ``pattern``; the JAX package scans over stacked
group parameters (one group = one pattern cycle) plus explicit tail layers
(e.g. recurrentgemma's 26 = 3*8 + 2).  Here the stack is a Python loop over
one module per layer in depth order: layer ``g * len(pattern) + i`` is the
JAX package's group ``g``, slot ``p{i}``, and the tail layers ``t{i}``
follow (``convert.py::lm_params_from_numpy`` maps one onto the other).

Layer kinds: ``global`` and ``local`` self-attention, ``recurrent``
(RG-LRU) and ``ssm`` (the Mamba-2 block, which has no MLP, as in the JAX
package); ``cross`` (vlm: queries from the stream, keys and values from the
context -- the patch embeddings -- without RoPE, computed at prefill and
read from the cache at decode, its attention and MLP gated by
``tanh(gate_attn)`` / ``tanh(gate_mlp)``); ``enc`` (whisper's encoder:
self-attention that is not causal, with RoPE, as in the JAX package) and
``encdec`` (whisper's decoder: self-attention, cross-attention over the
encoder's output, then the MLP).  Every kind but ``ssm`` has an MLP: the
fused block K7, or with ``n_experts > 0`` the mixture of experts
(``models/moe.py``), whose aux loss ``apply_stack`` sums.  Attention runs
K6 at a prefill and in a forward without a cache, self- and
cross-attention alike; a decode step attends in torch.  The sharding
context (``set_mesh_axes``, ``shard_hidden``) is dropped: the port runs on
one card.

Training (no cache) rematerialises each layer under ``remat="full"``
(``torch.utils.checkpoint``, non-reentrant), where the JAX package remats
each group of the scan: the same function, recomputed per layer, tail
layers included.  A layer's kernels launch again in its recomputation.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.attention import (blocked_attention, cache_update,
                                          init_kv_cache, plain_attention,
                                          ring_positions)
from repro_torch.models.layers import (D, Params, apply_rope, grad_fence,
                                       mlp_apply, mlp_defs, rms_norm,
                                       rope_angles)
from repro_torch.models.mamba2 import init_ssm_state, ssm_apply, ssm_defs
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.rglru import init_rglru_state, rglru_apply, rglru_defs

PORTED_KINDS = ("global", "local", "recurrent", "ssm", "cross", "enc",
                "encdec")
REMAT = ("full", "none")


# ------------------------------------------------------------- definitions
def attn_defs(cfg, kind: str) -> dict:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {
        "pre_norm": D((d,), init="zeros"),
        "wq": D((d, nh * hd)),
        "wk": D((d, nkv * hd)),
        "wv": D((d, nkv * hd)),
        "wo": D((nh * hd, d)),
    }
    if cfg.sandwich_norm:
        out["post_norm"] = D((d,), init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = D((hd,), init="zeros")
        out["k_norm"] = D((hd,), init="zeros")
    if kind == "cross" and cfg.family == "vlm":
        out["gate_attn"] = D((), init="zeros")
        out["gate_mlp"] = D((), init="zeros")
    return out


def ffn_defs(cfg) -> dict:
    return moe_defs(cfg) if cfg.n_experts else mlp_defs(cfg)


def layer_defs(cfg, kind: str) -> dict:
    """``{sub-block: {name: ParamDef}}`` of one layer."""
    if kind not in PORTED_KINDS:
        raise ValueError(f"layer kind {kind!r} not in {PORTED_KINDS}")
    if kind == "ssm":
        return {"ssm": ssm_defs(cfg)}
    if kind == "recurrent":
        return {"rglru": rglru_defs(cfg), "ffn": mlp_defs(cfg)}
    if kind == "encdec":                       # whisper decoder layer
        return {"attn": attn_defs(cfg, "global"),
                "xattn": attn_defs(cfg, "cross"), "ffn": ffn_defs(cfg)}
    return {"attn": attn_defs(cfg, kind), "ffn": ffn_defs(cfg)}


class Layer(nn.Module):
    """One layer's parameters: ``ssm``; or ``attn`` or ``rglru``, and
    ``ffn``; an ``encdec`` layer also ``xattn``."""

    def __init__(self, cfg, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        for name, defs in layer_defs(cfg, kind).items():
            self.add_module(name, Params(defs, dtype, device))


# ------------------------------------------------------------ attention op
def attn_apply(p: Params, x: torch.Tensor, cfg, kind: str, *,
               cache: dict | None = None, pos: int = 0,
               ctx: torch.Tensor | None = None, causal: bool = True,
               fill_cross: bool = False):
    """One attention sub-block with residual.  Returns (y, cache).

    Self-attention: a prefill (S > 1 with a cache) and a forward without a
    cache (the training path and the encoder, q, k and v behind
    ``grad_fence`` as in the JAX package; ``causal=False`` for the
    encoder) run K6 and must start at position 0, as the JAX package's
    serving and training paths always do; the decode step attends the
    cache (ring: blocked attention over slot positions; linear: plain
    attention over ``pos + 1`` entries).

    ``kind="cross"``: keys and values from ``ctx`` (no RoPE) at a prefill
    (``fill_cross``, which stores them in the cache as ``ck`` / ``cv``) or
    without a cache, attended by K6 without a mask; a decode step reads
    them from the cache and attends in torch (blocked attention, not
    causal, as the JAX package)."""
    B, S, _ = x.shape
    nh, hd = cfg.n_heads, cfg.hd
    h = rms_norm(x, p.pre_norm)
    q = (h @ p.wq.to(h.dtype)).reshape(B, S, nh, hd)
    if kind == "cross":
        out, cache = _cross_attention(p, q, cfg, cache, ctx, fill_cross)
    else:
        out, cache = _self_attention(p, h, q, cfg, kind, cache, pos, causal)
    y = out.reshape(B, S, nh * hd) @ p.wo.to(x.dtype)
    if cfg.sandwich_norm:
        y = rms_norm(y, p.post_norm)
    gate = p.get("gate_attn") if kind == "cross" else None
    if gate is not None:
        y = torch.tanh(gate.to(y.dtype)) * y
    return x + y, cache


def _self_attention(p, h, q, cfg, kind, cache, pos, causal):
    B, S, _ = h.shape
    nkv, hd = cfg.n_kv_heads, cfg.hd
    k = (h @ p.wk.to(h.dtype)).reshape(B, S, nkv, hd)
    v = (h @ p.wv.to(h.dtype)).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    sin, cos = rope_angles(pos + torch.arange(S, device=h.device), hd,
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    window = cfg.window if kind == "local" else 0
    if cache is not None:
        ring = cache["k"].shape[1] < cfg.max_seq
        cache = cache_update(cache, k, v, pos, ring=ring)
    if cache is None or S > 1:
        if pos != 0:
            raise NotImplementedError(
                f"attention of fresh keys from position {pos}: the port's "
                f"prefill and training forward (K6) start at position 0, "
                f"as the JAX package's do")
        if cache is None:
            q, k, v = grad_fence(q), grad_fence(k), grad_fence(v)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.attn_softcap)
    elif ring:
        kpos = ring_positions(pos + S, cache["k"].shape[1], h.device)
        out = blocked_attention(q, cache["k"], cache["v"], q_offset=pos,
                                causal=True, window=window,
                                softcap_val=cfg.attn_softcap,
                                k_positions=kpos)
    else:
        out = plain_attention(q, cache["k"], cache["v"], q_offset=pos,
                              causal=True, window=window,
                              softcap_val=cfg.attn_softcap, kv_len=pos + S)
    return out, cache


def _cross_attention(p, q, cfg, cache, ctx, fill_cross):
    B = q.shape[0]
    nkv, hd = cfg.n_kv_heads, cfg.hd
    decode = cache is not None and not fill_cross
    if decode:
        k, v = cache["ck"], cache["cv"]           # precomputed at prefill
    else:
        if ctx is None:
            raise ValueError("a cross layer's prefill or forward needs the "
                             "context (ctx)")
        T = ctx.shape[1]
        k = (ctx @ p.wk.to(ctx.dtype)).reshape(B, T, nkv, hd)
        v = (ctx @ p.wv.to(ctx.dtype)).reshape(B, T, nkv, hd)
        if cache is not None:                     # prefill: store
            cache = {"ck": k.to(cache["ck"].dtype),
                     "cv": v.to(cache["cv"].dtype)}
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    if decode:
        out = blocked_attention(q, k, v, causal=False,
                                softcap_val=cfg.attn_softcap)
    else:
        out = ops.flash_attention(q, k, v, causal=False, window=0,
                                  softcap=cfg.attn_softcap)
    return out, cache


def ffn_apply(p: Params, x: torch.Tensor, cfg, gate=None):
    """The MLP sub-block with residual (K7), or the mixture of experts.
    Returns (y, aux loss: None for a dense MLP).  ``gate`` (a vlm cross
    layer's ``gate_mlp``) scales the block's update by ``tanh(gate)``."""
    if cfg.n_experts:
        return moe_apply(p, x, cfg)
    y = mlp_apply(p, x, cfg)
    if gate is not None:
        y = x + torch.tanh(gate.to(x.dtype)) * (y - x)
    return y, None


# -------------------------------------------------------------- one layer
def apply_layer(layer: Layer, x: torch.Tensor, cfg, *, cache=None,
                pos: int = 0, ctx=None, fill_cross: bool = False):
    """Returns (x, new_cache, aux: None without experts)."""
    kind = layer.kind
    if kind == "ssm":
        x, cache = ssm_apply(layer.ssm, x, cfg, state=cache)
        return x, cache, None
    if kind == "recurrent":
        x, cache = rglru_apply(layer.rglru, x, cfg, state=cache)
        x, aux = ffn_apply(layer.ffn, x, cfg)
        return x, cache, aux
    if kind == "encdec":
        sc = None if cache is None else cache["self"]
        xc = None if cache is None else cache["crosskv"]
        x, sc = attn_apply(layer.attn, x, cfg, "global", cache=sc, pos=pos)
        x, xc = attn_apply(layer.xattn, x, cfg, "cross", cache=xc, ctx=ctx,
                           fill_cross=fill_cross)
        x, aux = ffn_apply(layer.ffn, x, cfg)
        return x, None if cache is None else {"self": sc, "crosskv": xc}, aux
    if kind == "enc":
        x, _ = attn_apply(layer.attn, x, cfg, "global", causal=False)
        x, aux = ffn_apply(layer.ffn, x, cfg)
        return x, None, aux
    x, cache = attn_apply(layer.attn, x, cfg, kind, cache=cache, pos=pos,
                          ctx=ctx, fill_cross=fill_cross)
    gate = layer.attn.get("gate_mlp") if kind == "cross" else None
    x, aux = ffn_apply(layer.ffn, x, cfg, gate=gate)
    return x, cache, aux


def _layer_output(layer: Layer, x: torch.Tensor, cfg, ctx):
    return apply_layer(layer, x, cfg, ctx=ctx)[::2]


# ------------------------------------------------------------- caches
def layer_cache(cfg, kind: str, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cpu"):
    nkv, hd = cfg.n_kv_heads, cfg.hd

    def context_kv(length):
        return {n: torch.zeros((batch, length, nkv, hd), dtype=dtype,
                               device=device) for n in ("ck", "cv")}

    if kind == "ssm":
        return init_ssm_state(cfg, batch, device)
    if kind == "recurrent":
        return init_rglru_state(cfg, batch, device)
    if kind == "local":
        return init_kv_cache(batch, min(max_len, cfg.window), nkv, hd, dtype,
                             device)
    if kind == "encdec":
        return {"self": init_kv_cache(batch, max_len, nkv, hd, dtype,
                                      device),
                "crosskv": context_kv(cfg.enc_seq)}
    if kind == "cross":
        return context_kv(cfg.vision_seq)
    return init_kv_cache(batch, max_len, nkv, hd, dtype, device)


# ------------------------------------------------------ stack construction
def stack_structure(cfg, decoder: bool = True) -> tuple[list[str], int, int]:
    """(pattern kinds, n_groups, n_tail) of the decoder or encoder stack."""
    if cfg.family == "audio":
        pattern = ["encdec"] if decoder else ["enc"]
        n_layers = cfg.n_layers if decoder else cfg.enc_layers
    else:
        pattern = ["ssm"] if cfg.family == "ssm" else list(cfg.pattern)
        n_layers = cfg.n_layers
    n_groups = n_layers // len(pattern)
    n_tail = n_layers - n_groups * len(pattern)
    return pattern, n_groups, n_tail


def stack_kinds(cfg, decoder: bool = True) -> list[str]:
    """The stack's layer kinds in depth order: the groups' slots, then the
    tail."""
    pattern, n_groups, n_tail = stack_structure(cfg, decoder)
    return pattern * n_groups + [pattern[i % len(pattern)]
                                 for i in range(n_tail)]


def build_stack(cfg, dtype, device, decoder: bool = True) -> nn.ModuleList:
    return nn.ModuleList(Layer(cfg, kind, dtype, device)
                         for kind in stack_kinds(cfg, decoder))


def stack_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cpu") -> list:
    """The decoder's cache, one entry a layer (the encoder keeps none)."""
    return [layer_cache(cfg, kind, batch, max_len, dtype, device)
            for kind in stack_kinds(cfg)]


def apply_stack(layers: nn.ModuleList, x: torch.Tensor, cfg, *,
                cache: list | None = None, pos: int = 0, ctx=None,
                remat: str = "none", fill_cross: bool = False):
    """Run the whole layer stack.  Returns (x, new_cache, aux): aux is the
    MoE layers' aux losses summed in depth order (a float32 scalar), None
    for a stack without experts.

    ``remat="full"`` (without a cache) recomputes each layer in the
    backward instead of keeping its activations; ``"dots"`` (the JAX
    package's policy of keeping the products) is not ported."""
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (keep the products, recompute the rest) is not "
            "ported; use 'full' or 'none'")
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    aux = None
    new_cache = None if cache is None else []
    for i, layer in enumerate(layers):
        if cache is None and remat == "full":
            x, a = checkpoint(_layer_output, layer, x, cfg, ctx,
                              use_reentrant=False)
        else:
            x, c, a = apply_layer(layer, x, cfg,
                                  cache=None if cache is None else cache[i],
                                  pos=pos, ctx=ctx, fill_cross=fill_cross)
            if new_cache is not None:
                new_cache.append(c)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, new_cache, aux
