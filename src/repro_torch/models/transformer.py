"""Composable block definitions and the layer stack in torch.

The counterpart of the JAX package's ``models/transformer.py``.  Layer kinds
are cycled per the config ``pattern``; the JAX package scans over stacked
group parameters (one group = one pattern cycle) plus explicit tail layers
(e.g. recurrentgemma's 26 = 3*8 + 2).  Here the stack is a Python loop over
one module per layer in depth order: layer ``g * len(pattern) + i`` is the
JAX package's group ``g``, slot ``p{i}``, and the tail layers ``t{i}``
follow (``convert.py::lm_params_from_numpy`` maps one onto the other).

Ported layer kinds: ``global`` and ``local`` self-attention and
``recurrent`` (RG-LRU), each with its MLP, and ``ssm`` (the Mamba-2 block,
which has no MLP, as in the JAX package).  ``cross`` (vlm), ``enc`` /
``encdec`` (whisper) and MoE MLPs (``n_experts > 0``) raise
``NotImplementedError``.  The sharding context (``set_mesh_axes``,
``shard_hidden``) is dropped: the port runs on one card.

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
from repro_torch.models.rglru import init_rglru_state, rglru_apply, rglru_defs

PORTED_KINDS = ("global", "local", "recurrent", "ssm")
REMAT = ("full", "none")


def _require_kind(cfg, kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} ({cfg.name}) is not ported yet: the port "
            f"serves {', '.join(PORTED_KINDS)} layers (cross, enc and encdec "
            f"come with the vlm and audio families)")


def _require_dense(cfg) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"MoE MLPs ({cfg.name}: {cfg.n_experts} experts) are not ported "
            f"yet")


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
    return out


def ffn_defs(cfg) -> dict:
    _require_dense(cfg)
    return mlp_defs(cfg)


def layer_defs(cfg, kind: str) -> dict:
    """``{sub-block: {name: ParamDef}}`` of one layer."""
    _require_kind(cfg, kind)
    if kind == "ssm":
        return {"ssm": ssm_defs(cfg)}
    if kind == "recurrent":
        return {"rglru": rglru_defs(cfg), "ffn": mlp_defs(cfg)}
    return {"attn": attn_defs(cfg, kind), "ffn": ffn_defs(cfg)}


class Layer(nn.Module):
    """One layer's parameters: ``ssm``, or ``attn`` or ``rglru`` and
    ``ffn``."""

    def __init__(self, cfg, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        for name, defs in layer_defs(cfg, kind).items():
            self.add_module(name, Params(defs, dtype, device))


# ------------------------------------------------------------ attention op
def attn_apply(p: Params, x: torch.Tensor, cfg, kind: str, *,
               cache: dict | None = None, pos: int = 0):
    """One self-attention sub-block with residual.  Returns (y, cache).

    A prefill (S > 1 with a cache) and a forward without a cache (the
    training path, q, k and v behind ``grad_fence`` as in the JAX package)
    run K6 and must start at position 0, as the JAX package's serving and
    training paths always do; the decode step attends the cache (ring:
    blocked attention over slot positions; linear: plain attention over
    ``pos + 1`` entries)."""
    _require_kind(cfg, kind)
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p.pre_norm)
    q = (h @ p.wq.to(h.dtype)).reshape(B, S, nh, hd)
    k = (h @ p.wk.to(h.dtype)).reshape(B, S, nkv, hd)
    v = (h @ p.wv.to(h.dtype)).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    sin, cos = rope_angles(pos + torch.arange(S, device=x.device), hd,
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
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_softcap)
    elif ring:
        kpos = ring_positions(pos + S, cache["k"].shape[1], x.device)
        out = blocked_attention(q, cache["k"], cache["v"], q_offset=pos,
                                causal=True, window=window,
                                softcap_val=cfg.attn_softcap,
                                k_positions=kpos)
    else:
        out = plain_attention(q, cache["k"], cache["v"], q_offset=pos,
                              causal=True, window=window,
                              softcap_val=cfg.attn_softcap, kv_len=pos + S)
    y = out.reshape(B, S, nh * hd) @ p.wo.to(x.dtype)
    if cfg.sandwich_norm:
        y = rms_norm(y, p.post_norm)
    return x + y, cache


def ffn_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    _require_dense(cfg)
    return mlp_apply(p, x, cfg)


# -------------------------------------------------------------- one layer
def apply_layer(layer: Layer, x: torch.Tensor, cfg, *, cache=None,
                pos: int = 0):
    """Returns (x, new_cache)."""
    if layer.kind == "ssm":
        return ssm_apply(layer.ssm, x, cfg, state=cache)
    if layer.kind == "recurrent":
        x, cache = rglru_apply(layer.rglru, x, cfg, state=cache)
    else:
        x, cache = attn_apply(layer.attn, x, cfg, layer.kind, cache=cache,
                              pos=pos)
    return ffn_apply(layer.ffn, x, cfg), cache


def _layer_output(layer: Layer, x: torch.Tensor, cfg) -> torch.Tensor:
    return apply_layer(layer, x, cfg)[0]


# ------------------------------------------------------------- caches
def layer_cache(cfg, kind: str, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cpu"):
    _require_kind(cfg, kind)
    nkv, hd = cfg.n_kv_heads, cfg.hd
    if kind == "ssm":
        return init_ssm_state(cfg, batch, device)
    if kind == "recurrent":
        return init_rglru_state(cfg, batch, device)
    if kind == "local":
        return init_kv_cache(batch, min(max_len, cfg.window), nkv, hd, dtype,
                             device)
    return init_kv_cache(batch, max_len, nkv, hd, dtype, device)


# ------------------------------------------------------ stack construction
def stack_structure(cfg) -> tuple[list[str], int, int]:
    """(pattern kinds, n_groups, n_tail) of the decoder stack."""
    pattern = ["ssm"] if cfg.family == "ssm" else list(cfg.pattern)
    n_groups = cfg.n_layers // len(pattern)
    n_tail = cfg.n_layers - n_groups * len(pattern)
    return pattern, n_groups, n_tail


def stack_kinds(cfg) -> list[str]:
    """The decoder's layer kinds in depth order: the groups' slots, then
    the tail."""
    pattern, n_groups, n_tail = stack_structure(cfg)
    return pattern * n_groups + [pattern[i % len(pattern)]
                                 for i in range(n_tail)]


def build_stack(cfg, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(Layer(cfg, kind, dtype, device)
                         for kind in stack_kinds(cfg))


def stack_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cpu") -> list:
    return [layer_cache(cfg, kind, batch, max_len, dtype, device)
            for kind in stack_kinds(cfg)]


def apply_stack(layers: nn.ModuleList, x: torch.Tensor, cfg, *,
                cache: list | None = None, pos: int = 0,
                remat: str = "none"):
    """Run the whole layer stack.  Returns (x, new_cache).

    ``remat="full"`` (without a cache) recomputes each layer in the
    backward instead of keeping its activations; ``"dots"`` (the JAX
    package's policy of keeping the products) is not ported."""
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (keep the products, recompute the rest) is not "
            "ported; use 'full' or 'none'")
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    if cache is None and remat == "full":
        for layer in layers:
            x = checkpoint(_layer_output, layer, x, cfg, use_reentrant=False)
        return x, None
    new_cache = None if cache is None else []
    for i, layer in enumerate(layers):
        x, c = apply_layer(layer, x, cfg,
                           cache=None if cache is None else cache[i],
                           pos=pos)
        if new_cache is not None:
            new_cache.append(c)
    return x, new_cache
