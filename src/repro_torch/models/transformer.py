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
cross-attention alike; a decode step attends in torch.  The JAX
package's sharding context (``set_mesh_axes``, ``shard_hidden``) is global
state and has no twin: each rank computes on its own rows, where
``shard_hidden`` would be the identity, and a mesh whose ``model`` axis is
above 1 passes its ``launch/tensor_parallel.py::ModelAxis`` down the stack
as ``tp`` (the model holds it, ``launch/distributed.py::MeshRun.place``):
each block runs its share of the heads, ``ff`` slice, width or experts.

Training (no cache) rematerialises each layer under ``remat="full"`` or
``"dots"`` (``torch.utils.checkpoint``, non-reentrant), where the JAX
package remats each group of the scan: the same function, recomputed per
layer, tail layers included.  Under ``"full"`` a layer's kernels launch
again in its recomputation; ``"dots"`` keeps the products without a batch
dimension and K7's output (``apply_stack`` states the policy op by op).
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.kernels import ops
from repro_torch.models.attention import (blocked_attention, cache_update,
                                          cp_attention, init_kv_cache,
                                          plain_attention, ring_positions,
                                          sharded_decode_attention)
from repro_torch.models.layers import (D, Params, apply_rope, block_in,
                                       block_out, grad_fence, mlp_apply,
                                       mlp_defs, on_shard, rms_norm,
                                       rope_angles)
from repro_torch.models.mamba2 import init_ssm_state, ssm_apply, ssm_defs
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.rglru import init_rglru_state, rglru_apply, rglru_defs

PORTED_KINDS = ("global", "local", "recurrent", "ssm", "cross", "enc",
                "encdec")
REMAT = ("full", "dots", "none")
# what remat="dots" keeps of a layer's forward (see ``apply_stack``)
DOTS_KEPT = frozenset((torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default, ops.fused_block_op))


# ------------------------------------------------------------- definitions
def attn_defs(cfg, kind: str) -> dict:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {
        "pre_norm": D((d,), ("embed",), init="zeros"),
        "wq": D((d, nh * hd), ("embed", "heads")),
        "wk": D((d, nkv * hd), ("embed", "kv")),
        "wv": D((d, nkv * hd), ("embed", "kv")),
        "wo": D((nh * hd, d), ("heads", "embed")),
    }
    if cfg.sandwich_norm:
        out["post_norm"] = D((d,), ("embed",), init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = D((hd,), (None,), init="zeros")
        out["k_norm"] = D((hd,), (None,), init="zeros")
    if kind == "cross" and cfg.family == "vlm":
        out["gate_attn"] = D((), (), init="zeros")
        out["gate_mlp"] = D((), (), init="zeros")
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
               fill_cross: bool = False, tp=None):
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
    causal, as the JAX package).

    With the heads split over ``tp``'s ranks, a rank projects its q heads
    (and its kv heads where the axis divides them; else all kv heads,
    of which its q heads read theirs under GQA's ``h // G``), attends
    with them, and ``wo`` is row-parallel: the partial outputs are summed
    in float32 before the sandwich norm and the vlm gate.  A decode
    cache that keeps every kv head is split by sequence
    (:func:`_seq_split`).  Under Megatron-SP (``tp.seq``) ``x`` is this
    rank's sequence shard: normed there, gathered whole for the
    projections (``layers.py::block_in``), and the partial outputs
    reduce-scattered back to the shard (``block_out``), where the
    sandwich norm, the gate and the residual apply."""
    hd = cfg.hd
    heads = tp is not None and tp.heads
    nh = cfg.n_heads // tp.n if heads else cfg.n_heads
    h = rms_norm(x, on_shard(p.pre_norm, tp))
    hq = block_in(h, tp, heads)
    if tp is not None and tp.seq:
        h = hq                      # the gathered sequence; k and v from it
    B, S, _ = hq.shape
    q = (hq @ p.wq.to(h.dtype)).reshape(B, S, nh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, tp.copy(p.q_norm) if heads else p.q_norm)
    if kind == "cross":
        out, cache = _cross_attention(p, q, cfg, cache, ctx, fill_cross, tp)
    else:
        out, cache = _self_attention(p, h, q, cfg, kind, cache, pos, causal,
                                     tp)
    y = out.reshape(B, S, nh * hd) @ p.wo.to(x.dtype)
    if heads:
        y = block_out(y.to(torch.float32), tp, x.dtype)
    if cfg.sandwich_norm:
        y = rms_norm(y, on_shard(p.post_norm, tp))
    gate = p.get("gate_attn") if kind == "cross" else None
    if gate is not None:
        y = torch.tanh(on_shard(gate, tp).to(y.dtype)) * y
    return x + y, cache


def _kv_split(tp) -> bool:
    return tp is not None and tp.heads and tp.kv


def _local_kv(t: torch.Tensor, cfg, tp) -> torch.Tensor:
    """``t`` [B, T, NKV, hd] with every kv head -> the kv heads this rank's
    q heads read (GQA: q head ``h`` reads ``h // G``): a slice where the
    rank's heads keep GQA's grouping, else one kv head a q head."""
    if tp is None or not tp.heads or tp.kv:
        return t
    nh = cfg.n_heads // tp.n
    g = cfg.n_heads // cfg.n_kv_heads
    idx = [(tp.rank * nh + i) // g for i in range(nh)]
    lo, hi = idx[0], idx[-1] + 1
    if nh % (hi - lo) == 0 and idx == [lo + i // (nh // (hi - lo))
                                       for i in range(nh)]:
        return t[:, :, lo:hi]
    # the index made on the device (no host list reaches a traced step)
    at = torch.div(torch.arange(nh, device=t.device) + tp.rank * nh, g,
                   rounding_mode="floor")
    return t.index_select(2, at)


def _seq_split(tp, length: int, full: int) -> bool:
    """Whether a cache leaf of ``length`` slots, of a cache whose whole
    length is ``full``, is split by sequence over ``tp``'s ranks
    (``launch/sharding.py::cache_pspecs``: kv heads kept whole, ``model``
    not a batch axis, a length the axis divides)."""
    return (tp is not None and tp.seq_cache and full % tp.n == 0
            and length * tp.n == full)


def _self_attention(p, h, q, cfg, kind, cache, pos, causal, tp):
    B, S, _ = h.shape
    hd = cfg.hd
    split = _kv_split(tp)
    sp = tp is not None and tp.seq
    nkv = cfg.n_kv_heads // tp.n if split else cfg.n_kv_heads
    # under SP ``h`` is already the gathered input of split work; kv heads
    # that are not split are then computed whole from it, each rank's
    # gradient of them a part, so their weights (not k and v) enter
    # through ``tp.copy``
    hk = tp.copy(h) if split and not sp else h
    wk, wv = p.wk, p.wv
    if sp and not split:
        wk, wv = tp.copy(wk), tp.copy(wv)
    k = (hk @ wk.to(h.dtype)).reshape(B, S, nkv, hd)
    v = (hk @ wv.to(h.dtype)).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        k = rms_norm(k, tp.copy(p.k_norm) if split or sp else p.k_norm)
    sin, cos = rope_angles(pos + torch.arange(S, device=h.device), hd,
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    window = cfg.window if kind == "local" else 0
    seq = False
    if cache is not None:
        full = (min(cfg.max_seq, cfg.window) if kind == "local"
                else cfg.max_seq)
        seq = _seq_split(tp, cache["k"].shape[1], full)
        length = cache["k"].shape[1] * (tp.n if seq else 1)
        ring = length < cfg.max_seq
        cache = cache_update(cache, k, v, pos, ring=ring,
                             shard=(tp.rank, tp.n) if seq else None)
    if cache is None or S > 1:
        if pos != 0:
            raise NotImplementedError(
                f"attention of fresh keys from position {pos}: the port's "
                f"prefill and training forward (K6) start at position 0, "
                f"as the JAX package's do")
        if cache is None:
            q, k, v = grad_fence(q), grad_fence(k), grad_fence(v)
        if tp is not None and tp.heads and not split and not sp:
            k, v = tp.copy(k), tp.copy(v)
        k, v = _local_kv(k, cfg, tp), _local_kv(v, cfg, tp)
        if (cache is not None and tp is not None and tp.cp and not tp.heads
                and S % tp.n == 0):
            return cp_attention(q, k, v, tp, causal=causal, window=window,
                                softcap=cfg.attn_softcap), cache
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.attn_softcap)
    elif seq:
        slots = torch.arange(length, device=h.device)
        kpos = (ring_positions(pos + S, length, h.device) if ring
                else slots)
        mine = slice(tp.rank * cache["k"].shape[1],
                     (tp.rank + 1) * cache["k"].shape[1])
        out = sharded_decode_attention(
            tp.gather(q, 2) if tp.heads else q, cache["k"], cache["v"], tp,
            q_pos=pos, k_pos=kpos[mine],
            valid=(slots < pos + S)[mine], causal=True, window=window,
            softcap_val=cfg.attn_softcap)
        if tp.heads:
            out = tp.slice(out, 2)
    elif ring:
        kpos = ring_positions(pos + S, cache["k"].shape[1], h.device)
        out = blocked_attention(q, _local_kv(cache["k"], cfg, tp),
                                _local_kv(cache["v"], cfg, tp), q_offset=pos,
                                causal=True, window=window,
                                softcap_val=cfg.attn_softcap,
                                k_positions=kpos)
    else:
        out = plain_attention(q, _local_kv(cache["k"], cfg, tp),
                              _local_kv(cache["v"], cfg, tp), q_offset=pos,
                              causal=True, window=window,
                              softcap_val=cfg.attn_softcap, kv_len=pos + S)
    return out, cache


def _cross_attention(p, q, cfg, cache, ctx, fill_cross, tp):
    B = q.shape[0]
    hd = cfg.hd
    split = _kv_split(tp)
    nkv = cfg.n_kv_heads // tp.n if split else cfg.n_kv_heads
    decode = cache is not None and not fill_cross
    full = cfg.enc_seq if cfg.family == "audio" else cfg.vision_seq
    if decode:
        k, v = cache["ck"], cache["cv"]           # precomputed at prefill
    else:
        if ctx is None:
            raise ValueError("a cross layer's prefill or forward needs the "
                             "context (ctx)")
        T = ctx.shape[1]
        c = tp.copy(ctx) if split else ctx
        k = (c @ p.wk.to(ctx.dtype)).reshape(B, T, nkv, hd)
        v = (c @ p.wv.to(ctx.dtype)).reshape(B, T, nkv, hd)
        if cache is not None:                     # prefill: store
            keep = (tp.slice(k, 1), tp.slice(v, 1)) if _seq_split(
                tp, cache["ck"].shape[1], full) else (k, v)
            cache = {"ck": keep[0].to(cache["ck"].dtype).contiguous(),
                     "cv": keep[1].to(cache["cv"].dtype).contiguous()}
    if cfg.qk_norm:
        k = rms_norm(k, tp.copy(p.k_norm) if split else p.k_norm)
    if decode and _seq_split(tp, k.shape[1], full):
        slots = torch.arange(k.shape[1], device=k.device)
        out = sharded_decode_attention(
            tp.gather(q, 2) if tp.heads else q, k, v, tp, q_pos=0,
            k_pos=slots, valid=torch.ones_like(slots, dtype=torch.bool),
            causal=False, softcap_val=cfg.attn_softcap)
        return (tp.slice(out, 2) if tp.heads else out), cache
    if tp is not None and tp.heads and not split and not decode:
        k, v = tp.copy(k), tp.copy(v)
    k, v = _local_kv(k, cfg, tp), _local_kv(v, cfg, tp)
    if decode:
        out = blocked_attention(q, k, v, causal=False,
                                softcap_val=cfg.attn_softcap)
    else:
        out = ops.flash_attention(q, k, v, causal=False, window=0,
                                  softcap=cfg.attn_softcap)
    return out, cache


def ffn_apply(p: Params, x: torch.Tensor, cfg, gate=None, tp=None):
    """The MLP sub-block with residual (K7), or the mixture of experts.
    Returns (y, aux loss: None for a dense MLP).  ``gate`` (a vlm cross
    layer's ``gate_mlp``) scales the block's update by ``tanh(gate)``."""
    if cfg.n_experts:
        return moe_apply(p, x, cfg, tp)
    y = mlp_apply(p, x, cfg, tp)
    if gate is not None:
        y = x + torch.tanh(on_shard(gate, tp).to(x.dtype)) * (y - x)
    return y, None


# -------------------------------------------------------------- one layer
def apply_layer(layer: Layer, x: torch.Tensor, cfg, *, cache=None,
                pos: int = 0, ctx=None, fill_cross: bool = False, tp=None):
    """Returns (x, new_cache, aux: None without experts)."""
    kind = layer.kind
    if kind == "ssm":
        x, cache = ssm_apply(layer.ssm, x, cfg, state=cache, tp=tp)
        return x, cache, None
    if kind == "recurrent":
        x, cache = rglru_apply(layer.rglru, x, cfg, state=cache, tp=tp)
        x, aux = ffn_apply(layer.ffn, x, cfg, tp=tp)
        return x, cache, aux
    if kind == "encdec":
        sc = None if cache is None else cache["self"]
        xc = None if cache is None else cache["crosskv"]
        x, sc = attn_apply(layer.attn, x, cfg, "global", cache=sc, pos=pos,
                           tp=tp)
        x, xc = attn_apply(layer.xattn, x, cfg, "cross", cache=xc, ctx=ctx,
                           fill_cross=fill_cross, tp=tp)
        x, aux = ffn_apply(layer.ffn, x, cfg, tp=tp)
        return x, None if cache is None else {"self": sc, "crosskv": xc}, aux
    if kind == "enc":
        x, _ = attn_apply(layer.attn, x, cfg, "global", causal=False, tp=tp)
        x, aux = ffn_apply(layer.ffn, x, cfg, tp=tp)
        return x, None, aux
    x, cache = attn_apply(layer.attn, x, cfg, kind, cache=cache, pos=pos,
                          ctx=ctx, fill_cross=fill_cross, tp=tp)
    gate = layer.attn.get("gate_mlp") if kind == "cross" else None
    x, aux = ffn_apply(layer.ffn, x, cfg, gate=gate, tp=tp)
    return x, cache, aux


def _layer_output(layer: Layer, x: torch.Tensor, cfg, ctx, tp):
    return apply_layer(layer, x, cfg, ctx=ctx, tp=tp)[::2]


def _dots_policy(_ctx, op, *_args, **_kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_KEPT
            else CheckpointPolicy.PREFER_RECOMPUTE)


_dots_contexts = partial(create_selective_checkpoint_contexts, _dots_policy)


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
                remat: str = "none", fill_cross: bool = False, tp=None):
    """Run the whole layer stack.  Returns (x, new_cache, aux): aux is the
    MoE layers' aux losses summed in depth order (a float32 scalar), None
    for a stack without experts.

    Without a cache (training), ``remat`` says what the backward gets of
    each layer's forward:

    * ``"none"``: every activation autograd saves;
    * ``"full"``: the layer's input alone; the backward runs the layer
      again (``torch.utils.checkpoint``, non-reentrant), each kernel with
      it;
    * ``"dots"``: the JAX package's ``checkpoint_dots_with_no_batch_dims``
      -- the same checkpoint, made selective
      (``create_selective_checkpoint_contexts``): the recomputation takes
      the outputs of the ops in ``DOTS_KEPT`` from the forward and runs
      every other op again.  Op by op:

      - kept: ``aten.mm`` and ``aten.addmm``, the products with no batch
        dimension: every projection ``h @ W`` (attention's q, k, v and
        output; the RG-LRU block's two input branches and its output; the
        SSM block's four input projections and its output; the MoE
        router), which ``torch.matmul`` of ``[B, S, d]`` by ``[d, k]``
        reaches as one ``mm``;
      - kept: ``repro_torch::fused_block``, K7 (the MLP, whose three
        products have no batch dimension, with its norm and residual), so
        K7 launches once a layer;
      - run again: ``repro_torch::flash_attention``, K6 (attention's
        products have batch and head dimensions, as the JAX package's
        einsums, which its policy recomputes); ``repro_torch::ssd_scan``
        (K8) and ``repro_torch::rglru_scan`` (K9); ``aten.bmm``, the
        batched products (the RG-LRU's block-diagonal gates, batched over
        blocks; the MoE experts, over experts); and every norm, rotation,
        convolution, cast, activation and elementwise op.

      The kernels are operators of their own (``kernels/ops.py``) on the
      card and on the CPU, where their bodies run the plain versions:
      the policy sees the same ops on both devices and never the products
      inside a plain version.  The backwards are unchanged
      (``kernels/autograd.py``: K6-K8 recompute their training functions
      from their saved inputs, K9 runs the reversed scan), so the
      gradients equal ``"none"``'s and ``"full"``'s.  The selective
      checkpoint is a dispatch mode: every op of the layer passes through
      Python in the forward and again in the recomputation, which on a
      step bound by the host costs more than the recomputation it saves
      (``PERF.md`` §6).

    With a cache (serving) ``remat`` is ignored.  ``tp``: the mesh's
    ``model`` axis (see the module docstring), None without one."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    aux = None
    new_cache = None if cache is None else []
    for i, layer in enumerate(layers):
        if cache is None and remat != "none":
            x, a = checkpoint(_layer_output, layer, x, cfg, ctx, tp,
                              use_reentrant=False,
                              context_fn=(_dots_contexts if remat == "dots"
                                          else noop_context_fn))
        else:
            x, c, a = apply_layer(layer, x, cfg,
                                  cache=None if cache is None else cache[i],
                                  pos=pos, ctx=ctx, fill_cross=fill_cross,
                                  tp=tp)
            if new_cache is not None:
                new_cache.append(c)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, new_cache, aux
