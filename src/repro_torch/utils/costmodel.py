"""Analytic per-cell FLOPs / HBM-bytes model.

The JAX package's ``utils/costmodel.py`` carried over unchanged: the
FLOPs of the products the model code performs, layer kind by layer kind
(the formulas mirror ``models/*.py`` one-to-one), and the bytes a step
moves.  It is plain Python floats in the reference's order of operations,
so every number equals the JAX package's exactly.  The JAX package needs
it because XLA's ``cost_analysis()`` counts a loop body once; the port
uses it for the model FLOPs of a train or serve step (``chip_smoke.py``'s
``model_flops_per_step`` and ``mfu``).

All results are GLOBAL per optimizer/serving step; divide by chip count for
per-device roofline terms (valid because batch/heads/experts are sharded).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclass
class CellCost:
    flops: float               # global FLOPs per step
    weight_bytes: float        # parameter traffic per device-visible step
    act_bytes: float           # activation/KV HBM traffic (global)
    notes: str = ""

    def per_device(self, chips: int) -> tuple[float, float]:
        return self.flops / chips, (self.weight_bytes + self.act_bytes) / chips


def _attn_layer_flops(cfg: ModelConfig, S: int, kv_len: float,
                      window: int = 0) -> float:
    """Per-sequence FLOPs of one self-attention layer over S new tokens."""
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    proj = 2 * S * d * (nh + 2 * nkv) * hd + 2 * S * nh * hd * d
    eff = min(window, kv_len) if window else kv_len
    attn = 2 * 2 * S * eff * nh * hd        # QK^T + PV
    return proj + attn


def _ffn_flops(cfg: ModelConfig, S: int) -> float:
    n_mats = 3 if cfg.mlp_gated else 2
    if cfg.n_experts:
        return S * (2 * cfg.d_model * cfg.n_experts          # router
                    + cfg.top_k * n_mats * 2 * cfg.d_model * cfg.d_ff
                    * cfg.capacity_factor)
    return S * n_mats * 2 * cfg.d_model * cfg.d_ff


def _ssm_layer_flops(cfg: ModelConfig, S: int, decode: bool) -> float:
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh, p = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    proj = 2 * S * d * (2 * di + 2 * g * n + nh) + 2 * S * di * d
    conv = 2 * S * cfg.conv_width * (di + 2 * g * n)
    if decode:
        scan = S * (4 * nh * p * n)                       # state update + C.h
    else:
        Q = cfg.ssm_chunk
        # intra-chunk scores/apply + state build + inter-chunk apply
        scan = S * (2 * Q * g * n + 2 * Q * nh * p + 8 * nh * p * n)
    return proj + conv + scan


def _rglru_layer_flops(cfg: ModelConfig, S: int) -> float:
    d = cfg.d_model
    w = cfg.lru_width or d
    proj = 2 * S * d * w * 2 + 2 * S * w * d
    gates = 2 * 2 * S * w * (w // 8)
    conv = 2 * S * cfg.conv_width * w
    scan = 8 * S * w
    return proj + gates + conv + scan


def _cross_layer_flops(cfg: ModelConfig, S: int, ctx: int,
                       kv_fresh: bool) -> float:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = 2 * S * d * nh * hd + 2 * S * nh * hd * d
    kv = 2 * ctx * d * 2 * nkv * hd if kv_fresh else 0
    attn = 2 * 2 * S * ctx * nh * hd
    return q + kv + attn


def _layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "audio":
        return ["encdec"] * cfg.n_layers
    return [cfg.layer_kind(i) for i in range(cfg.n_layers)]


def forward_flops(cfg: ModelConfig, S: int, kv_len: float, mode: str) -> float:
    """Global forward FLOPs for ONE sequence processing S new tokens."""
    decode = mode == "decode"
    total = 0.0
    ctx_len = cfg.enc_seq if cfg.family == "audio" else cfg.vision_seq
    for kind in _layer_kinds(cfg):
        if kind == "ssm":
            total += _ssm_layer_flops(cfg, S, decode)
        elif kind == "recurrent":
            total += _rglru_layer_flops(cfg, S) + _ffn_flops(cfg, S)
        elif kind == "cross":
            total += _cross_layer_flops(cfg, S, ctx_len, mode != "decode")
            total += _ffn_flops(cfg, S)
        elif kind == "encdec":
            total += _attn_layer_flops(cfg, S, kv_len)
            total += _cross_layer_flops(cfg, S, ctx_len, mode != "decode")
            total += _ffn_flops(cfg, S)
        else:
            win = cfg.window if kind == "local" else 0
            total += _attn_layer_flops(cfg, S, kv_len, win) \
                + _ffn_flops(cfg, S)
    # whisper encoder
    if cfg.family == "audio" and mode != "decode":
        for _ in range(cfg.enc_layers):
            total += _attn_layer_flops(cfg, ctx_len, ctx_len / 2) \
                + _ffn_flops(cfg, ctx_len)
    return total


def unembed_flops(cfg: ModelConfig, tokens: float) -> float:
    return 2 * tokens * cfg.d_model * cfg.vocab


def attention_fraction(cfg: ModelConfig, S: int, kv_len: float,
                       mode: str) -> float:
    """Fraction of forward FLOPs in (head-sharded-able) attention --
    used to attribute hybrid-plan compute between the batch-parallel
    attention and the ff-TP MLP."""
    total = forward_flops(cfg, S, kv_len, mode)
    if not total:
        return 0.0
    attn = 0.0
    for kind in _layer_kinds(cfg):
        if kind in ("global", "local", "encdec"):
            win = cfg.window if kind == "local" else 0
            attn += _attn_layer_flops(cfg, S, kv_len, win)
    return attn / total


def cell_cost(cfg: ModelConfig, cell: ShapeCell, chips: int,
              remat: str = "full", dtype_bytes: int = 2) -> CellCost:
    B, S = cell.global_batch, cell.seq_len
    param_bytes_total = cfg.param_count() * dtype_bytes
    d = cfg.d_model

    if cell.mode == "train":
        fwd = B * forward_flops(cfg, S, (S + 1) / 2, "train") \
            + unembed_flops(cfg, B * S) \
            + B * S * 2 * d * cfg.vocab          # gather/grad of embedding
        factor = 4.0 if remat == "full" else 3.0
        flops = fwd * factor
        # traffic: fp32 params read (fwd+bwd) + grads written + AdamW m/v
        # read+write + param write  (per model-replica, i.e. global bytes
        # = per-device bytes * chips when fully sharded)
        p32 = cfg.param_count() * 4
        weight_traffic = p32 * (2 + 1 + 4 + 1) * 1.0
        # layer-boundary activations saved + reread under full remat
        layers = cfg.n_layers
        act = 2 * layers * B * S * d * dtype_bytes * (2 if remat == "full"
                                                      else 3)
        return CellCost(flops, weight_traffic, act,
                        notes=f"remat={remat} factor={factor}")

    if cell.mode == "prefill":
        flops = B * forward_flops(cfg, S, (S + 1) / 2, "prefill") \
            + unembed_flops(cfg, B)              # last-position logits
        act = 2 * cfg.n_layers * B * S * d * dtype_bytes
        kv_write = _kv_bytes(cfg, B, S, dtype_bytes)
        return CellCost(flops, param_bytes_total, act + kv_write)

    # decode: one token per sequence, full KV/state read per layer
    flops = B * forward_flops(cfg, 1, S, "decode") + unembed_flops(cfg, B)
    kv_read = _kv_bytes(cfg, B, S, dtype_bytes)
    act = 4 * cfg.n_layers * B * d * dtype_bytes
    return CellCost(flops, param_bytes_total, kv_read + act)


def _kv_bytes(cfg: ModelConfig, B: int, S: int, dtype_bytes: int) -> float:
    """Total KV-cache / recurrent-state bytes for the whole stack."""
    total = 0.0
    for kind in _layer_kinds(cfg):
        if kind == "ssm":
            total += B * (cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
                          + (cfg.conv_width - 1)
                          * (cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state)
                          * dtype_bytes)
        elif kind == "recurrent":
            w = cfg.lru_width or cfg.d_model
            total += B * (w * 4 + (cfg.conv_width - 1) * w * dtype_bytes)
        elif kind == "cross":
            total += 2 * B * cfg.vision_seq * cfg.n_kv_heads * cfg.hd \
                * dtype_bytes
        else:
            eff = min(S, cfg.window) if kind == "local" else S
            total += 2 * B * eff * cfg.n_kv_heads * cfg.hd * dtype_bytes
            if kind == "encdec":
                total += 2 * B * cfg.enc_seq * cfg.n_kv_heads * cfg.hd \
                    * dtype_bytes
    return total
