"""Model configuration schema for the assigned architecture pool."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # --- attention structure -------------------------------------------
    # layer-kind pattern cycled over depth:
    #   'global' | 'local' | 'recurrent' | 'cross'
    pattern: tuple[str, ...] = ("global",)
    window: int = 4096                # local-attention window
    attn_softcap: float = 0.0         # 0 disables (gemma2: 50)
    final_softcap: float = 0.0        # gemma2: 30
    sandwich_norm: bool = False       # gemma2 pre+post norm
    act: str = "silu"                 # silu (SwiGLU) | gelu (GeGLU)
    mlp_gated: bool = True            # False: plain 2-matrix MLP (granite)
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    qk_norm: bool = False             # qwen3-style
    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (Mamba-2 SSD) ----------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    # --- RG-LRU (hybrid) --------------------------------------------------
    lru_width: int = 0                # 0 -> d_model
    # --- encoder-decoder / multimodal stubs -------------------------------
    enc_layers: int = 0               # whisper encoder depth
    enc_seq: int = 1500               # precomputed frame embeddings length
    vision_seq: int = 1600            # precomputed patch embeddings length
    # --- bookkeeping ------------------------------------------------------
    max_seq: int = 8192               # overridden by shape cells
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def d_inner(self) -> int:         # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def pattern_len(self) -> int:
        return len(self.pattern)

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------ counting
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        total = v * d                                   # embeddings
        if not self.tie_embeddings:
            total += v * d
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "recurrent":
                w = self.lru_width or d
                total += 2 * d * w + 2 * w + self.conv_width * w + w * d \
                    + 2 * w * (w // 8)                   # rg-lru gates (block-diag 8)
            elif self.family == "ssm":
                di, g, s = self.d_inner, self.ssm_ngroups, self.ssm_state
                total += d * (2 * di + 2 * g * s + self.ssm_nheads) \
                    + self.conv_width * (di + 2 * g * s) + di * d \
                    + 2 * self.ssm_nheads
            else:
                total += d * hd * (nh + 2 * nkv) + nh * hd * d   # attention
            n_mats = 3 if self.mlp_gated else 2
            if self.family == "ssm" and kind != "recurrent":
                pass                                     # no FFN in mamba2
            elif self.n_experts and kind != "cross":
                total += self.n_experts * n_mats * d * ff  # expert FFNs
                total += d * self.n_experts              # router
            else:
                total += n_mats * d * ff
            total += 2 * d                               # norms
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_gated else 2
        dense = (self.param_count()
                 - self.n_layers * self.n_experts * n_mats * d * ff)
        return dense + self.n_layers * self.top_k * n_mats * d * ff


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    mode: str            # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
