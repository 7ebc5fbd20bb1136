"""Architecture registry: the 10 assigned configs + reduced smoke variants
+ the paper's own CNN workloads (see repro_torch.cnn.zoo)."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell  # noqa: F401
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2_2b
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2_27b
from repro_torch.configs.granite_20b import CONFIG as _granite
from repro_torch.configs.llama_3p2_vision_11b import CONFIG as _llama_vis
from repro_torch.configs.mamba2_2p7b import CONFIG as _mamba2
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.whisper_base import CONFIG as _whisper

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        _smollm, _gemma2_2b, _gemma2_27b, _granite, _moonshot,
        _qwen3, _mamba2, _whisper, _llama_vis, _rgemma]
}

# Archs whose stacks are fully sub-quadratic (long_500k eligible).
SUBQUADRATIC = {"mamba2-2.7b", "recurrentgemma-2b"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers (one full
    pattern cycle + remainder), narrow width, tiny vocab/experts."""
    c = get_config(name)
    p = c.pattern_len
    kw = dict(
        name=c.name + "-smoke",
        n_layers=max(p + 1, 2) if c.family != "vlm" else 2 * p,
        d_model=64,
        n_heads=4 if c.n_heads else 0,
        n_kv_heads=min(2, c.n_kv_heads) if c.n_kv_heads else 0,
        head_dim=16 if c.n_heads else 0,
        d_ff=128 if c.d_ff else 0,
        vocab=512,
        window=16,
        max_seq=64,
        enc_seq=24 if c.family == "audio" else c.enc_seq,
        vision_seq=8 if c.family == "vlm" else c.vision_seq,
        lru_width=64 if c.lru_width else 0,
        dtype="float32",          # CPU smoke tests check numerics
    )
    if c.n_experts:
        # high capacity factor: no token drops, so prefill-vs-decode
        # consistency tests see identical routing
        kw.update(n_experts=8, top_k=2, capacity_factor=8.0)
    if c.family == "ssm":
        kw.update(ssm_state=16, ssm_headdim=8, ssm_chunk=8)
    if c.family == "audio":
        kw.update(enc_layers=2)
    return c.replace(**kw)


def valid_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch x shape) cells minus documented skips."""
    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in SUBQUADRATIC:
                continue        # full attention: documented skip
            cells.append((arch, shape))
    return cells


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
