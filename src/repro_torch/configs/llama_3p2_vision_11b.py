"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer;
vision tower is a STUB: input_specs() provides precomputed patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128,
    # 4 self-attention layers then 1 cross-attention (image) layer.
    pattern=("global", "global", "global", "global", "cross"),
    act="silu", tie_embeddings=False, vision_seq=1600,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision")
