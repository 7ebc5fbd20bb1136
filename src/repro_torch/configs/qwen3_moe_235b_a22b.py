"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-*; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    pattern=("global",), act="silu", tie_embeddings=False,
    qk_norm=True,
    n_experts=128, top_k=8,
    source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)")
