"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].

Deviation noted in DESIGN.md: Moonlight's first layer is dense and it adds
shared experts (DeepSeek-V3 lineage); we model a uniform 64e top-6 stack as
the assignment specifies.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, head_dim=128,
    pattern=("global",), act="silu", tie_embeddings=True,
    n_experts=64, top_k=6,
    source="hf:moonshotai/Moonlight-16B-A3B")
