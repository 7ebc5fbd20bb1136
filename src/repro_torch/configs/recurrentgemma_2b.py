"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1 attn per 2 recurrent
[arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    pattern=("recurrent", "recurrent", "local"), window=2048,
    act="gelu", tie_embeddings=True, lru_width=2560,
    source="arXiv:2402.19427")
