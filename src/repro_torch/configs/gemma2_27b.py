"""gemma2-27b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab=256000, head_dim=128,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, sandwich_norm=True,
    act="gelu", tie_embeddings=True,
    source="arXiv:2408.00118")
