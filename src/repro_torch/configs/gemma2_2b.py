"""gemma2-2b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab=256000, head_dim=256,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, sandwich_norm=True,
    act="gelu", tie_embeddings=True,
    source="arXiv:2408.00118")
